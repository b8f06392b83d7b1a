"""CPU tests of `spans`: attribution of planted kernels to the span that
launched them, the flattening of the spans, `span_kernels`' arithmetic,
`capture` on planted profiler events, and a small stream played under
the port's tracer.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import pytest

from bench_tiny import REPO

import harness
import spans

DEC, CALLER = 11, 22


def _span(sid, name, thread, start, end, parent=None, **attrs):
    return {"id": sid, "name": name, "frame": 0, "parent": parent,
            "thread": thread, "start": start, "end": end, "attrs": attrs}


def _profile():
    """A caller in decode_next from 0 to 100, waiting from 10 to 90; the
    decode thread in decode from 20 to 80, a key frame from 25 to 50 and
    an inter frame from 50 to 78, each with stages."""
    ss = [_span(1, "decode_next", CALLER, 0, 100),
          _span(2, "wait", CALLER, 10, 90, 1),
          _span(3, "decode", DEC, 20, 80, 1),
          _span(4, "frame", DEC, 25, 50, 3, kind="key"),
          _span(5, "intra", DEC, 25, 40, 4),
          _span(6, "lr", DEC, 40, 50, 4),
          _span(7, "frame", DEC, 50, 78, 3, kind="inter"),
          _span(8, "intra", DEC, 50, 60, 7),
          _span(9, "tail", DEC, 60, 78, 7),
          _span(10, "download", DEC, 70, 75, 9)]
    # (name, device start, duration), launched at (thread, time)
    kernels = [("intra_wavefront_kernel", 30, 10, (DEC, 26)),
               ("at::native::add", 45, 5, (DEC, 41)),
               ("at::native::mul", 52, 3, (DEC, 42)),
               ("intra_wavefront_kernel", 60, 4, (DEC, 55)),
               ("at::native::copy", 70, 2, (DEC, 61)),
               ("Memcpy DtoH", 72, 3, (DEC, 71)),
               # launched on the caller while the decode thread was in
               # lr: not lr's
               ("at::native::fill", 80, 1, (CALLER, 45)),
               ("unlinked_kernel", 90, 1, None)]
    return {"window": (0, 100), "spans": ss,
            "device_events": [(n, s, d) for n, s, d, _ in kernels],
            "launches": [x for *_, x in kernels],
            "frame_indices": [0, 1]}


def _run(prof):
    return SimpleNamespace(profile=prof)


def test_a_kernel_goes_to_the_innermost_span_of_its_launching_thread():
    assert spans.attribute(_profile()) == [5, 6, 6, 8, 9, 10, 2, None]


def test_span_kernels_reads_kernels_launched_inside_a_span():
    p = _profile()
    # two lr kernels, 5 and 3 ns, over 2 frames
    assert spans.span_kernels(_run(p), {"span": "lr"}) \
        == pytest.approx(8e-6 / 2)
    assert spans.span_kernels(_run(p), {"span": "lr", "count": True}) == 1.0
    assert spans.span_kernels(_run(p), {"span": "intra"}) \
        == pytest.approx(14e-6 / 2)
    assert spans.span_kernels(_run(p), {"span": "intra", "frames": "inter"}) \
        == pytest.approx(4e-6 / 2)
    assert spans.span_kernels(_run(p), {"span": "intra", "frames": "key"}) \
        == pytest.approx(10e-6 / 2)
    # the copy inside tail, not the Memcpy under download
    assert spans.span_kernels(_run(p), {"span": ["tail", "grain"]}) \
        == pytest.approx(2e-6 / 2)
    assert spans.span_kernels(_run(p), {"span": "mc"}) is None


def test_span_kernels_reads_nothing_without_spans():
    p = _profile()
    for gone in ("spans", "launches"):
        q = dict(p)
        del q[gone]
        assert spans.span_kernels(_run(q), {"span": "lr"}) is None
    assert spans.span_kernels(_run(None), {"span": "lr"}) is None


def test_per_span_kernel_times_sum_to_the_kernel_time():
    p = _profile()
    by = spans.kernels_by_span(p)
    assert by == pytest.approx({"intra": 14e-9, "lr": 8e-9, "tail": 2e-9,
                                "wait": 1e-9, spans.OUTSIDE: 1e-9})
    kernels = [e for e in p["device_events"] if "Memcpy" not in e[0]]
    assert sum(by.values()) == pytest.approx(
        harness.readers.busy_ns(p, kernels) * 1e-9)


def test_flatten_prefers_the_decode_thread_then_the_caller():
    flat = spans.flatten(_profile())
    assert flat == [("decode_next", 0, 10), ("wait", 10, 20),
                    ("decode", 20, 25), ("intra", 25, 40), ("lr", 40, 50),
                    ("intra", 50, 60), ("tail", 60, 70),
                    ("download", 70, 75), ("tail", 75, 78),
                    ("decode", 78, 80), ("wait", 80, 90),
                    ("decode_next", 90, 100)]
    assert all(a[2] <= b[1] for a, b in zip(flat, flat[1:]))


def test_idle_time_goes_to_the_flattened_span():
    p = _profile()
    p["window"] = (0, 110)
    idle = spans.idle_by_span(p)
    # busy: 30-40, 45-50, 52-55, 60-64, 70-75, 80-81, 90-91
    assert idle == pytest.approx({
        "decode_next": 10e-9 + 9e-9, "wait": 10e-9 + 9e-9,
        "decode": 5e-9 + 2e-9, "intra": 5e-9 + 2e-9 + 1e-9 + 4e-9,
        "lr": 5e-9, "tail": 6e-9 + 3e-9, spans.OUTSIDE: 10e-9})
    assert sum(idle.values()) == pytest.approx(
        (110 - 10 - 5 - 3 - 4 - 5 - 1 - 1) * 1e-9)


class _Event:
    def __init__(self, name, device, start, corr, thread=0, dur=1):
        self._v = (name, device, start, corr, thread, dur)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_resource_id(self):
        return self._v[4]

    def duration_ns(self):
        return self._v[5]


def test_capture_links_each_device_event_to_its_runtime_call():
    """The profiler names the thread that started it by its OS id and
    another by pthread_self() cut to a signed 32-bit int."""
    ident = 140177253070528
    cut = (ident & 0xFFFFFFFF) - (1 << 32)
    events = [_Event("aten::add", "CPU", 5, 7, thread=118),
              _Event("cudaLaunchKernel", "CPU", 6, 17, thread=118),
              _Event("cudaLaunchKernel", "CPU", 8, 71, thread=cut),
              _Event("cudaMemcpyAsync", "CPU", 9, 72, thread=cut),
              _Event("k", "CUDA", 10, 17), _Event("k2", "CUDA", 12, 71),
              _Event("Memcpy HtoD", "CUDA", 13, 72),
              _Event("k3", "CUDA", 14, 7)]
    device = events[4:]
    sp = SimpleNamespace(id=1, name="lr", frame=3, parent=None, thread=131,
                         start_ns=2, end_ns=20, attrs={"h2d_bytes": 4})
    got = spans.capture(events, device, [sp], {118: 1, 131: ident}, 100)
    assert got["launches"] == [(118, 6), (131, 8), (131, 9), None]
    assert got["spans"] == [_span(1, "lr", 131, 102, 120, h2d_bytes=4)
                            | {"frame": 3}]


def test_a_small_stream_under_the_tracer_flattens_and_attributes():
    """The port's spans of a played stream (on the CPU: no device
    events) flatten to a sequence that does not overlap, in which the
    decode thread's stages show."""
    from easyav1_tpu_torch import trace

    import easyav1_tpu_torch as port
    av = port.EasyAV1(str(REPO / "tests/data/smoke/inter_modes_96x96.webm"),
                      device="cpu")
    try:
        player = harness.Player(av, 8)
        trace.start()
        try:
            for _ in range(8):
                player.step()
        finally:
            got = trace.stop()
    finally:
        av.close()
    p = spans.capture([], [], got, trace.thread_ids(), 0)
    caller = threading.get_native_id()
    assert {s["thread"] for s in p["spans"]} - {caller}
    flat = spans.flatten(p)
    assert all(a[2] <= b[1] for a, b in zip(flat, flat[1:]))
    names = {n for n, _, _ in flat}
    assert {"entropy", "plan", "mc", "lf_cdef", "tail", "decode_next"} \
        <= names
    assert spans._thread_order(p["spans"])[-1] == caller


def test_clock_offset_centres_the_mark_between_the_readings():
    """The last mark ran 1000 to 1010 on the profiler's clock, between
    the readings 50 and 70 of perf_counter: they map to 995 and 1015."""
    events = [_Event("mark", "CPU", 400, 3, dur=90),
              _Event("other", "CPU", 0, 1),
              _Event("mark", "CPU", 1000, 2, dur=10)]
    off = spans.clock_offset(events, "mark", 50, 70)
    assert (50 + off, 70 + off) == (995, 1015)
