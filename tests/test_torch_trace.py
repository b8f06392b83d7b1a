"""The port's tracer (`easyav1_tpu_torch.trace`) on the CPU.

- tracing off, the default, records nothing and makes every site a no-op;
- tracing on, the 8-frame smoke stream through the public API: one
  "frame" span a covered frame on the decode thread, with the stages as
  children, each child inside its parent on its thread, and the caller's
  "decode_next" and "wait" sharing the packet's number with the decode
  thread's "decode";
- the bytes the pipe copies, on the spans that copy them;
- a declined frame carries its reason;
- film grain: its "fg_templates" span inside "grain", made or cached;
- `trace.counters()` against `pipe.stats`, each kernel declaration's
  launches (through a fake library: a launch that succeeds counts, one
  that fails raises and does not), the strip kernel's units and levels,
  and the film grain template sets made.
"""

import contextlib
import ctypes
import os
import threading
from collections import defaultdict
from types import SimpleNamespace

import pytest
import torch

import easyav1_tpu_torch
from easyav1_tpu_torch import _build, trace
from easyav1_tpu_torch.native import pipe
from easyav1_tpu_torch.unit_programs import random_fg_case
from easyav1_tpu_torch.video.av1.backend import AV1Backend
from easyav1_tpu_torch.video.av1.recon import (cdef_torch, fg_torch,
                                               inter_mc, intra_strip,
                                               itx_torch, lf_torch,
                                               lr_torch, resident)

SMOKE = os.path.join(os.path.dirname(__file__), "data", "smoke")
# compound, warps and OBMC: 1 key and 7 inter frames
INTER_MODES = os.path.join(SMOKE, "inter_modes_96x96.webm")
# two key frames, each with film grain of its own seed
GRAIN = os.path.join(SMOKE, "fgreal_7cdd830f.webm")
KEY_STAGES = {"entropy", "prepare", "compose", "upload", "intra", "lf_cdef",
              "tail"}
INTER_STAGES = KEY_STAGES | {"plan", "mc"}


def _play(path, **session):
    """Every frame of a stream through the public API on the CPU, each
    frame's planes read: the number of frames."""
    av = easyav1_tpu_torch.EasyAV1(path, device="cpu", **session)
    n = 0
    try:
        for _ in range(256):
            if av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                av.get_video_frame().data[0]
                n += 1
    finally:
        av.close()
    return n


def _traced(path, **session):
    """(frames, spans) of `_play` under the tracer."""
    trace.start()
    try:
        n = _play(path, **session)
    finally:
        spans = trace.stop()
    return n, spans


@pytest.fixture(scope="module")
def smoke_trace():
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    n, spans = _traced(INTER_MODES)
    return n, spans, dict(easyav1_tpu_torch.stats)


def _children(spans):
    out = defaultdict(list)
    for sp in spans:
        out[sp.parent].append(sp)
    return out


def test_tracing_off_records_nothing():
    assert not trace._on
    with trace.span("decode_next") as sp:
        assert sp is None
        assert trace.current() is None
        trace.tag(frame=3, x=1)
        trace.add(h2d_bytes=5)
    with trace.Stages() as clock:
        clock.mark("entropy")
        clock.decline("planner")
    assert _play(INTER_MODES) == 8
    assert trace._spans == []
    trace.start()
    assert trace.stop() == []


def test_every_covered_frame_has_a_frame_span_with_its_stages(smoke_trace):
    n, spans, stats = smoke_trace
    frames = [sp for sp in spans if sp.name == "frame"]
    assert n == 8 and len(frames) == stats["frames"] == 8
    assert stats["fallbacks"] == 0
    decode_threads = {sp.thread for sp in spans if sp.name == "decode"}
    assert len(decode_threads) == 1
    assert decode_threads != {threading.get_native_id()}
    assert {sp.thread for sp in frames} == decode_threads
    kids = _children(spans)
    names = [{c.name for c in kids[f.id]} for f in frames]
    assert [f.attrs["kind"] for f in frames] == ["key"] + ["inter"] * 7
    assert names[0] == KEY_STAGES
    assert all(s == INTER_STAGES for s in names[1:])
    assert all("declined" not in f.attrs for f in frames)


def test_children_lie_inside_their_parents(smoke_trace):
    _, spans, _ = smoke_trace
    by_id = {sp.id: sp for sp in spans}
    assert all(sp.start_ns <= sp.end_ns for sp in spans)
    inside = 0
    for sp in spans:
        parent = by_id.get(sp.parent)
        if parent is None:
            continue
        # the decode thread's "decode" is caused by the caller's
        # "decode_next", which waits for it
        assert parent.thread == sp.thread or sp.name == "decode"
        assert parent.start_ns <= sp.start_ns <= sp.end_ns <= parent.end_ns
        inside += 1
    assert inside > 100


def test_caller_and_decode_thread_share_the_packet(smoke_trace):
    _, spans, _ = smoke_trace
    by_id = {sp.id: sp for sp in spans}
    decodes = [sp for sp in spans if sp.name == "decode"]
    assert len(decodes) == 8
    waits = {sp.frame for sp in spans if sp.name == "wait"}
    for d in decodes:
        cause = by_id[d.parent]
        assert cause.name == "decode_next"
        assert cause.frame == d.frame is not None
        assert d.frame in waits
        assert cause.thread == threading.get_native_id() != d.thread
    # every span under a decode serves its packet
    kids = _children(spans)
    todo = list(decodes)
    while todo:
        sp = todo.pop()
        for c in kids[sp.id]:
            assert c.frame == sp.frame
            todo.append(c)
    assert len({d.frame for d in decodes}) == 8


def test_copies_carry_their_bytes(smoke_trace):
    _, spans, _ = smoke_trace
    uploads = [sp for sp in spans if sp.name == "upload"]
    assert len(uploads) == 8
    assert all(sp.attrs["h2d_bytes"] > 0 for sp in uploads)
    downloads = [sp for sp in spans if sp.name == "download"]
    # 96x96 8-bit 4:2:0: 96 * 96 + 2 * 48 * 48 bytes a frame
    assert [sp.attrs["d2h_bytes"] for sp in downloads] == [13824] * 8
    by_id = {sp.id: sp for sp in spans}
    assert {by_id[sp.parent].name for sp in downloads} == {"tail"}


def test_the_tracer_keeps_the_stage_clock_name():
    """The pipe makes each frame's clock through `pipe._Stages`."""
    assert pipe._Stages is trace.Stages


def test_a_declined_frame_carries_its_reason():
    """The postfilter pipe hands superres frames to the C recon."""
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    n, spans = _traced(os.path.join(SMOKE, "superres_lr_88x64.webm"),
                       pipe="postfilter")
    frames = [sp for sp in spans if sp.name == "frame"]
    assert n == len(frames) == easyav1_tpu_torch.stats["fallbacks"] == 3
    assert all(f.attrs["declined"] == "superres" for f in frames)
    kids = _children(spans)
    assert all([c.name for c in kids[f.id]] == ["entropy", "recon"]
               for f in frames)


def test_counters_follow_pipe_stats():
    before = trace.counters()
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    _play(os.path.join(SMOKE, "superres_lr_88x64.webm"), pipe="postfilter")
    _play(INTER_MODES)
    after = trace.counters()
    assert after["pipe.frames"] - before["pipe.frames"] \
        == pipe.stats["frames"] == 11
    assert after["pipe.fallbacks"] - before["pipe.fallbacks"] \
        == pipe.stats["fallbacks"] == 3
    # the CPU runs the kernels' plain versions: no launch is counted
    assert {k: after[k] - before[k] for k in after
            if k.startswith("launches.")} == dict.fromkeys(
                (k for k in after if k.startswith("launches.")), 0)


# each hand kernel's declarations, by its name in the profiler
LAUNCHERS = {"intra_wavefront_kernel": (intra_strip._STRIP,),
             "mc_kernel": inter_mc._MC,
             "obmc_kernel": inter_mc._OBMC,
             "itx_kernel": (itx_torch._ITX,),
             "lf_frame_kernel": (lf_torch._LF,),
             "cdef_dirs_kernel": (cdef_torch._DIRS,),
             "cdef_filter_kernel": (cdef_torch._FILTER,),
             "lr_frame_kernel": (lr_torch._LR,),
             "fg_frame_kernel": (fg_torch._FG,),
             "frame_hash_kernel": (resident._HASH,)}


def test_grain_templates_have_a_span_inside_grain_and_a_counter():
    before = trace.counters()
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    n, spans = _traced(GRAIN)
    after = trace.counters()
    assert n == 2 and easyav1_tpu_torch.stats["fallbacks"] == 0
    by_id = {sp.id: sp for sp in spans}
    made = [sp for sp in spans if sp.name == "fg_templates"]
    assert [by_id[sp.parent].name for sp in made] == ["grain", "grain"]
    # the two frames' seeds differ: each makes its own templates
    assert [sp.attrs for sp in made] == [{"cached": False}] * 2
    assert after["fg.templates"] - before["fg.templates"] == 2
    # the CPU runs the plain version: no launch
    assert after["launches.fg_frame_kernel"] == \
        before["launches.fg_frame_kernel"]


def test_grain_templates_of_the_same_parameters_are_cached():
    fg, seq, planes = random_fg_case(3, 40, 24)
    be = SimpleNamespace(_dev_fg=None, device="cpu")
    tin = [torch.from_numpy(p) for p in planes]
    before = trace.counters()
    trace.start()
    try:
        first = AV1Backend._film_grain_device(be, fg, seq, tin)
        again = AV1Backend._film_grain_device(be, fg, seq, tin)
    finally:
        spans = trace.stop()
    assert trace.counters()["fg.templates"] == before["fg.templates"] + 1
    assert [sp.attrs["cached"] for sp in spans
            if sp.name == "fg_templates"] == [False, True]
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("kernel", sorted(LAUNCHERS))
def test_counters_read_each_launcher(kernel, monkeypatch):
    """Three launches of the kernel's declarations (all its
    instantiations) on a fake library count 3 under its name and nothing
    else; a fourth, which fails, raises and counts nothing.  Each launch
    passes its arguments, then the device's current stream."""
    calls = []

    def fn(*args):
        calls.append(args)
        return 0 if len(calls) <= 3 else 700    # cudaErrorIllegalAddress

    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=42))
    decls = LAUNCHERS[kernel]
    for d in decls:
        monkeypatch.setattr(d, "_fn", None)
        monkeypatch.setitem(_build._libs, d.lib, SimpleNamespace(
            **{x.symbol: fn for x in decls}))
    before = trace.counters()
    for k in range(3):
        decls[k % len(decls)].launch(torch.device("cuda", 0), k, "arg")
    with pytest.raises(RuntimeError,
                       match=f"^{decls[0].symbol}: cudaError 700$"):
        decls[0].launch(torch.device("cuda", 0), 3, "arg")
    after = trace.counters()
    assert calls == [(k, "arg", 42) for k in range(4)]
    assert fn.restype is ctypes.c_int and fn.argtypes[-1] is ctypes.c_void_p
    assert {k for k in after if k.startswith("launches.")} == {
        f"launches.{k}" for k in LAUNCHERS}
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {f"launches.{kernel}": 3}


@pytest.mark.parametrize("name", ["units", "levels"])
def test_counters_read_the_strip_steps(name):
    """`strip.units` and `strip.levels` are what the strip kernel's
    wrapper counts at each launch (none on the CPU, whose plain version
    runs in decode order)."""
    before = trace.counters()
    _play(INTER_MODES)
    trace.count(f"strip.{name}", 5)
    after = trace.counters()
    assert {k: after[k] - before[k] for k in ("strip.units", "strip.levels")
            } == {"strip.units": 5 * (name == "units"),
                  "strip.levels": 5 * (name == "levels")}


def test_spans_nest_and_take_the_parents_frame():
    trace.start()
    try:
        with trace.span("decode_next") as outer:
            with trace.span("demux") as inner:
                trace.add(h2d_bytes=2)
                trace.add(h2d_bytes=3)
            trace.tag(frame=7, key="x")
            with trace.Stages() as clock:
                clock.tag(kind="inter")
                clock.mark("entropy")
                with trace.span("download"):
                    pass
                clock.mark("tail")
    finally:
        spans = trace.stop()
    names = [sp.name for sp in spans]
    # in the order they opened: a stage opens at the mark before it
    assert names == ["decode_next", "demux", "frame", "entropy", "tail",
                     "download"]
    by = {sp.name: sp for sp in spans}
    assert outer is by["decode_next"] and inner is by["demux"]
    assert by["demux"].attrs == {"h2d_bytes": 5}
    assert by["decode_next"].attrs == {"key": "x"}
    assert all(sp.frame == 7 for sp in spans)
    assert by["frame"].parent == outer.id
    assert by["entropy"].parent == by["tail"].parent == by["frame"].id
    assert by["download"].parent == by["tail"].id
    assert by["frame"].attrs == {"kind": "inter"}
    assert by["entropy"].end_ns <= by["tail"].start_ns
    assert set(trace.thread_ids()) >= {threading.get_native_id()}
