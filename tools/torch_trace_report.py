"""A cell of the benchmark played under the port's tracer, on the card:
kernel time by the span that launched it, the device's idle time by the
span the host was in, the span readers' per-layer metrics, the counters,
the pipe's frames by kind, tiles and entropy threads, and what the tracer
costs.

    python3 tools/torch_trace_report.py --workload <cell> --seed <n> \
        [--seconds 10] [--rounds 6] [--out report.json]

Set-up as `benchmark/harness.py` makes it (the session, the warm-up
pass, `seed % frames` more frames), then one window of whole passes under
torch.profiler (CPU and CUDA) with `easyav1_tpu_torch.trace` on, every
delivered frame hashed and held to libdav1d's digests, read through
`benchmark/spans.py`.  Then `--rounds` pairs of whole passes without the
profiler, tracing on and off in turn (the first of a pair alternating):
process CPU time a frame and spans a frame in each, and the cost of one
span site on and off in a loop.  Prints one JSON line, and writes it,
indented, to --out if given.
"""

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

import harness  # noqa: E402
import reference  # noqa: E402
import spans  # noqa: E402

WARM_MARK = "benchmark.clock.warm"
# the per-layer metrics that read the port's spans
SPAN_METRICS = ("lr.kernel_ms", "lr.launches", "strip_inter.kernel_ms",
                "mc.kernel_ms", "tail.kernel_ms")


def traced_window(player, seconds, window):
    """The traced run's profile (harness._profiled's traced branch) with
    the port's spans, the launches and the counters' deltas."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from easyav1_tpu_torch import trace
    first_frame = len(window.frames)
    c0 = trace.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the harness's mark, as it takes it (the first of the window),
        # then a warm one between two readings: a name's first call is
        # the slow one
        first = time.perf_counter_ns()
        with record_function(harness.CLOCK_MARK):
            pass
        with record_function(WARM_MARK):
            pass
        before = time.perf_counter_ns()
        with record_function(WARM_MARK):
            pass
        after = time.perf_counter_ns()
        trace.start()
        try:
            start, end = player.play(seconds, window)
            torch.cuda.synchronize()
        finally:
            got = trace.stop()
    c1 = trace.counters()
    events = prof.profiler.kineto_results.events()
    device = [e for e in events if str(e.device_type()).endswith("CUDA")
              and e.duration_ns() > 0]
    off = spans.clock_offset(events, WARM_MARK, before, after)
    mark = next(e for e in events if e.name() == harness.CLOCK_MARK)
    # how late the harness's offset puts the host's clock
    out = {"clock": {"readings_ns": after - before,
                     "first_mark_late_ns": mark.start_ns() - first - off},
           "window": (round(start * 1e9) + off, round(end * 1e9) + off),
           "device_events": [(e.name(), e.start_ns(), e.duration_ns())
                             for e in device],
           "frame_indices": [f["index"] for f in window.frames[first_frame:]],
           "counters": {k: c1[k] - c0[k] for k in c1}}
    out |= spans.capture(events, device, got, trace.thread_ids(), off)
    out["host_spans"] = spans.flatten(out)
    return out, (start, end)


def on_cost(player, n, rounds):
    """Pairs of whole passes, tracing on and off in turn: CPU us a frame
    and spans a frame of each, and the ns of one span site."""
    from easyav1_tpu_torch import trace
    cpu = {True: [], False: []}
    wall = {True: [], False: []}
    per_frame = []
    for k in range(rounds):
        for on in ((True, False) if k % 2 == 0 else (False, True)):
            if on:
                trace.start()
            c0, w0 = time.process_time(), time.perf_counter()
            for _ in range(n):
                player.step()
            cpu[on].append((time.process_time() - c0) * 1e6 / n)
            wall[on].append((time.perf_counter() - w0) * 1e6 / n)
            if on:
                per_frame.append(len(trace.stop()) / n)

    def site_ns(on, reps=10_000):
        if on:
            trace.start()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            with trace.span("x"):
                pass
        t = (time.perf_counter_ns() - t0) / reps
        if on:
            trace.stop()
        return t

    def in_situ_ns():
        """One more pass on, the time inside the tracer's functions
        summed (the outermost call of each timed, the timing's own cost
        in: an upper bound), ns a frame."""
        spent, depth = [0], [0]

        def timed(fn):
            def call(*args, **kwargs):
                depth[0] += 1
                t0 = time.perf_counter_ns()
                try:
                    return fn(*args, **kwargs)
                finally:
                    depth[0] -= 1
                    if depth[0] == 0:
                        spent[0] += time.perf_counter_ns() - t0
            return call

        names = ("_open", "_close", "span", "current", "tag", "add")
        saved = {k: getattr(trace, k) for k in names}
        marks = (trace.Stages.__init__, trace.Stages.mark,
                 trace.Stages.__exit__)
        try:
            for k in names:
                setattr(trace, k, timed(saved[k]))
            trace.Stages.__init__, trace.Stages.mark, \
                trace.Stages.__exit__ = (timed(f) for f in marks)
            trace.start()
            for _ in range(n):
                player.step()
            trace.stop()
        finally:
            for k in names:
                setattr(trace, k, saved[k])
            trace.Stages.__init__, trace.Stages.mark, \
                trace.Stages.__exit__ = marks
        return spent[0] / n

    diffs = [a - b for a, b in zip(cpu[True], cpu[False])]
    return {"cpu_us_per_frame_on": cpu[True],
            "cpu_us_per_frame_off": cpu[False],
            "median_on": statistics.median(cpu[True]),
            "median_off": statistics.median(cpu[False]),
            "median_paired_diff": statistics.median(diffs),
            "wall_us_per_frame_on": wall[True],
            "wall_us_per_frame_off": wall[False],
            "spans_per_frame": statistics.median(per_frame),
            "tracer_ns_per_frame_in_situ": in_situ_ns(),
            "span_site_ns_on": site_ns(True),
            "span_site_ns_off": site_ns(False)}


def report(workload, seed, seconds, rounds):
    import torch

    import easyav1_tpu_torch as port
    cell = harness.find_cell(harness.load_spec(), workload)
    n = len(cell.config["frames"])
    window = harness.Window()
    window.start()
    av = port.EasyAV1(str(ROOT / cell.config["stream"]), device="cuda",
                      **cell.traffic.get("session", {}))
    try:
        player = harness.Player(av, n)
        for _ in range(cell.traffic["warmup_passes"] * n + 1 + seed % n):
            player.step()
        prof, (start, end) = traced_window(player, seconds, window)
        window.close()
        checks = reference.compare(window.frames, window.digests,
                                   cell.config["frames"])
        # the profiler's results, young, would make every collection of
        # the young generations long, the more so the more a pass
        # allocates: age them first
        gc.collect()
        # whole passes again: the player is at the window's first frame
        cost = on_cost(player, n, rounds)
    finally:
        av.close()
    frames = len(prof["frame_indices"])
    run = harness.Readings(config=cell.config, n_frames=frames,
                           window_s=end - start, profile=prof)
    metrics = {}
    for m in (["kernel_ms_per_frame"]
              + [m["name"] for m in cell.metrics[True]]
              + list(SPAN_METRICS)):
        metrics[m] = harness.metric_reader(m)(run)
    total = metrics["kernel_ms_per_frame"] * frames * 1e-3
    by_span = spans.kernels_by_span(prof)
    idle = spans.idle_by_span(prof)
    window_s = (prof["window"][1] - prof["window"][0]) * 1e-9
    # each kernel's spans, by the kernel's name: the launch attribution
    # put to the test (a kernel launched in one stage only, such as the
    # strip kernel in "intra", has to land there alone)
    owner = spans.attribute(prof)
    span_name = {s["id"]: s["name"] for s in prof["spans"]}
    by_kernel = {}
    for (name, _, d), sid in zip(prof["device_events"], owner):
        k = by_kernel.setdefault(name[:60], {})
        o = span_name.get(sid, spans.OUTSIDE)
        k[o] = k.get(o, 0) + d * 1e-9
    names = {}
    for s in prof["spans"]:
        names[s["name"]] = names.get(s["name"], 0) + 1
    copied = {k: sum(s["attrs"].get(k, 0) for s in prof["spans"]) / frames
              for k in ("h2d_bytes", "d2h_bytes")}
    # the frames the pipe made, by kind, tiles and entropy threads
    shapes = {}
    for s in prof["spans"]:
        if s["name"] == "frame":
            a = s["attrs"]
            key = (f"{a.get('kind')}, {a.get('tiles')} tiles, "
                   f"{a.get('workers')} workers")
            shapes[key] = shapes.get(key, 0) + 1
    return {
        "workload": workload, "seed": seed,
        "device": torch.cuda.get_device_name(),
        "correct": checks.pop("failed_frames") == 0
        and all(v == 0 for v in checks.values()),
        "frames": frames, "window_s": window_s,
        "metrics": metrics,
        "kernel_s": total,
        "kernel_s_by_span": dict(sorted(by_span.items(),
                                        key=lambda kv: -kv[1])),
        "kernel_s_sum_of_spans": sum(by_span.values()),
        "kernel_s_by_name_and_span": by_kernel,
        "clock": prof["clock"],
        "kernel_share_outside": by_span.get(spans.OUTSIDE, 0.0) / total,
        "idle_s": sum(idle.values()),
        "idle_s_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_share_outside": idle.get(spans.OUTSIDE, 0.0)
        / sum(idle.values()),
        "launches_linked": sum(x is not None for x in prof["launches"])
        / len(prof["launches"]),
        "spans_per_frame_traced": len(prof["spans"]) / frames,
        "span_names_per_frame": {k: v / frames for k, v in names.items()},
        "counters_per_frame": {k: v / frames
                               for k, v in prof["counters"].items()},
        "bytes_per_frame": copied,
        "frame_spans": shapes,
        "on_cost": cost}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    out = report(a.workload, a.seed, a.seconds, a.rounds)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
