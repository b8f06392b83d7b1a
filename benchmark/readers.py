"""The metrics' arithmetic: what a run read, reduced to numbers.

A metric's file, `metrics/<name>.json`, names one of the readers of
`READERS` under "reader" and gives its parameters; `metrics/<name>.py`
instead defines `read(run, spec)` itself.  A reader returns a number, or
None when the run holds nothing for it to read (the harness then leaves
the metric out of the result).  `run` is the harness's `Readings`.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# The H100 SXM's published HBM3 rate (NVIDIA's data sheet), at the full
# power limit of 700 W.
HBM_BYTES_PER_S = 3.35e12
# entries of each list of the traced run's breakdown
TOP = 10

# ---------------------------------------------------------------- window


def fps(run, spec) -> Optional[float]:
    """Frames delivered in the window over the window's seconds."""
    return run.n_frames / run.window_s if run.window_s > 0 else None


def frame_ms_percentile(run, spec) -> Optional[float]:
    """A percentile (numpy's linear one) of every window frame's time, in
    ms: from its `decode_next` call until its planes are on the host."""
    if not run.frame_s:
        return None
    return float(np.percentile(np.asarray(run.frame_s) * 1e3, spec["q"]))


def cpu_ms_per_frame(run, spec) -> Optional[float]:
    """The process's CPU time in the window (every thread, user and
    system) over the frames delivered, in ms."""
    return run.cpu_s * 1e3 / run.n_frames if run.n_frames else None


def setup_s(run, spec) -> float:
    """From the process's start until the window may begin."""
    return run.setup_s

# ---------------------------------------------------------------- device


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The disjoint, sorted union of half-open [start, end) intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clipped(prof, events) -> List[Tuple[int, int]]:
    """The events' [start, end) intervals, cut to the profiled window
    where it is known."""
    if prof["window"] is None:
        return [(s, s + d) for _, s, d in events]
    w0, w1 = prof["window"]
    return [(max(s, w0), min(s + d, w1)) for _, s, d in events]


def busy_ns(prof, events=None) -> int:
    """ns in which any of `events` (every device operation by default)
    ran, inside the profiled window."""
    events = prof["device_events"] if events is None else events
    return sum(b - a for a, b in union(_clipped(prof, events)))


def device_ms(run, spec) -> Optional[float]:
    """ms a frame in which the device ran an operation, over the profiled
    frames: every operation, or only those whose profiler names contain
    one of spec["names"], less those whose names contain one of
    spec["skip"].  None where none of them ran."""
    p = run.profile
    if p is None or not p["frame_indices"]:
        return None
    names, skip = spec.get("names"), spec.get("skip", ())
    events = [e for e in p["device_events"]
              if (names is None or any(n in e[0] for n in names))
              and not any(n in e[0] for n in skip)]
    if not events:
        return None
    return busy_ns(p, events) * 1e-6 / len(p["frame_indices"])


def idle_gaps(prof) -> List[List]:
    """The device's idle time in the profiled window, summed by the pipe
    stage that was open on the host through it (the stage's host span,
    without device synchronisation); idle time outside every stage is
    "outside the pipe" (API, demuxing, headers, waits).  The TOP largest,
    in seconds."""
    w0, w1 = prof["window"]
    busy = union(_clipped(prof, prof["device_events"]))
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    spans = sorted(prof["host_spans"], key=lambda s: s[1])
    starts = [s[1] for s in spans]
    by = defaultdict(int)
    for a, b in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(spans) and spans[i][1] < b:
            name, s, e = spans[i]
            o = min(b, e) - max(a, s)
            if o > 0:
                by[name] += o
                covered += o
            i += 1
        by["outside the pipe"] += (b - a) - covered
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, v * 1e-9] for k, v in ranked if v > 0]


def device_ops(prof) -> List[List]:
    """The TOP device operations that took most time in the window, by
    name, in seconds."""
    by = defaultdict(int)
    for name, _, d in prof["device_events"]:
        by[name[:200]] += d
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, v * 1e-9] for k, v in ranked]


def kernel_ns(prof, kernels: Sequence[str]) -> int:
    """Device ns of the kernels whose profiler names contain one of
    `kernels`."""
    return sum(d for name, _, d in prof["device_events"]
               if any(k in name for k in kernels))

# ---------------------------------------------------------------- bytes


def plane_samples(cfg) -> List[int]:
    """Samples of each plane of the configuration's frames."""
    w, h = cfg["width"], cfg["height"]
    sx, sy = cfg["subsampling"]
    cw, ch = (w + (1 << sx) - 1) >> sx, (h + (1 << sy) - 1) >> sy
    return [w * h, cw * ch, cw * ch]


def lf_cdef_bytes(cfg, frame: dict) -> int:
    """The least bytes the deblocking and CDEF of one shown frame move,
    whatever their design, over the frames decoded for it: each plane a
    header deblocks read once and written once, luma read once by the
    direction search when any plane takes CDEF, and each plane that takes
    CDEF read once and written once; at the stream's sample size (1 byte
    at 8 bits, 2 above).  No working planes, maps or tables."""
    n = plane_samples(cfg)
    sb = 1 if cfg["bit_depth"] == 8 else 2
    total = 0
    for d in frame["decoded"]:
        total += 2 * sum(n[p] for p in d["deblock"])
        if d["cdef"]:
            total += n[0] + 2 * sum(n[p] for p in d["cdef"])
    return sb * total


BYTE_FLOORS = {"lf_cdef": lf_cdef_bytes}


def byte_roofline(run, spec) -> Optional[float]:
    """% of the byte roofline of the kernels spec["kernels"] over the
    profiled frames: the least time (spec["bytes"]'s floor over
    `HBM_BYTES_PER_S`) over their device time.  None where none of them
    ran or their frames need no bytes."""
    p = run.profile
    if p is None:
        return None
    t = kernel_ns(p, spec["kernels"])
    floor = BYTE_FLOORS[spec["bytes"]]
    need = sum(floor(run.config, run.config["frames"][i])
               for i in p["frame_indices"])
    if t <= 0 or need <= 0:
        return None
    return 100.0 * (need / HBM_BYTES_PER_S) / (t * 1e-9)


READERS = {f.__name__: f for f in (
    fps, frame_ms_percentile, cpu_ms_per_frame, setup_s, device_ms,
    byte_roofline)}


def breakdown(prof) -> Dict[str, List]:
    return {"device_ops": device_ops(prof), "idle_gaps": idle_gaps(prof)}
