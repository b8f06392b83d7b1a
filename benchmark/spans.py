"""The port's spans in a traced run: which span launched each kernel, and
which span the host was in while the device idled.

The port keeps its spans in memory between `easyav1_tpu_torch.trace.
start()` and `stop()` (see that module).  `capture` puts them, with the
host call that launched each device operation, into a traced run's
profile beside its device operations, all on the profiler's clock:

- profile["spans"]: one dict a span, {"id", "name", "frame", "parent",
  "thread", "start", "end", "attrs"}; "thread" is the OS thread id;
- profile["launches"]: for each of profile["device_events"], in the same
  order, (OS thread id, time) of the host call that launched it, or None
  where the profiler linked none;
- profile["host_spans"]: `flatten`'s sequence, which `readers.idle_gaps`
  reads.

A device operation belongs to the innermost span open on the thread that
launched it, at the launch call (`attribute`).  Attribution never reads
the device's time: launches are asynchronous.  `span_kernels` is the
reader of the per-layer metrics built on it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import readers

OUTSIDE = "outside every span"
# what the kernel metrics leave out, as `kernel_ms_per_frame` does
COPIES = ("Memcpy", "Memset")


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def capture(events, device: Sequence, spans, thread_ids: Dict[int, int],
            offset: int) -> Dict[str, list]:
    """profile["spans"] and profile["launches"] from torch.profiler's
    events (`kineto_results.events()`), those of them that make the
    profile's device events (`device`, in its order), the port's spans
    (`trace.stop()`) and threads (`trace.thread_ids()`), and the offset
    from `time.perf_counter_ns()` to the profiler's clock.

    The profiler links a device operation to its CUDA runtime call by
    their correlation id.  It names the call's thread by its OS id on a
    thread where it records CPU operations (the one that started it),
    and elsewhere by pthread_self() cut to a signed 32-bit int; both are
    mapped to the OS id."""
    names = {}
    for native, ident in thread_ids.items():
        names[native] = names[_int32(ident)] = native
    wanted = {e.correlation_id() for e in device}
    calls = {}
    for e in events:
        if (str(e.device_type()).endswith("CPU")
                and e.name().startswith("cu")
                and e.correlation_id() in wanted):
            calls[e.correlation_id()] = (
                names.get(e.device_resource_id(), e.device_resource_id()),
                e.start_ns())
    return {
        "spans": [{"id": s.id, "name": s.name, "frame": s.frame,
                   "parent": s.parent, "thread": s.thread,
                   "start": s.start_ns + offset, "end": s.end_ns + offset,
                   "attrs": dict(s.attrs)} for s in spans],
        "launches": [calls.get(e.correlation_id()) for e in device]}


def clock_offset(events, name: str, before: int, after: int) -> int:
    """The offset from `time.perf_counter_ns()` to the profiler's clock,
    from the last of the profiler's events `name` (a `record_function`
    mark) and the perf_counter readings just before and just after it:
    the middle of the offsets that put the event inside those readings.
    Call the mark once before: a name's first call costs more than the
    readings apart."""
    e = [e for e in events if e.name() == name][-1]
    lo = before - e.start_ns()
    hi = after - (e.start_ns() + e.duration_ns())
    return -((lo + hi) // 2)


def _innermost(spans: List[dict]) -> Dict[int, Tuple[list, list]]:
    """Per thread, the innermost open span through time: (starts, ids) of
    consecutive segments, an id None where no span is open."""
    by = defaultdict(list)
    for s in spans:
        by[s["thread"]].append(s)
    out = {}
    for thread, ss in by.items():
        # opening and closing events; at one time, closings first, then
        # openings (outer before inner)
        ev = []
        for s in ss:
            ev.append((s["start"], 1, s["start"] - s["end"], s["id"]))
            ev.append((s["end"], 0, 0, s["id"]))
        ev.sort()
        starts, ids, open_ = [], [], []
        for t, opening, _, sid in ev:
            if opening:
                open_.append(sid)
            elif sid in open_:
                open_.remove(sid)
            top = open_[-1] if open_ else None
            if starts and starts[-1] == t:
                ids[-1] = top
            elif not ids or ids[-1] != top:
                starts.append(t)
                ids.append(top)
        out[thread] = (starts, ids)
    return out


def _at(timeline: Tuple[list, list], t: int) -> Optional[int]:
    starts, ids = timeline
    i = bisect.bisect_right(starts, t) - 1
    return ids[i] if i >= 0 else None


def attribute(prof) -> Optional[List[Optional[int]]]:
    """For each device event, the id of the innermost span open on the
    thread that launched it, at the launch; None where none was open or
    no launch is linked.  None where the run kept no spans."""
    if not prof.get("spans") or prof.get("launches") is None:
        return None
    tl = _innermost(prof["spans"])
    out = []
    for launch in prof["launches"]:
        if launch is None or launch[0] not in tl:
            out.append(None)
        else:
            out.append(_at(tl[launch[0]], launch[1]))
    return out


def _thread_order(spans: List[dict]) -> List[int]:
    """The threads, those that decode packets first (a "decode" span; a
    caller that seeks decodes frames too, but no packet), then the
    others, each group by its first span."""
    first, decodes = {}, set()
    for s in spans:
        first.setdefault(s["thread"], s["start"])
        if s["name"] == "decode":
            decodes.add(s["thread"])
    return sorted(first, key=lambda t: (t not in decodes, first[t]))


def flatten(prof) -> List[Tuple[str, int, int]]:
    """The spans as one sequence that does not overlap, (name, start,
    end), sorted: each instant goes to the innermost span open on the
    decode thread, else to the innermost open on another thread (the
    caller's), else to no span.  So a gap in which the caller waits and
    no decode span is open goes to "wait": the hand-off."""
    spans = prof.get("spans") or []
    if not spans:
        return []
    names = {s["id"]: s["name"] for s in spans}
    tl = _innermost(spans)
    order = _thread_order(spans)
    cuts = sorted({t for th in order for t in tl[th][0]})
    out: List[List] = []
    for a, b in zip(cuts, cuts[1:]):
        sid = None
        for th in order:
            sid = _at(tl[th], a)
            if sid is not None:
                break
        if sid is None:
            continue
        name = names[sid]
        if out and out[-1][0] == name and out[-1][2] == a:
            out[-1][2] = b
        else:
            out.append([name, a, b])
    return [tuple(x) for x in out]


def _ancestors(by_id: Dict[int, dict], sid: Optional[int]) -> List[dict]:
    out = []
    while sid is not None and sid in by_id:
        out.append(by_id[sid])
        sid = by_id[sid]["parent"]
    return out


def _kernels(prof, skip=COPIES) -> List[int]:
    return [i for i, (name, _, _) in enumerate(prof["device_events"])
            if not any(k in name for k in skip)]


def span_kernels(run, spec) -> Optional[float]:
    """ms a frame of the device time of the kernels launched inside a
    span named in spec["span"] (a name or a list), over the profiled
    frames: the union of their intervals, as `readers.device_ms` reads
    it.  spec["frames"], "key" or "inter": only kernels of frames of that
    kind (the "kind" of the "frame" span they were launched under).
    spec["count"]: launches a frame in place of ms.  Copies and fills
    are left out.  None where the run kept no spans or no such kernel
    ran."""
    p = run.profile
    if p is None or not p["frame_indices"]:
        return None
    owner = attribute(p)
    if owner is None:
        return None
    want = spec["span"]
    want = {want} if isinstance(want, str) else set(want)
    by_id = {s["id"]: s for s in p["spans"]}
    picked = []
    for i in _kernels(p):
        chain = _ancestors(by_id, owner[i])
        if not any(s["name"] in want for s in chain):
            continue
        if "frames" in spec:
            kinds = [s["attrs"].get("kind") for s in chain
                     if s["name"] == "frame"]
            if kinds[:1] != [spec["frames"]]:
                continue
        picked.append(p["device_events"][i])
    if not picked:
        return None
    n = len(p["frame_indices"])
    if spec.get("count"):
        return len(picked) / n
    return readers.busy_ns(p, picked) * 1e-6 / n


def kernels_by_span(prof) -> Dict[str, float]:
    """Device seconds of the window's kernels by the name of the
    innermost span that launched them (OUTSIDE where none), each the
    union of its kernels' intervals."""
    owner = attribute(prof) or [None] * len(prof["device_events"])
    names = {s["id"]: s["name"] for s in prof.get("spans") or []}
    by = defaultdict(list)
    for i in _kernels(prof):
        by[names.get(owner[i], OUTSIDE)].append(prof["device_events"][i])
    return {k: readers.busy_ns(prof, v) * 1e-9 for k, v in by.items()}


def idle_by_span(prof) -> Dict[str, float]:
    """The device's idle seconds in the window by `flatten`'s span open
    on the host through them (OUTSIDE where none)."""
    w0, w1 = prof["window"]
    gaps, t = [], w0
    for a, b in readers.union(readers._clipped(prof,
                                               prof["device_events"])):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    flat = flatten(prof)
    starts = [s[1] for s in flat]
    by = defaultdict(int)
    for a, b in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(flat) and flat[i][1] < b:
            name, s, e = flat[i]
            o = min(b, e) - max(a, s)
            if o > 0:
                by[name] += o
                covered += o
            i += 1
        by[OUTSIDE] += (b - a) - covered
    return {k: v * 1e-9 for k, v in by.items() if v > 0}
