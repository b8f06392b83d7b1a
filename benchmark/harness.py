"""The benchmark of easyav1_tpu_torch: one cell, run once.

A cell (`BENCHMARK.json`'s "workloads") is a configuration, a stream
pinned by its sha256 with libdav1d's frame table (`configs/<name>.json`),
played under a traffic mix (`traffic/<mix>.json`, parameters of the one
player below, or `traffic/<mix>.py` with its own `play_cell`).  Each
metric is read by the file `metrics/<name>.json` (a reader of
`readers.READERS` and its parameters) or `metrics/<name>.py` (its own
`read`).  Adding a configuration, a mix, a cell or a metric is adding
files and entries: nothing here names one.

The player is what a looping video player does with the public API: one
session, `decode_next()` then `get_video_frame()`, the planes indexed on
the host, and `seek_to_timestamp(0)` when the stream ends.  Set-up opens
the session and warms up one pass and the seek; then `seed % frames`
more frames, outside set-up's clock, so that the seed sets the frame the
window starts at.  The window then runs whole passes of the stream until
`seconds` have passed: every seed times the same frames, in another
order.  The player hands each frame's planes to a thread of its own
(`Window`) once they are read, and drops them, as a player does; that
thread hashes every delivered frame, on another core, and its CPU time
is left out of the window's.  Once the window has closed and the session
is freed, every frame's digest and timestamp is compared with libdav1d's
(`reference.compare`).

The window runs under torch.profiler (`_profiled`): untraced, the
device's activity alone, which the end-to-end metric of kernel time a
frame reads; traced, the host's too, for the per-layer metrics and the
breakdown.  The host's rate and CPU time a frame are printed beside the
metrics (`host`): on a host whose speed wanders they spread too widely
between processes to be held to a bound.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import queue
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import readers
import reference

ROOT = Path(__file__).resolve().parent.parent
HERE = "benchmark"

# modules that no run may load, by top-level name (the port's own name
# begins with the JAX package's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "easyav1_tpu")
PORT = "easyav1_tpu_torch"
CLOCK_MARK = "benchmark.clock"
# decode_next calls a frame may take: a packet with no shown frame, or
# the end of the stream and the seek back
MAX_CALLS = 4


def forbidden_modules(names=None) -> List[str]:
    """The FORBIDDEN top-level names among `names` (sys.modules)."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None
                                      else names)}
    return sorted(tops.intersection(FORBIDDEN))


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    traffic_code: Optional[Path]
    metrics: Dict[bool, List[dict]]  # by trace: per-layer, else end-to-end


def load_config(path: Path, root: Path) -> dict:
    """A configuration's file; raises when its stream is missing or its
    sha256 is not the pinned one."""
    with open(path) as f:
        cfg = json.load(f)
    with open(root / cfg["stream"], "rb") as f:
        got = hashlib.sha256(f.read()).hexdigest()
    if got != cfg["sha256"]:
        raise ValueError(f"{cfg['stream']}: sha256 {got}, the configuration "
                         f"pins {cfg['sha256']}")
    return cfg


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    mixes = root / HERE / "traffic"
    with open(mixes / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    code = mixes / f"{w['traffic']}.py"
    return Cell(
        name=workload, chips=w["chips"],
        config=load_config(root / conf["file"], root), traffic=traffic,
        traffic_code=code if code.exists() else None,
        metrics={False: [m for m in spec["end_to_end"]
                         if _applies(m, workload)],
                 True: [m for m in spec["per_layer"]
                        if _applies(m, workload)]})


def _module(path: Path, prefix: str):
    name = prefix + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """`read(run)` of the metric `name`, from `metrics/<name>.json` or
    `metrics/<name>.py`."""
    base = root / HERE / "metrics"
    js, py = base / f"{name}.json", base / f"{name}.py"
    if js.exists():
        with open(js) as f:
            spec = json.load(f)
        fn = readers.READERS[spec["reader"]]
        return lambda run: fn(run, spec)
    if py.exists():
        mod = _module(py, "benchmark_metric_")
        return lambda run: mod.read(run, {})
    raise FileNotFoundError(f"no reader for the metric {name!r} under "
                            f"{base}")


@dataclasses.dataclass
class Readings:
    """What a run read, for the metrics' readers."""
    config: dict
    setup_s: float = 0.0
    n_frames: int = 0
    window_s: float = 0.0
    cpu_s: float = 0.0
    frame_s: List[float] = dataclasses.field(default_factory=list)
    # the window's device operations (see _profiled)
    profile: Optional[dict] = None


class Window:
    """What the window delivered: each frame's time (`frame_s`), position,
    index, timestamp and whether it came (`frames`), and the digest of
    every delivered frame's planes (`digests`, by position), made by a
    thread of its own that `add` feeds (`start`, then `close` once the
    window has closed).  The thread's CPU time (`hash_cpu_s`) is read from
    its own clock, so that the window can leave it out of the process's."""

    def __init__(self):
        self.frame_s: List[float] = []
        self.frames: List[dict] = []
        self.digests: Dict[int, str] = {}
        self.todo: queue.SimpleQueue = queue.SimpleQueue()
        self.thread: Optional[threading.Thread] = None
        self.clock: Optional[int] = None

    def _hash(self) -> None:
        while True:
            item = self.todo.get()
            if item is None:
                return
            pos, planes = item
            self.digests[pos] = reference.frame_digest(planes)

    def start(self) -> None:
        self.thread = threading.Thread(target=self._hash, daemon=True,
                                       name="benchmark-hash")
        self.thread.start()
        self.clock = time.pthread_getcpuclockid(self.thread.ident)

    def hash_cpu_s(self) -> float:
        """The hashing thread's CPU seconds so far."""
        return time.clock_gettime(self.clock)

    def close(self) -> None:
        self.todo.put(None)
        self.thread.join()

    def add(self, t0: float, t1: float, rec: dict) -> None:
        pos, planes = len(self.frames), rec["planes"]
        self.frame_s.append(t1 - t0)
        self.frames.append({"pos": pos, "index": rec["index"],
                            "got": planes is not None,
                            "timestamp": rec["timestamp"]})
        if planes is not None:
            self.todo.put((pos, planes))


class Player:
    """A looping player of one session (see the module docstring).
    `step()` delivers one frame: (start, end, record) on the host clock;
    the record holds the frame's index in the stream, its timestamp and
    its planes, or None for both where no frame came."""

    def __init__(self, av, n_frames: int):
        from easyav1_tpu_torch.settings import EasyAV1Status
        self.av, self.n, self.index = av, n_frames, 0
        self.OK, self.FINISHED = EasyAV1Status.OK, EasyAV1Status.FINISHED

    def step(self):
        av, frame = self.av, None
        t0 = time.perf_counter()
        for _ in range(MAX_CALLS):
            st = av.decode_next()
            if st == self.FINISHED:
                av.seek_to_timestamp(0)
            elif st != self.OK:
                break
            if av.has_video_frame():
                frame = av.get_video_frame()
                break
        planes = None
        if frame is not None:
            planes = [frame.data[i] for i in range(len(frame.data))]
        t1 = time.perf_counter()
        rec = {"index": self.index, "planes": planes,
               "timestamp": None if frame is None else frame.timestamp}
        self.index = (self.index + 1) % self.n
        return t0, t1, rec

    def play(self, seconds: float, window: Window):
        """Whole passes of the stream until `seconds` have passed (and at
        most three times as long, should a pass never end); returns this
        part's (start, end) on the host clock."""
        k, start = 0, None
        while True:
            t0, t1, rec = self.step()
            start = t0 if start is None else start
            window.add(t0, t1, rec)
            k += 1
            if (k % self.n == 0 and t1 - start >= seconds) \
                    or t1 - start >= 3 * seconds + 60:
                return start, t1


def _span_clock(base, spans: list):
    """The pipe's stage clock `base`, also keeping each stage's host span,
    (name, start ns, end ns); with the stage log off it synchronises
    nothing."""

    class SpanClock(base):
        def __init__(self):
            super().__init__()
            self.span_t0 = time.perf_counter_ns()

        def mark(self, name, device=None):
            super().mark(name, device)
            t = time.perf_counter_ns()
            spans.append((name, self.span_t0, t))
            self.span_t0 = t

    return SpanClock


def _profiled(player, seconds, window, pipe, cuda, trace) -> dict:
    """The window's whole passes under torch.profiler: the device's
    operations and the frames delivered.  Untraced, device activity alone,
    every operation from the window's start until the device has done
    what the window sent (`window` None).  Traced, also the host's
    operations, with the pipe's stages' host spans (unsynchronised) and
    the window on the profiler's clock, to which the device operations are
    cut."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = ([ProfilerActivity.CPU] if trace else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    spans: list = []
    first = len(window.frames)
    saved = pipe._Stages
    if trace:
        pipe._Stages = _span_clock(saved, spans)
    try:
        with (profile(activities=acts) if acts else
              contextlib.nullcontext()) as prof:
            mark = time.perf_counter_ns()
            if trace:
                with record_function(CLOCK_MARK):
                    pass
            start, end = player.play(seconds, window)
            if cuda:
                torch.cuda.synchronize()
    finally:
        pipe._Stages = saved
    events = prof.profiler.kineto_results.events() if acts else []
    dev = [(e.name(), e.start_ns(), e.duration_ns()) for e in events
           if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0]
    out = {"window": None, "device_events": dev, "host_spans": [],
           "frame_indices": [f["index"] for f in window.frames[first:]],
           "host": (start, end)}
    if trace:
        off = next(e.start_ns() for e in events
                   if e.name() == CLOCK_MARK) - mark
        out["window"] = (round(start * 1e9) + off, round(end * 1e9) + off)
        out["host_spans"] = [(n, a + off, b + off) for n, a, b in spans]
    return out


def play_cell(cell: Cell, av, seed: int, seconds: float, trace: bool,
              run: Readings, window: Window, cuda: bool,
              since_start: Callable[[], float]) -> None:
    """Set-up's warm-up, then the window: fills `run` and `window`."""
    from easyav1_tpu_torch.native import pipe
    n = len(cell.config["frames"])
    player = Player(av, n)
    for _ in range(cell.traffic["warmup_passes"] * n + 1):
        player.step()
    gc.collect()
    run.setup_s = since_start()
    for _ in range(seed % n):
        player.step()
    cpu0, hash0 = time.process_time(), window.hash_cpu_s()
    run.profile = _profiled(player, seconds, window, pipe, cuda, trace)
    run.cpu_s = (time.process_time() - cpu0
                 - (window.hash_cpu_s() - hash0))
    start, end = run.profile.pop("host")
    run.window_s = end - start
    run.n_frames = len(window.frames)
    run.frame_s = window.frame_s


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             since_start: Optional[Callable[[], float]] = None) -> dict:
    """One run of a cell: the result line's object."""
    import torch

    import easyav1_tpu_torch as port
    spec = load_spec(root)
    cell = find_cell(spec, workload, root)
    cuda = torch.device(device).type == "cuda"
    if since_start is None:
        t0 = time.perf_counter()
        since_start = lambda: time.perf_counter() - t0  # noqa: E731
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    play = play_cell
    if cell.traffic_code is not None:
        play = _module(cell.traffic_code, "benchmark_traffic_").play_cell
    run = Readings(config=cell.config)
    window = Window()
    window.start()
    try:
        av = port.EasyAV1(str(root / cell.config["stream"]), device=device,
                          **cell.traffic.get("session", {}))
        try:
            play(cell, av, seed, seconds, trace, run, window, cuda,
                 since_start)
            if cuda:
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() if cuda else 0
        finally:
            av.close()
    finally:
        window.close()
    del av
    gc.collect()
    checks = reference.compare(window.frames, window.digests,
                               cell.config["frames"])
    failed = checks.pop("failed_frames")
    metrics = {}
    for m in cell.metrics[trace]:
        v = metric_reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
               "count": cell.chips}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = peak
    out = {"correct": failed == 0 and all(v == 0 for v in checks.values()),
           "attempted": len(window.frames), "failed": failed,
           "metrics": metrics, "device": dev}
    p = run.profile
    if trace and p is not None and p["window"] is not None:
        dev["busy_s"] = readers.busy_ns(p) * 1e-9
        dev["window_s"] = (p["window"][1] - p["window"][0]) * 1e-9
        out["breakdown"] = readers.breakdown(p)
    # the host's readings of the window, for people (no metric of a cell)
    out["host"] = {"fps": readers.fps(run, {}),
                   "host_cpu_ms_per_frame": readers.cpu_ms_per_frame(run, {})}
    out["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    return out
