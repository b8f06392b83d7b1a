"""Profile the port's deblocking + CDEF stage (eager torch ops) on one
NVIDIA GPU: how many device operations one frame's `postfilter_apply`
launches, their summed device time, and how much of the stage's wall time
the device is busy.

    python3 tools/torch_postfilter_profile.py [FRAME] [REPEATS]

Decodes tests/data/bench/bench_av1_inter_1920x1080_60.webm through the
port up to inter frame FRAME (default 5), keeps that frame's planes
before the postfilters and its filter maps, then runs `postfilter_apply`
on them REPEATS times (default 5) under `torch.profiler` and prints, per
frame: the device operations (kernels and copies), their summed device
time, the time the device is busy (the union of their intervals), the
stage's wall time on the host clock with the device synchronised at its
end, the idle time between operations, the busy share, and the ten
operations that take the most device time.  The same stage is timed
without the profiler, for what the instrumentation costs.
"""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import easyav1_tpu_torch  # noqa: E402
from easyav1_tpu_torch.native import pipe  # noqa: E402
from easyav1_tpu_torch.video.av1.recon.postfilter import (  # noqa: E402
    postfilter_apply, postfilter_maps)

STREAM = os.path.join(REPO, "tests", "data", "bench",
                      "bench_av1_inter_1920x1080_60.webm")


def capture(index):
    """(planes, maps) of the stream's inter frame `index` as they enter
    the postfilters."""
    got, seen = {}, {"inter": 0}
    orig = pipe.postfilter_frame

    def spy(planes, hdr, seq, grids_for, skip, cdef):
        if not hdr.frame_is_intra:
            seen["inter"] += 1
            if seen["inter"] == index:
                dims = tuple((int(p.shape[0]), int(p.shape[1]))
                             for p in planes)
                got.update(planes=[p.clone() for p in planes],
                           maps=postfilter_maps(hdr, seq, dims, grids_for,
                                                skip, cdef, planes[0].device))
        return orig(planes, hdr, seq, grids_for, skip, cdef)

    pipe.postfilter_frame = spy
    av = easyav1_tpu_torch.EasyAV1(STREAM, device="cuda")
    try:
        for _ in range(4096):
            if got or av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                av.get_video_frame()
    finally:
        av.close()
        pipe.postfilter_frame = orig
    if not got:
        raise RuntimeError(f"no inter frame {index} in {STREAM}")
    return got["planes"], got["maps"]


def wall_ms(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_postfilter_profile: no CUDA device")
    index = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    planes, maps = capture(index)
    print(f"1080p inter frame {index}: deblocking "
          f"{'on' if maps['lf'] is not None else 'off'}, CDEF "
          f"{'on' if maps['cdef'] is not None else 'off'}")

    def stage():
        return postfilter_apply(planes, maps)

    wall_ms(stage, 3)                       # warm up
    plain = wall_ms(stage, reps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced = wall_ms(stage, reps)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(b - a for a, b in spans)
    ops, busy_ms, total_ms = len(dev) / reps, busy / reps / 1e3, \
        total / reps / 1e3
    print(f"postfilter_apply, per frame over {reps} runs: {ops:.1f} device "
          f"operations, summed device time {total_ms:.4f} ms, device busy "
          f"{busy_ms:.4f} ms of {traced:.4f} ms wall (host clock, "
          f"synchronised): idle between operations {traced - busy_ms:.4f} "
          f"ms, busy share {busy_ms / traced:.4f}")
    print(f"the same stage without the profiler: {plain:.4f} ms wall; busy "
          f"share against it {busy_ms / plain:.4f}")
    by_name = {}
    for e in dev:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.time_range.end - e.time_range.start
    print("device time by operation (calls and ms per frame):")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:10]:
        print(f"  {n / reps:7.1f} {us / reps / 1e3:9.4f}  {name[:90]}")


if __name__ == "__main__":
    main()
