"""Profile the port's postfilter stages on one NVIDIA GPU: how many
device operations one frame's stage launches, their summed device time,
and how much of the stage's wall time the device is busy.

    python3 tools/torch_postfilter_profile.py [FRAME] [REPEATS]
    python3 tools/torch_postfilter_profile.py --batch [SLOTS] [REPEATS]

Decodes tests/data/bench/bench_av1_inter_1920x1080_60.webm (deblocking
off, CDEF on) through the port up to inter frame FRAME (default 5) and
tests/data/bench/bench_av1_lr_grain_1920x1080_8.webm (deblocking, loop
restoration and film grain on) up to inter frame min(FRAME, 7), keeps
what enters each stage of that frame, then runs each stage REPEATS times
(default 5) under `torch.profiler`: deblocking + CDEF on both, as the
pipe runs it (`postfilter_apply`: the hand kernels of
csrc/loopfilter.cu and csrc/cdef.cu, three launches a frame at most)
and as plain torch ops
(`postfilter_apply_plain`, the eager chain those kernels replaced),
loop restoration (`lr_torch`, host maps included) and film grain
(`fg_torch`: its kernel, csrc/fg.cu, the templates made before) on the
second.  It prints, per
frame and stage: the device operations (kernels and copies), their
summed device time, the time the device is busy (the union of their
intervals), the stage's wall time on the host clock with the device
synchronised at its end, the idle time between operations, the busy
share, and the ten operations that take the most device time.  Each
stage is also timed without the profiler, for what the instrumentation
costs.  The host half of LF + CDEF is timed too, split into the
deblocking maps (`_lf_size_maps`), the CDEF maps and the upload.

With --batch, it profiles the multi-stream postfilter instead: one batch
of SLOTS (default 8) 1080p key frames, LF and CDEF not yet applied, half
of tests/data/bench/bench_av1_intra_lf_1920x1080_8.webm (deblocking on)
and half of bench_av1_intra_1920x1080_30.webm (deblocking off), C
decoded (`multistream_av1.decode_frames_unfiltered_native`): the stacked
pass (`postfilter_apply` over a stream axis, as
`multistream_av1.batched_postfilter_real` runs it) against a pass a slot
(as `batched_postfilter_loop` runs them), both on uploaded inputs.

`lf_cdef_ops(index, reps)` is the LF + CDEF half of the default mode as a
function: chip_smoke.py reads the operation counts and the host split
from it.
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
from easyav1_tpu_torch.parallel import multistream_av1  # noqa: E402
from easyav1_tpu_torch.video.av1.recon import postfilter  # noqa: E402
from easyav1_tpu_torch.video.av1.recon.postfilter import (  # noqa: E402
    postfilter_apply, postfilter_apply_plain, postfilter_maps, upload_maps)

BENCH = os.path.join(REPO, "tests", "data", "bench")
STREAM = os.path.join(BENCH, "bench_av1_inter_1920x1080_60.webm")
INTRA = os.path.join(BENCH, "bench_av1_intra_1920x1080_30.webm")
INTRA_LF = os.path.join(BENCH, "bench_av1_intra_lf_1920x1080_8.webm")
LR_GRAIN = os.path.join(BENCH, "bench_av1_lr_grain_1920x1080_8.webm")


def capture(path, index):
    """What enters the postfilter stages of the stream's inter frame
    `index`: {"planes", "maps"} of LF + CDEF, and where the frame has
    them {"lr": (LoopRestoration, planes, deblocked)} and {"grain":
    (FilmGrain, planes)}."""
    from easyav1_tpu_torch.video.av1.backend import AV1Backend

    got, seen = {}, {"inter": 0, "on": False}
    orig = pipe.postfilter_frame, pipe.LoopRestoration, \
        AV1Backend._film_grain_device

    def spy(planes, hdr, seq, grids_for, skip, cdef, want_deblocked=False):
        seen["inter"] += not hdr.frame_is_intra
        seen["on"] = not hdr.frame_is_intra and seen["inter"] == index
        if seen["on"]:
            dims = tuple((int(p.shape[0]), int(p.shape[1])) for p in planes)
            got.update(planes=[p.clone() for p in planes],
                       maps=postfilter_maps(hdr, seq, dims, grids_for, skip,
                                            cdef, planes[0].device),
                       host_ms=host_split(hdr, seq, dims, grids_for, skip,
                                          cdef, planes[0].device))
        return orig[0](planes, hdr, seq, grids_for, skip, cdef,
                       want_deblocked)

    class SpyLR(orig[1]):
        def apply(self, planes, deblocked):
            if seen["on"]:
                got["lr"] = (self, planes, deblocked)
            return super().apply(planes, deblocked)

    def spy_grain(self, fg, seq, planes):
        out = orig[2](self, fg, seq, planes)
        if seen["on"]:
            got["grain"] = (self._dev_fg[1], planes)
        return out

    pipe.postfilter_frame, pipe.LoopRestoration = spy, SpyLR
    AV1Backend._film_grain_device = spy_grain
    av = easyav1_tpu_torch.EasyAV1(path, device="cuda")
    try:
        for _ in range(4096):
            if (got and not seen["on"]) or av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                av.get_video_frame()
    finally:
        av.close()
        pipe.postfilter_frame, pipe.LoopRestoration = orig[:2]
        AV1Backend._film_grain_device = orig[2]
    if not got:
        raise RuntimeError(f"no inter frame {index} in {path}")
    return got


def host_split(hdr, seq, dims, grids_for, skip, cdef, dev, reps=5):
    """The host half of a frame's LF + CDEF (`postfilter_maps`), split,
    in ms on the host clock, mean of `reps` calls: the deblocking maps
    (`_lf_size_maps`, and `lf_host_maps` around it), the CDEF maps
    (`cdef_host_maps`), the upload (`upload_maps`, synchronised) and the
    whole (`postfilter_maps`)."""
    bd = seq.color.bitdepth
    parts = {
        "lf_size_maps": lambda: any(hdr.lf.level)
        and postfilter._lf_size_maps(hdr, bd, dims, grids_for),
        "lf_host_maps": lambda: postfilter.lf_host_maps(hdr, seq, dims,
                                                        grids_for),
        "cdef_host_maps": lambda: postfilter.cdef_host_maps(hdr, seq, skip,
                                                            cdef)}
    out = {}
    for k, fn in parts.items():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[k] = (time.perf_counter() - t0) * 1e3 / reps
    host = postfilter.host_maps(hdr, seq, dims, grids_for, skip, cdef)
    out["upload"] = wall_ms(lambda: upload_maps(host, dev), reps)
    out["postfilter_maps"] = wall_ms(lambda: postfilter_maps(
        hdr, seq, dims, grids_for, skip, cdef, dev), reps)
    return out


def wall_ms(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profile(name, stage, reps):
    """Run `stage` under the profiler and print its counts (see the
    module docstring); "per frame" is per call of `stage`.  Returns
    {"ops", "device_ms", "busy_ms", "wall_ms"} a frame (the wall time
    without the profiler)."""
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
    print(f"{name}, per frame over {reps} runs: {ops:.1f} device "
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
    for op, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:10]:
        print(f"  {n / reps:7.1f} {us / reps / 1e3:9.4f}  {op[:90]}")
    return {"ops": ops, "device_ms": total_ms, "busy_ms": busy_ms,
            "wall_ms": plain}


def profile_batch(slots, reps):
    """The --batch mode (see the module docstring)."""
    half = slots // 2
    lf, intra = (multistream_av1.decode_frames_unfiltered_native(p, half)
                 for p in (INTRA_LF, INTRA))
    frames = [f for pair in zip(lf, intra) for f in pair]
    dev = torch.device("cuda", 0)
    planes, maps = multistream_av1.batch_inputs(frames, dev)
    single = [upload_maps(m, dev)
              for m in multistream_av1.batch_maps(frames)[1]]
    damping = sorted(int(d) for d in maps["cdef"]["damping"].flatten())
    print(f"a batch of {len(frames)} 1080p key frames, deblocking on in "
          f"{half}, CDEF damping {damping}")
    profile(f"stacked pass over {len(frames)} slots",
            lambda: postfilter_apply(planes, maps), reps)
    profile(f"a pass a slot, {len(frames)} slots",
            lambda: [postfilter_apply([p[k] for p in planes], single[k])
                     for k in range(len(frames))], reps)


# the streams of the default mode: title, path, and which inter frame
STREAMS = (("1080p inter stream", STREAM, None),
           ("1080p LR + grain stream", LR_GRAIN, 7))


def lf_cdef_ops(index=5, reps=5):
    """LF + CDEF of inter frame `index` of each stream of STREAMS (at most
    the last inter frame), through the hand kernels and as plain torch
    ops, under the profiler: {title: {"kernels": profile's dict,
    "plain": profile's dict, "lf": deblocking on?}}."""
    out = {}
    for title, path, last in STREAMS:
        k = min(index, last or index)
        c = capture(path, k)
        planes, maps = c["planes"], c["maps"]
        print(f"{title}, inter frame {k}: host maps, ms a frame (host "
              "clock): " + ", ".join(f"{n} {v:.3f}"
                                     for n, v in c["host_ms"].items()))
        out[title] = {
            "lf": maps["lf"] is not None, "host_ms": c["host_ms"],
            "kernels": profile(f"{title}, inter frame {k}: LF + CDEF, hand "
                               "kernels (postfilter_apply)",
                               lambda: postfilter_apply(planes, maps), reps),
            "plain": profile(f"{title}, inter frame {k}: LF + CDEF, plain "
                             "torch ops (postfilter_apply_plain)",
                             lambda: postfilter_apply_plain(planes, maps),
                             reps)}
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_postfilter_profile: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if sys.argv[1:2] == ["--batch"]:
        profile_batch(int(sys.argv[2]) if len(sys.argv) > 2 else 8,
                      int(sys.argv[3]) if len(sys.argv) > 3 else 5)
        return
    index = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    lf_cdef_ops(index, reps)
    for title, path, last in STREAMS:
        k = min(index, last or index)
        c = capture(path, k)
        print(f"{title}, inter frame {k}: deblocking "
              f"{'on' if c['maps']['lf'] is not None else 'off'}, CDEF "
              f"{'on' if c['maps']['cdef'] is not None else 'off'}, loop "
              f"restoration {'on' if 'lr' in c else 'off'}, film grain "
              f"{'on' if 'grain' in c else 'off'}")
        if "lr" in c:
            lr, lr_planes, debl = c["lr"]
            profile(f"{title}: loop restoration",
                    lambda: lr.apply(lr_planes, debl), reps)
        if "grain" in c:
            fg, clean = c["grain"]
            profile(f"{title}: film grain", lambda: fg.apply(clean), reps)


if __name__ == "__main__":
    main()
