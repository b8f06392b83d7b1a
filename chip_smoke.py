"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `easyav1_tpu_torch/csrc` (at first
use), then:

1. holds every kernel against its plain torch version on the card,
   exactly: seeded random unit programs of every class, and the first
   key frame of the 1080p intra stream, luma and chroma;
2. drives the port's main path: all 30 frames of
   tests/data/bench/bench_av1_intra_1920x1080_30.webm through
   `easyav1_tpu_torch.EasyAV1(path, device="cuda")`, every frame's hash
   equal to the native C decode's, no fallback, and the kernel launched
   on every frame; then the first (key) frame of the 4K stream;
3. times the port against the native C path on this host, the strip
   kernel against its plain version, and deblocking + CDEF per frame.

The native C decode is the reference's jax-free host path, reached
through the port's `api.native_session`; the smoke imports only torch
and `easyav1_tpu_torch`, and checks that no JAX was imported.  Every
phase raises on failure.  The line before the last gives the card's name
and power limit, the last line the device summary.
"""

import json
import os
import subprocess
import sys
import time

import torch

import easyav1_tpu_torch
from easyav1_tpu_torch import _build
from easyav1_tpu_torch.api import frame_hash, native_session
from easyav1_tpu_torch.native import first_frame_inputs
from easyav1_tpu_torch.unit_programs import random_program
from easyav1_tpu_torch.video.av1.recon import intra_strip
from easyav1_tpu_torch.video.av1.recon.intra_exec import prepare_fields
from easyav1_tpu_torch.video.av1.recon.postfilter import (postfilter_apply,
                                                          postfilter_maps)

REPO = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(REPO, "tests", "data", "bench")
INTRA_1080 = os.path.join(BENCH, "bench_av1_intra_1920x1080_30.webm")
KEY_4K = os.path.join(BENCH, "bench_av1_4k_3840x2160_24.webm")
SEEDS = [301, 304, 305, 317, 310, 311, 312, 313]


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def decode_hashes(make, limit=None):
    """(frame hashes, wall seconds) of a session's video frames."""
    av = make()
    hashes = []
    t0 = time.perf_counter()
    try:
        for _ in range(4096):
            if av.is_finished() or (limit and len(hashes) >= limit):
                break
            av.decode_next()
            while av.has_video_frame() and not (limit and
                                                len(hashes) >= limit):
                hashes.append(frame_hash(av.get_video_frame().data))
        check(not av.get_status().is_error, f"status {av.get_status()}")
    finally:
        av.close()
    return hashes, time.perf_counter() - t0


def run_kernel(dims, t, plain=False):
    """Luma then U+V of one frame through the kernel (or plain); t holds
    per-plane (fields, residual) tensors."""
    if plain:
        y = intra_strip.strip_exec_plain(t[0][0], t[0][1], dims[0], 8)
        return [y] + [intra_strip.strip_exec_plain(f, r, dims[1], 8, y)
                      for f, r in t[1:]]
    y = intra_strip.strip_exec([t[0][0]], [t[0][1]], dims[0], 8)[0]
    return [y] + intra_strip.strip_exec([f for f, _ in t[1:]],
                                        [r for _, r in t[1:]], dims[1], 8,
                                        luma=y)


def cuda_ms(fn, reps):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    os.environ.pop("EASYAV1_PIPE", None)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}")
    print(f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load("intra_strip")
    print(f"kernel build {time.perf_counter() - t0:.3f} s")

    # 1. kernel vs plain; integer arithmetic, so the tolerance is 0
    max_err = 0
    for seed in SEEDS:
        prog = random_program(seed, mi_rows=68, mi_cols=120, n_rand=400)
        p = prog["plane"]
        f = torch.from_numpy(prepare_fields(prog["units"],
                                            prog["dims"])[p]).to(dev)
        r = torch.from_numpy(prog["resid"][p]).to(dev)
        luma = torch.from_numpy(prog["luma"]).to(dev) if p else None
        got = intra_strip.strip_exec([f], [r], prog["dims"][p], 8, luma)[0]
        want = intra_strip.strip_exec_plain(f, r, prog["dims"][p], 8, luma)
        err = int((got - want).abs().max())
        print(f"program seed {seed} plane {p} units {f.shape[0]}: "
              f"max_abs_err {err}")
        max_err = max(max_err, err)
    key = first_frame_inputs(INTRA_1080, dev)
    check(key is not None, "1080p frame 0 declined")
    dims, n_units = key["recon"].dims, key["units"]
    t = list(zip(key["fields"], key["resid"]))
    got = run_kernel(dims, t)
    want = run_kernel(dims, t, plain=True)
    for p, (a, b) in enumerate(zip(got, want)):
        err = int((a - b).abs().max())
        print(f"1080p frame 0 plane {p}: max_abs_err {err}")
        max_err = max(max_err, err)
    print(f"1080p frame 0: {n_units} units")
    check(max_err == 0, f"kernel vs plain max_abs_err {max_err} "
                        "(tolerance 0)")

    # 2. the main path, hash-equal to the native C decode
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    intra_strip.strip_exec.launches = 0
    port, _ = decode_hashes(
        lambda: easyav1_tpu_torch.EasyAV1(INTRA_1080, device="cuda"))
    launches = intra_strip.strip_exec.launches
    stats = dict(easyav1_tpu_torch.stats)
    native, _ = decode_hashes(lambda: native_session(INTRA_1080))
    print(f"main path: {len(port)} frames, stats {stats}, "
          f"intra_strip launches {launches}")
    check(len(port) == 30 and port == native,
          f"1080p hashes {len(port)} frames, "
          f"{sum(a != b for a, b in zip(port, native))} differ")
    check(stats == {"frames": 30, "fallbacks": 0}, f"stats {stats}")
    check(launches >= 60, f"launches {launches}")
    port4k, _ = decode_hashes(
        lambda: easyav1_tpu_torch.EasyAV1(KEY_4K, device="cuda"), limit=1)
    native4k, _ = decode_hashes(lambda: native_session(KEY_4K), limit=1)
    print(f"4K key frame hash port {port4k} native {native4k}")
    check(len(port4k) == 1 and port4k == native4k, "4K key frame hash")

    # 3. timings (warm: every path above ran once)
    _, port_s = decode_hashes(
        lambda: easyav1_tpu_torch.EasyAV1(INTRA_1080, device="cuda"))
    _, native_s = decode_hashes(lambda: native_session(INTRA_1080))
    print(f"1080p intra 30 frames: port {30 / port_s:.3f} fps, "
          f"native C {30 / native_s:.3f} fps (this host)")
    kern_ms = cuda_ms(lambda: run_kernel(dims, t), 20)
    plain_ms = cuda_ms(lambda: run_kernel(dims, t, plain=True), 2)
    print(f"1080p frame 0 strip executor: kernel {kern_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    planes = run_kernel(dims, t)
    pf_args = (key["hdr"], key["seq"], [tuple(p.shape) for p in planes],
               *key["maps"], dev)

    def maps():
        m = postfilter_maps(*pf_args)
        torch.cuda.synchronize()
        return m

    m = maps()
    postfilter_apply(planes, m)
    t0 = time.perf_counter()
    for _ in range(10):
        maps()
    maps_ms = (time.perf_counter() - t0) * 100
    apply_ms = cuda_ms(lambda: postfilter_apply(planes, m), 10)
    print(f"1080p frame 0 LF + CDEF: host maps + upload {maps_ms:.3f} ms "
          f"(host clock), device filters {apply_ms:.3f} ms (CUDA events)")

    print(json.dumps({"kernels": [{
        "name": "intra_strip", "route": "cuda",
        "source": "easyav1_tpu_torch/csrc/intra_strip.cu",
        "replaces": "easyav1_tpu/video/av1/recon/intra_pallas.py:66",
        "launches": launches, "max_abs_err": max_err, "ms": kern_ms,
        "plain_ms": plain_ms}]}))
    check("jax" not in sys.modules, "jax was imported")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
