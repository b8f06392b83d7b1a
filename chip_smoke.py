"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's four libraries from the checkout at first use, all at
once: the C decoder (gcc, `easyav1_tpu_torch/native`) and the CUDA
kernels (nvcc, `easyav1_tpu_torch/csrc/intra_strip.cu`,
`csrc/inter_mc.cu` and `csrc/frame_hash.cu`, whose ptxas reports it
prints).  Then:

1. holds every kernel against its plain torch version on the card,
   exactly: the strip kernel on seeded random unit programs of every
   class under the sequential schedule, on intrabc programs under the
   sequential schedule and on interintra programs in place on a base
   plane, on the key frames of the 1080p intra stream and of the 4K
   stream under the superblock wavefront, with 20 wavefront runs of the
   4K key frame each bit-equal to the first, and on the pred units of a
   1080p and a 4K inter frame in place on their MC planes; the MC kernel
   (6a) and the OBMC kernel (6b) on seeded random MC programs of every
   unit kind at 1080p and at an odd size (reference pitches that are no
   multiple of 4), 6a on the 1080p inter frame, 20 runs of 6a on the 4K
   inter frame and 20 runs of 6b on a random 1080p program, each
   bit-equal to the first (a race shows here); the frame hash kernel on
   seeded uint8 and uint16 planes of odd sizes, offsets and pitches
   against its plain version and `api.frame_hash`; the torch-ops stages
   (superres upscale, loop restoration, film grain) on the card against
   the same functions on the CPU, on seeded 1080p inputs; and the 10-
   and 12-bit instantiations: 6a and 6b on uint16 references of seeded
   random 10- and 12-bit MC programs at 1080p and at an odd size, with
   20 runs of each bit-equal to the first, the strip kernel on random
   programs at 10 and 12 bits, on the key frames of three small 10- and
   12-bit streams and in place on a 4K 10-bit inter frame's pred units
   (the uint16 6a on that frame too), and on the 4K 10-bit key frame
   under the wavefront, with 5 more runs bit-equal to the first;
2. drives the port's main path through `easyav1_tpu_torch.EasyAV1(path,
   device="cuda")`, each stream with the launch counts set to 0 just
   before it and read just after: all 30 frames of
   tests/data/bench/bench_av1_intra_1920x1080_30.webm, all 60 frames of
   bench_av1_inter_1920x1080_60.webm, all 24 frames of
   bench_av1_4k_3840x2160_24.webm, and the 8 frames of
   tests/data/smoke/inter_modes_96x96.webm (compound, warps and OBMC,
   which the bench streams lack), and the streams with loop
   restoration, film grain and superres: the 8 frames of
   tests/data/bench/bench_av1_lr_grain_1920x1080_8.webm and the five
   small streams of tests/data/smoke/, and its two libaom streams with
   wedge and diffwtd compound blocks, and the 10- and 12-bit streams:
   all 8 frames of tests/data/bench/bench_av1_10bit_3840x2160_8.webm
   and the ten hbd_*.webm of tests/data/smoke/ (STREAMS below); every
   frame's hash equal to the port's native C session's, no fallback,
   and the launches as expected: one strip launch a frame, one of 6a an
   inter frame, one of 6b a frame with OBMC blocks.  Then `decode_resident`
   on every stream (at most RESIDENT_FRAMES frames of each): its device
   hashes equal `api.frame_hash` of the same frames pulled through the
   API, no plane is downloaded, and the hash kernel launches once a
   frame;
3. times, in this run (CUDA events for kernels, the host clock around
   synchronised work for stages): the strip kernel under the wavefront
   and the sequential schedule at 1080p and 4K, 6a on a 1080p and a 4K
   inter frame, 6b on a random OBMC program, their plain versions, the
   strip kernel on a 1080p inter frame's pred units beside its bound,
   deblocking + CDEF, the stages of the 1080p inter stream's frames, and
   the port's fps beside the native C session's on both 1080p streams;
   the hash kernel on a 1080p frame beside its plain version and its
   byte bound; superres, loop restoration and film grain on 1080p
   planes; the stages of the 1080p loop-restoration and grain stream,
   and on it the port's fps, the native C session's and the resident
   decode's; on the 4K 10-bit stream the strip kernel on the key frame,
   the uint16 6a and the strip kernel on an inter frame, 6b on a random
   10-bit program and the hash kernel on a 4K 10-bit frame beside their
   bounds (2 bytes a reference or frame sample), the stages of its inter
   frames, and its port, resident and native fps.

The smoke imports only torch and `easyav1_tpu_torch`, and checks that
neither jax nor easyav1_tpu was imported.  Every phase raises on
failure.  The line before the last gives the card's name and power
limit, the last line the device summary.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

import easyav1_tpu_torch
from easyav1_tpu_torch import _build, native
from easyav1_tpu_torch.api import frame_hash, native_session
from easyav1_tpu_torch.native import pipe
from easyav1_tpu_torch.native.pipe import first_frame_inputs
from easyav1_tpu_torch.unit_programs import (
    program_frame, random_ibc_program, random_interintra_program,
    random_mc_program, random_program)
from easyav1_tpu_torch.video.av1.recon import (fg_torch, inter_mc, intra_strip,
                                               lr_torch, resident, sr_torch)
from easyav1_tpu_torch.video.av1.headers import FilmGrainParams
from easyav1_tpu_torch.video.av1.recon.mc_plan import (
    P_MODE, P_PRED0, P_PRED1, P_VALID, P_X, P_Y, S_FH, S_FV, S_IX, S_IY,
    S_NORES, S_SLOT, S_VALID, S_X, S_Y, W_IX4, W_IY4, W_SLOT, W_VALID, W_X,
    W_Y)
from easyav1_tpu_torch.video.av1.recon.inter_exec import InterRecon, ii_masks
from easyav1_tpu_torch.video.av1.recon.records import (F_H, F_RES, F_W,
                                                       preprocess_units)
from easyav1_tpu_torch.video.av1.recon.postfilter import (postfilter_apply,
                                                          postfilter_maps)

REPO = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(REPO, "tests", "data", "bench")
INTRA_1080 = os.path.join(BENCH, "bench_av1_intra_1920x1080_30.webm")
INTER_1080 = os.path.join(BENCH, "bench_av1_inter_1920x1080_60.webm")
KEY_4K = os.path.join(BENCH, "bench_av1_4k_3840x2160_24.webm")
SMOKE = os.path.join(REPO, "tests", "data", "smoke")
MODES = os.path.join(SMOKE, "inter_modes_96x96.webm")
LR_GRAIN_1080 = os.path.join(BENCH, "bench_av1_lr_grain_1920x1080_8.webm")
HBD_4K = os.path.join(BENCH, "bench_av1_10bit_3840x2160_8.webm")
SEEDS = [301, 304, 305, 317, 310, 311, 312, 313]
SCAN_SEEDS = [301, 303, 302, 310, 311, 319]
# (seed, width, height): 1080p, and a size whose reference pitches are
# odd, for the windows' alignment
MC_PROGRAMS = [(21, 1920, 1080), (22, 1920, 1080), (23, 1920, 1080),
               (24, 1278, 718)]
# (seed, width, height, bit depth) of the uint16 instantiations'
# programs; the last 1080p one (10-bit) takes the race check and the
# timing of 6b
MC_PROGRAMS_16 = [(32, 1920, 1080, 12), (31, 1920, 1080, 10),
                  (33, 1278, 718, 10)]
# (seed, bit depth) of the strip kernel's high-bit-depth programs
STRIP_HBD = [(301, 10), (305, 10), (304, 12), (317, 12)]
# the kernels' launch counters, by the name of the kernels line
COUNTERS = {"intra_strip": intra_strip.strip_exec_frame,
            "inter_mc": inter_mc.mc_launch, "obmc": inter_mc.obmc_launch,
            "frame_hash": resident.frame_hash_device}
KERNEL_SOURCES = ("intra_strip", "inter_mc", "frame_hash")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
INT32_OPS_PER_S = 33.5e12   # half the 67 TFLOP/s of float32 outside tensor cores


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def build():
    """The four libraries, built at once; prints ptxas's reports."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1 + len(KERNEL_SOURCES)) as ex:
        jobs = [ex.submit(native._load)] + [ex.submit(_build.build, name)
                                            for name in KERNEL_SOURCES]
        for j in jobs:
            j.result()
    print(f"build (gcc and {len(KERNEL_SOURCES)} nvcc at once) "
          f"{time.perf_counter() - t0:.3f} s")
    for name in KERNEL_SOURCES:
        _build.load(name)
        for line in (_build.BUILD / f"{name}.log").read_text().splitlines():
            if "spill" in line or "ptxas info" in line and (
                    "Used" in line or "bytes" in line):
                print(f"{name}: {line.strip()}")


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


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


HOLD_CYCLES = 20_000_000    # some 10 ms of device clock


def cuda_ms(fn, reps):
    """Mean device time of fn over reps calls (CUDA events), after one
    warm-up call.  The device is first held busy for HOLD_CYCLES, so that
    the host has queued every call before the first one starts: a kernel
    shorter than its wrapper's host time is timed back to back, not at
    the host's launch rate."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want):
    return max(int((a - b).abs().max()) for a, b in zip(got, want))


class Frame:
    """A frame's executor inputs on the card: per-plane fields and
    residuals, dims, and its wavefront and sequential schedules."""

    def __init__(self, fields, resid, dims, wavefront, dev, bd=8):
        self.bd = bd
        self.fields = [torch.from_numpy(f).to(dev) for f in fields]
        self.resid = [torch.from_numpy(r).to(dev) for r in resid]
        self.dims = dims
        sbh, sbw, spans = intra_strip.sequential_schedule(fields, dims)
        self.sequential = (sbh, sbw, torch.from_numpy(spans).to(dev))
        self.wavefront = wavefront

    @classmethod
    def key_frame(cls, path, dev):
        k = first_frame_inputs(path, dev)
        check(k is not None, f"{path} frame 0 declined")
        f = cls([f.cpu().numpy() for f in k["fields"]],
                [r.cpu().numpy() for r in k["resid"]], k["recon"].dims,
                k["schedule"], dev, k["seq"].color.bitdepth)
        f.key = k
        return f

    def run(self, schedule):
        return intra_strip.strip_exec_frame(self.fields, self.resid,
                                            self.dims, self.bd, schedule)

    def plain(self):
        return intra_strip.strip_exec_frame_plain(self.fields, self.resid,
                                                  self.dims, self.bd)

    def bound_ms(self):
        """The least time for the kernel's work on this frame: each input
        (records, residual, schedule) read once and each int32 plane
        written once at the HBM rate, against 3 integer operations a
        pixel (prediction + residual, clip) at the int32 rate."""
        pix = sum(h * w for h, w in self.dims)
        nbytes = sum(t.numel() * t.element_size()
                     for t in self.fields + self.resid) \
            + self.wavefront[2].numel() * 4 + 4 * pix
        by_bytes = nbytes / HBM_BYTES_PER_S
        by_ops = 3 * pix / INT32_OPS_PER_S
        return (max(by_bytes, by_ops) * 1e3, nbytes,
                "bytes" if by_bytes >= by_ops else "operations")


def check_kernel(dev):
    """Phase 1: kernel against plain, tolerance 0 (integer arithmetic)."""
    err = 0
    for seed in SEEDS:
        prog = random_program(seed, mi_rows=68, mi_cols=120, n_rand=400)
        pf = program_frame(prog)
        fields = preprocess_units(pf["units"], prog["dims"])
        fr = Frame(fields, pf["resid"], prog["dims"], None, dev)
        e = max_err(fr.run(fr.sequential), fr.plain())
        print(f"program seed {seed} plane {prog['plane']} units "
              f"{fields[prog['plane']].shape[0]}: max_abs_err {e}")
        err = max(err, e)
    frames = {}
    for name, path in (("1080p", INTRA_1080), ("4K", KEY_4K)):
        fr = frames[name] = Frame.key_frame(path, dev)
        want = fr.plain()
        e = max_err(fr.run(fr.wavefront), want)
        rows, cols = intra_strip.sb_grid(fr.dims, *fr.wavefront[:2])[0][:2]
        print(f"{name} frame 0: {sum(f.shape[0] for f in fr.fields)} units, "
              f"SB grid {rows}x{cols}, wavefront max_abs_err {e}")
        err = max(err, e)
    fr = frames["4K"]
    first = fr.run(fr.wavefront)
    for k in range(20):
        again = fr.run(fr.wavefront)
        check(all(torch.equal(a, b) for a, b in zip(again, first)),
              f"4K wavefront run {k} differs from the first")
    print("4K frame 0: 20 wavefront runs bit-equal to the first")
    check(err == 0, f"kernel vs plain max_abs_err {err} (tolerance 0)")
    return err, frames


def check_kernel_hbd(dev):
    """Phase 1: the strip kernel at 10 and 12 bits, against its plain
    version, tolerance 0: seeded random programs under the sequential
    schedule, and the key frames of the 10-bit, 12-bit and 10-bit 4:4:4
    smoke streams under the wavefront; then the 4K 10-bit stream's key
    frame under the wavefront against its plain version (one call, the
    slowest of the run; its time is kept as the frame's `plain_ms`), and
    5 more wavefront runs bit-equal to the first.  Returns (error, that
    key frame)."""
    err = 0
    for seed, bd in STRIP_HBD:
        prog = random_program(seed, mi_rows=68, mi_cols=120, n_rand=400,
                              bd=bd)
        pf = program_frame(prog)
        fields = preprocess_units(pf["units"], prog["dims"])
        fr = Frame(fields, pf["resid"], prog["dims"], None, dev, bd)
        e = max_err(fr.run(fr.sequential), fr.plain())
        print(f"{bd}-bit program seed {seed} plane {prog['plane']} units "
              f"{fields[prog['plane']].shape[0]}: max_abs_err {e}")
        err = max(err, e)
    for name in ("hbd_10i.webm", "hbd_12i.webm", "hbd_444x10.webm"):
        fr = Frame.key_frame(os.path.join(SMOKE, name), dev)
        e = max_err(fr.run(fr.wavefront), fr.plain())
        print(f"{name} frame 0 ({fr.bd}-bit): "
              f"{sum(f.shape[0] for f in fr.fields)} units, wavefront "
              f"max_abs_err {e}")
        err = max(err, e)
    fr = Frame.key_frame(HBD_4K, dev)
    check(fr.bd == 10, f"{HBD_4K}: bit depth {fr.bd}")
    first = fr.run(fr.wavefront)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fr.plain()
    torch.cuda.synchronize()
    fr.plain_ms = (time.perf_counter() - t0) * 1e3
    e = max_err(first, want)
    err = max(err, e)
    for k in range(5):
        check(all(torch.equal(a, b) for a, b in
                  zip(fr.run(fr.wavefront), first)),
              f"4K 10-bit wavefront run {k} differs from the first")
    print(f"4K 10-bit frame 0: {sum(f.shape[0] for f in fr.fields)} units, "
          f"wavefront max_abs_err {e} (plain version {fr.plain_ms:.1f} ms), "
          "5 more wavefront runs bit-equal to the first")
    check(err == 0, f"strip kernel at 10 and 12 bits max_abs_err {err}")
    return err, fr


SCAN_CASES = [("intrabc", 301), ("intrabc", 303), ("intrabc", 302),
              ("interintra", 310), ("interintra", 311),
              ("interintra", 319)]


def check_scan_units(dev):
    """Phase 1: the strip kernel on intrabc programs under the
    sequential schedule and on interintra programs in place on a base
    plane, against its plain version, tolerance 0."""
    err = 0
    for kind, seed in SCAN_CASES:
        prog = (random_ibc_program(seed, 68, 120, 400, 100)
                if kind == "intrabc" else
                random_interintra_program(seed, 68, 120, 400))
        pf = program_frame(prog)
        fields = preprocess_units(pf["units"], prog["dims"])
        masks = []
        for p in range(3):
            fields[p], m = ii_masks(fields[p], p, 1, 1, 64 if p == 0 else 32)
            intra_strip.check_units(fields[p], prog["dims"][p], p > 0,
                                    0 if m is None else m.shape[0],
                                    64 if p == 0 else 32)
            masks.append(None if m is None else torch.from_numpy(m).to(dev))
        fr = Frame(fields, pf["resid"], prog["dims"], None, dev)
        base = prog.get("base") or [np.zeros(d, np.int32)
                                    for d in prog["dims"]]

        def planes():
            return [torch.from_numpy(b.copy()).to(dev) for b in base]

        got = intra_strip.strip_exec_frame(fr.fields, fr.resid, fr.dims, 8,
                                           fr.sequential, planes(), masks)
        want = intra_strip.strip_exec_frame_plain(fr.fields, fr.resid,
                                                  fr.dims, 8, planes(), masks)
        e = max_err(got, want)
        n_ii = sum(m.shape[0] for m in masks if m is not None)
        print(f"{kind} program seed {seed} plane {prog['plane']}: "
              f"{int((pf['units'][:, 5] == 11).sum())} intrabc units, "
              f"{n_ii} interintra units, max_abs_err {e}")
        err = max(err, e)
    check(err == 0, f"strip kernel on intrabc/interintra max_abs_err {err}")
    return err


def mc_inputs(prog, dev):
    """A random MC program's (resid, refs) on the card."""
    return ([torch.from_numpy(r).to(dev) for r in prog["resid"]],
            [[torch.from_numpy(r).to(dev) for r in rs]
             for rs in prog["refs"]])


def zero_planes(dims, dev):
    return [torch.zeros(d, dtype=torch.int32, device=dev) for d in dims]


def check_mc(dev, programs=MC_PROGRAMS):
    """Phase 1: kernels 6a and 6b on random MC programs of every unit
    kind (`programs`: (seed, width, height[, bit depth]), 8 bits where
    none is given), against their plain versions, tolerance 0; then 20
    runs of 6b on the last 1080p program, each bit-equal to the first,
    and at 10 and 12 bits 20 runs of 6a too.  Returns (6a error, 6b
    error, the last 1080p program)."""
    err_mc = err_obmc = 0
    for seed, width, height, *depth in programs:
        bd = depth[0] if depth else 8
        prog = random_mc_program(seed, width, height, bd=bd)
        prog["bd"] = bd
        resid, refs = mc_inputs(prog, dev)
        plan = prog["plan"]
        got = inter_mc.mc_units(zero_planes(prog["dims"], dev), resid, refs,
                                plan, bd)
        want = inter_mc.mc_units_plain(zero_planes(prog["dims"], dev), resid,
                                       refs, plan, bd)
        e_mc = max_err(got, want)
        mc_only = [g.clone() for g in got]
        got = inter_mc.obmc(got, resid, refs, plan, bd)
        want = inter_mc.obmc_plain(want, resid, refs, plan, bd)
        e_ob = max_err(got, want)
        if (width, height) == (1920, 1080):
            last = (prog, got, mc_only)

        def n(name):
            return sum(v.shape[0] for v in plan[name].values())

        n_masked = sum(int((v[:, P_MODE] == 1).sum())
                       for v in plan["pairs"].values())
        print(f"MC program seed {seed} {width}x{height} {bd}-bit: "
              f"{n('singles')} single, "
              f"{n('pairs')} pair ({n_masked} masked), {n('warps')} warp, "
              f"{n('obmc_above') + n('obmc_left')} OBMC overlay units, "
              f"{n('obmc_resid')} OBMC blocks, "
              f"{inter_mc.mc_tables(plan)['n_tiles']} and "
              f"{inter_mc.obmc_tables(plan)['n_tiles']} tiles; "
              f"6a max_abs_err {e_mc}, 6b max_abs_err {e_ob}")
        err_mc, err_obmc = max(err_mc, e_mc), max(err_obmc, e_ob)
    check(err_mc == 0 and err_obmc == 0,
          f"MC kernels vs plain max_abs_err {err_mc}, {err_obmc}")
    prog, first, mc_first = last
    bd = prog["bd"]
    resid, refs = mc_inputs(prog, dev)
    base = inter_mc.mc_units(zero_planes(prog["dims"], dev), resid, refs,
                             prog["plan"], bd)
    tabs = inter_mc.upload(inter_mc.obmc_tables(prog["plan"]), dev)
    for k in range(20):
        again = inter_mc.obmc_launch([b.clone() for b in base], resid, refs,
                                     tabs, bd)
        check(all(torch.equal(a, b) for a, b in zip(again, first)),
              f"6b run {k} differs from the first")
    runs = "6b"
    if bd > 8:
        mc_tabs = inter_mc.upload(inter_mc.mc_tables(prog["plan"]), dev)
        for k in range(20):
            again = inter_mc.mc_launch(zero_planes(prog["dims"], dev), resid,
                                       refs, mc_tabs, bd)
            check(all(torch.equal(a, b) for a, b in zip(again, mc_first)),
                  f"{bd}-bit 6a run {k} differs from the first")
        runs = "6a and of 6b"
    print(f"MC program {prog['dims'][0][1]}x{prog['dims'][0][0]} {bd}-bit: "
          f"{tabs['n_tiles']} tiles, 20 runs of {runs} bit-equal to the "
          "first")
    return err_mc, err_obmc, prog


def capture_inter(path, index, dev):
    """The device inputs of a stream's first inter frame from frame
    `index` on that has pred units, decoded through the port: {"dims",
    "resid", "plan", "refs", "bd"} of its MC, and {"fields", "masks",
    "schedule", "base"} of its strip kernel launch ("base": a copy of
    the MC planes it starts from)."""
    got, cur = {}, {}
    motion, intra = InterRecon.motion, InterRecon.intra

    def spy_motion(self, resid, plan, refs):
        cur.update(n=cur.get("n", 0) + 1, dims=self.dims, resid=resid,
                   plan=plan, refs=refs, bd=self.bd)
        return motion(self, resid, plan, refs)

    def spy_intra(self, planes, fields, resid, masks, schedule):
        if cur["n"] >= index and "base" not in got \
                and any(f.shape[0] for f in fields):
            got.update(cur, fields=fields, masks=masks, schedule=schedule,
                       base=[p.clone() for p in planes])
        return intra(self, planes, fields, resid, masks, schedule)

    InterRecon.motion, InterRecon.intra = spy_motion, spy_intra
    try:
        decode_hashes(lambda: easyav1_tpu_torch.EasyAV1(path, device="cuda"))
    finally:
        InterRecon.motion, InterRecon.intra = motion, intra
    check("base" in got, f"{path}: no inter frame with pred units")
    return got


def strip_inter(c, base=None):
    """The strip kernel on a captured inter frame's units, in place on
    `base` (default: a copy of its MC planes)."""
    return intra_strip.strip_exec_frame(
        c["fields"], c["resid"], c["dims"], c["bd"], c["schedule"],
        base if base is not None else [b.clone() for b in c["base"]],
        c["masks"])


def check_inter_frames(dev):
    """Phase 1: 6a on a 1080p inter frame and the strip kernel on the
    pred units of a 1080p and a 4K inter frame, in place on their MC
    planes, against their plain versions; 20 runs of 6a on the 4K
    frame, each bit-equal to the first.  Returns (6a error, strip
    kernel error, the captured frames)."""
    caps = {"1080p": capture_inter(INTER_1080, 2, dev),
            "4K": capture_inter(KEY_4K, 2, dev)}
    for cap in caps.values():
        cap["tabs"] = inter_mc.upload(inter_mc.mc_tables(cap["plan"]), dev)
    c = caps["1080p"]
    got = inter_mc.mc_launch(zero_planes(c["dims"], dev), c["resid"],
                             c["refs"], c["tabs"], 8)
    want = inter_mc.mc_units_plain(zero_planes(c["dims"], dev), c["resid"],
                                   c["refs"], c["plan"], 8)
    err = max_err(got, want)
    print(f"1080p inter frame {c['n']}: {c['tabs']['n_tiles']} "
          f"tiles, 6a max_abs_err {err}")
    check(err == 0, f"6a on the 1080p inter frame max_abs_err {err}")
    e = 0
    for name, c in caps.items():
        e = max(e, max_err(strip_inter(c), intra_strip.strip_exec_frame_plain(
            c["fields"], c["resid"], c["dims"], 8,
            [b.clone() for b in c["base"]], c["masks"])))
        print(f"{name} inter frame {c['n']}: "
              f"{sum(f.shape[0] for f in c['fields'])} pred units, strip "
              f"kernel in place on the MC planes max_abs_err {e}")
    check(e == 0, f"strip kernel on the inter frames max_abs_err {e}")
    c = caps["4K"]
    first = inter_mc.mc_launch(zero_planes(c["dims"], dev), c["resid"],
                               c["refs"], c["tabs"], 8)
    for k in range(20):
        again = inter_mc.mc_launch(zero_planes(c["dims"], dev), c["resid"],
                                   c["refs"], c["tabs"], 8)
        check(all(torch.equal(a, b) for a, b in zip(again, first)),
              f"4K 6a run {k} differs from the first")
    print(f"4K inter frame {c['n']}: {c['tabs']['n_tiles']} tiles, "
          "20 runs of 6a bit-equal to the first")
    return err, e, caps


def check_inter_hbd(dev):
    """Phase 1: the uint16 6a on an inter frame of the 4K 10-bit stream,
    and the strip kernel on that frame's pred units in place on its MC
    planes, against their plain versions.  Returns (6a error, strip
    kernel error, the captured frame)."""
    c = capture_inter(HBD_4K, 2, dev)
    check(c["bd"] == 10 and c["refs"][0][0].dtype == torch.uint16,
          f"{HBD_4K}: bit depth {c['bd']}, refs {c['refs'][0][0].dtype}")
    c["tabs"] = inter_mc.upload(inter_mc.mc_tables(c["plan"]), dev)
    got = inter_mc.mc_launch(zero_planes(c["dims"], dev), c["resid"],
                             c["refs"], c["tabs"], 10)
    want = inter_mc.mc_units_plain(zero_planes(c["dims"], dev), c["resid"],
                                   c["refs"], c["plan"], 10)
    e_mc = max_err(got, want)
    e_strip = max_err(strip_inter(c), intra_strip.strip_exec_frame_plain(
        c["fields"], c["resid"], c["dims"], 10,
        [b.clone() for b in c["base"]], c["masks"]))
    print(f"4K 10-bit inter frame {c['n']}: {c['tabs']['n_tiles']} tiles, "
          f"uint16 6a max_abs_err {e_mc}; "
          f"{sum(f.shape[0] for f in c['fields'])} pred units, strip kernel "
          f"in place on the MC planes max_abs_err {e_strip}")
    check(e_mc == 0 and e_strip == 0,
          f"4K 10-bit inter frame: 6a {e_mc}, strip kernel {e_strip}")
    return e_mc, e_strip, c


HASH_DIMS = [[(1080, 1920), (540, 960), (540, 960)],     # 1080p 4:2:0
             [(67, 131), (34, 66), (34, 66)], [(1, 1)], [(3, 1031)],
             [(135, 241), (135, 241), (135, 241)]]


def check_hash(dev):
    """Phase 1: the frame hash kernel against its plain version and
    against `api.frame_hash` of the same planes on the host, on seeded
    uint8 and uint16 (10- and 12-bit) planes: whole tensors, and views
    that start off a 16-byte boundary with pitched rows; 20 runs on the
    1080p planes of each type bit-equal to the first.  Returns the largest
    difference between the kernel's hash and the plain version's
    (tolerance 0) for each sample type, {"uint8": e, "uint16": e}."""
    err = {"uint8": 0, "uint16": 0}
    rng = np.random.default_rng(77)
    for dims, dt, top in [(d, np.uint8, 256) for d in HASH_DIMS] + \
            [(d, np.uint16, 1024) for d in HASH_DIMS] + \
            [(HASH_DIMS[0], np.uint16, 4096)]:
        host = [rng.integers(0, top, d).astype(dt) for d in dims]
        planes = [torch.from_numpy(p).to(dev) for p in host]
        cases = [("whole", planes)]
        if dims[0][0] > 2 and dims[0][1] > 8:
            cases.append(("view", [t[1:, 3:-2] for t in planes]))
        for what, pl in cases:
            got = resident.hash_value(resident.frame_hash_device(pl))
            torch.cuda.synchronize()
            plain = resident.hash_value(resident.frame_hash_plain(pl))
            want = frame_hash([t.cpu().numpy() for t in pl])
            print(f"frame hash {dims[0][1]}x{dims[0][0]} x{len(dims)} "
                  f"{np.dtype(dt).name} {what}: "
                  f"kernel {got:#010x}, plain {plain:#010x}, host "
                  f"{want:#010x}")
            check(plain == want, "plain hash differs from api.frame_hash")
            err[np.dtype(dt).name] = max(err[np.dtype(dt).name],
                                         abs(got - plain))
        first = resident.hash_value(resident.frame_hash_device(planes))
        for k in range(20 if dims is HASH_DIMS[0] else 0):
            check(resident.hash_value(resident.frame_hash_device(planes))
                  == first, f"hash run {k} differs from the first")
    check(not any(err.values()),
          f"hash kernel vs plain differ by {err} (tolerance 0)")
    return err


def lr_case(w, h, seed):
    """A seeded loop-restoration frame at w x h, 4:2:0, 8 bits: (hdr,
    seq, plan, planes, deblocked) with switchable luma (Wiener,
    SGR and absent units interleaved), Wiener U and SGR
    V, 64-pixel units, in mi-padded int32 planes."""
    rng = np.random.default_rng(seed)
    plan = SimpleNamespace(lr_type={}, lr_wiener={}, lr_sgr={})

    def units(plane, pw, ph, kinds):
        for urow in range(max((ph + 32) // 64, 1)):
            for ucol in range(max((pw + 32) // 64, 1)):
                kind = kinds[(urow + ucol) % len(kinds)]
                key = (plane, urow, ucol)
                if kind:
                    plan.lr_type[key] = kind
                if kind == 2:
                    plan.lr_wiener[key] = [
                        [0 if plane else int(rng.integers(-5, 11)),
                         int(rng.integers(-23, 9)), int(rng.integers(-17, 47))]
                        for _ in range(2)]
                elif kind == 3:
                    plan.lr_sgr[key] = (int(rng.integers(0, 16)),
                                        int(rng.integers(-96, 32)),
                                        int(rng.integers(-32, 96)))

    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    units(0, w, h, (2, 3, 0))
    units(1, cw, ch, (2,))
    units(2, cw, ch, (3, 0))
    ns = SimpleNamespace
    hdr = ns(upscaled_width=w, frame_height=h, lr=ns(
        uses_lr=True, frame_restoration_type=[1, 2, 3],
        loop_restoration_size=[64, 64, 64]))
    seq = ns(color=ns(subsampling_x=1, subsampling_y=1, num_planes=3,
                      mono_chrome=False, bitdepth=8))
    ah, aw = (h + 7) & ~7, (w + 7) & ~7
    planes = [rng.integers(0, 256, d).astype(np.int32)
              for d in ((ah, aw), (ah >> 1, aw >> 1), (ah >> 1, aw >> 1))]
    debl = [np.clip(p + rng.integers(-2, 3, p.shape), 0, 255).astype(np.int32)
            for p in planes]
    return hdr, seq, plan, planes, debl


def grain_case(seed):
    """Film grain parameters shaped like libaom's denoiser's: several
    luma points, lag 3, both chroma planes, overlap."""
    rng = np.random.default_rng(seed)
    return FilmGrainParams(
        apply_grain=True, grain_seed=43962, num_y_points=6,
        point_y_value=[0, 40, 90, 140, 200, 255],
        point_y_scaling=[30, 45, 60, 55, 40, 20], num_cb_points=2,
        point_cb_value=[0, 255], point_cb_scaling=[20, 28], num_cr_points=2,
        point_cr_value=[0, 255], point_cr_scaling=[18, 30], grain_scaling=9,
        ar_coeff_lag=3, ar_coeffs_y=rng.integers(-20, 20, 24).tolist(),
        ar_coeffs_cb=rng.integers(-20, 20, 25).tolist(),
        ar_coeffs_cr=rng.integers(-20, 20, 25).tolist(), ar_coeff_shift=7,
        cb_mult=128, cb_luma_mult=192, cb_offset=256, cr_mult=134,
        cr_luma_mult=190, cr_offset=260, overlap_flag=True)


def check_torch_stages(dev):
    """Phase 1: the stages this slice ports as exact torch ops, on the
    card against the same functions on the CPU, tolerance 0, on seeded
    1080p inputs: the superres upscale (luma 1280 -> 1920 and its
    chroma, and an unaligned coded width), loop restoration over all
    three planes, film grain over all three planes.  Returns the inputs
    on the card, for the timings."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(5)
    sr = []
    for src_w, dst_w, aw in ((1280, 1920, 1280), (640, 960, 640),
                             (1181, 1920, 1184)):
        plane = torch.from_numpy(
            rng.integers(0, 256, (1080, aw)).astype(np.int32))
        got = sr_torch.upscale_plane(plane.to(dev), src_w, dst_w, 8)
        want = sr_torch.upscale_plane(plane, src_w, dst_w, 8)
        e = int((got.cpu() - want).abs().max())
        print(f"superres {src_w} -> {dst_w} (stored {aw}) x 1080 rows: card "
              f"vs CPU max_abs_err {e}")
        check(e == 0, "sr_torch differs between the card and the CPU")
        sr.append((plane.to(dev), src_w, dst_w))
    hdr, seq, plan, planes, debl = lr_case(1920, 1080, 6)
    lr = lr_torch.LoopRestoration(hdr, seq, plan, 8)

    def run_lr(device):
        return lr.apply([torch.from_numpy(p).to(device) for p in planes],
                        [torch.from_numpy(p).to(device) for p in debl])

    got, want = run_lr(dev), run_lr(cpu)
    e = max_err([g.cpu() for g in got], want)
    changed = sum(int((w != torch.from_numpy(p)).sum())
                  for w, p in zip(want, planes))
    print(f"loop restoration 1920x1080, {len(plan.lr_type)} units "
          f"({len(plan.lr_wiener)} Wiener, {len(plan.lr_sgr)} SGR), "
          f"{changed} pixels changed: card vs CPU max_abs_err {e}")
    check(e == 0 and changed > 0, "lr_torch differs between card and CPU")
    fgp = grain_case(7)
    u8 = [torch.from_numpy(rng.integers(0, 256, d).astype(np.uint8))
          for d in ((1080, 1920), (540, 960), (540, 960))]
    got = fg_torch.FilmGrain(fgp, seq, 8, dev).apply([t.to(dev) for t in u8])
    want = fg_torch.FilmGrain(fgp, seq, 8, cpu).apply(u8)
    e = max_err([g.cpu().int() for g in got], [w.int() for w in want])
    changed = sum(int((w != t).sum()) for w, t in zip(want, u8))
    print(f"film grain 1920x1080, {changed} pixels changed: card vs CPU "
          f"max_abs_err {e}")
    check(e == 0 and changed > 0, "fg_torch differs between card and CPU")
    return {"sr": sr, "lr": (lr, [torch.from_numpy(p).to(dev) for p in planes],
                             [torch.from_numpy(p).to(dev) for p in debl]),
            "fg": (fgp, seq, [t.to(dev) for t in u8])}


# name, path, frames shown, and the launches expected: the strip kernel
# once a decoded frame, 6a once an inter frame, 6b once a frame that has
# OBMC blocks
STREAMS = [("1080p intra", INTRA_1080, 30, (30, 0, 0)),
           ("1080p inter", INTER_1080, 60, (60, 59, 0)),
           ("4K", KEY_4K, 24, (24, 23, 0)),
           ("inter modes 96x96", MODES, 8, (8, 7, 7)),
           # loop restoration on every frame (Wiener and SGR),
           # deblocking on the inter frames, film grain on every frame
           ("1080p LR + grain", LR_GRAIN_1080, 8, (8, 7, 0)),
           ("LR mixed units 320x200",
            os.path.join(SMOKE, "lreal_mix_e8bf32ba.webm"), 1, (1, 0, 0)),
           ("LR inter 160x128",
            os.path.join(SMOKE, "lreal_interlr_863022fc.webm"), 4, (4, 3, 0)),
           ("film grain 160x128",
            os.path.join(SMOKE, "fgreal_7cdd830f.webm"), 2, (2, 0, 0)),
           ("superres + LR 88x64",
            os.path.join(SMOKE, "superres_lr_88x64.webm"), 3, (3, 0, 0)),
           ("superres + LR 1920x128",
            os.path.join(SMOKE, "superres_lr_1920x128.webm"), 3, (3, 0, 0)),
           # libaom streams whose pairs carry wedge and diffwtd masks (22
           # diffwtd blocks and 1 wedge; 4 and 2, and one hidden frame)
           ("masked compound 320x192",
            os.path.join(SMOKE, "comp_masked_320x192.webm"), 10, (10, 9, 0)),
           ("wedge compound 320x192",
            os.path.join(SMOKE, "comp_wedge_320x192.webm"), 12, (13, 12, 0))]
# the 10- and 12-bit streams: uint16 frames, the kernels' uint16
# instantiations
HBD_STREAMS = [("4K 10-bit", HBD_4K, 8, (8, 7, 0)),
               ("10-bit intra 96x96",
                os.path.join(SMOKE, "hbd_10i.webm"), 4, (4, 0, 0)),
               ("10-bit inter 96x96",
                os.path.join(SMOKE, "hbd_10p.webm"), 4, (4, 3, 0)),
               ("10-bit deblocking + CDEF 128x96",
                os.path.join(SMOKE, "hbd_10pf.webm"), 4, (4, 3, 0)),
               ("12-bit intra 96x96",
                os.path.join(SMOKE, "hbd_12i.webm"), 4, (4, 0, 0)),
               ("12-bit inter 96x96",
                os.path.join(SMOKE, "hbd_12p.webm"), 8, (8, 7, 0)),
               ("10-bit 4:4:4 96x96",
                os.path.join(SMOKE, "hbd_444x10.webm"), 4, (4, 3, 0)),
               ("10-bit film grain 160x128",
                os.path.join(SMOKE, "hbd_10fg.webm"), 3, (3, 2, 0)),
               ("12-bit film grain 160x128",
                os.path.join(SMOKE, "hbd_12fg.webm"), 3, (3, 2, 0)),
               # compound, OBMC and warps at 10 and 12 bits
               ("10-bit inter modes 96x96",
                os.path.join(SMOKE, "hbd_modes10_96x96.webm"), 8, (8, 7, 6)),
               ("12-bit inter modes 96x96",
                os.path.join(SMOKE, "hbd_modes12_96x96.webm"), 8, (8, 7, 6))]
# the resident decode runs at most this many frames of a stream
RESIDENT_FRAMES = 12


def main_path(streams):
    """Phase 2: the port's main path, hash-equal to native C, each
    stream with the launch counts set to 0 just before it and read just
    after; then the resident decode of the same stream, its device
    hashes against those of the frames pulled through the API, with the
    hash kernel's launches counted.  Returns the launches of each
    kernel over the streams."""
    total = dict.fromkeys(COUNTERS, 0)
    for name, path, n, want in streams:
        easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
        reset_counts()
        port, _ = decode_hashes(
            lambda: easyav1_tpu_torch.EasyAV1(path, device="cuda"))
        c = counts()
        stats = dict(easyav1_tpu_torch.stats)
        native_h, _ = decode_hashes(lambda: native_session(path))
        print(f"main path {name}: {len(port)} frames, stats {stats}, "
              f"launches {c}")
        check(len(port) == n and port == native_h,
              f"{name} hashes: {len(port)} frames, "
              f"{sum(a != b for a, b in zip(port, native_h))} differ")
        check(stats["fallbacks"] == 0 and stats["frames"] >= n,
              f"{name} stats {stats}")
        # a hidden frame is decoded and not shown: the strip kernel's
        # launches count the decoded frames
        check(stats["frames"] == want[0]
              and tuple(c.values()) == want + (0,),
              f"{name}: launches {c}, want {want} (strip, 6a, 6b)")
        for k in total:
            total[k] += c[k]
        easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
        reset_counts()
        m = min(n, RESIDENT_FRAMES)
        got_n, wall, hashes, frames = resident.decode_resident(
            path, "cuda", max_frames=m)
        c = counts()
        lazy = [f.data.materialised for f in frames]
        print(f"resident {name}: {got_n} frames in {wall:.3f} s, "
              f"hash launches {c['frame_hash']}, planes downloaded "
              f"{sum(lazy)}, stats {dict(easyav1_tpu_torch.stats)}")
        check(got_n == m and hashes == port[:m],
              f"resident {name}: {got_n} frames, "
              f"{sum(a != b for a, b in zip(hashes, port))} hashes differ")
        check(c["frame_hash"] == m and not any(lazy)
              and easyav1_tpu_torch.stats["fallbacks"] == 0,
              f"resident {name}: launches {c}, downloaded {sum(lazy)}")
        check(frame_hash(frames[-1].data) == port[m - 1],
              f"resident {name}: the last frame's planes, pulled, differ")
        total["frame_hash"] += c["frame_hash"]
    return total


def timings(frames, dev):
    """Phase 3: every time of the kernels line, from this run."""
    out = {}
    for name, fr in frames.items():
        wave = cuda_ms(lambda: fr.run(fr.wavefront), 20)
        seq = cuda_ms(lambda: fr.run(fr.sequential), 5)
        bound, nbytes, by = fr.bound_ms()
        out[name] = {"wavefront_ms": wave, "sequential_ms": seq,
                     "bound_ms": bound, "bound_by": by}
        print(f"{name} frame 0 strip kernel: wavefront {wave:.3f} ms, "
              f"sequential schedule {seq:.3f} ms ({seq / wave:.2f}x), "
              f"bound {bound * 1e3:.3f} us ({nbytes / 1e6:.2f} MB)")
    fr = frames["1080p"]
    out["plain_ms"] = cuda_ms(fr.plain, 2)
    print(f"1080p frame 0 plain version {out['plain_ms']:.3f} ms")
    key = fr.key
    planes = fr.run(fr.wavefront)
    pf_args = (key["hdr"], key["seq"], [tuple(p.shape) for p in planes],
               *key["maps"], dev)

    def maps():
        m = postfilter_maps(*pf_args)
        torch.cuda.synchronize()
        return m

    m = maps()
    t0 = time.perf_counter()
    for _ in range(10):
        maps()
    maps_ms = (time.perf_counter() - t0) * 100
    apply_ms = cuda_ms(lambda: postfilter_apply(planes, m), 10)
    print(f"1080p frame 0 LF + CDEF: host maps + upload {maps_ms:.3f} ms "
          f"(host clock), device filters {apply_ms:.3f} ms (CUDA events)")
    _, port_s = decode_hashes(
        lambda: easyav1_tpu_torch.EasyAV1(INTRA_1080, device="cuda"))
    _, native_s = decode_hashes(lambda: native_session(INTRA_1080))
    print(f"1080p intra 30 frames: port {30 / port_s:.3f} fps, "
          f"native C session {30 / native_s:.3f} fps (this host)")
    return out


def covered(shape, y0, x0, y1, x1):
    """How many pixels of an [h, w] plane at least one of the rects
    [y0, y1) x [x0, x1) covers, each rect clipped to the plane."""
    h, w = shape
    y0, y1 = np.clip(y0, 0, h), np.clip(y1, 0, h)
    x0, x1 = np.clip(x0, 0, w), np.clip(x1, 0, w)
    k = (y1 > y0) & (x1 > x0)
    d = np.zeros((h + 1, w + 1), np.int32)
    for ys, xs, s in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        np.add.at(d, (ys[k], xs[k]), s)
    return int((d.cumsum(0).cumsum(1) > 0).sum())


class Footprint:
    """The bytes a kernel must move on this run's data: the pixels that
    its units read or write, each pixel counted once per plane however
    many units touch it, times the bytes it moves per pixel."""

    def __init__(self):
        self.rects = {}

    def add(self, key, shape, size, y0, x0, y1, x1):
        r = self.rects.setdefault(key, (shape, size, []))
        r[2].append(np.stack([np.asarray(a, np.int64).ravel()
                              for a in (y0, x0, y1, x1)]))

    def out(self, key, shape, size, f, xcol, ycol, w, h, keep=None):
        """The output rects of units f at (f[:, xcol], f[:, ycol])."""
        if keep is not None:
            f = f[keep]
        self.add(key, shape, size, f[:, ycol], f[:, xcol], f[:, ycol] + h,
                 f[:, xcol] + w)

    def window(self, p, refs, f, slot, y0, x0, y1, x1):
        """Reference windows [y0, y1) x [x0, x1) of units f, clamped to
        the edge of each unit's slot as the kernels clamp them; a
        reference pixel is its sample's bytes (1, or 2 above 8 bits)."""
        for s in np.unique(f[:, slot]):
            rh, rw = refs[p][s].shape
            k = f[:, slot] == s
            self.add(("ref", p, int(s)), (rh, rw), refs[p][s].element_size(),
                     np.clip(y0[k], 0, rh - 1), np.clip(x0[k], 0, rw - 1),
                     np.clip(y1[k] - 1, 0, rh - 1) + 1,
                     np.clip(x1[k] - 1, 0, rw - 1) + 1)

    def taps(self, p, refs, f, b_slot, b_ix, b_iy, b_fh, b_fv, w, h):
        """The windows of 8-tap units: only the rows and columns of
        their live (nonzero) taps, so a whole-pixel motion reads w x h."""
        def live(taps):
            nz = taps != 0
            return nz.argmax(1), 7 - nz[:, ::-1].argmax(1)

        r0, r1 = live(f[:, b_fv:b_fv + 8])
        c0, c1 = live(f[:, b_fh:b_fh + 8])
        iy, ix = f[:, b_iy], f[:, b_ix]
        self.window(p, refs, f, b_slot, iy - 3 + r0, ix - 3 + c0,
                    iy - 3 + r1 + h, ix - 3 + c1 + w)

    def nbytes(self):
        return sum(size * covered(shape, *np.concatenate(parts, 1))
                   for shape, size, parts in self.rects.values())


def _bound(nbytes, ops):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def _taps_ops(h):
    """Integer operations a pixel of an 8-tap unit of height h: the
    across pass over its window rows, the down pass, the roundings."""
    return 16 * (1 + 7 / min(h, inter_mc.TILE)) + 16


def mc_bound(plan, refs, dims):
    """(ms, bound_by) of the least time for 6a's work on one frame: its
    tables read once, the reference pixels its units' windows cover
    read once (1 byte each, 2 above 8 bits), the residual under the units that add it
    read once (2 bytes a pixel) and the int32 pixels the units write
    written once, at the HBM rate; against the integer operations of
    its units (8-tap across and down, rounding, residual, clip; pairs
    twice and a blend; warps 15 x 8 and 8 x 8 eight-tap sums)."""
    fp = Footprint()
    for (p, w, h), f in plan["singles"].items():
        v = f[:, S_VALID] != 0
        fp.out(("out", p), dims[p], 4, f, S_X, S_Y, w, h, v)
        fp.out(("resid", p), dims[p], 2, f, S_X, S_Y, w, h,
               v & (f[:, S_NORES] == 0))
        fp.taps(p, refs, f[v], S_SLOT, S_IX, S_IY, S_FH, S_FV, w, h)
    for (p, w, h), f in plan["pairs"].items():
        v = f[:, P_VALID] != 0
        for key, size in ((("out", p), 4), (("resid", p), 2)):
            fp.out(key, dims[p], size, f, P_X, P_Y, w, h, v)
        for b in (P_PRED0, P_PRED1):
            fp.taps(p, refs, f[v], b, b + 1, b + 2, b + 3, b + 11, w, h)
    for p, f in plan["warps"].items():
        f = f[f[:, W_VALID] != 0]
        for key, size in ((("out", p), 4), (("resid", p), 2)):
            fp.out(key, dims[p], size, f, W_X, W_Y, 8, 8)
        fp.window(p, refs, f, W_SLOT, f[:, W_IY4] - 7, f[:, W_IX4] - 7,
                  f[:, W_IY4] + 8, f[:, W_IX4] + 8)
    nbytes = fp.nbytes() + inter_mc.mc_tables(plan)["buf"].nbytes
    ops = sum(f.shape[0] * w * h * (_taps_ops(h) + 4)
              for (_p, w, h), f in plan["singles"].items())
    ops += sum(f.shape[0] * w * h * (2 * _taps_ops(h) + 10)
               for (_p, w, h), f in plan["pairs"].items())
    ops += sum(f.shape[0] * (15 * 8 * 16 + 64 * 20)
               for f in plan["warps"].values())
    return _bound(nbytes, ops)


def obmc_bound(plan, refs, dims):
    """(ms, bound_by) of the least time for 6b's work, from the
    plan's own rects: its tables read once, the int32 pixels of the
    overlay and OBMC block rects read once and written once (8 bytes a
    pixel), the residual under the OBMC blocks read once (2 bytes a
    pixel) and the reference pixels of the overlays' windows read once;
    against the overlays' 8-tap sums and blends and the residual
    adds."""
    fp = Footprint()
    for d in ("obmc_above", "obmc_left"):
        for (p, w, h), f in plan[d].items():
            f = f[f[:, S_VALID] != 0]
            fp.out(("plane", p), dims[p], 8, f, S_X, S_Y, w, h)
            fp.taps(p, refs, f, S_SLOT, S_IX, S_IY, S_FH, S_FV, w, h)
    for (p, w, h), f in plan["obmc_resid"].items():
        fp.out(("plane", p), dims[p], 8, f, 0, 1, w, h)
        fp.out(("resid", p), dims[p], 2, f, 0, 1, w, h)
    nbytes = fp.nbytes() + inter_mc.obmc_tables(plan)["buf"].nbytes
    ops = sum(f.shape[0] * w * h * (_taps_ops(h) + 8)
              for d in ("obmc_above", "obmc_left")
              for (_p, w, h), f in plan[d].items())
    ops += sum(f.shape[0] * w * h * 3
               for (_p, w, h), f in plan["obmc_resid"].items())
    return _bound(nbytes, ops)


def strip_inter_bound(c):
    """(ms, bound_by) of the least time for the strip kernel's work on a
    captured inter frame's pred units, in place on its MC planes: the
    records, the schedule and the interintra masks read once; under each
    unit the residual read once (2 bytes a pixel) and the int32 pixels
    written once, its 2 (w + h) + 1 edge pixels read once, and an
    interintra unit's base pixels read once; against 3 integer
    operations a pixel."""
    nbytes = c["schedule"][2].numel() * 4
    pix = 0
    for f, m in zip(c["fields"], c["masks"]):
        f = f.cpu().numpy()
        w, h = f[:, F_W].astype(np.int64), f[:, F_H].astype(np.int64)
        nbytes += f.nbytes + (0 if m is None else m.numel() * 4)
        nbytes += int((w * h * (6 + 4 * (f[:, F_RES] != 0))
                       + 4 * (2 * (w + h) + 1)).sum())
        pix += int((w * h).sum())
    return _bound(nbytes, 3 * pix)


def inter_timings(caps, prog, dev):
    """Phase 3: 6a on the captured 1080p and 4K inter frames and 6b on a
    random 1080p OBMC program (CUDA events), their plain versions, the
    stages of the 1080p inter stream, and the port's fps beside the
    native C session's on it."""
    out = {}
    for name, c in caps.items():
        planes = zero_planes(c["dims"], dev)
        ms = cuda_ms(lambda: inter_mc.mc_launch(planes, c["resid"], c["refs"],
                                                c["tabs"], 8), 20)
        bound, by = mc_bound(c["plan"], c["refs"], c["dims"])
        out[name] = {"ms": ms, "bound_ms": bound, "bound_by": by}
        print(f"{name} inter frame {c['n']} MC (6a): {ms:.4f} ms, "
              f"{c['tabs']['n_tiles']} tiles, bound {bound:.4f} ms "
              f"({by})")
    c = caps["1080p"]
    planes = [b.clone() for b in c["base"]]
    out["strip_ms"] = cuda_ms(lambda: strip_inter(c, planes), 20)
    bound, by = strip_inter_bound(c)
    print(f"1080p inter frame {c['n']} strip kernel on its "
          f"{sum(f.shape[0] for f in c['fields'])} pred units: "
          f"{out['strip_ms']:.4f} ms, bound {bound * 1e3:.4f} us ({by})")
    parts = dict.fromkeys(("zero planes", "tables", "upload",
                           "launch and wait"), 0.0)
    for _ in range(10):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        planes = zero_planes(c["dims"], dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        tabs = inter_mc.mc_tables(c["plan"], pinned=True)
        t.append(time.perf_counter())
        tabs = inter_mc.upload(tabs, dev)
        t.append(time.perf_counter())
        inter_mc.mc_launch(planes, c["resid"], c["refs"], tabs, 8)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, name in enumerate(parts):
            parts[name] += (t[k + 1] - t[k]) * 100
    print(f"1080p inter frame {c['n']} MC stage parts (ms, host clock, mean "
          "of 10): " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    out["mc_plain_ms"] = cuda_ms(lambda: inter_mc.mc_units_plain(
        zero_planes(c["dims"], dev), c["resid"], c["refs"], c["plan"], 8), 2)
    print(f"1080p inter frame {c['n']} MC plain version "
          f"{out['mc_plain_ms']:.3f} ms")
    resid, refs = mc_inputs(prog, dev)
    plan = prog["plan"]
    tabs = inter_mc.upload(inter_mc.obmc_tables(plan), dev)
    planes = zero_planes(prog["dims"], dev)
    ms = cuda_ms(lambda: inter_mc.obmc_launch(planes, resid, refs, tabs, 8),
                 20)
    plain = cuda_ms(lambda: inter_mc.obmc_plain(planes, resid, refs, plan,
                                                8), 2)
    bound, by = obmc_bound(plan, refs, prog["dims"])
    out["obmc"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                   "bound_by": by}
    print(f"random 1080p OBMC program, 6b's one launch over "
          f"{tabs['n_tiles']} tiles: "
          f"{ms:.4f} ms, plain version {plain:.3f} ms, bound {bound:.4f} ms "
          f"({by})")
    pipe.stage_log = []
    try:
        decode_hashes(lambda: easyav1_tpu_torch.EasyAV1(INTER_1080,
                                                        device="cuda"))
        log = [d for d in pipe.stage_log if "mc" in d]
    finally:
        pipe.stage_log = None
    stages = ("entropy", "plan", "prepare", "upload", "mc", "intra",
              "lf_cdef", "tail")
    med = {k: sorted(d[k] for d in log)[len(log) // 2] * 1e3 for k in stages}
    print(f"1080p inter stream stages (ms, host clock, device synchronised "
          f"at each stage's end), frame 1: "
          + ", ".join(f"{k} {log[0][k] * 1e3:.3f}" for k in stages))
    print(f"  median over its {len(log)} inter frames: "
          + ", ".join(f"{k} {med[k]:.3f}" for k in stages)
          + f"; total {sum(med.values()):.3f}")
    _, port_s = decode_hashes(
        lambda: easyav1_tpu_torch.EasyAV1(INTER_1080, device="cuda"))
    _, native_s = decode_hashes(lambda: native_session(INTER_1080))
    print(f"1080p inter 60 frames: port {60 / port_s:.3f} fps, "
          f"native C session {60 / native_s:.3f} fps (this host)")
    return out


def hash_timings(dev):
    """Phase 3: the hash kernel on a decoded 1080p 4:2:0 frame's uint8
    planes, its plain version right after it (both timed back to back by
    `cuda_ms`), and its bound: the frame's bytes read once and one word
    written, at the HBM rate, against two multiply-adds a pixel."""
    _, _, _, frames = resident.decode_resident(LR_GRAIN_1080, "cuda",
                                               max_frames=1)
    planes = frames[0].data.device_planes
    check([tuple(p.shape) for p in planes]
          == [(1080, 1920), (540, 960), (540, 960)], "1080p planes")
    got = resident.hash_value(resident.frame_hash_device(planes))
    check(got == resident.hash_value(resident.frame_hash_plain(planes))
          == frame_hash(frames[0].data),
          "hash of a decoded 1080p frame: kernel, plain and host differ")
    ms = cuda_ms(lambda: resident.frame_hash_device(planes), 50)
    plain = cuda_ms(lambda: resident.frame_hash_plain(planes), 10)
    nbytes = sum(p.numel() for p in planes) + 4
    bound, by = _bound(nbytes, 4 * (nbytes - 4))
    print(f"frame hash of a 1080p frame ({nbytes / 1e6:.2f} MB): kernel "
          f"{ms:.4f} ms, plain version {plain:.4f} ms, bound "
          f"{bound * 1e3:.4f} us ({by})")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by}


def stage_timings(inp, dev):
    """Phase 3: the torch-ops stages of this slice on the card, on the
    seeded 1080p inputs of `check_torch_stages` (CUDA events, back to
    back), and on the 1080p loop-restoration and grain stream the stage
    medians, the port's fps, the native C session's and the resident
    decode's."""
    plane, src_w, dst_w = inp["sr"][0]
    chroma = inp["sr"][1]
    sr_ms = cuda_ms(lambda: (sr_torch.upscale_plane(plane, src_w, dst_w, 8),
                             sr_torch.upscale_plane(*chroma, 8),
                             sr_torch.upscale_plane(*chroma, 8)), 10)
    lr, planes, debl = inp["lr"]
    lr_ms = cuda_ms(lambda: lr.apply(planes, debl), 5)
    fgp, seq, u8 = inp["fg"]
    t0 = time.perf_counter()
    fg = fg_torch.FilmGrain(fgp, seq, 8, dev)
    torch.cuda.synchronize()
    fg_host_ms = (time.perf_counter() - t0) * 1e3
    fg_ms = cuda_ms(lambda: fg.apply(u8), 5)
    print(f"torch-ops stages on seeded 1080p 4:2:0 planes (CUDA events): "
          f"superres 1280 -> 1920 of three planes {sr_ms:.3f} ms, loop "
          f"restoration of three planes {lr_ms:.3f} ms, film grain of three "
          f"planes {fg_ms:.3f} ms after {fg_host_ms:.3f} ms of host "
          f"templates and LUTs (host clock)")
    # byte bounds: each plane the stage reads read once, each plane it
    # writes written once (superres: int32 in and out, at the output
    # width; LR: the planes and the deblocked snapshot in, int32 out;
    # grain: the uint8 planes in and out)
    sr_bytes = sum(p.shape[0] * (p.shape[1] + dw) * 4
                   for p, _sw, dw in (inp["sr"][0], chroma, chroma))
    lr_bytes = sum(3 * p.numel() * 4 for p in planes)
    fg_bytes = sum(2 * t.numel() for t in u8)
    for name, nbytes in (("superres", sr_bytes), ("loop restoration",
                                                  lr_bytes),
                         ("film grain", fg_bytes)):
        print(f"  {name}: {nbytes / 1e6:.3f} MB, byte bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e6:.3f} us")
    pipe.stage_log = []
    try:
        decode_hashes(lambda: easyav1_tpu_torch.EasyAV1(LR_GRAIN_1080,
                                                        device="cuda"))
        log = [d for d in pipe.stage_log if "mc" in d]
        key = pipe.stage_log[0]
    finally:
        pipe.stage_log = None
    stages = ("entropy", "plan", "prepare", "upload", "mc", "intra",
              "lf_cdef", "sr", "lr", "tail", "grain")
    med = {k: sorted(d.get(k, 0.0) for d in log)[len(log) // 2] * 1e3
           for k in stages}
    print("1080p LR + grain stream stages (ms, host clock, device "
          "synchronised at each stage's end), key frame: "
          + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in key.items()))
    print(f"  median over its {len(log)} inter frames: "
          + ", ".join(f"{k} {med[k]:.3f}" for k in stages)
          + f"; total {sum(med.values()):.3f}")
    pipe.stage_log = []
    try:
        decode_hashes(lambda: easyav1_tpu_torch.EasyAV1(
            os.path.join(SMOKE, "superres_lr_1920x128.webm"), device="cuda"))
        log = list(pipe.stage_log)
    finally:
        pipe.stage_log = None
    print("superres + LR 1920x128 key frames, stages of the last (ms): "
          + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in log[-1].items()))
    _, port_s = decode_hashes(
        lambda: easyav1_tpu_torch.EasyAV1(LR_GRAIN_1080, device="cuda"))
    _, native_s = decode_hashes(lambda: native_session(LR_GRAIN_1080))
    _, res_s, _, _ = resident.decode_resident(LR_GRAIN_1080, "cuda")
    print(f"1080p LR + grain 8 frames: port {8 / port_s:.3f} fps, resident "
          f"decode {8 / res_s:.3f} fps, native C session "
          f"{8 / native_s:.3f} fps (this host)")


def hbd_timings(key, c, prog, dev):
    """Phase 3: the 10- and 12-bit instantiations, back to back (CUDA
    events), beside their bounds and plain versions: the strip kernel on
    the 4K 10-bit key frame (wavefront; the kernels line's entry, with
    the plain time of phase 1) and on the pred units of its inter frame
    `c`, the uint16 6a on that
    frame, the uint16 6b on the random 10-bit 1080p program `prog`, the
    hash kernel on a 4K 10-bit frame's uint16 planes; then the stages of
    the 4K 10-bit stream's inter frames and its port, resident and native
    fps."""
    out = {}
    wave = cuda_ms(lambda: key.run(key.wavefront), 10)
    bound, nbytes, by = key.bound_ms()
    out["strip"] = {"ms": wave, "plain_ms": key.plain_ms, "bound_ms": bound,
                    "bound_by": by}
    print(f"4K 10-bit key frame strip kernel ("
          f"{sum(f.shape[0] for f in key.fields)} units): wavefront "
          f"{wave:.3f} ms, plain version {key.plain_ms:.1f} ms, bound "
          f"{bound * 1e3:.3f} us ({nbytes / 1e6:.2f} MB, {by})")
    planes = [b.clone() for b in c["base"]]
    ms = cuda_ms(lambda: strip_inter(c, planes), 20)
    plain = cuda_ms(lambda: intra_strip.strip_exec_frame_plain(
        c["fields"], c["resid"], c["dims"], 10,
        [b.clone() for b in c["base"]], c["masks"]), 2)
    bound, by = strip_inter_bound(c)
    print(f"4K 10-bit inter frame {c['n']} strip kernel on its "
          f"{sum(f.shape[0] for f in c['fields'])} pred units: {ms:.4f} ms, "
          f"plain version {plain:.3f} ms, bound {bound * 1e3:.4f} us ({by})")
    planes = zero_planes(c["dims"], dev)
    ms = cuda_ms(lambda: inter_mc.mc_launch(planes, c["resid"], c["refs"],
                                            c["tabs"], 10), 20)
    plain = cuda_ms(lambda: inter_mc.mc_units_plain(
        zero_planes(c["dims"], dev), c["resid"], c["refs"], c["plan"], 10), 2)
    bound, by = mc_bound(c["plan"], c["refs"], c["dims"])
    out["mc"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                 "bound_by": by}
    print(f"4K 10-bit inter frame {c['n']} MC (uint16 6a): {ms:.4f} ms, "
          f"{c['tabs']['n_tiles']} tiles, plain version {plain:.3f} ms, "
          f"bound {bound:.4f} ms ({by})")
    resid, refs = mc_inputs(prog, dev)
    bd, plan = prog["bd"], prog["plan"]
    tabs = inter_mc.upload(inter_mc.obmc_tables(plan), dev)
    planes = zero_planes(prog["dims"], dev)
    ms = cuda_ms(lambda: inter_mc.obmc_launch(planes, resid, refs, tabs, bd),
                 20)
    plain = cuda_ms(lambda: inter_mc.obmc_plain(planes, resid, refs, plan,
                                                bd), 2)
    bound, by = obmc_bound(plan, refs, prog["dims"])
    out["obmc"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                   "bound_by": by}
    print(f"random 1080p {bd}-bit OBMC program, uint16 6b over "
          f"{tabs['n_tiles']} tiles: {ms:.4f} ms, plain version "
          f"{plain:.3f} ms, bound {bound:.4f} ms ({by})")
    _, _, _, frames = resident.decode_resident(HBD_4K, "cuda", max_frames=1)
    planes = frames[0].data.device_planes
    check([(tuple(p.shape), p.dtype) for p in planes]
          == [((2160, 3840), torch.uint16)] + [((1080, 1920), torch.uint16)]
          * 2, "4K 10-bit planes")
    check(resident.hash_value(resident.frame_hash_device(planes))
          == resident.hash_value(resident.frame_hash_plain(planes))
          == frame_hash(frames[0].data),
          "hash of a 4K 10-bit frame: kernel, plain and host differ")
    ms = cuda_ms(lambda: resident.frame_hash_device(planes), 50)
    plain = cuda_ms(lambda: resident.frame_hash_plain(planes), 5)
    nbytes = sum(p.numel() * 2 for p in planes) + 4
    bound, by = _bound(nbytes, 4 * (nbytes - 4) // 2)
    out["hash"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                   "bound_by": by}
    print(f"frame hash of a 4K 10-bit frame ({nbytes / 1e6:.2f} MB): kernel "
          f"{ms:.4f} ms, plain version {plain:.4f} ms, bound "
          f"{bound * 1e3:.4f} us ({by})")
    pipe.stage_log = []
    try:
        decode_hashes(lambda: easyav1_tpu_torch.EasyAV1(HBD_4K, device="cuda"))
        log = [d for d in pipe.stage_log if "mc" in d]
        key_log = pipe.stage_log[0]
    finally:
        pipe.stage_log = None
    stages = ("entropy", "plan", "prepare", "upload", "mc", "intra",
              "lf_cdef", "lr", "tail")
    med = {k: sorted(d.get(k, 0.0) for d in log)[len(log) // 2] * 1e3
           for k in stages}
    print("4K 10-bit stream stages (ms, host clock, device synchronised at "
          "each stage's end), key frame: "
          + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in key_log.items()))
    print(f"  median over its {len(log)} inter frames: "
          + ", ".join(f"{k} {med[k]:.3f}" for k in stages)
          + f"; total {sum(med.values()):.3f}")
    _, port_s = decode_hashes(
        lambda: easyav1_tpu_torch.EasyAV1(HBD_4K, device="cuda"))
    _, native_s = decode_hashes(lambda: native_session(HBD_4K))
    _, res_s, _, _ = resident.decode_resident(HBD_4K, "cuda")
    print(f"4K 10-bit 8 frames: port {8 / port_s:.3f} fps, resident decode "
          f"{8 / res_s:.3f} fps, native C session {8 / native_s:.3f} fps "
          f"(this host)")
    return out


def kernel_entry(name, source, replaces, launches, err, t):
    """One entry of the kernels line; t: {"ms", "plain_ms", "bound_ms",
    "bound_by"} from this run."""
    return {"name": name, "route": "cuda",
            "source": f"easyav1_tpu_torch/csrc/{source}",
            "replaces": f"easyav1_tpu/video/av1/recon/{replaces}",
            "launches": launches, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None}


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
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    build()
    err, frames = check_kernel(dev)
    err = max(err, check_scan_units(dev))
    err_hbd, hbd_key = check_kernel_hbd(dev)
    err_mc, err_obmc, prog = check_mc(dev)
    err_mc16, err_obmc16, prog16 = check_mc(dev, MC_PROGRAMS_16)
    err_frame, err_strip, caps = check_inter_frames(dev)
    err = max(err, err_strip)
    err_frame16, err_strip16, cap16 = check_inter_hbd(dev)
    err_hbd = max(err_hbd, err_strip16)
    err_hash = check_hash(dev)
    stage_inputs = check_torch_stages(dev)
    # the main path: the 8-bit streams, then the 10- and 12-bit ones (the
    # kernels' uint16 instantiations); each stream's counts are set to 0
    # just before it and read just after
    launches = main_path(STREAMS)
    check(all(v > 0 for v in launches.values()),
          f"a kernel never ran on the 8-bit streams: {launches}")
    launches16 = main_path(HBD_STREAMS)
    check(all(v > 0 for v in launches16.values()),
          f"a kernel never ran on the 10- and 12-bit streams: {launches16}")
    print(f"main path launches: 8-bit streams {launches}, 10- and 12-bit "
          f"streams {launches16}")
    t = timings(frames, dev)
    ti = inter_timings(caps, prog, dev)
    th = hash_timings(dev)
    stage_timings(stage_inputs, dev)
    t16 = hbd_timings(hbd_key, cap16, prog16, dev)
    strip = dict(t["1080p"], ms=t["1080p"]["wavefront_ms"],
                 plain_ms=t["plain_ms"])
    mc = dict(ti["1080p"], plain_ms=ti["mc_plain_ms"])
    print(json.dumps({"kernels": [
        kernel_entry("intra_strip", "intra_strip.cu", "intra_pallas.py:66",
                     launches["intra_strip"], err, strip),
        kernel_entry("inter_mc", "inter_mc.cu", "mc_jax.py:636",
                     launches["inter_mc"], max(err_mc, err_frame), mc),
        kernel_entry("obmc", "inter_mc.cu", "mc_jax.py:681",
                     launches["obmc"], err_obmc, ti["obmc"]),
        kernel_entry("frame_hash", "frame_hash.cu", "resident.py:31",
                     launches["frame_hash"], err_hash["uint8"], th),
        kernel_entry("intra_strip_hbd", "intra_strip.cu",
                     "intra_pallas.py:66", launches16["intra_strip"],
                     err_hbd, t16["strip"]),
        kernel_entry("inter_mc_u16", "inter_mc.cu", "mc_jax.py:636",
                     launches16["inter_mc"], max(err_mc16, err_frame16),
                     t16["mc"]),
        kernel_entry("obmc_u16", "inter_mc.cu", "mc_jax.py:681",
                     launches16["obmc"], err_obmc16, t16["obmc"]),
        kernel_entry("frame_hash_u16", "frame_hash.cu", "resident.py:31",
                     launches16["frame_hash"], err_hash["uint16"],
                     t16["hash"])]}))
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.split(".")[0] == "easyav1_tpu")
    check(not leaked, f"imported {leaked}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
