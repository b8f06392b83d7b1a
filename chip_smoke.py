"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's libraries from the checkout at first use, all at
once: the C decoder (gcc, `easyav1_tpu_torch/native`), the C ABI's
library and its client executable (gcc, `easyav1_tpu_torch/capi`) and
the CUDA kernels (nvcc, `easyav1_tpu_torch/csrc/intra_strip.cu`,
`csrc/inter_mc.cu`, `csrc/frame_hash.cu`, `csrc/itx.cu`,
`csrc/loopfilter.cu`, `csrc/cdef.cu`, `csrc/lr.cu` and `csrc/fg.cu`,
whose ptxas reports it prints).
Then:

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
   against its plain version and `api.frame_hash`; the superres
   upscale's torch ops on the card against the same functions on the
   CPU, and the film grain kernel against its plain version on the card
   and on the CPU, on seeded 1080p inputs (grain also with the 1080p
   grain bench stream's two parameter sets); loop restoration
   (`csrc/lr.cu`, every plane, one launch a frame) against
   `LoopRestoration.apply_plain` on the card on seeded 1920x1080 8-bit
   and 3840x2160 10-bit frames (`unit_programs.random_lr_case`: Wiener,
   SGR and absent units), 1080p also against the plain version on the
   CPU, with 10 runs of each bit-equal to the first; and the 10-
   and 12-bit instantiations: 6a and 6b on uint16 references of seeded
   random 10- and 12-bit MC programs at 1080p and at an odd size, with
   20 runs of each bit-equal to the first, the strip kernel on random
   programs at 10 and 12 bits, on the key frames of three small 10- and
   12-bit streams and in place on a 4K 10-bit inter frame's pred units
   (the uint16 6a on that frame too), and on the 4K 10-bit key frame
   under the wavefront, with 5 more runs bit-equal to the first; the
   device residual composer (`csrc/itx.cu`) on packed records
   (`records.pack_coeff_rows`) against `compose_residual_packed_plain`:
   seeded random transform programs at 8, 10 and 12 bits with every
   legal (tx_size, tx_type) pair, at 1080p 4:2:0 and at an odd 4:4:4
   size, a DC-heavy program and one of 4x4 and 8x8 transforms only, and
   the records of the 1080p intra and 4K 10-bit key frames (also against
   the host C composer), with 20 runs of the 4K 10-bit one bit-equal to
   the first; the deblocking of a frame (`csrc/loopfilter.cu`, every
   plane, both directions, one launch), the CDEF direction search and
   the CDEF filter (`csrc/cdef.cu`, every plane, one launch) against
   `lf_torch.lf_frame_plain`, `cdef_torch.find_dirs` and
   `filter_planes` on the card, each on the same inputs, exactly: seeded
   planes and maps (`unit_programs.random_postfilter_case`: every
   filter length, hev on and off, overlapping edges) at 8, 10 and 12
   bits at 1080p 4:2:0 and at an odd size whose CDEF unit grid
   overhangs, with the decoder's cell maps and with one map row a pixel
   line, with a stream axis of 8 (a damping a stream) at 8 and 12 bits,
   the 1080p key frame of
   bench_av1_intra_lf_1920x1080_8.webm (deblocking on) and the 4K 10-bit
   key frame, with 20 runs of each kernel on the 1080p key frame
   bit-equal to the first;
2. drives the port's main path through `easyav1_tpu_torch.EasyAV1(path,
   device="cuda")`, each stream's launch counts read just before it and
   just after: all 30 frames of
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
   and the launches as expected: one strip launch a frame that has pred
   units (none for a frame without: 2 of the 1080p inter stream's 60),
   one of 6a an inter frame, one of 6b a frame with OBMC blocks, and the
   LF + CDEF kernels as each frame's header asks (`pf_launches`: one
   deblocking launch when a plane deblocks, one direction search and one
   CDEF filter when CDEF is on), and one loop-restoration launch a frame
   whose restoration restores a plane (`lr_restores`).  Then
   `decode_resident` on every stream (at most RESIDENT_FRAMES frames of
   each): its device hashes equal `api.frame_hash` of the same frames
   pulled through the API, no plane is downloaded, and the hash kernel
   launches once a frame; then the main path again with the device
   residual composer (`host_residual=False`) on the 1080p intra and
   inter streams, the 4K 10-bit stream, inter_modes_96x96, hbd_12p and
   hbd_444x10, each with its own counts: hash-equal to the native C
   session, no fallback, one device composer launch a frame that has
   transforms; then the C ABI
   (`easyav1_tpu_torch/capi`, `check_capi`): its library loaded into
   this process decodes every frame of the three bench streams and of
   inter_modes_96x96 through `easyav1_decode_next` and
   `easyav1_get_video_frame` on the card, each stream with its own
   counts, hash-equal to the native C session with no fallback and the
   main path's launches, and the 4K 10-bit stream again under
   `EASYAV1_HOST_RESID=0` with one device composer launch a frame that
   has transforms; its client executable, in a process of its own,
   decodes the 1080p inter stream with per-frame hashes computed in C
   equal and its status FINISHED; and under `EASYAV1_PIPE=device` the
   postfilter pipe (C recon, then LF, CDEF and LR on the card) decodes
   the 1080p LR + grain stream, bench_av1_intra_lf_1920x1080_8.webm,
   the 4K 10-bit stream and superres_lr_1920x128 hash-equal, with the
   superres frames, and only those, on the C path, no recon kernel
   launched and the LF + CDEF and LR kernels as the headers ask; with
   the fps of one
   pass each through the C ABI and the client, and the postfilter
   pipe's stages (phase 3 sets the C ABI's fps beside the Python API's
   and the native C session's);
3. times, in this run (CUDA events for kernels, the port's spans for
   the stages: host time, the device not synchronised): the strip
   kernel under the wavefront and the sequential schedule at 1080p and
   4K, 6a on a 1080p and a 4K
   inter frame, 6b on a random OBMC program, their plain versions, the
   strip kernel on a 1080p inter frame's pred units beside its bound,
   deblocking + CDEF (the deblocking, the direction search and the CDEF
   filter of the 1080p deblocking key frame and of the 4K 10-bit key
   frame, each beside its plain version and its bound, the deblocking
   and the filter beside their first designs, tools/torch_loopfilter_first.cu
   and tools/torch_cdef_first.cu, on the same frames, and the device
   operations a frame of both paths and the host maps' split on two
   1080p inter frames, by tools/torch_postfilter_profile.py), the stages
   of the
   1080p inter stream's frames, and
   the port's fps beside the native C session's on both 1080p streams;
   the hash kernel on a 1080p frame beside its plain version and its
   byte bound; superres and film grain on 1080p planes; the
   loop-restoration kernel alone and its wrapper on the seeded 1080p
   8-bit and 4K 10-bit frames beside its plain version and its byte
   bound (`lr_bytes`); the stages of the 1080p loop-restoration and grain stream,
   and on it the port's fps, the native C session's and the resident
   decode's; on the 4K 10-bit stream the strip kernel on the key frame,
   the uint16 6a and the strip kernel on an inter frame, 6b on a random
   10-bit program and the hash kernel on a 4K 10-bit frame beside their
   bounds (2 bytes a reference or frame sample), the stages of its inter
   frames, and its port, resident and native fps; the device composer
   on the two key frames' records beside its plain version, its bound
   on the packed input and the first design's on the dense input, and
   the first design (tools/torch_itx_first.cu, in a process of its own,
   `itx_first_design`) on the dense records; and on the
   1080p intra, 1080p inter and 4K 10-bit streams, with each composer,
   the stages "prepare", "pack", "compose" and "upload", the residual's
   upload bytes a frame and the port's fps, beside the native C
   session's;
4. runs the off-path modules: the multi-stream batch
   (`parallel/multistream_av1.py`) on 3 batches of 8 1080p key frames,
   half of tests/data/bench/bench_av1_intra_lf_1920x1080_8.webm
   (deblocking on, CDEF damping 6) and half of the 1080p intra stream
   (deblocking off, damping 4), no frame twice in a batch, every frame
   through `batched_postfilter_real` (one LF + CDEF pass over a stream
   axis) and `batched_postfilter_loop` (a pass a frame) hash-equal to
   the native C session's, with the LF + CDEF kernels' launches as the
   frames' headers ask, and `postfilter_torch.MultiStreamPostfilter`
   at 8 streams of 1080p luma bit-equal to the same step on the CPU;
   Vorbis synthesis (`audio/vorbis/device.py`) fed a packet at a time
   on tests/data/bench/bench_vorbis_stereo_48k_30s.webm and
   tests/data/smoke/vorbis_clicks_2s.webm, within 5e-6 of the host
   decoder's PCM, chunk 7 and chunk 64 bit-equal, and
   `parallel/mesh.py::MultiStreamVorbisSynth` at 8 streams within 5e-6
   (of its peak) of its CPU run; and times them: the batch against the
   loop (host clock, and the device pass alone by CUDA events) beside
   the byte bound, BASELINE config 5 (8 interleaved resident sessions of
   the 1080p inter stream, 3 frames each, device hashes checked), the
   Vorbis host pipeline and device synth in times realtime, the synth on
   one chunk of 512 blocks and `MultiStreamVorbisSynth.step` beside
   their float32 operation bounds and one `torch.matmul`.

The smoke imports only torch and `easyav1_tpu_torch` (and
tools/torch_postfilter_profile.py, which imports no more), and checks
that neither jax nor easyav1_tpu was imported.  Every phase raises on
failure.  The line before the last gives the card's name and power
limit, the last line the device summary.
"""

import ctypes
import importlib.util
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
from easyav1_tpu_torch import _build, capi, native, trace
from easyav1_tpu_torch.api import frame_hash, native_session
from easyav1_tpu_torch.audio.vorbis import VorbisDecoder
from easyav1_tpu_torch.audio.vorbis.device import VorbisDeviceSynth
from easyav1_tpu_torch.capi.bridge import _VideoFrame
from easyav1_tpu_torch.container import TrackType, WebMDemuxer
from easyav1_tpu_torch.native import pipe
from easyav1_tpu_torch.native.pipe import first_frame_inputs
from easyav1_tpu_torch.parallel import multistream_av1
from easyav1_tpu_torch.parallel.mesh import MultiStreamVorbisSynth
from easyav1_tpu_torch.unit_programs import (
    program_frame, random_ibc_program, random_interintra_program,
    random_lr_case, random_mc_program, random_postfilter_case,
    random_program, random_tx_program, shaped_tx_program, stream_grain)
from easyav1_tpu_torch.video.av1 import itx_ref
from easyav1_tpu_torch.video.av1 import tables as T
from easyav1_tpu_torch.video.av1.recon import (cdef_torch, fg_torch, inter_mc,
                                               intra_strip, itx_torch,
                                               lf_torch, lr_torch, postfilter,
                                               postfilter_torch, resident,
                                               sr_torch)
from easyav1_tpu_torch.video.av1.recon.intra_exec import IntraRecon
from easyav1_tpu_torch.video.av1.headers import FilmGrainParams
from easyav1_tpu_torch.video.av1.recon.mc_plan import (
    P_MODE, P_PRED0, P_PRED1, P_VALID, P_X, P_Y, S_FH, S_FV, S_IX, S_IY,
    S_NORES, S_SLOT, S_VALID, S_X, S_Y, W_IX4, W_IY4, W_SLOT, W_VALID, W_X,
    W_Y)
from easyav1_tpu_torch.video.av1.recon.inter_exec import InterRecon, ii_masks
from easyav1_tpu_torch.video.av1.recon.records import (
    F_H, F_RES, F_W, coded_box, compose_residual_host, pack_coeff_rows,
    preprocess_units)
from easyav1_tpu_torch.video.av1.recon.postfilter import (
    postfilter_apply, postfilter_apply_plain, postfilter_maps, upload_maps)

REPO = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(REPO, "tests", "data", "bench")
INTRA_1080 = os.path.join(BENCH, "bench_av1_intra_1920x1080_30.webm")
INTER_1080 = os.path.join(BENCH, "bench_av1_inter_1920x1080_60.webm")
KEY_4K = os.path.join(BENCH, "bench_av1_4k_3840x2160_24.webm")
SMOKE = os.path.join(REPO, "tests", "data", "smoke")
MODES = os.path.join(SMOKE, "inter_modes_96x96.webm")
LR_GRAIN_1080 = os.path.join(BENCH, "bench_av1_lr_grain_1920x1080_8.webm")
HBD_4K = os.path.join(BENCH, "bench_av1_10bit_3840x2160_8.webm")
# 8 key frames, deblocking and CDEF on (the intra stream above has
# deblocking level 0)
LF_1080 = os.path.join(BENCH, "bench_av1_intra_lf_1920x1080_8.webm")
VORBIS_30S = os.path.join(BENCH, "bench_vorbis_stereo_48k_30s.webm")
VORBIS_CLICKS = os.path.join(SMOKE, "vorbis_clicks_2s.webm")
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
# the kernels' launch counters of `trace.counters()`, by the name of the
# kernels line
COUNTERS = {"intra_strip": "intra_wavefront_kernel", "inter_mc": "mc_kernel",
            "obmc": "obmc_kernel", "frame_hash": "frame_hash_kernel",
            "itx_compose": "itx_kernel", "deblock": "lf_frame_kernel",
            "cdef_dirs": "cdef_dirs_kernel",
            "cdef_filter": "cdef_filter_kernel", "lr": "lr_frame_kernel",
            "fg": "fg_frame_kernel"}
# the LF + CDEF kernels' counters; the others but "lr" and "fg" are the
# recon kernels'
PF_KERNELS = ("deblock", "cdef_dirs", "cdef_filter")
KERNEL_SOURCES = ("intra_strip", "inter_mc", "frame_hash", "itx",
                  "loopfilter", "cdef", "lr", "fg")
# (seed, plane dims, bit depth) of the device composer's random
# programs: 1080p 4:2:0 and an odd 4:4:4 size (crops at the right and
# bottom edges), each with every legal (tx_size, tx_type) pair
ITX_PROGRAMS = [(41, [(1080, 1920), (540, 960), (540, 960)], 8),
                (42, [(719, 1277)] * 3, 8),
                (43, [(1080, 1920), (540, 960), (540, 960)], 10),
                (44, [(719, 1277)] * 3, 10),
                (45, [(1080, 1920), (540, 960), (540, 960)], 12),
                (46, [(719, 1277)] * 3, 12)]
# (name, seed, plane dims, bit depth, tx sizes, DC-only share) of the
# device composer's shaped programs (`unit_programs.shaped_tx_program`):
# DC-heavy, as inter frames are, and 4x4 and 8x8 transforms only, as the
# 4K 10-bit key frame's are
ITX_SHAPED = [("DC-heavy", 47, [(1080, 1920), (540, 960), (540, 960)], 8,
               None, 0.8),
              ("4x4 and 8x8", 48, [(1080, 1920), (540, 960), (540, 960)], 10,
               (0, 1), 0.0)]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
INT32_OPS_PER_S = 33.5e12   # half the 67 TFLOP/s of float32 outside tensor cores
FP32_OPS_PER_S = 67e12      # float32 outside the tensor cores (TF32 is off)
# the multi-stream phase: slots a batch (BASELINE config 5's 8 streams)
# and batches
MS_SLOTS = 8
MS_BATCHES = 3
# Vorbis PCM against the host decoder (tests/test_vorbis.py's TOL)
VORBIS_TOL = 5e-6


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def build():
    """The C decoder, the C ABI's library and client, the kernel
    libraries and the yardsticks, built at once; prints ptxas's
    reports."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2 + len(KERNEL_SOURCES) + len(YARDSTICKS)) \
            as ex:
        jobs = [ex.submit(native._load), ex.submit(capi.build)] + [
            ex.submit(_build.build, name) for name in KERNEL_SOURCES] + [
            ex.submit(build_yardstick, name) for name in YARDSTICKS]
        for j in jobs:
            j.result()
    print(f"build (gcc twice and {len(KERNEL_SOURCES) + len(YARDSTICKS)} "
          f"nvcc at once) {time.perf_counter() - t0:.3f} s")
    for name in KERNEL_SOURCES + tuple(YARDSTICKS):
        if name in KERNEL_SOURCES:
            _build.load(name)
        for line in (_build.BUILD / f"{name}.log").read_text().splitlines():
            if "spill" in line or "ptxas info" in line and (
                    "Used" in line or "bytes" in line
                    or "Compiling entry" in line):
                print(f"{name}: {line.strip()}")


def counts(since):
    """Each kernel's launches since `since`, a reading of
    `trace.counters()`."""
    now = trace.counters()
    return {name: now[f"launches.{k}"] - since[f"launches.{k}"]
            for name, k in COUNTERS.items()}


def traced_stages(make):
    """Each covered frame's stages in a session's decode
    (`decode_hashes`) under the port's tracer (`trace`), in decode order:
    {stage: host seconds}, a stage's spans summed; no stage synchronises
    the device."""
    trace.start()
    try:
        decode_hashes(make)
    finally:
        spans = trace.stop()
    frames = {sp.id: {} for sp in spans
              if sp.name == "frame" and "declined" not in sp.attrs}
    for sp in spans:
        if sp.parent in frames:
            d = frames[sp.parent]
            d[sp.name] = d.get(sp.name, 0.0) + (sp.end_ns - sp.start_ns) * 1e-9
    return list(frames.values())


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
        self.sequential = intra_strip.schedule_to(
            intra_strip.sequential_schedule(fields, dims), dev)
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
            + (self.wavefront[2].numel() + self.wavefront[3].numel()) * 4 \
            + 4 * pix
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


class Records:
    """A frame's transform records on the card, as the device composer
    reads them (packed by `records.pack_coeff_rows`: txs, coded rows and
    class offsets), with the decoder's dense export they were packed
    from (host arrays), its plane dims and bit depth."""

    def __init__(self, txs, coeffs, dims, bd, dev):
        self.dense = (np.asarray(txs, np.int32), np.asarray(coeffs, np.int32))
        ptxs, pco, self.off = pack_coeff_rows(*self.dense)
        self.txs = torch.from_numpy(ptxs).to(dev)
        self.coeffs = torch.from_numpy(pco).to(dev)
        self.dims, self.bd = [tuple(d) for d in dims], bd

    @classmethod
    def key_frame(cls, path, dev):
        k = first_frame_inputs(path, dev, host_residual=False)
        check(k is not None and k["records"] is not None,
              f"{path} frame 0 declined")
        r = cls(*k["dense"], k["recon"].dims, k["recon"].bd, dev)
        check(all(np.array_equal(a.cpu().numpy() if torch.is_tensor(a)
                                 else a, b.cpu().numpy()
                                 if torch.is_tensor(b) else b)
                  for a, b in zip(k["records"], (r.txs, r.coeffs, r.off))),
              f"{path}: the pipe's packed records differ from the packer's")
        return r

    def run(self):
        return itx_torch.compose_residual(self.txs, self.coeffs, self.off,
                                          self.dims, self.bd)

    def plain(self):
        return itx_torch.compose_residual_packed_plain(
            self.txs, self.coeffs, self.dims, self.bd, self.txs.device)

    def host(self):
        return [torch.from_numpy(h) for h in compose_residual_host(
            *self.dense, self.dims, self.bd)]

    def pairs(self):
        return len(set(map(tuple, self.dense[0][:, 3:5].tolist())))

    def dc_only(self):
        nzh, nzw = coded_box(self.dense[0])
        return int(((self.dense[0][:, 4] == 0) & (nzh == 1)
                    & (nzw == 1)).sum())

    def bound_ms(self):
        """(ms, bound_by, bytes) of the least time for the redesigned
        kernel's work: the records (32 bytes each) and their coded rows
        (4 a coefficient) read once, every plane sample written once (2
        bytes, 4 at 12 bits: the planes are the output, zeros included),
        at the HBM rate; against the integer operations of the
        butterflies over the coded rows the box leaves (`itx_ops`) at the
        int32 rate."""
        nbytes = (self.txs.numel() * 4 + self.coeffs.numel() * 4
                  + self._plane_bytes())
        ms, by = _bound(nbytes, itx_ops(self.dense[0], coded=True))
        return ms, by, nbytes

    def bound_dense_ms(self):
        """(ms, bound_by, bytes) of the first design's bound, on the
        dense input: the records and every dense coefficient read once,
        the planes written once, against the operations over all adj_h
        rows."""
        nbytes = (self.dense[0].nbytes + self.dense[1].nbytes
                  + self._plane_bytes())
        ms, by = _bound(nbytes, itx_ops(self.dense[0]))
        return ms, by, nbytes

    def _plane_bytes(self):
        size = torch.tensor([], dtype=itx_torch.residual_dtype(self.bd)
                            ).element_size()
        return size * sum(h * w for h, w in self.dims)


class _Op:
    """A value of a butterfly whose operations are counted."""
    count = 0

    def _op(self, _other=None):
        _Op.count += 1
        return _Op()

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _op
    __rshift__ = __neg__ = _op


class _CountXp:
    """The namespace `itx_ref.transform_1d` takes, counting a clamp as a
    min and a max."""

    @staticmethod
    def clip(_x, _mn, _mx):
        _Op.count += 2
        return _Op()

    @staticmethod
    def stack(xs):
        return xs


def _ops_1d(kind, n):
    """The integer operations of one n-point 1-D transform of `kind`, as
    itx_ref's butterflies do them."""
    _Op.count = 0
    itx_ref.transform_1d(kind, np.array([_Op() for _ in range(n)]), 0, 0,
                         xp=_CountXp)
    return _Op.count


def itx_ops(txs, coded=False):
    """The integer operations of the device composer on records txs: for
    each transform, its coded rows' row transforms (all adj_h rows, or
    with `coded` the nzh rows of its box), the rectangular scaling, the
    row rounding and clamp (4 a sample), its columns' transforms and the
    final rounding (2 a sample)."""
    nzh, _ = coded_box(txs)
    rows = np.array([T.TX_HEIGHT[T.ADJUSTED_TX_SIZE[s]] for s in
                     range(len(T.TX_WIDTH))])[txs[:, 3]]
    if coded:
        rows = np.minimum(nzh, rows)
    ops, memo = 0, {}
    for (ts, tt, nr), n in zip(*np.unique(
            np.stack([txs[:, 3], txs[:, 4], rows], 1), axis=0,
            return_counts=True)):
        if (ts, tt) not in memo:
            w, h = T.TX_WIDTH[ts], T.TX_HEIGHT[ts]
            adj = T.ADJUSTED_TX_SIZE[ts]
            aw = T.TX_WIDTH[adj]
            vk, hk = itx_ref._TX_1D[int(tt)]
            rect = abs(w.bit_length() - h.bit_length()) == 1
            # (ops a coded row, ops of the column pass and final rounding)
            memo[ts, tt] = (_ops_1d(hk, w) + 3 * rect * aw + 4 * w,
                            w * _ops_1d(vk, h) + 2 * h * w)
        row, col = memo[ts, tt]
        ops += int(n) * (int(nr) * row + col)
    return ops


def check_itx(dev):
    """Phase 1: the device composer's kernel on packed records against
    its plain version (`compose_residual_packed_plain`), tolerance 0:
    seeded random programs at 8, 10 and 12 bits with every legal
    (tx_size, tx_type) pair, at 1080p 4:2:0 and at an odd 4:4:4 size
    (misaligned rows and crops); a DC-heavy program and one of 4x4 and
    8x8 transforms only (ITX_SHAPED); the real records of the 1080p intra
    stream's and the 4K 10-bit stream's key frames, also against the
    host C composer on the decoder's dense records; then 20 runs of the
    4K 10-bit key frame, each bit-equal to the first.  Returns (8-bit
    error, 10- and 12-bit error, {"1080p", "4K 10-bit"}: those two key
    frames' `Records`)."""
    err = {8: 0, 10: 0, 12: 0}
    progs = [(f"seed {seed}", random_tx_program(seed, dims, bd), True)
             for seed, dims, bd in ITX_PROGRAMS]
    progs += [(name, shaped_tx_program(seed, dims, bd, sizes, dc), False)
              for name, seed, dims, bd, sizes, dc in ITX_SHAPED]
    for name, prog, all_pairs in progs:
        dims, bd = prog["dims"], prog["bd"]
        r = Records(prog["txs"], prog["coeffs"], dims, bd, dev)
        e = max_err(r.run(), r.plain())
        print(f"transform program {name} {dims[0][1]}x{dims[0][0]} "
              f"x{len(dims)} {bd}-bit: {r.txs.shape[0]} transforms "
              f"({r.dc_only()} DC-only), classes {np.diff(r.off).tolist()}, "
              f"{r.pairs()} pairs, max_abs_err {e}")
        check(not all_pairs or r.pairs() == len(itx_torch.legal_pairs()),
              f"program {name}: {r.pairs()} pairs")
        err[bd] = max(err[bd], e)
    frames = {}
    for name, path in (("1080p", INTRA_1080), ("4K 10-bit", HBD_4K)):
        r = frames[name] = Records.key_frame(path, dev)
        got = r.run()
        e = max_err(got, r.plain())
        e_host = max_err([g.cpu() for g in got], r.host())
        print(f"{name} frame 0 ({r.bd}-bit): {r.txs.shape[0]} transforms "
              f"({r.dc_only()} DC-only), {r.pairs()} pairs, classes "
              f"{np.diff(r.off).tolist()}, {r.dense[1].size} dense and "
              f"{r.coeffs.numel()} packed coefficients: max_abs_err {e} "
              f"against the plain version, {e_host} against the host C "
              "composer")
        err[r.bd] = max(err[r.bd], e, e_host)
    r = frames["4K 10-bit"]
    first = r.run()
    for k in range(20):
        check(all(torch.equal(a, b) for a, b in zip(r.run(), first)),
              f"4K 10-bit device composer run {k} differs from the first")
    print("4K 10-bit frame 0: 20 device composer runs bit-equal to the first")
    check(not any(err.values()),
          f"device composer vs plain max_abs_err {err} (tolerance 0)")
    return err[8], max(err[10], err[12]), frames


# (seed, luma size, bit depth, streams, map-row shift, clamp) of the LF +
# CDEF kernels' seeded cases (4:2:0; every filter length at random a map
# cell and edge, so neighbouring edges' writes overlap): 1080p and an odd
# size whose CDEF unit grid overhangs the plane at each bit depth, with
# the decoder's cell maps (shift 2), a stream axis of 8, a damping a
# stream, maps of one row a pixel line (shift 0, make_postfilter's), and
# at each bit depth CDEF's upper clamp binding beside the plane's border,
# where taps read CDEF_VERY_LARGE (`random_postfilter_case`'s `clamp`)
PF_CASES = [(61, (1080, 1920), 8, 0, 2, False),
            (62, (717, 1277), 8, 0, 2, False),
            (63, (1080, 1920), 10, 0, 2, False),
            (64, (717, 1277), 10, 0, 2, False),
            (65, (1080, 1920), 12, 0, 2, False),
            (66, (717, 1277), 12, 0, 2, False),
            (67, (539, 957), 8, 8, 2, False), (68, (539, 957), 12, 8, 2, False),
            (69, (717, 1277), 10, 0, 0, False),
            (70, (539, 957), 8, 8, 0, False),
            (71, (539, 957), 8, 8, 2, True), (72, (717, 1277), 10, 0, 2, True),
            (73, (1080, 1920), 12, 0, 2, True)]


def cdef_args(planes, dirs, cd):
    """The arguments of `cdef_torch.filter_launch` after the planes."""
    return (*dirs, *cdef_torch.strengths(cd, len(planes)), cd["filt"],
            *cd["ss"], cd["cs"] + 8, cd["damping"], cd["tabs"])


def pf_stage_errors(planes, maps):
    """Each LF + CDEF kernel against its plain version on the card, on
    the same inputs, stage by stage (the kernel's output feeds the next
    stage): {kernel: max_abs_err}, and the filtered planes."""
    bd = maps["bd"]
    err = dict.fromkeys(PF_KERNELS, 0)
    out = list(planes)
    if maps["lf"] is not None:
        got = lf_torch.lf_launch(out, maps["lf"], bd)
        err["deblock"] = max_err(got, lf_torch.lf_frame_plain(
            out, maps["lf"], bd))
        out = got
    cd = maps["cdef"]
    if cd is not None:
        uh, uw = cd["filt"].shape[-2:]
        dirs = cdef_torch.dirs_launch(out[0], uh, uw, cd["cs"], cd["tabs"])
        err["cdef_dirs"] = max_err(dirs, cdef_torch.find_dirs(
            out[0], uh, uw, cd["cs"], cd["tabs"]))
        args = cdef_args(out, dirs, cd)
        got = cdef_torch.filter_launch(out, *args)
        err["cdef_filter"] = max_err(got, cdef_torch.filter_planes(
            out, *args))
        out = got
    return err, out


def pf_key_frame(fr, dev):
    """A key frame's LF + CDEF inputs on the card: its planes from the
    strip kernel (wavefront) and its uploaded maps."""
    planes = fr.run(fr.wavefront)
    key = fr.key
    maps = postfilter_maps(key["hdr"], key["seq"],
                           [tuple(p.shape) for p in planes], *key["maps"],
                           dev)
    return {"planes": planes, "maps": maps}


def check_postfilter(dev, hbd_key):
    """Phase 1: the deblocking (every plane, both directions), the CDEF
    direction search and the CDEF filter (every plane) against their plain versions on the card,
    tolerance 0 (integer arithmetic), stage by stage: the seeded
    PF_CASES, the 1080p key frame of the deblocking stream and the 4K
    10-bit key frame `hbd_key`, whose LF + CDEF is also held whole
    against the plain chain; then 20 runs of each kernel on the 1080p key
    frame, each bit-equal to the first.  Returns ({kernel: error} at 8
    bits, the same above 8, the two key frames' inputs)."""
    errs = {8: dict.fromkeys(PF_KERNELS, 0), 16: dict.fromkeys(PF_KERNELS, 0)}
    for seed, luma, bd, streams, shift, clamp in PF_CASES:
        h, w = luma
        case = random_postfilter_case(
            seed, [luma] + [((h + 1) >> 1, (w + 1) >> 1)] * 2, bd, streams,
            map_shift=shift, clamp=clamp)
        maps = upload_maps(case["maps"], dev)
        planes = [torch.from_numpy(p).to(dev) for p in case["planes"]]
        e, _ = pf_stage_errors(planes, maps)
        print(f"LF + CDEF seeded {w}x{h} 4:2:0, {bd}-bit, "
              f"{streams or 1} stream(s), "
              f"{'cell maps' if shift else 'a map row a line'}"
              f"{', the border clamp' if clamp else ''}: "
              f"max_abs_err {e}")
        side = errs[8 if bd == 8 else 16]
        for k in PF_KERNELS:
            side[k] = max(side[k], e[k])
    frames = {"1080p": pf_key_frame(Frame.key_frame(LF_1080, dev), dev),
              "4K 10-bit": pf_key_frame(hbd_key, dev)}
    for name, f in frames.items():
        check(f["maps"]["lf"] is not None and f["maps"]["cdef"] is not None,
              f"{name} key frame: deblocking and CDEF must both be on")
        e, out = pf_stage_errors(f["planes"], f["maps"])
        whole = max_err(out, postfilter_apply_plain(f["planes"], f["maps"]))
        print(f"LF + CDEF {name} key frame: max_abs_err {e}, the whole "
              f"chain against the plain chain {whole}")
        side = errs[16 if "10-bit" in name else 8]
        for k in PF_KERNELS:
            side[k] = max(side[k], e[k], whole)
    f = frames["1080p"]
    m, bd = f["maps"], f["maps"]["bd"]
    cd = m["cdef"]
    uh, uw = cd["filt"].shape[-2:]
    dirs = cdef_torch.dirs_launch(f["planes"][0], uh, uw, cd["cs"],
                                  cd["tabs"])
    runs = {"deblock": lambda: lf_torch.lf_launch(f["planes"], m["lf"], bd),
            "cdef_dirs": lambda: list(cdef_torch.dirs_launch(
                f["planes"][0], uh, uw, cd["cs"], cd["tabs"])),
            "cdef_filter": lambda: cdef_torch.filter_launch(
                f["planes"], *cdef_args(f["planes"], dirs, cd))}
    for name, run in runs.items():
        first = run()
        for k in range(20):
            check(all(torch.equal(a, b) for a, b in zip(run(), first)),
                  f"{name} run {k} on the 1080p key frame differs from the "
                  "first")
    print("LF + CDEF 1080p key frame: 20 runs of each kernel bit-equal to "
          "the first")
    for side in errs.values():
        check(not any(side.values()),
              f"LF + CDEF kernels vs plain: max_abs_err {errs} (tolerance 0)")
    return errs[8], errs[16], frames


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
    """Phase 1: the superres upscale as exact torch ops on the card
    against the same functions on the CPU, tolerance 0, on seeded 1080p
    inputs (luma 1280 -> 1920 and its chroma, and an unaligned coded
    width); film grain's kernel (`csrc/fg.cu`, `FilmGrain.apply`, one
    launch) over all three planes against its plain version on the card
    and on the CPU, tolerance 0, with a seeded parameter set and with
    both of the 1080p grain bench stream's.  Returns the inputs on the
    card, for the timings."""
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
    fgp = grain_case(7)
    seq = SimpleNamespace(color=SimpleNamespace(
        subsampling_x=1, subsampling_y=1, num_planes=3, mono_chrome=False,
        bitdepth=8))
    u8 = [torch.from_numpy(rng.integers(0, 256, d).astype(np.uint8))
          for d in ((1080, 1920), (540, 960), (540, 960))]
    on_dev = [t.to(dev) for t in u8]
    for name, (p, sq) in [("seeded", (fgp, seq))] + [
            (f"bench stream frame {i}", g)
            for i, g in enumerate(stream_grain(LR_GRAIN_1080))]:
        grain = fg_torch.FilmGrain(p, sq, 8, dev)
        before = trace.counters()
        got = grain.apply(on_dev)
        launches = counts(before)["fg"]
        plain = grain.apply_plain(on_dev)
        want = fg_torch.FilmGrain(p, sq, 8, cpu).apply(u8)
        e = max(max_err([g.cpu().int() for g in got],
                        [w.cpu().int() for w in plain]),
                max_err([g.cpu().int() for g in got], [w.int() for w in want]))
        changed = sum(int((w != t).sum()) for w, t in zip(want, u8))
        print(f"film grain kernel 1920x1080 ({name}, {changed} pixels "
              f"changed, {launches} launch): vs plain on the card and on "
              f"the CPU max_abs_err {e}")
        check(e == 0 and changed > 0 and launches == 1,
              "the film grain kernel differs from its plain version")
    return {"sr": sr, "fg": (fgp, seq, on_dev)}


# (name, seed, width, height, bit depth) of the loop-restoration frames:
# 4:2:0, Wiener, SGR and absent units interleaved in luma, Wiener U, SGR
# and absent units in V, 64-pixel units, mi-padded planes
LR_CASES = [("1920x1080 8-bit", 6, 1920, 1080, 8),
            ("3840x2160 10-bit", 7, 3840, 2160, 10)]


def check_lr(dev):
    """Phase 1: the loop-restoration kernel (`csrc/lr.cu`, through
    `LoopRestoration.apply`) against its plain version on the card,
    exactly, on each of LR_CASES, one launch a frame, 10 runs bit-equal
    to the first; 1080p also against the plain version on the CPU.
    Returns the largest difference and {name: (lr, planes, snapshot)} on
    the card, for the timings."""
    err, inputs = 0, {}
    for name, seed, w, h, bd in LR_CASES:
        hdr, seq, plan, planes, debl = random_lr_case(seed, w, h, bd=bd)
        lr = lr_torch.LoopRestoration(hdr, seq, plan, bd)
        tp = [torch.from_numpy(p).to(dev) for p in planes]
        td = [torch.from_numpy(d).to(dev) for d in debl]
        before = trace.counters()
        got = lr.apply(tp, td)
        launched = counts(before)["lr"]
        want = lr.apply_plain(tp, td)
        e = max_err([g.cpu() for g in got], [x.cpu() for x in want])
        if name.startswith("1920"):
            e = max(e, max_err([g.cpu() for g in got], lr.apply(
                [torch.from_numpy(p) for p in planes],
                [torch.from_numpy(d) for d in debl])))
        changed = sum(int((x.cpu() != torch.from_numpy(p)).sum())
                      for x, p in zip(want, planes))
        for _ in range(10):
            again = lr.apply(tp, td)
            e = max(e, max_err([a.cpu() for a in again],
                               [g.cpu() for g in got]))
        print(f"loop restoration {name}, {len(plan.lr_type)} units "
              f"({len(plan.lr_wiener)} Wiener, {len(plan.lr_sgr)} SGR), "
              f"{changed} samples changed: kernel vs plain max_abs_err {e}, "
              f"{launched} launch")
        check(e == 0 and changed > 0 and launched == 1,
              f"lr kernel {name}: max_abs_err {e}, {changed} changed, "
              f"{launched} launches")
        err = max(err, e)
        inputs[name] = (lr, tp, td)
    return err, inputs


def lr_bytes(lr, planes):
    """The least bytes loop restoration moves: each plane that restores
    read and written once (int32, as stored), and each row of the
    deblocked snapshot that a stripe reads (two above and two below it,
    clamped into the plane) read once."""
    total = 0
    for plane, ph, pw, sh, off, *_ in lr.unit_table()[0]:
        rows = set()
        for s in range(-(-(ph + off) // sh)):
            ss = s * sh - off
            se = ss + sh - 1
            for y in range(ss - 3, se + 4):
                yy = min(max(y, 0), ph - 1)
                if yy < ss:
                    rows.add(max(ss - 2, yy))
                elif yy > se:
                    rows.add(min(se + 2, yy))
        total += 8 * planes[plane].numel() + 4 * pw * len(rows)
    return total


def lr_timings(inputs):
    """Phase 3: the loop-restoration kernel alone (`lr_torch.frame_launch`
    on the uploaded table) and its plain version on the card (CUDA
    events, back to back) on LR_CASES, beside the byte bound (`lr_bytes`
    at 3.35 TB/s), and the wrapper `lr.apply` with its host table and
    upload (host clock to the device's end, median of 10): {name: {"ms",
    "plain_ms", "bound_ms", "bound_by", "mbytes", "wrapper_ms"}}."""
    out = {}
    for name, (lr, planes, debl) in inputs.items():
        dims, table = lr.unit_table()
        ints = lr_torch.launch_dims(dims, planes, debl)
        on = [d[0] for d in dims]
        tab = torch.from_numpy(table).to(planes[0].device)
        ms = cuda_ms(lambda: lr_torch.frame_launch(planes, debl, on, ints,
                                                   tab, lr.bd), 20)
        plain = cuda_ms(lambda: lr.apply_plain(planes, debl), 3)
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lr.apply(planes, debl)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        nbytes = lr_bytes(lr, planes)
        out[name] = {"ms": ms, "plain_ms": plain,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "mbytes": nbytes / 1e6,
                     "wrapper_ms": _median(walls)}
        print(f"loop restoration {name} (CUDA events): kernel {ms:.4f} ms, "
              f"plain {plain:.3f} ms, bound {out[name]['bound_ms'] * 1e3:.3f}"
              f" us ({nbytes / 1e6:.3f} MB), "
              f"{ms / out[name]['bound_ms']:.2f}x the bound; the wrapper "
              f"with its host table {out[name]['wrapper_ms']:.3f} ms "
              f"(host clock)")
    return out


# name, path, frames shown, and (frames decoded, then the launches
# expected): the strip kernel once a decoded frame that has pred units
# (a frame without any launches nothing; the counts are the streams'
# own, from their units), 6a once an inter frame, 6b once a frame that
# has OBMC blocks
STREAMS = [("1080p intra", INTRA_1080, 30, (30, 30, 0, 0)),
           ("1080p inter", INTER_1080, 60, (60, 2, 59, 0)),
           ("4K", KEY_4K, 24, (24, 9, 23, 0)),
           ("inter modes 96x96", MODES, 8, (8, 8, 7, 7)),
           # loop restoration on every frame (Wiener and SGR),
           # deblocking on the inter frames, film grain on every frame
           ("1080p LR + grain", LR_GRAIN_1080, 8, (8, 8, 7, 0)),
           ("LR mixed units 320x200",
            os.path.join(SMOKE, "lreal_mix_e8bf32ba.webm"), 1, (1, 1, 0, 0)),
           ("LR inter 160x128",
            os.path.join(SMOKE, "lreal_interlr_863022fc.webm"), 4,
            (4, 4, 3, 0)),
           ("film grain 160x128",
            os.path.join(SMOKE, "fgreal_7cdd830f.webm"), 2, (2, 2, 0, 0)),
           ("superres + LR 88x64",
            os.path.join(SMOKE, "superres_lr_88x64.webm"), 3, (3, 3, 0, 0)),
           ("superres + LR 1920x128",
            os.path.join(SMOKE, "superres_lr_1920x128.webm"), 3, (3, 3, 0, 0)),
           # libaom streams whose pairs carry wedge and diffwtd masks (22
           # diffwtd blocks and 1 wedge; 4 and 2, and one hidden frame)
           ("masked compound 320x192",
            os.path.join(SMOKE, "comp_masked_320x192.webm"), 10,
            (10, 1, 9, 0)),
           ("wedge compound 320x192",
            os.path.join(SMOKE, "comp_wedge_320x192.webm"), 12,
            (13, 12, 12, 0))]
# the 10- and 12-bit streams: uint16 frames, the kernels' uint16
# instantiations
HBD_STREAMS = [("4K 10-bit", HBD_4K, 8, (8, 8, 7, 0)),
               ("10-bit intra 96x96",
                os.path.join(SMOKE, "hbd_10i.webm"), 4, (4, 4, 0, 0)),
               ("10-bit inter 96x96",
                os.path.join(SMOKE, "hbd_10p.webm"), 4, (4, 4, 3, 0)),
               ("10-bit deblocking + CDEF 128x96",
                os.path.join(SMOKE, "hbd_10pf.webm"), 4, (4, 4, 3, 0)),
               ("12-bit intra 96x96",
                os.path.join(SMOKE, "hbd_12i.webm"), 4, (4, 4, 0, 0)),
               ("12-bit inter 96x96",
                os.path.join(SMOKE, "hbd_12p.webm"), 8, (8, 8, 7, 0)),
               ("10-bit 4:4:4 96x96",
                os.path.join(SMOKE, "hbd_444x10.webm"), 4, (4, 4, 3, 0)),
               ("10-bit film grain 160x128",
                os.path.join(SMOKE, "hbd_10fg.webm"), 3, (3, 3, 2, 0)),
               ("12-bit film grain 160x128",
                os.path.join(SMOKE, "hbd_12fg.webm"), 3, (3, 3, 2, 0)),
               # compound, OBMC and warps at 10 and 12 bits
               ("10-bit inter modes 96x96",
                os.path.join(SMOKE, "hbd_modes10_96x96.webm"), 8,
                (8, 8, 7, 6)),
               ("12-bit inter modes 96x96",
                os.path.join(SMOKE, "hbd_modes12_96x96.webm"), 8,
                (8, 8, 7, 6))]
# the resident decode runs at most this many frames of a stream
RESIDENT_FRAMES = 12
# the main path again with the device residual composer
# (host_residual=False): the 8-bit streams, then the 10- and 12-bit ones
COMPOSER_STREAMS = [s for s in STREAMS if s[0] in (
    "1080p intra", "1080p inter", "inter modes 96x96")]
COMPOSER_STREAMS_HBD = [s for s in HBD_STREAMS if s[0] in (
    "4K 10-bit", "12-bit inter 96x96", "10-bit 4:4:4 96x96")]
# the native C session's frame hashes, and the wall seconds of that pass,
# by stream
NATIVE, NATIVE_WALL = {}, {}


def native_hashes(path):
    if path not in NATIVE:
        NATIVE[path], NATIVE_WALL[path] = decode_hashes(
            lambda: native_session(path))
    return NATIVE[path]


class ComposerCalls:
    """Within the block, the record count of each frame that the recons
    hand to the device composer (`IntraRecon.compose`): a frame without
    transforms launches nothing."""

    def __enter__(self):
        self.calls, self.fn = [], IntraRecon.compose

        def spy(recon, resid):
            if isinstance(resid, tuple):
                self.calls.append(int(resid[0].shape[0]))
            return self.fn(recon, resid)

        IntraRecon.compose = spy
        return self

    def __exit__(self, *exc):
        IntraRecon.compose = self.fn

    @property
    def with_transforms(self):
        return sum(n > 0 for n in self.calls)


def pf_planes_on(hdr, seq, n_planes):
    """From a frame's header: (deblocking on, by plane; CDEF on).  A
    plane deblocks when the frame does (a level not 0, no intrabc) and
    its own level is not 0 (luma: either direction's); CDEF runs when the
    sequence enables it, the frame is neither lossless nor intrabc and
    a strength is not 0."""
    lv, ibc = hdr.lf.level, getattr(hdr, "allow_intrabc", False)
    frame_lf = any(lv) and not ibc
    lf = [frame_lf and bool(lv[0] or lv[1] if p == 0 else lv[p + 1])
          for p in range(n_planes)]
    cd = hdr.cdef
    cdef = bool(getattr(seq, "enable_cdef", False) and cd is not None
                and not hdr.coded_lossless and not ibc
                and any(max(v, default=0) for v in (
                    cd.y_pri_strength, cd.y_sec_strength,
                    cd.uv_pri_strength, cd.uv_sec_strength)))
    return lf, cdef


def pf_launches(lf, cdef, dims):
    """{deblock, cdef_dirs, cdef_filter} launches of one LF + CDEF pass
    over planes of `dims` with `pf_planes_on`'s flags: one deblocking
    launch when a plane deblocks (every plane, both directions); when
    CDEF is on, one search and one filter (every plane)."""
    return {"deblock": int(any(lf)), "cdef_dirs": int(cdef),
            "cdef_filter": int(cdef)}


def lr_restores(lr):
    """Whether a frame's `LoopRestoration` restores a plane, by the plain
    version's maps: a plane whose frame type is not NONE and whose units
    include a Wiener or SGR one."""
    hl = getattr(lr.hdr, "lr", None)
    if hl is None or not hl.uses_lr:
        return False
    return any(m["is_w"].any() or m["is_s"].any()
               for m in (lr.stripe_params(p)[1]
                         for p in range(lr.seq.color.num_planes)
                         if hl.frame_restoration_type[p] != 0))


class PostfilterCalls:
    """Within the block, the LF + CDEF launches that the frames whose
    maps a pipe makes (`postfilter.host_maps`, which every path that
    filters one frame calls) should cause, from each frame's header
    (`pf_planes_on`, `pf_launches`), summed in `want`; and in `lr_want`
    the loop-restoration launches, one a frame whose restoration
    restores a plane (`lr_restores`, spying on `LoopRestoration.apply`,
    which every path that restores calls)."""

    def __enter__(self):
        self.want, self.frames = dict.fromkeys(PF_KERNELS, 0), 0
        self.fn = postfilter.host_maps
        self.lr_want, self.lr_apply = 0, lr_torch.LoopRestoration.apply

        def lr_spy(lr, planes, deblocked):
            self.lr_want += lr_restores(lr)
            return self.lr_apply(lr, planes, deblocked)

        lr_torch.LoopRestoration.apply = lr_spy

        def spy(hdr, seq, dims, *a, **k):
            for name, n in pf_launches(*pf_planes_on(hdr, seq, len(dims)),
                                       dims).items():
                self.want[name] += n
            self.frames += 1
            return self.fn(hdr, seq, dims, *a, **k)

        postfilter.host_maps = spy
        return self

    def __exit__(self, *exc):
        postfilter.host_maps = self.fn
        lr_torch.LoopRestoration.apply = self.lr_apply


def recon_counts(c):
    """The recon kernels' counts of `counts`, in COUNTERS order."""
    return tuple(v for k, v in c.items()
                 if k not in PF_KERNELS + ("lr", "fg"))


def pf_counts(c):
    return {k: c[k] for k in PF_KERNELS}


def main_path(streams, host_residual=True):
    """Phase 2: the port's main path, hash-equal to native C, each
    stream's launch counts read just before it and just after; with the
    host composer, then the resident decode of the same
    stream, its device hashes against those of the frames pulled through
    the API, with the hash kernel's launches counted.  With the device
    composer (host_residual False), one device composer launch a frame
    that has transforms.  Returns the launches of each kernel over the
    streams."""
    total = dict.fromkeys(COUNTERS, 0)
    for name, path, n, want in streams:
        easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
        c0 = trace.counters()
        with ComposerCalls() as composer, PostfilterCalls() as pf:
            port, _ = decode_hashes(lambda: easyav1_tpu_torch.EasyAV1(
                path, device="cuda", host_residual=host_residual))
        c = counts(c0)
        stats = dict(easyav1_tpu_torch.stats)
        native_h = native_hashes(path)
        mode = "" if host_residual else " (device composer)"
        print(f"main path {name}{mode}: {len(port)} frames, stats {stats}, "
              f"launches {c}")
        check(len(port) == n and port == native_h,
              f"{name}{mode} hashes: {len(port)} frames, "
              f"{sum(a != b for a, b in zip(port, native_h))} differ")
        check(stats["fallbacks"] == 0 and stats["frames"] >= n,
              f"{name}{mode} stats {stats}")
        # a hidden frame is decoded and not shown: the strip kernel's
        # launches count the decoded frames
        itx_want = 0 if host_residual else composer.with_transforms
        check(stats["frames"] == want[0] == pf.frames
              and recon_counts(c) == want[1:] + (0, itx_want)
              and pf_counts(c) == pf.want and c["lr"] == pf.lr_want
              and len(composer.calls) == (0 if host_residual
                                          else stats["frames"]),
              f"{name}{mode}: launches {c}, want {want} (frames, strip, "
              f"6a, 6b), "
              f"{itx_want} device composer launches, LF + CDEF "
              f"{pf.want} and {pf.lr_want} LR over {pf.frames} frames; "
              f"composer calls {composer.calls}")
        for k in total:
            total[k] += c[k]
        if not host_residual:
            continue
        easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
        c0 = trace.counters()
        m = min(n, RESIDENT_FRAMES)
        got_n, wall, hashes, frames = resident.decode_resident(
            path, "cuda", max_frames=m)
        c = counts(c0)
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
    nbytes = 2 * sum(p.numel() * 4 for p in planes) + map_bytes(m)
    print(f"1080p frame 0 LF + CDEF: host maps + upload {maps_ms:.3f} ms "
          f"(host clock), device filters {apply_ms:.3f} ms (CUDA events), "
          f"byte bound {nbytes / HBM_BYTES_PER_S * 1e6:.3f} us "
          f"({nbytes / 1e6:.2f} MB: int32 planes in and out, maps)")
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


def _bound(nbytes, ops, ops_per_s=INT32_OPS_PER_S):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
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
    nbytes = (c["schedule"][2].numel() + c["schedule"][3].numel()) * 4
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
    log = [d for d in traced_stages(lambda: easyav1_tpu_torch.EasyAV1(
        INTER_1080, device="cuda")) if "mc" in d]
    stages = ("entropy", "plan", "prepare", "compose", "upload", "mc",
              "intra", "lf_cdef", "tail")
    med = {k: sorted(d[k] for d in log)[len(log) // 2] * 1e3 for k in stages}
    print(f"1080p inter stream stages (ms, host spans, the device not "
          f"synchronised), frame 1: "
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


# integer operations a unit of work, for the LF + CDEF kernels' operation
# bounds (estimates from the plain versions' arithmetic): a deblocked
# (line, edge) (masks, flatness, the longest filter's outputs), an 8x8
# direction search (8 x 64 partial-sum adds, 8 x 15 squares, weights and
# sums), a CDEF tap the filter takes (a constrain, its weighted sum, a min
# and a max) and a CDEF-filtered pixel's rounding and clamp
LF_EDGE_OPS = 64
CDEF_UNIT_OPS = 900
CDEF_TAP_OPS = 10
CDEF_PIXEL_OPS = 10


def pf_bounds(f, var):
    """(bytes, operations) each LF + CDEF kernel's work on frame `f`
    (`pf_key_frame`) needs: planes read once and written once, the maps
    read once (the deblocking maps as the decoder makes them: a uint8
    size and level a 4x4-cell row and edge, the LUT; 4 bytes a CDEF unit
    map a unit: direction, variance, flag, and two strengths a plane
    kind), 8 bytes of output a searched unit; operations by LF_EDGE_OPS
    a (line, edge) of nonzero size, CDEF_UNIT_OPS a unit, and for a pixel
    that the filter changes CDEF_PIXEL_OPS plus CDEF_TAP_OPS for each tap
    it takes: 4 primary ones where the primary strength the filter uses
    (luma's scaled by the search's variance `var`, [uh, uw]) is not 0, 8
    secondary ones where the secondary strength is not 0."""
    m = f["maps"]
    out = {}
    nbytes = ops = 0
    for p, lf in enumerate(m["lf"] or ()):
        if lf is None:
            continue
        x = f["planes"][p]
        nbytes += 8 * x.numel() + sum(lf[k].numel() * lf[k].element_size()
                                      for k in ("sv", "lv", "sh", "lh",
                                                "lut"))
        for size, lines in ((lf["sv"], x.shape[-2]), (lf["sh"], x.shape[-1])):
            rows = size.shape[-2]
            shift = lf_torch.map_shift(rows, lines)
            # the lines each map row covers
            n = torch.clamp(lines - (torch.arange(rows, device=size.device)
                                     << shift), max=1 << shift)
            ops += LF_EDGE_OPS * int(((size != 0).sum(-1) * n).sum())
    out["deblock"] = (nbytes, ops)
    cd = m["cdef"]
    units = cd["filt"].numel()
    out["cdef_dirs"] = (f["planes"][0].numel() * 4 + 8 * units,
                        CDEF_UNIT_OPS * units)
    nbytes = 4 * units * (3 + 2 * min(len(f["planes"]), 2))
    ops = 0
    for p, plane in enumerate(f["planes"]):
        ph, pw = plane.shape[-2:]
        bh = 8 >> (cd["ss"][1] if p else 0)
        bw = 8 >> (cd["ss"][0] if p else 0)
        pri = cd["pri_y" if p == 0 else "pri_uv"]
        sec = cd["sec_y" if p == 0 else "sec_uv"]
        if p == 0:
            # the variance scaling of `cdef_torch.filter_plane`; frexp's
            # exponent less 1 is floor(log2) of a positive int, exactly
            i = (torch.frexp(torch.clamp(var >> 6, min=1).double())[1]
                 - 1).clamp(max=12)
            pri = torch.where(var != 0, (pri * (4 + i) + 8) >> 4, 0)
        filt = cd["filt"] != 0
        taps = filt * (4 * (pri != 0) + 8 * (sec != 0))
        ops_u = torch.where(taps > 0, CDEF_PIXEL_OPS + CDEF_TAP_OPS * taps, 0)
        ops_px = ops_u.repeat_interleave(bh, -2).repeat_interleave(bw, -1)
        nbytes += 8 * plane.numel()
        ops += int(ops_px[..., :ph, :pw].sum())
    out["cdef_filter"] = (nbytes, ops)
    return out


# The yardsticks the deblocking, the CDEF filter and the device composer
# are timed against: their first designs, and the two-launch deblocking
# on cell maps that the one-launch tile was raced against.  Library name
# "<source>_<tag>": its source, and the extern names a build suffixes
# with "_<tag>" so that it stands beside the shipped kernels in one
# process (none for the composer's, which runs in a process of its own,
# `itx_first_design`)
YARDSTICKS = {
    "loopfilter_first": ("tools/torch_loopfilter_first.cu",
                         ("lf_pass_kernel", "lf_pass_launch")),
    "cdef_first": ("tools/torch_cdef_first.cu",
                   ("cdef_dirs_kernel", "cdef_filter_kernel",
                    "cdef_dirs_launch", "cdef_filter_launch", "kDirs",
                    "kUvDir")),
    "loopfilter_twopass": ("tools/torch_loopfilter_twopass.cu",
                           ("lf_frame_kernel", "lf_frame_launch")),
    "itx_first": ("tools/torch_itx_first.cu", ())}


def build_yardstick(name):
    """`_build/<name>.so` from YARDSTICKS[name] (nvcc)."""
    src, names = YARDSTICKS[name]
    tag = name.split("_", 1)[1]
    so = _build.BUILD / f"{name}.so"
    _build.BUILD.mkdir(exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        *(f"-D{n}={n}_{tag}" for n in names), "-o", str(so),
                        os.path.join(REPO, src)], capture_output=True,
                       text=True)
    check(r.returncode == 0, f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    (_build.BUILD / f"{name}.log").write_text(r.stdout + r.stderr)
    return so


def load_yardsticks():
    """The yardsticks' libraries, their launch functions typed."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lf = ctypes.CDLL(str(_build.BUILD / "loopfilter_first.so"))
    lf.lf_pass_launch_first.restype = ci
    lf.lf_pass_launch_first.argtypes = [vp] * 4 + [ci] * 6 + [vp]
    cd = ctypes.CDLL(str(_build.BUILD / "cdef_first.so"))
    cd.cdef_filter_launch_first.restype = ci
    cd.cdef_filter_launch_first.argtypes = [vp] * 8 + [ci] * 10 + [vp]
    tp = ctypes.CDLL(str(_build.BUILD / "loopfilter_twopass.so"))
    tp.lf_twopass_launch.restype = ci
    tp.lf_twopass_launch.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ci),
                                     ci, ci, ci, vp]
    return {"deblock": lf, "cdef_filter": cd, "twopass": tp}


def twopass_deblock(lib, planes, lf_maps, bd):
    """The two-launch deblocking on cell maps
    (tools/torch_loopfilter_twopass.cu), through a scratch plane a plane,
    the same work as `lf_torch.lf_launch`."""
    out = list(planes)
    ptrs, dims, keep = [], [], []
    for p, (x, m) in enumerate(zip(planes, lf_maps)):
        if m is None:
            continue
        tmp, out[p] = torch.empty_like(x), torch.empty_like(x)
        keep.append(tmp)
        ptrs += [x.data_ptr(), tmp.data_ptr(), out[p].data_ptr()] + [
            m[k].data_ptr() for k in ("sv", "lv", "sh", "lh", "lut")]
        dims += [*x.shape[-2:], lf_torch.map_shift(m["sv"].shape[-2],
                                                   x.shape[-2]),
                 lf_torch.map_shift(m["sh"].shape[-2], x.shape[-1])]
    lead = planes[0].shape[:-2]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    check(lib.lf_twopass_launch(
        (vp * len(ptrs))(*ptrs), (ci * len(dims))(*dims), len(dims) // 4,
        lead[0] if lead else 1, bd,
        torch.cuda.current_stream().cuda_stream) == 0,
        "the two-launch deblocking")
    return out


def first_maps(planes, lf_maps):
    """The per-line int32 maps the first deblocking design reads, made on
    the card from the cell maps (`lf_torch.expand_maps`): for each plane
    None or ((size, lim) vertical, (size, lim) horizontal)."""
    return [None if m is None else tuple(
        tuple(t.contiguous() for t in lf_torch.expand_maps(
            m[s], m[lv], m["lut"], x.shape[-2 if s == "sv" else -1]))
        for s, lv in (("sv", "lv"), ("sh", "lh")))
        for x, m in zip(planes, lf_maps)]


def first_deblock(lib, planes, rows, bd):
    """The first design: two passes a plane that deblocks, each a launch
    of `lf_pass_kernel` on per-line maps `rows` (`first_maps`)."""
    out = list(planes)
    stream = torch.cuda.current_stream().cuda_stream
    for p, r in enumerate(rows):
        if r is None:
            continue
        *lead, H, W = out[p].shape
        for horizontal, (size, lim) in enumerate(r):
            ne = size.shape[-1]
            if ne < 1:
                continue
            dst = torch.empty_like(out[p])
            check(lib.lf_pass_launch_first(
                out[p].data_ptr(), dst.data_ptr(), size.data_ptr(),
                lim.data_ptr(), lead[0] if lead else 1, H, W, ne,
                horizontal, bd, stream) == 0, "the first deblocking design")
            out[p] = dst
    return out


def first_cdef(lib, planes, dirs, cd, bd):
    """The first design: a launch of `cdef_filter_kernel` a plane."""
    pri, sec = cdef_torch.strengths(cd, len(planes))
    damp = cd["damping"]
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for p, x in enumerate(planes):
        *lead, ph, pw = x.shape
        dst = torch.empty_like(x)
        check(lib.cdef_filter_launch_first(
            x.data_ptr(), dst.data_ptr(), dirs[0].data_ptr(),
            dirs[1].data_ptr(), pri[p].data_ptr(), sec[p].data_ptr(),
            cd["filt"].data_ptr(),
            damp.data_ptr() if isinstance(damp, torch.Tensor) else None,
            0 if isinstance(damp, torch.Tensor) else int(damp),
            lead[0] if lead else 1, ph, pw, *cd["filt"].shape[-2:],
            *cd["ss"], p, bd, stream) == 0, "the first CDEF design")
        out.append(dst)
    return out


def lf_cdef_timings(frames, dev):
    """Phase 3: on the 1080p deblocking key frame and the 4K 10-bit key
    frame (`check_postfilter`'s), each LF + CDEF kernel's work on the
    frame (the deblocking of every plane; the search; the filter of the
    three planes), back to back (CUDA events), beside the same work in
    its plain version, in its first design (YARDSTICKS: six deblocking
    passes on per-line maps expanded on the card before the timing, three
    filter launches; each held against the shipped kernel's output
    first), for the deblocking also in the two-launch design on cell
    maps the one-launch tile was raced against (held the same way), and
    its bound (`pf_bounds`); the whole chain against the plain
    chain; then the device operations a frame of both chains and the
    host maps' split on an inter frame of the 1080p inter stream (CDEF
    only) and of the 1080p LR + grain stream (deblocking on), under
    `torch.profiler` (tools/torch_postfilter_profile.py).  Returns
    {frame: {kernel: timings}} and the profile's results."""
    first = load_yardsticks()
    out = {}
    for name, f in frames.items():
        planes, m = f["planes"], f["maps"]
        bd, cd = m["bd"], m["cdef"]
        uh, uw = cd["filt"].shape[-2:]
        dirs = cdef_torch.dirs_launch(planes[0], uh, uw, cd["cs"], cd["tabs"])
        args = cdef_args(planes, dirs, cd)
        rows = first_maps(planes, m["lf"])
        work = {"deblock": (
                    lambda: lf_torch.lf_launch(planes, m["lf"], bd),
                    lambda: lf_torch.lf_frame_plain(planes, m["lf"], bd),
                    lambda: first_deblock(first["deblock"], planes, rows,
                                          bd)),
                "cdef_dirs": (lambda: cdef_torch.dirs_launch(
                                  planes[0], uh, uw, cd["cs"], cd["tabs"]),
                              lambda: cdef_torch.find_dirs(
                                  planes[0], uh, uw, cd["cs"], cd["tabs"]),
                              None),
                "cdef_filter": (
                    lambda: cdef_torch.filter_launch(planes, *args),
                    lambda: cdef_torch.filter_planes(planes, *args),
                    lambda: first_cdef(first["cdef_filter"], planes, dirs,
                                       cd, bd))}
        bounds = pf_bounds(f, dirs[1])
        t = out[name] = {}
        for k, (kern, plain, old) in work.items():
            nbytes, ops = bounds[k]
            bound, by = _bound(nbytes, ops)
            t[k] = {"ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 3),
                    "bound_ms": bound, "bound_by": by}
            first_txt = ""
            if old is not None:
                check(max_err(old(), kern()) == 0,
                      f"{name} key frame: the first {k} design differs from "
                      "the shipped kernel")
                t[k]["first_ms"] = cuda_ms(old, 20)
                first_txt = (f", first design {t[k]['first_ms']:.4f} ms "
                             f"({t[k]['first_ms'] / bound:.2f}x the bound)")
            if k == "deblock":
                def two():
                    return twopass_deblock(first["twopass"], planes, m["lf"],
                                           bd)

                check(max_err(two(), kern()) == 0,
                      f"{name} key frame: the two-launch deblocking differs "
                      "from the shipped kernel")
                t[k]["twopass_ms"] = cuda_ms(two, 20)
                first_txt += (f", two launches on cell maps "
                              f"{t[k]['twopass_ms']:.4f} ms "
                              f"({t[k]['twopass_ms'] / bound:.2f}x)")
            print(f"{name} key frame {k}: kernel {t[k]['ms']:.4f} ms "
                  f"({t[k]['ms'] / bound:.2f}x the bound){first_txt}, plain "
                  f"version {t[k]['plain_ms']:.3f} ms, bound "
                  f"{bound * 1e3:.3f} us ({by}: {nbytes / 1e6:.2f} MB, "
                  f"{ops / 1e6:.1f} M integer operations)")
        t["chain"] = {"ms": cuda_ms(lambda: postfilter_apply(planes, m), 20),
                      "plain_ms": cuda_ms(
                          lambda: postfilter_apply_plain(planes, m), 3)}

        def first_chain():
            d = first_deblock(first["deblock"], planes, rows, bd)
            return first_cdef(first["cdef_filter"], d, cdef_torch.dirs_launch(
                d[0], uh, uw, cd["cs"], cd["tabs"]), cd, bd)

        t["chain"]["first_ms"] = cuda_ms(first_chain, 20)
        n_lf = sum(r is not None for r in rows)
        print(f"{name} key frame LF + CDEF (postfilter_apply, 1 + 1 + 1 "
              f"launches): {t['chain']['ms']:.4f} ms; the first designs "
              f"({2 * n_lf} + 1 + {len(planes)} launches, on maps expanded "
              f"before) {t['chain']['first_ms']:.4f} ms; plain chain "
              f"{t['chain']['plain_ms']:.3f} ms (CUDA events)")
    spec = importlib.util.spec_from_file_location(
        "torch_postfilter_profile",
        os.path.join(REPO, "tools", "torch_postfilter_profile.py"))
    profile = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile)
    ops = profile.lf_cdef_ops(5, 3)
    print("LF + CDEF device operations a frame "
          "(tools/torch_postfilter_profile.py): " + "; ".join(
              f"{title} (deblocking {'on' if o['lf'] else 'off'}): kernels "
              f"{o['kernels']['ops']:.1f} in {o['kernels']['wall_ms']:.3f} ms "
              f"wall, busy share {o['kernels']['busy_ms'] / o['kernels']['wall_ms']:.3f}; "
              f"plain {o['plain']['ops']:.1f} in {o['plain']['wall_ms']:.3f} "
              f"ms wall; host maps (ms) " + ", ".join(
                  f"{n} {v:.3f}" for n, v in o["host_ms"].items())
              for title, o in ops.items()))
    return out, ops


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
    fgp, seq, u8 = inp["fg"]
    t0 = time.perf_counter()
    fg = fg_torch.FilmGrain(fgp, seq, 8, dev)
    torch.cuda.synchronize()
    fg_host_ms = (time.perf_counter() - t0) * 1e3
    fg_ms = cuda_ms(lambda: fg.apply(u8), 50)
    fg_plain_ms = cuda_ms(lambda: fg.apply_plain(u8), 5)
    print(f"seeded 1080p 4:2:0 planes (CUDA events): superres 1280 -> 1920 "
          f"of three planes (torch ops) {sr_ms:.3f} ms; film grain of three "
          f"planes, kernel {fg_ms:.4f} ms (plain version {fg_plain_ms:.3f} "
          f"ms) after {fg_host_ms:.3f} ms of host templates, LUTs and their "
          f"upload (host clock)")
    # byte bounds: each plane the stage reads read once, each plane it
    # writes written once (superres: int32 in and out, at the output
    # width; grain: the uint8 planes in and out)
    sr_bytes = sum(p.shape[0] * (p.shape[1] + dw) * 4
                   for p, _sw, dw in (inp["sr"][0], chroma, chroma))
    fg_bytes = sum(2 * t.numel() for t in u8)
    for name, nbytes, ms in (("superres", sr_bytes, sr_ms),
                             ("film grain", fg_bytes, fg_ms)):
        floor_us = nbytes / HBM_BYTES_PER_S * 1e6
        print(f"  {name}: {nbytes / 1e6:.3f} MB, byte bound "
              f"{floor_us:.3f} us, {ms * 1e3 / floor_us:.2f}x")
    every = traced_stages(lambda: easyav1_tpu_torch.EasyAV1(
        LR_GRAIN_1080, device="cuda"))
    log, key = [d for d in every if "mc" in d], every[0]
    stages = ("entropy", "plan", "prepare", "compose", "upload", "mc",
              "intra", "lf_cdef", "sr", "lr", "tail", "grain")
    med = {k: sorted(d.get(k, 0.0) for d in log)[len(log) // 2] * 1e3
           for k in stages}
    print("1080p LR + grain stream stages (ms, host spans, the device "
          "not synchronised), key frame: "
          + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in key.items()))
    print(f"  median over its {len(log)} inter frames: "
          + ", ".join(f"{k} {med[k]:.3f}" for k in stages)
          + f"; total {sum(med.values()):.3f}")
    log = traced_stages(lambda: easyav1_tpu_torch.EasyAV1(
        os.path.join(SMOKE, "superres_lr_1920x128.webm"), device="cuda"))
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
    every = traced_stages(lambda: easyav1_tpu_torch.EasyAV1(
        HBD_4K, device="cuda"))
    log, key_log = [d for d in every if "mc" in d], every[0]
    stages = ("entropy", "plan", "prepare", "compose", "upload", "mc",
              "intra", "lf_cdef", "lr", "tail")
    med = {k: sorted(d.get(k, 0.0) for d in log)[len(log) // 2] * 1e3
           for k in stages}
    print("4K 10-bit stream stages (ms, host spans, the device not "
          "synchronised), key frame: "
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


def itx_first_design():
    """The device composer's first design (tools/torch_itx_first.cu, the
    yardstick "itx_first" of `build`) on the dense records of the 1080p
    intra and the 4K 10-bit key frames: one zero fill of the planes and
    one launch a call, held to `compose_residual_plain` and timed by
    `cuda_ms`.  Prints {frame: {"ms": ...}} as one JSON line.
    `itx_timings` runs it in a process of its own: two builds of one
    kernel in one process have faulted on the card."""
    dev = torch.device("cuda", 0)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(str(_build.BUILD / "itx_first.so")).itx_compose_launch
    fn.restype = ci
    fn.argtypes = [ctypes.c_int64, vp, vp, ctypes.c_int64, ci, vp, vp, vp,
                   ci, vp]
    out = {}
    for name, path in (("1080p", INTRA_1080), ("4K 10-bit", HBD_4K)):
        k = first_frame_inputs(path, dev, host_residual=False)
        check(k is not None and k["records"] is not None,
              f"{path} frame 0 declined")
        dims, bd = k["recon"].dims, k["recon"].bd
        txs, co = (torch.from_numpy(a).to(dev) for a in k["dense"])
        sizes, n = [h * w for h, w in dims], len(dims)

        def compose():
            flat = torch.zeros(sum(sizes), dtype=itx_torch.residual_dtype(bd),
                               device=dev)
            planes = [v.view(d) for v, d in zip(flat.split(sizes), dims)]
            rc = fn(txs.shape[0], txs.data_ptr(), co.data_ptr(), co.shape[0],
                    n, (vp * n)(*(p.data_ptr() for p in planes)),
                    (ci * n)(*(h for h, _ in dims)),
                    (ci * n)(*(w for _, w in dims)), bd,
                    torch.cuda.current_stream(dev).cuda_stream)
            check(rc == 0, f"the first design's launch: cudaError {rc}")
            return planes

        e = max_err([g.long() for g in compose()],
                    [w.long() for w in itx_torch.compose_residual_plain(
                        txs, co, dims, bd, dev)])
        check(e == 0, f"the first design on {name}: max_abs_err {e}")
        out[name] = {"ms": cuda_ms(compose, 20)}
    print(json.dumps(out))


def itx_timings(frames):
    """Phase 3: the device composer's kernel on the packed records of the
    1080p intra and the 4K 10-bit key frames (CUDA events, back to back),
    its plain version, its bound on the packed input and the first
    design's on the dense input, and the first design
    (tools/torch_itx_first.cu) on the dense records, timed in a process
    of its own by `itx_first_design`."""
    r = subprocess.run([sys.executable, "-c",
                        "import chip_smoke; chip_smoke.itx_first_design()"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0,
          f"the first design's run: rc {r.returncode}\n{r.stdout[-3000:]}"
          f"{r.stderr[-3000:]}")
    first = json.loads(r.stdout.strip().splitlines()[-1])
    out = {}
    for name, rec in frames.items():
        ms = cuda_ms(rec.run, 20)
        plain = cuda_ms(rec.plain, 1)
        bound, by, nbytes = rec.bound_ms()
        dense, dense_by, dense_bytes = rec.bound_dense_ms()
        out[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": by, "bound_dense_ms": dense,
                     "first_ms": first[name]["ms"]}
        print(f"{name} frame 0 device composer ({rec.txs.shape[0]} "
              f"transforms, {rec.coeffs.numel()} packed coefficients of "
              f"{rec.dense[1].size}, {rec.bd}-bit): kernel {ms:.4f} ms, "
              f"first design {first[name]['ms']:.4f} ms, plain version "
              f"{plain:.1f} ms; bound {bound * 1e3:.3f} us "
              f"({nbytes / 1e6:.2f} MB, {by}; {ms / bound:.2f}x), dense bound "
              f"{dense * 1e3:.3f} us ({dense_bytes / 1e6:.2f} MB, {dense_by}; "
              f"first design {first[name]['ms'] / dense:.2f}x)")
    return out


# the bench streams on which both composers are timed: name, path,
# frames
COMPOSE_STREAMS = [("1080p intra", INTRA_1080, 30),
                   ("1080p inter", INTER_1080, 60), ("4K 10-bit", HBD_4K, 8)]


def _median(values):
    values = sorted(values)
    return values[len(values) // 2]


def compose_stages():
    """Phase 3: on the three bench streams, with the host C composer and
    with the device composer: the median stages "prepare", "pack",
    "compose" and "upload" and the frame's total (ms, host spans, the
    device not synchronised) over the inter frames (all
    frames of the intra stream) and on the key frame; the bytes of the
    residual uploaded a frame (int16 planes, or packed records and coded
    rows); and the port's fps in each mode beside the native C
    session's, which it returns by stream."""
    stages = ("prepare", "pack", "compose", "upload")
    out = {}
    for name, path, n in COMPOSE_STREAMS:
        fps = out[name] = {}
        for host in (True, False):
            mode = "host C composer" if host else "device composer"
            sizes, upload = [], IntraRecon.upload

            def spy(self, fields, resid, masks, schedule):
                # the packed records' class offsets stay on the host
                sizes.append(sum(a.nbytes for a in (
                    resid[:2] if isinstance(resid, tuple) else resid)))
                return upload(self, fields, resid, masks, schedule)

            IntraRecon.upload = spy
            try:
                log = traced_stages(lambda: easyav1_tpu_torch.EasyAV1(
                    path, device="cuda", host_residual=host))
            finally:
                IntraRecon.upload = upload
            check(len(log) == len(sizes) == n,
                  f"{name} {mode}: {len(log)} frames timed")
            check(all(("pack" in d) is not host for d in log),
                  f"{name} {mode}: the pack stage")
            rest = [i for i, d in enumerate(log) if "mc" in d] \
                or range(len(log))
            med = {k: _median(log[i].get(k, 0.0) for i in rest) * 1e3
                   for k in stages}
            total = _median(sum(log[i].values()) for i in rest) * 1e3
            print(f"{name} {mode}: median over {len(rest)} frames (ms): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
                  + f", frame total {total:.3f}; residual upload "
                  f"{_median(sizes[i] for i in rest) / 1e6:.3f} MB a frame; "
                  "key frame: "
                  + ", ".join(f"{k} {log[0].get(k, 0.0) * 1e3:.3f}"
                              for k in stages)
                  + f", residual upload {sizes[0] / 1e6:.3f} MB")
            _, wall = decode_hashes(lambda: easyav1_tpu_torch.EasyAV1(
                path, device="cuda", host_residual=host))
            fps[mode] = n / wall
        _, wall = decode_hashes(lambda: native_session(path))
        fps["native"] = n / wall
        print(f"{name} {n} frames: port with the host C composer "
              f"{fps['host C composer']:.3f} fps, with the device composer "
              f"{fps['device composer']:.3f} fps, native C session "
              f"{n / wall:.3f} fps (this host)")
    return out


# ------------------------------------------------------- the C ABI

# the C ABI's main pipe: the three bench streams and inter_modes_96x96,
# with their launches as on the Python API
CAPI_STREAMS = [s for s in STREAMS + HBD_STREAMS if s[0] in (
    "1080p inter", "1080p intra", "4K 10-bit", "inter modes 96x96")]
# the postfilter pipe (EASYAV1_PIPE=device): name, path, frames shown
POSTFILTER_STREAMS = [
    ("1080p LR + grain", LR_GRAIN_1080, 8),
    ("1080p intra, deblocking", LF_1080, 8),
    ("4K 10-bit", HBD_4K, 8),
    ("superres + LR 1920x128",
     os.path.join(SMOKE, "superres_lr_1920x128.webm"), 3)]
BITS_PER_COLOR_8 = 1        # easyav1.h's EASYAV1_BITS_PER_COLOR_8


class CAbi:
    """The port's C ABI (`capi.LIB`) loaded into this process: its shim
    finds this interpreter initialised and imports the bridge here, so
    its sessions share this process's `stats` and launch counters.  The
    session's device and pipe come from the environment, as for any C
    program (`capi/bridge.py`)."""

    def __init__(self):
        lib = ctypes.CDLL(str(capi.LIB))
        vp = ctypes.c_void_p
        lib.easyav1_init_from_filename.restype = vp
        lib.easyav1_init_from_filename.argtypes = [ctypes.c_char_p, vp]
        for name in ("easyav1_decode_next", "easyav1_has_video_frame",
                     "easyav1_get_status"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [vp]
        lib.easyav1_get_video_frame.restype = ctypes.POINTER(_VideoFrame)
        lib.easyav1_get_video_frame.argtypes = [vp]
        lib.easyav1_destroy.restype = None
        lib.easyav1_destroy.argtypes = [ctypes.POINTER(vp)]
        self.lib = lib

    @staticmethod
    def planes(f):
        """numpy views of a pulled `easyav1_video_frame`'s planes."""
        p = f.properties
        w, h = p.width, p.height
        cw, ch = {2: ((w + 1) >> 1, (h + 1) >> 1),
                  3: ((w + 1) >> 1, h)}.get(p.pixel_layout, (w, h))
        dt = np.uint8 if p.bits_per_color == BITS_PER_COLOR_8 else np.uint16
        out = []
        for i in range(3):
            if not f.data[i]:
                break
            pw, ph = (w, h) if i == 0 else (cw, ch)
            raw = (ctypes.c_uint8 * (f.stride[i] * ph)).from_address(
                f.data[i])
            out.append(np.frombuffer(raw, dt).reshape(ph, -1)[:, :pw])
        return out

    def decode_hashes(self, path):
        """(frame hashes, wall seconds) of every frame of a stream, pulled
        through the C ABI (default settings: `easyav1_decode_next`, then
        `easyav1_get_video_frame` while `easyav1_has_video_frame`); the
        session must end FINISHED."""
        lib = self.lib
        t0 = time.perf_counter()
        h = ctypes.c_void_p(lib.easyav1_init_from_filename(path.encode(),
                                                           None))
        check(h.value, f"C ABI init of {path} returned NULL")
        hashes = []
        try:
            for _ in range(4096):
                st = lib.easyav1_decode_next(h)
                while lib.easyav1_has_video_frame(h):
                    f = lib.easyav1_get_video_frame(h)
                    check(bool(f), f"C ABI {path}: a NULL frame")
                    hashes.append(frame_hash(self.planes(f.contents)))
                if st != 1:
                    break
            status = lib.easyav1_get_status(h)
        finally:
            lib.easyav1_destroy(ctypes.byref(h))
        check(status == 2, f"C ABI {path}: status {status}, not FINISHED")
        return hashes, time.perf_counter() - t0


class SuperresFrames:
    """Within the block, whether each frame that reaches the port's pipe
    has superres (`pipe.decode_and_recon`'s frame headers)."""

    def __enter__(self):
        self.frames, self.fn = [], pipe.decode_and_recon

        def spy(seq, hdr, *a, **k):
            self.frames.append(bool(getattr(hdr, "use_superres", False)))
            return self.fn(seq, hdr, *a, **k)

        pipe.decode_and_recon = spy
        return self

    def __exit__(self, *exc):
        pipe.decode_and_recon = self.fn


def run_client(path):
    """The port's client (`capi/capi_smoke.c`) in a process of its own on
    a stream, on the card: (key=value pairs, per-frame hashes).  The
    interpreter it embeds finds the repository and this interpreter's
    packages (torch, numpy) on PYTHONPATH."""
    site = os.path.dirname(os.path.dirname(torch.__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, site]))
    r = subprocess.run([str(capi.CLIENT), path], capture_output=True,
                       text=True, env=env, timeout=300)
    check(r.returncode == 0, f"the C client on {path}: rc {r.returncode}\n"
          f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    kv, hashes = {}, []
    for line in r.stdout.splitlines():
        if line.startswith("frame="):
            hashes.append(int(line.rsplit("hash=", 1)[1]))
            continue
        for part in line.split():
            if "=" in part:
                k, v = part.split("=", 1)
                kv[k] = v
    return kv, hashes


def check_capi():
    """Phase 2b: the C ABI.  Its main pipe on every frame of the three
    bench streams and inter_modes_96x96, in this process, each stream
    with its launch counts read just before it and just after:
    hash-equal to the native C session, no fallback, the launches of the
    Python API's main path; the 4K 10-bit stream again under
    `EASYAV1_HOST_RESID=0`, one device composer launch a frame that has
    transforms; the client executable in a process of its own on the
    1080p inter stream, its per-frame hashes (computed in C) equal and
    its status FINISHED, its decode rate as tools/easyav1_benchmark.c
    measures it; then the postfilter pipe (`EASYAV1_PIPE=device`) on
    POSTFILTER_STREAMS, hash-equal, the superres frames, and only those,
    declined to the C path.  Returns the fps of one pass each through
    the C ABI (`capi_fps` sets them beside the Python API's), the
    client's decode rate and the postfilter pipe's stages
    (`postfilter_stages`)."""
    abi = CAbi()
    fps = {}
    runs = [(s, False) for s in CAPI_STREAMS] + [
        (s, True) for s in CAPI_STREAMS if s[0] == "4K 10-bit"]
    for (name, path, n, want), device_composer in runs:
        mode = " (EASYAV1_HOST_RESID=0)" if device_composer else ""
        if device_composer:
            os.environ["EASYAV1_HOST_RESID"] = "0"
        easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
        c0 = trace.counters()
        try:
            with ComposerCalls() as composer, PostfilterCalls() as pf:
                got, wall = abi.decode_hashes(path)
        finally:
            os.environ.pop("EASYAV1_HOST_RESID", None)
        c, stats = counts(c0), dict(easyav1_tpu_torch.stats)
        native_h = native_hashes(path)
        print(f"C ABI {name}{mode}: {len(got)} frames in {wall:.3f} s, "
              f"stats {stats}, launches {c}")
        check(len(got) == n and got == native_h,
              f"C ABI {name}{mode}: {len(got)} frames, "
              f"{sum(a != b for a, b in zip(got, native_h))} differ")
        itx_want = composer.with_transforms if device_composer else 0
        check(stats == {"frames": want[0], "fallbacks": 0}
              and recon_counts(c) == want[1:] + (0, itx_want)
              and pf_counts(c) == pf.want and pf.frames == want[0]
              and c["lr"] == pf.lr_want
              and (itx_want > 0 or not device_composer),
              f"C ABI {name}{mode}: stats {stats}, launches {c}, want "
              f"{want} (frames, strip, 6a, 6b), {itx_want} composer "
              f"launches, "
              f"LF + CDEF {pf.want} and {pf.lr_want} LR")
        if not device_composer:
            fps[name] = n / wall
    kv, hashes = run_client(INTER_1080)
    check(hashes == native_hashes(INTER_1080) and kv["decode_status"] == "2"
          and kv["rate_status"] == "2"
          and int(kv["rate_frames"]) == len(hashes)
          and int(kv["pull_hash"]) == hashes[0],
          f"the C client on the 1080p inter stream: {kv}, {len(hashes)} "
          "frames, "
          f"{sum(a != b for a, b in zip(hashes, native_hashes(INTER_1080)))}"
          " differ")
    client = float(kv["rate_fps"])
    print(f"C client 1080p inter: {len(hashes)} frames hash-equal, status "
          f"FINISHED, decode rate {client} fps over {kv['rate_frames']} "
          "frames (tools/easyav1_benchmark.c's loop: no hash, no pull)")
    # the native session refuses to run under EASYAV1_PIPE=device
    for _name, path, _n in POSTFILTER_STREAMS:
        native_hashes(path)
    os.environ["EASYAV1_PIPE"] = "device"
    try:
        for name, path, n in POSTFILTER_STREAMS:
            native_h = native_hashes(path)
            easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
            c0 = trace.counters()
            with SuperresFrames() as sr, PostfilterCalls() as pf:
                got, wall = abi.decode_hashes(path)
            c, stats = counts(c0), dict(easyav1_tpu_torch.stats)
            check(got == native_h and len(got) == n,
                  f"postfilter pipe {name}: {len(got)} frames, "
                  f"{sum(a != b for a, b in zip(got, native_h))} differ")
            # the superres frames, and only those, take the C path; the
            # pipe launches none of the recon kernels, and the LF + CDEF
            # kernels as the other frames' headers ask
            check(stats == {"frames": len(sr.frames),
                            "fallbacks": sum(sr.frames)}
                  and any(sr.frames) == name.startswith("superres")
                  and not any(recon_counts(c))
                  and pf_counts(c) == pf.want and c["lr"] == pf.lr_want
                  and pf.frames == len(sr.frames) - sum(sr.frames),
                  f"postfilter pipe {name}: stats {stats}, superres "
                  f"{sr.frames}, launches {c}, LF + CDEF wanted {pf.want}")
            fps[f"postfilter {name}"] = n / wall
            print(f"C ABI postfilter pipe (EASYAV1_PIPE=device) {name}: "
                  f"{len(got)} frames hash-equal in {wall:.3f} s "
                  f"({n / wall:.3f} fps), stats {stats}, superres frames "
                  f"{sum(sr.frames)}")
    finally:
        os.environ.pop("EASYAV1_PIPE", None)
    return {"fps": fps, "client_1080p_inter_fps": client,
            "postfilter_stages": postfilter_stages()}


def capi_fps(c_abi, composer_fps):
    """The C ABI's fps on the bench streams beside the Python API's (the
    host C composer) and the native C session's from `compose_stages`,
    one pass each in this run, all with the frame hash."""
    for name, _path, n in COMPOSE_STREAMS:
        f = composer_fps[name]
        print(f"{name}, {n} frames, one pass each, with the frame hash: C "
              f"ABI (pull path) {c_abi['fps'][name]:.3f} fps, Python API "
              f"{f['host C composer']:.3f}, native C session "
              f"{f['native']:.3f}")


def postfilter_stages():
    """The postfilter pipe's stages through the Python API
    (`pipe="postfilter"`), median ms a frame over each stream's frames
    (host spans, the device not synchronised), on the streams of
    POSTFILTER_STREAMS without superres."""
    out = {}
    for name, path, n in POSTFILTER_STREAMS:
        if name.startswith("superres"):
            continue
        log = traced_stages(lambda: easyav1_tpu_torch.EasyAV1(
            path, device="cuda", pipe="postfilter"))
        check(len(log) == n, f"postfilter stages {name}: {len(log)} frames")
        names = [k for k in ("entropy", "recon", "upload", "lf_cdef", "lr",
                             "tail", "grain") if any(k in d for d in log)]
        med = {k: _median(d.get(k, 0.0) for d in log) * 1e3 for k in names}
        med["total"] = _median(sum(d.values()) for d in log) * 1e3
        out[name] = med
        print(f"postfilter pipe {name}: median over {n} frames (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
    return out


# --------------------------------------------- the multi-stream batch

def multistream_batches():
    """MS_BATCHES batches of MS_SLOTS 1080p key frames, LF and CDEF not
    yet applied: in each, half the slots hold frames of the deblocking
    stream (deblocking on, CDEF damping 6) and half frames of the 1080p
    intra stream (deblocking off, damping 4), no frame twice.  Returns a
    list of [(stream path, frame index, frame)]."""
    half = MS_SLOTS // 2
    lf = multistream_av1.decode_frames_unfiltered_native(LF_1080, 8)
    intra = multistream_av1.decode_frames_unfiltered_native(
        INTRA_1080, half * MS_BATCHES)
    batches = []
    for k in range(MS_BATCHES):
        slots = []
        for j in range(half):
            i = (half * k + j) % len(lf)
            slots += [(LF_1080, i, lf[i]),
                      (INTRA_1080, half * k + j, intra[half * k + j])]
        batches.append(slots)
    return batches


def check_multistream(dev):
    """The multi-stream phase: every slot of every batch through
    `batched_postfilter_real` (one pass a batch, over a stream axis) and
    `batched_postfilter_loop` (a pass a slot), each frame hash-equal to
    the native C session's; `MultiStreamPostfilter` at 8 streams of 1080p
    on the card bit-equal to the same step on the CPU."""
    batches = multistream_batches()
    n = 0
    for b, batch in enumerate(batches):
        frames = [f for _, _, f in batch]
        dims = [tuple(p.shape) for p in frames[0][2]]
        flags = [pf_planes_on(hdr, seq, len(dims))
                 for seq, hdr, *_ in frames]
        # the stacked pass filters a plane when any slot's does
        want_pf = {"batched": pf_launches(
            [any(f[0][p] for f in flags) for p in range(len(dims))],
            any(f[1] for f in flags), dims), "loop": dict.fromkeys(
                PF_KERNELS, 0)}
        for f in flags:
            for k, v in pf_launches(*f, dims).items():
                want_pf["loop"][k] += v
        outs = {}
        for how, run in (("batched", multistream_av1.batched_postfilter_real),
                         ("loop", multistream_av1.batched_postfilter_loop)):
            c0 = trace.counters()
            outs[how] = run(frames, dev)
            c = counts(c0)
            check(pf_counts(c) == want_pf[how] and not any(recon_counts(c)),
                  f"multi-stream batch {b} ({how}): launches {c}, want "
                  f"{want_pf[how]}")
        for s, (path, i, f) in enumerate(batch):
            want = native_hashes(path)[i]
            for how, out in outs.items():
                got = frame_hash(multistream_av1.shown_planes(
                    f, [o[s] for o in out]))
                check(got == want, f"multi-stream batch {b} slot {s} "
                      f"({os.path.basename(path)} frame {i}, {how}): hash "
                      f"{got}, native {want}")
                n += 1
    print(f"multi-stream: {len(batches)} batches of {MS_SLOTS} 1080p key "
          f"frames (deblocking on in half the slots, CDEF damping 6 and "
          f"4), {n} frames hash-equal to the native C session, batched "
          f"and slot by slot; LF + CDEF launches of the last batch as its "
          f"headers ask: {want_pf}")
    step = postfilter_torch.MultiStreamPostfilter(MS_SLOTS, 1080, 1920,
                                                  device=dev)
    inputs = step.example_inputs()
    got = step.step(*inputs).cpu()
    want = postfilter_torch.MultiStreamPostfilter(
        MS_SLOTS, 1080, 1920, device="cpu").step(*inputs)
    err = int((got - want).abs().max())
    check(err == 0, f"MultiStreamPostfilter on the card: max_abs_err {err}")
    print(f"MultiStreamPostfilter, {MS_SLOTS} streams of 1080x1920 luma: "
          f"bit-equal to the CPU")
    return batches


def _wall_ms(fn, reps):
    """Median wall time of fn, the device synchronised after each call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def multistream_timings(batches, dev):
    """Batch 0: wall ms of `batched_postfilter_real` against
    `batched_postfilter_loop` (host maps, uploads and filters); the device
    pass alone on uploaded inputs (CUDA events), one stacked pass against
    a pass a slot; the byte bound of the stacked pass (planes in and out,
    maps, at HBM_BYTES_PER_S); then BASELINE config 5 as
    `bench.py::bench_multistream_device` measures it."""
    frames = [f for _, _, f in batches[0]]
    s = len(frames)
    out = {"slots": s,
           "batched_ms": _wall_ms(lambda: multistream_av1.
                                  batched_postfilter_real(frames, dev), 5),
           "loop_ms": _wall_ms(lambda: multistream_av1.
                               batched_postfilter_loop(frames, dev), 5)}
    planes, stacked = multistream_av1.batch_inputs(frames, dev)
    single = [upload_maps(m, dev)
              for m in multistream_av1.batch_maps(frames)[1]]
    out["batched_device_ms"] = cuda_ms(lambda: postfilter_apply(planes,
                                                                stacked), 5)
    out["loop_device_ms"] = cuda_ms(lambda: [
        postfilter_apply([p[k] for p in planes], single[k])
        for k in range(s)], 5)
    nbytes = 2 * sum(p.numel() * 4 for p in planes) + map_bytes(stacked)
    out["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"multi-stream LF + CDEF, {s} 1080p key frames a batch: "
          f"batched_postfilter_real {out['batched_ms']:.3f} ms a batch "
          f"({out['batched_ms'] / s:.3f} a frame), batched_postfilter_loop "
          f"{out['loop_ms']:.3f} ({out['loop_ms'] / s:.3f}) (host clock, "
          f"synchronised, median of 5); the device pass on uploaded inputs "
          f"{out['batched_device_ms']:.3f} ms stacked against "
          f"{out['loop_device_ms']:.3f} slot by slot (CUDA events); byte "
          f"bound {out['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB)")
    step = postfilter_torch.MultiStreamPostfilter(s, 1080, 1920, device=dev)
    args = [torch.as_tensor(a).to(dev) for a in step.example_inputs()]
    out["step_ms"] = cuda_ms(lambda: step.step(*args), 5)
    nbytes = sum(a.numel() * 4 for a in args) + args[0].numel() * 4
    out["step_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"MultiStreamPostfilter.step, {s} streams of 1080x1920 luma: "
          f"{out['step_ms']:.3f} ms (CUDA events), byte bound "
          f"{out['step_bound_ms'] * 1e3:.3f} us ({nbytes / 1e6:.2f} MB)")
    out |= config5_fps(dev)
    return out


def map_bytes(maps):
    """Bytes of the deblocking and CDEF maps of `postfilter_maps` or
    `stack_maps`, CDEF's constant tables left out."""
    tensors = [t for m in maps["lf"] or () if m is not None
               for t in m.values()] + [
        t for k, t in (maps["cdef"] or {}).items()
        if isinstance(t, torch.Tensor) and k != "tabs"]
    return sum(t.numel() * t.element_size() for t in tensors)


def config5_fps(dev, streams=8, frames=3):
    """BASELINE config 5 as `bench.py::bench_multistream_device` measures
    it: `streams` resident sessions of the 1080p inter stream through the
    port's backend, interleaved a packet at a time, `frames` frames each,
    after a warm-up pass; every frame's device hash against the native C
    session's."""
    from easyav1_tpu_torch.container import TrackType, WebMDemuxer
    from easyav1_tpu_torch.video.av1.backend import AV1Backend

    dmx = WebMDemuxer(INTER_1080)
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    pkts = []
    while len(pkts) < frames and (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            pkts.extend(p.frames)
    pkts = pkts[:frames]

    def run(n):
        decs = [AV1Backend(vt, dev, resident=True) for _ in range(n)]
        hashes = [[] for _ in range(n)]
        t0 = time.perf_counter()
        for pk in pkts:
            for s, be in enumerate(decs):
                for f in be.decode([pk], 0):
                    hashes[s].append(resident.frame_hash_device(
                        f.data.device_planes))
        hashes = [[resident.hash_value(h) for h in hs] for hs in hashes]
        return hashes, time.perf_counter() - t0

    run(1)
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    hashes, wall = run(streams)
    want = native_hashes(INTER_1080)[:frames]
    check(all(h == want for h in hashes)
          and easyav1_tpu_torch.stats["fallbacks"] == 0,
          f"config 5: hashes {hashes}, native {want}, stats "
          f"{dict(easyav1_tpu_torch.stats)}")
    fps = streams * frames / wall
    print(f"config 5: {streams} interleaved resident sessions of the 1080p "
          f"inter stream, {frames} frames each, {fps:.3f} fps in all "
          f"({wall:.3f} s), every device hash equal to the native C session")
    return {"config5_fps": fps, "config5_streams": streams,
            "config5_frames": streams * frames}


# ------------------------------------------------- Vorbis synthesis

def vorbis_packets(path):
    dmx = WebMDemuxer(path)
    at = dmx.tracks_of_type(TrackType.AUDIO)[0]
    pkts = []
    while (p := dmx.read_packet()) is not None:
        if p.track == at.number:
            pkts.extend(p.frames)
    return at.vorbis_headers(), pkts


def vorbis_synth(dec, coupling, chunk, dev, band=True):
    i = dec.info
    return VorbisDeviceSynth(i.channels, i.blocksize0, i.blocksize1,
                             tuple(coupling), chunk=chunk,
                             band_limit=(dec.spectral_band_limits() if band
                                         else (0, 0)), device=dev)


def check_vorbis(dev):
    """The Vorbis phase, on both committed streams: the host pipeline
    (`decode_packet_host`), then the device synth fed a packet at a time
    as `bench.py::bench_vorbis` feeds it (chunk 512, the band limit, a
    warm-up first), within VORBIS_TOL of the host PCM, each timed on the
    host clock; chunk 7 and chunk 64 bit-equal on the card; and
    `MultiStreamVorbisSynth` at 8 streams on the card within VORBIS_TOL of
    its CPU run (relative to the peak: its example spectra are standard
    normal).  Returns the timings and the stereo stream's synth."""
    out = {}
    for name, path in (("stereo 30 s", VORBIS_30S),
                       ("clicks 2 s", VORBIS_CLICKS)):
        headers, pkts = vorbis_packets(path)
        t0 = time.perf_counter()
        dec = VorbisDecoder(headers)
        host = np.concatenate([dec.decode_packet_host(p) for p in pkts])
        t_host = time.perf_counter() - t0
        secs = host.shape[0] / dec.info.sample_rate
        dec = VorbisDecoder(headers)
        warm = [b for b in (dec.decode_packet_symbols(p) for p in pkts[:8])
                if b is not None]
        synth = vorbis_synth(dec, warm[0].coupling, 512, dev)
        synth.process(warm)
        synth.reset()
        dec = VorbisDecoder(headers)
        t0 = time.perf_counter()
        synth.begin()
        blocks = []
        for p in pkts:
            b = dec.decode_packet_symbols(p)
            if b is not None:
                blocks.append(b)
                synth.feed([b])
        pcm = synth.finish()
        t_dev = time.perf_counter() - t0
        err = float(np.abs(pcm - host).max()) if pcm.shape == host.shape \
            else float("inf")
        check(err < VORBIS_TOL, f"Vorbis {name}: device synth against the "
              f"host decoder {pcm.shape} {host.shape}, max_abs_err {err}")
        out[name] = {"seconds": secs, "host_xrt": secs / t_host,
                     "device_xrt": secs / t_dev, "max_abs_err": err,
                     "blocks": len(blocks)}
        print(f"Vorbis {name}: {len(blocks)} blocks, {secs:.3f} s of audio; "
              f"host pipeline {secs / t_host:.1f}x realtime, device synth "
              f"fed a packet at a time {secs / t_dev:.1f}x (host symbol "
              f"decode included), max_abs_err {err:.3g} against the host")
        if name == "clicks 2 s":
            a, b = (vorbis_synth(dec, blocks[0].coupling, c, dev,
                                 band=False).process(blocks) for c in (7, 64))
            check(np.array_equal(a, b), "Vorbis chunk 7 against chunk 64 "
                  "on the card")
            print("Vorbis clicks 2 s: chunk 7 and chunk 64 bit-equal on the "
                  "card")
        else:
            out["synth"] = (synth, blocks)
    ms = MultiStreamVorbisSynth(MS_SLOTS, 2, 256, 2048, chunk=16, device=dev)
    inputs = ms.example_inputs(np.random.default_rng(0))
    got = ms.step(*inputs).cpu().numpy()
    want = MultiStreamVorbisSynth(MS_SLOTS, 2, 256, 2048, chunk=16,
                                  device="cpu").step(*inputs).numpy()
    err = float(np.abs(got - want).max())
    check(err <= VORBIS_TOL * float(np.abs(want).max()),
          f"MultiStreamVorbisSynth on the card: max_abs_err {err}, peak "
          f"{np.abs(want).max()}")
    print(f"MultiStreamVorbisSynth, {MS_SLOTS} streams, chunk 16, n1 2048: "
          f"max_abs_err {err:.3g} against the CPU (peak "
          f"{np.abs(want).max():.1f})")
    out["multistream"] = {"max_abs_err": err, "ms": ms, "inputs": inputs}
    return out


def vorbis_timings(v, dev):
    """The synth alone on one chunk of 512 stereo blocks (CUDA events),
    beside its bound (2 B ch bl1 n1 operations of float32 at
    FP32_OPS_PER_S, against its bytes) and one `torch.matmul` of the long
    IMDCT on the same spectra; `MultiStreamVorbisSynth.step` likewise."""
    synth, blocks = v.pop("synth")
    got = {}
    orig = synth.synth

    def spy(*args):
        got.setdefault("args", args)
        return orig(*args)

    synth.synth = spy
    synth.process(blocks[:synth.chunk])
    synth.synth = orig
    args = got["args"]
    B, ch, n1 = synth.chunk, synth.ch, synth.n1
    t = {"ms": cuda_ms(lambda: synth.synth(*args), 10)}
    long_rows = args[0][:B * ch * synth.bl1].reshape(B * ch, synth.bl1)
    t["library_ms"] = cuda_ms(lambda: torch.matmul(long_rows,
                                                   synth._imdct1), 10)
    ops = 2 * B * ch * (synth.bl1 * n1 + synth.bl0 * synth.n0)
    nbytes = (args[0].numel() * 4 + synth._imdct1.numel() * 4
              + synth._imdct0.numel() * 4 + ch * synth._buf_len * 4)
    t["bound_ms"], t["bound_by"] = _bound(nbytes, ops, FP32_OPS_PER_S)
    print(f"Vorbis synth, a chunk of {B} stereo blocks (bl1 {synth.bl1}): "
          f"{t['ms']:.4f} ms (CUDA events), one torch.matmul of the long "
          f"IMDCT {t['library_ms']:.4f} ms, bound {t['bound_ms'] * 1e3:.3f} "
          f"us ({t['bound_by']}: {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} "
          f"MB)")
    m = v["multistream"]
    ms, inputs = m.pop("ms"), [torch.from_numpy(np.asarray(a)).to(dev)
                               for a in m.pop("inputs")]
    S, B, ch, n2 = ms.S, ms.B, ms.ch, ms.n1 // 2
    m["ms"] = cuda_ms(lambda: ms.step(*inputs), 10)
    ops = 2 * S * B * ch * n2 * ms.n1
    nbytes = (2 * S * B * ch * n2 + S * ch * n2 + S * ch * ms.BUF
              + n2 * ms.n1) * 4
    m["bound_ms"], m["bound_by"] = _bound(nbytes, ops, FP32_OPS_PER_S)
    print(f"MultiStreamVorbisSynth.step, S {S}, chunk {B}, n1 {ms.n1}: "
          f"{m['ms']:.4f} ms (CUDA events), bound {m['bound_ms'] * 1e3:.3f} "
          f"us ({m['bound_by']})")
    v["synth_chunk"] = t
    return v


def kernel_entry(name, source, replaces, launches, err, t):
    """One entry of the kernels line; t: {"ms", "plain_ms", "bound_ms",
    "bound_by"} from this run, for a redesigned kernel "first_ms" (the
    first design's time, on the same input), for the deblocking
    "twopass_ms" (the two-launch design's), and for the device composer
    "bound_dense_ms" (its first design's bound, on the dense input)."""
    extra = {"bound_dense_ms": t["bound_dense_ms"]} \
        if "bound_dense_ms" in t else {}
    if "first_ms" in t:
        extra["first_design_ms"] = t["first_ms"]
    if "twopass_ms" in t:
        extra["twopass_ms"] = t["twopass_ms"]
    return {"name": name, "route": "cuda",
            "source": f"easyav1_tpu_torch/csrc/{source}",
            "replaces": f"easyav1_tpu/video/av1/recon/{replaces}",
            "launches": launches, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None} | extra


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
    err_itx, err_itx16, itx_frames = check_itx(dev)
    err_pf, err_pf16, pf_frames = check_postfilter(dev, hbd_key)
    stage_inputs = check_torch_stages(dev)
    err_lr, lr_inputs = check_lr(dev)
    # the main path: the 8-bit streams, then the 10- and 12-bit ones (the
    # kernels' uint16 instantiations); each stream's counts are read just
    # before it and just after
    launches = main_path(STREAMS)
    check(all(v > 0 for k, v in launches.items() if k != "itx_compose"),
          f"a kernel never ran on the 8-bit streams: {launches}")
    launches16 = main_path(HBD_STREAMS)
    check(all(v > 0 for k, v in launches16.items() if k != "itx_compose"),
          f"a kernel never ran on the 10- and 12-bit streams: {launches16}")
    print(f"main path launches: 8-bit streams {launches}, 10- and 12-bit "
          f"streams {launches16}")
    # the main path with the device residual composer, its own counts
    composer = main_path(COMPOSER_STREAMS, host_residual=False)
    composer16 = main_path(COMPOSER_STREAMS_HBD, host_residual=False)
    check(composer["itx_compose"] > 0 and composer16["itx_compose"] > 0,
          f"the device composer never ran: {composer}, {composer16}")
    print(f"main path launches with the device composer: 8-bit streams "
          f"{composer}, 10- and 12-bit streams {composer16}")
    # the C ABI: its main pipe, the client executable, its postfilter pipe
    c_abi = check_capi()
    t = timings(frames, dev)
    tpf, pf_ops = lf_cdef_timings(pf_frames, dev)
    ti = inter_timings(caps, prog, dev)
    th = hash_timings(dev)
    stage_timings(stage_inputs, dev)
    tlr = lr_timings(lr_inputs)
    t16 = hbd_timings(hbd_key, cap16, prog16, dev)
    titx = itx_timings(itx_frames)
    capi_fps(c_abi, compose_stages())
    # the off-path modules: the multi-stream batch and Vorbis synthesis
    batches = check_multistream(dev)
    vorbis = check_vorbis(dev)
    print(json.dumps({"multistream": multistream_timings(batches, dev),
                      "vorbis": vorbis_timings(vorbis, dev),
                      "c_abi": c_abi, "lf_cdef": tpf,
                      "lf_cdef_ops": pf_ops}))
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
                     t16["hash"]),
        kernel_entry("itx_compose", "itx.cu", "itx_jax.py:31",
                     composer["itx_compose"], err_itx, titx["1080p"]),
        kernel_entry("itx_compose_hbd", "itx.cu", "itx_jax.py:31",
                     composer16["itx_compose"], err_itx16,
                     titx["4K 10-bit"]),
        kernel_entry("lr", "lr.cu", "lr_jax.py:47", launches["lr"], err_lr,
                     tlr["1920x1080 8-bit"]),
        kernel_entry("lr_hbd", "lr.cu", "lr_jax.py:47", launches16["lr"],
                     err_lr, tlr["3840x2160 10-bit"])] + [
        kernel_entry(name + suffix, source, replaces, lc[name], err[name],
                     tpf[frame][name])
        for suffix, lc, err, frame in (("", launches, err_pf, "1080p"),
                                       ("_hbd", launches16, err_pf16,
                                        "4K 10-bit"))
        for name, source, replaces in (
            ("deblock", "loopfilter.cu", "lf_jax.py:27"),
            ("cdef_dirs", "cdef.cu", "cdef_jax.py:245"),
            ("cdef_filter", "cdef.cu", "cdef_jax.py:107"))]}))
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.split(".")[0] == "easyav1_tpu")
    check(not leaked, f"imported {leaked}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
