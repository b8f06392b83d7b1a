"""The port's intra strip executor against the JAX package, exactly.

- `strip_exec_plain` against `exec_ref.UnitExecutor` on seeded random
  unit programs of every class;
- `strip_exec_plain` against the Pallas strip kernel in interpret mode;
- `IntraRecon` (the whole device intra recon: records, host residual,
  luma then chroma) against the native C recon with LF and CDEF off, on
  real libaom key frames;
- the superblock (SB) schedule of the wavefront kernel on real exports
  with 64x64 and 128x128 SBs and several tile columns: every pixel a
  unit reads lies in its own SB or in one the wavefront has finished;
  the plain executor gives the same planes with the records in wavefront
  order; the spans equal a brute-force scan;
- the level order inside each SB (`av1_strip_levels`), on those exports
  and the bench streams' key frames: a unit's level is one more than
  the highest of the units of its SB whose pixels it reads, each SB's
  order is a topological order of decode order, the plain executor
  gives the same planes in it (also on seeded SB programs with inter
  blocks and interintra units), and intrabc frames keep decode order;
- sparse inter frames (units in a few SBs of an 8 x 15 grid): the host
  half counts the SBs without units that the kernel passes over;
- the CUDA kernel against its plain version (needs the card), also on
  the sparse frames, and a frame without units launching nothing.
"""

import ctypes
import functools
import hashlib
import subprocess

import numpy as np
import pytest
import torch

import easyav1_tpu.native as nat
from easyav1_tpu.container.webm import TrackType, WebMDemuxer
from easyav1_tpu.video.av1.backend import AV1Backend
from easyav1_tpu.video.av1.recon import jax_exec as JX
from easyav1_tpu.video.av1.recon.exec_ref import UnitExecutor
from easyav1_tpu_torch import trace
from easyav1_tpu_torch.native.pipe import export_units, first_frame_inputs
from easyav1_tpu_torch.unit_programs import (MI_COLS, MI_ROWS, program_frame,
                                             random_program, random_sb_program)
from easyav1_tpu_torch.video.av1.recon import records as R
from easyav1_tpu_torch.video.av1.recon.inter_exec import InterRecon, ii_masks
from easyav1_tpu_torch.video.av1.recon.intra_exec import IntraRecon
from easyav1_tpu_torch.video.av1.recon.intra_strip import (
    sb_grid, sb_schedule, schedule_to, sequential_schedule,
    strip_exec_frame, strip_exec_frame_plain, strip_exec_plain)

from fixtures import CACHE, tool
from test_av1_multitg import _fixture as multitg_fixture
from test_av1_real import real_fixture
from test_torch_fixtures import steady

SEEDS = [301, 304, 305, 317, 310]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _plain(prog, device="cpu"):
    plane = prog["plane"]
    fields = JX.preprocess_units(prog["units"], prog["dims"], pad=0)[plane]
    luma = torch.from_numpy(prog["luma"]).to(device) if plane else None
    return strip_exec_plain(torch.from_numpy(fields).to(device),
                            torch.from_numpy(prog["resid"][plane]).to(device),
                            prog["dims"][plane], 8, luma)


def _assert_equal(got, want, what):
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert d.max() == 0, (f"{what}: maxdiff {d.max()} at "
                          f"{np.argwhere(d > 0)[:4].tolist()}")


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_vs_exec_ref(seed):
    prog = random_program(seed)
    plane = prog["plane"]
    ex = UnitExecutor(MI_ROWS, MI_COLS, 1, 1, 8, 3)
    if plane:
        ex.planes[0][:] = prog["luma"]
    gold = ex.run(prog["units"], [r.astype(np.int64) for r in prog["resid"]])
    _assert_equal(_plain(prog).numpy(), gold[plane], f"plane {plane}")


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_plain_vs_pallas_interpret(seed):
    import jax.numpy as jnp
    from easyav1_tpu.video.av1.recon import intra_pallas as IP

    prog = random_program(seed)
    plane = prog["plane"]
    pr = JX.PallasRecon(MI_ROWS, MI_COLS, 1, 1, 8, 3, interpret=True)
    fields = JX.preprocess_units(prog["units"], pr.dims, pad=0)
    hp, wp, ns = pr.layouts[plane]
    ph, pw = pr.dims[plane]
    rp = np.zeros((hp, wp), np.int32)
    rp[:ph, IP.LPAD:IP.LPAD + pw] = prog["resid"][plane]
    u3, cnt, umax = pr._strip_fields(fields[plane], plane)
    args = [jnp.asarray(u3), jnp.asarray(cnt), jnp.asarray(rp)]
    wp0 = 0
    if plane:
        hp0, wp0, _ = pr.layouts[0]
        lum = np.zeros((hp0, wp0), np.int32)
        lum[:pr.dims[0][0], IP.LPAD:IP.LPAD + pr.dims[0][1]] = prog["luma"]
        args.append(jnp.asarray(lum))
    k = IP.make_strip_kernel(pr.strips[plane], wp, ns, umax, 8,
                             plane > 0, wp0, True)
    want = np.asarray(k(*args))[:ph, IP.LPAD:IP.LPAD + pw]
    _assert_equal(_plain(prog).numpy(), want, f"plane {plane}")


def _first_keyframe(path):
    """(seq, hdr, tiles) of the stream's first frame."""
    lib = nat._load()
    if lib is None:
        pytest.skip("native library unavailable")
    dmx = WebMDemuxer(str(path))
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = AV1Backend(vt)
    be._fp_on = False
    got = {}
    orig = nat.decode_and_recon_native

    def hook(seq, hdr, tiles, **kw):
        got.update(seq=seq, hdr=hdr, tiles=tiles)
        raise StopIteration

    nat.decode_and_recon_native = hook
    try:
        while "hdr" not in got:
            p = dmx.read_packet()
            if p.track == vt.number:
                try:
                    be.decode(p.frames, 0)
                except StopIteration:
                    pass
    finally:
        nat.decode_and_recon_native = orig
    return lib, got["seq"], got["hdr"], got["tiles"]


@pytest.mark.parametrize("tag,w,h", [("64", 64, 64), ("128", 128, 128),
                                     ("qcif", 176, 144)])
def test_intra_recon_vs_native(tag, w, h):
    """Raw recon (LF and CDEF off) of the first key frame."""
    path, _ = steady(real_fixture, tag, w, h)
    lib, seq, hdr, tiles = _first_keyframe(path)
    out, bufs, _blob, (fp_rc, _keep) = nat._run_tiles(lib, seq, hdr, tiles)
    rp = nat._build_rp(seq, hdr)
    rp.lf_level = (ctypes.c_int32 * 4)(0, 0, 0, 0)
    rp.enable_cdef = 0
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    ir = IntraRecon(hdr.mi_rows, hdr.mi_cols, ssx, ssy, seq.color.bitdepth,
                    seq.color.num_planes,
                    128 if seq.use_128x128_superblock else 64,
                    torch.device("cpu"))
    gold = [np.empty(d, np.uint16) for d in ir.dims]
    assert lib.av1_recon_frame(ctypes.byref(rp), ctypes.byref(out),
                               ctypes.byref(fp_rc),
                               ctypes.byref(nat._RefPlanes()),
                               *(nat._vp(g) for g in gold)) == 0
    planes = ir.run(export_units(lib, hdr, out, rp), bufs["txs"][:out.n_txs],
                    bufs["coeffs"][:out.coeffs_used],
                    literals=nat._export_literals(lib, rp, out))
    assert planes is not None, "declined"
    for p, (a, b) in enumerate(zip(planes, gold)):
        _assert_equal(a.numpy(), b, f"{tag} plane {p}")


def _sb128_fixture():
    """The all-intra 512x512 stream with 128x128 SBs, made with the
    arguments of test_av1_sb128.py::test_sb128_intra_rich; run under
    `steady`."""
    tail = ["w=512", "h=512", "fps=30", "frames=2", "gop=1", "crf=30",
            "audio_secs=0", "content=1", "vopt:sb-size=128"]
    out = CACHE / f"sb128_{hashlib.sha1(' '.join(tail).encode()).hexdigest()[:8]}.webm"
    if not out.exists():
        r = subprocess.run([str(tool("make_fixture")), str(out)] + tail,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
    return out


# real key frames: (SB size, tile columns) = (64, 1), (64, 2), (128, 1),
# (128, 4)
KEY_FRAMES = {
    "qcif": lambda: steady(real_fixture, "qcif", 176, 144)[0],
    "tiles2x2": lambda: steady(multitg_fixture, 320, 240, 3, 1, 4)[0],
    "sb128": lambda: steady(_sb128_fixture),
    "sb128_tiles4": lambda: steady(multitg_fixture, 640, 360, 3, 100, 2,
                                   tile_cols=2, tile_rows=0)[0],
}
SB_TILES = {"qcif": (64, 1), "tiles2x2": (64, 2), "sb128": (128, 1),
            "sb128_tiles4": (128, 4)}


def _key_inputs(tag):
    """The port's first-frame export of a KEY_FRAMES stream on the CPU:
    numpy fields per plane, the dims and the SB size."""
    key = first_frame_inputs(str(KEY_FRAMES[tag]()), torch.device("cpu"))
    assert key is not None
    sb = key["recon"].sb
    assert (sb, key["hdr"].tile.cols) == SB_TILES[tag]
    return key, [f.numpy() for f in key["fields"]], key["recon"].dims, sb


def _reads(f, plane, dims):
    """(plane, ys, xs) of every pixel a unit reads before it writes:
    corner, `na` above, `nl` left (clamped as the executor clamps), and
    the CfL luma block."""
    ph, pw = dims[plane]
    x, y, w, h = (int(f[k]) for k in (R.F_X, R.F_Y, R.F_W, R.F_H))
    ha, hl = f[R.F_HA] != 0, f[R.F_HL] != 0
    ys, xs = [], []
    if ha:
        ys += [y - 1] * (f[R.F_NA] + 1)
        xs += [x - 1 if hl else x] + [min(x + i, pw - 1)
                                       for i in range(f[R.F_NA])]
    if hl:
        ys += [y] + [min(y + i, ph - 1) for i in range(f[R.F_NL])]
        xs += [x - 1] * (f[R.F_NL] + 1)
    out = [(plane, np.array(ys, int), np.array(xs, int))]
    if plane and f[R.F_CLS] == R.K_CFL and f[R.F_ALPHA]:
        acx, acy, acw, ach = (int(f[k]) for k in (R.F_ACX, R.F_ACY,
                                                  R.F_ACW, R.F_ACH))
        ly, lx = np.mgrid[2 * acy:2 * (acy + ach), 2 * acx:2 * (acx + acw)]
        out.append((0, ly.ravel(), lx.ravel()))
    return out


@pytest.mark.parametrize("tag", sorted(KEY_FRAMES) + ["bench1080"])
def test_wavefront_reads_only_finished_sbs(tag):
    """(a) Every pixel a unit reads lies in its own SB, or in an SB the
    wavefront has finished before that SB starts: in its own plane the
    SBs left of it in its row and, k rows up, those up to column c + k;
    in luma, for chroma CfL, the same up to column c in its row."""
    if tag == "bench1080":
        path = "tests/data/bench/bench_av1_intra_1920x1080_30.webm"
        key = first_frame_inputs(path, torch.device("cpu"))
        fields = [f.numpy() for f in key["fields"]]
        dims, sb = key["recon"].dims, key["recon"].sb
        assert sb == 128
    else:
        key, fields, dims, sb = _key_inputs(tag)
    cols = -(-dims[0][1] // sb)
    n_checked = 0
    for p, fp in enumerate(fields):
        sbh, sbw = (sb >> 1, sb >> 1) if p else (sb, sb)
        for f in fp:
            r, c = int(f[R.F_Y]) // sbh, int(f[R.F_X]) // sbw
            for q, ys, xs in _reads(f, p, dims):
                if ys.size == 0:
                    continue
                qh, qw = (sb >> 1, sb >> 1) if q else (sb, sb)
                sr, sc = ys // qh, xs // qw
                up = r - sr
                if q == p:
                    ok = ((up == 0) & (sc <= c)) | \
                        ((up > 0) & (sc <= np.minimum(c + up, cols - 1)))
                else:
                    ok = (up >= 0) & (sc <= np.minimum(c + up, cols - 1))
                assert ok.all(), (tag, p, f.tolist(), q, sr[~ok], sc[~ok])
                n_checked += ys.size
    assert n_checked > 1000


def _wavefront_order(fp, spans, rows, cols):
    """The records of one plane reordered SB by SB in anti-diagonal
    order (c + 2r, r), decode order within each SB."""
    order = sorted(((c + 2 * r, r, c) for r in range(rows)
                    for c in range(cols)))
    idx = [np.arange(*spans[r * cols + c]) for _, r, c in order]
    idx = np.concatenate(idx)
    assert np.array_equal(np.sort(idx), np.arange(fp.shape[0]))
    return fp[idx]


@pytest.mark.parametrize("tag", sorted(KEY_FRAMES))
def test_wavefront_order_gives_sequential_planes(tag):
    """(b) The plain executor on the records permuted into wavefront
    order equals it in decode order, exactly."""
    key, fields, dims, sb = _key_inputs(tag)
    _sbh, _sbw, spans, _order = sb_schedule(fields, dims, sb)
    rows, cols = sb_grid(dims, sb, sb)[0][:2]
    resid = key["resid"]
    want = strip_exec_frame_plain(key["fields"], resid, dims, 8)
    for p, fp in enumerate(fields):
        perm = torch.from_numpy(_wavefront_order(fp, spans[p, :, :2], rows,
                                                 cols))
        got = strip_exec_plain(perm, resid[p], dims[p], 8,
                               want[0] if p else None)
        _assert_equal(got.numpy(), want[p].numpy(), f"{tag} plane {p}")


@pytest.mark.parametrize("tag", sorted(KEY_FRAMES)[:2])
def test_sb_spans_match_brute_force(tag):
    """(c) Each SB's span is the run of records whose top-left pixel
    lies in it, found by a scan of every SB; empty SBs have empty
    spans."""
    _key, fields, dims, sb = _key_inputs(tag)
    _sbh, _sbw, spans, _order = sb_schedule(fields, dims, sb)
    rows, cols = -(-dims[0][0] // sb), -(-dims[0][1] // sb)
    assert spans.shape == (len(fields), rows * cols, 4)
    for p, fp in enumerate(fields):
        s = sb >> (p > 0)
        for r in range(rows):
            for c in range(cols):
                idx = np.flatnonzero((fp[:, R.F_Y] // s == r)
                                     & (fp[:, R.F_X] // s == c))
                b, e = spans[p, r * cols + c, :2]
                assert e - b == idx.size
                if idx.size:
                    assert np.array_equal(idx, np.arange(b, e))


def test_sb_schedule_raises_on_split_sb():
    """(c) Units of one SB separated by a unit of another SB raise."""
    f = np.zeros((3, R.NF), np.int32)
    f[:, R.F_X] = [0, 64, 4]
    with pytest.raises(ValueError, match=r"SB \(0, 0\).*not contiguous"):
        sb_schedule([f], [(64, 128)], 64)
    f[:, R.F_W] = 4
    f[:, R.F_X] = [0, 4, 62]
    with pytest.raises(ValueError, match="unit crosses its SB"):
        sb_schedule([f], [(64, 128)], 64)
    # SB 0: records 0 and 1, one level (neither reads the other), its
    # order [0, 1] and the level's end 2 at offset 0; SB 1 empty
    _sbh, _sbw, spans, order = sb_schedule([f[:2]], [(64, 128)], 64)
    assert spans.tolist() == [[[0, 2, 0, 1], [0, 0, 3, 0]]]
    assert order.tolist() == [0, 1, 2]
    sbh, sbw, spans, order = sequential_schedule([f, f[:1]],
                                                 [(64, 128), (32, 64)])
    assert (sbh, sbw) == (64, 128)
    assert spans.tolist() == [[[0, 3, 0, 0]], [[0, 1, 0, 0]]]
    assert order.size == 0


# the bench streams' key frames: the 1080p intra stream's, and those of
# the three configurations' streams (4K 10-bit, 1080p grain, 1080p inter)
BENCH_KEYS = {"bench1080": "bench_av1_intra_1920x1080_30.webm",
              "bench4k10": "bench_av1_10bit_3840x2160_8.webm",
              "bench_grain": "bench_av1_lr_grain_1920x1080_8.webm",
              "bench_inter": "bench_av1_inter_1920x1080_60.webm"}
ORDER_TAGS = sorted(KEY_FRAMES) + sorted(BENCH_KEYS)


@functools.lru_cache(maxsize=1)
def _order_inputs(tag):
    """(fields, dims, sb, sb_schedule) of a KEY_FRAMES or BENCH_KEYS key
    frame, exported on the CPU."""
    if tag in BENCH_KEYS:
        key = first_frame_inputs(f"tests/data/bench/{BENCH_KEYS[tag]}",
                                 torch.device("cpu"))
        assert key is not None
        fields = [f.numpy() for f in key["fields"]]
        dims, sb = key["recon"].dims, key["recon"].sb
    else:
        _key, fields, dims, sb = _key_inputs(tag)
    return fields, dims, sb, sb_schedule(fields, dims, sb)


def _record_levels(spans, order, n):
    """One plane's level of each record (1 up) and its place in the
    plane's level order (SB by SB, each SB's order), holding each SB's
    order to be its records by level, decode order within a level."""
    lv = np.zeros(n, np.int64)
    at = np.zeros(n, np.int64)
    for u0, u1, o0, nl in spans.tolist():
        k = u1 - u0
        if k == 0:
            assert nl == 0
            continue
        perm, ends = order[o0:o0 + k], order[o0 + k:o0 + k + nl]
        assert np.array_equal(np.sort(perm), np.arange(k))
        steps = np.diff(np.r_[0, ends])
        assert nl >= 1 and ends[-1] == k and (steps > 0).all()
        lev = np.repeat(np.arange(1, nl + 1), steps)
        assert ((np.diff(lev) > 0) | (np.diff(perm) > 0)).all()
        lv[u0 + perm] = lev
        at[u0 + perm] = o0 + np.arange(k)
    return lv, at


def _in_sb_reads(fp, p, dims, sb):
    """Each unit of plane p with the units of its own SB whose pixels it
    reads (`_reads`), and the SB rows up and columns of the reads that
    lie in other SBs: (u, (r, c), writers, rows up, columns)."""
    ph, pw = dims[p]
    s = sb >> (p > 0)
    who = np.full((ph, pw), -1, np.int64)
    for u, f in enumerate(fp):
        who[f[R.F_Y]:f[R.F_Y] + f[R.F_H], f[R.F_X]:f[R.F_X] + f[R.F_W]] = u
    for u, f in enumerate(fp):
        r, c = int(f[R.F_Y]) // s, int(f[R.F_X]) // s
        _q, ys, xs = _reads(f, p, dims)[0]
        own = (ys // s == r) & (xs // s == c)
        yield (u, (r, c), who[ys[own], xs[own]], r - ys[~own] // s,
               xs[~own] // s)


@pytest.mark.parametrize("tag", ORDER_TAGS)
def test_level_order_reads_lower_levels(tag):
    """Every pixel a unit reads in its own SB was written by a unit of
    that SB decoded before it and of a lower level, and the unit's level
    is one more than the highest of them (1 if none); every other pixel
    it reads lies in an SB the wavefront has finished (in its row, to its
    left; k rows up, up to column c + k)."""
    fields, dims, sb, (_h, _w, spans, order) = _order_inputs(tag)
    cols = -(-dims[0][1] // sb)
    n_checked = 0
    for p, fp in enumerate(fields):
        lv, _at = _record_levels(spans[p], order, fp.shape[0])
        for u, (_r, c), dep, up, sc in _in_sb_reads(fp, p, dims, sb):
            assert (dep >= 0).all() and (dep < u).all(), (tag, p, u)
            assert lv[u] == 1 + (lv[dep].max() if dep.size else 0), \
                (tag, p, u, lv[u], lv[dep])
            ok = ((up == 0) & (sc < c)) | \
                ((up > 0) & (sc <= np.minimum(c + up, cols - 1)))
            assert ok.all(), (tag, p, u)
            n_checked += dep.size + up.size
    assert n_checked > 1000


@pytest.mark.parametrize("tag", ORDER_TAGS)
def test_level_order_is_topological(tag):
    """Each SB's level order is a permutation of its records in which
    every unit comes after the units of its SB whose pixels it reads;
    the counts: the levels summed over the SBs are the order's length
    less the records, and at most the records."""
    fields, dims, sb, (_h, _w, spans, order) = _order_inputs(tag)
    n = sum(f.shape[0] for f in fields)
    levels = int(spans[:, :, 3].sum())
    assert order.size == n + levels and 0 < levels <= n
    for p, fp in enumerate(fields):
        _lv, at = _record_levels(spans[p], order, fp.shape[0])
        for u, _rc, dep, _up, _sc in _in_sb_reads(fp, p, dims, sb):
            assert (at[dep] < at[u]).all(), (tag, p, u)


def _sb_program_inputs(seed, bd, interintra, **grid):
    """(fields, resid, dims, base, masks) of `random_sb_program` (grid:
    its size, SB size and occupied SBs) as the executor takes them
    (numpy; masks None where a plane has no interintra unit)."""
    prog = random_sb_program(seed, bd=bd, interintra=interintra, **grid)
    fields = R.preprocess_units(prog["units"], prog["dims"])
    masks = []
    for p in range(3):
        fields[p], m = ii_masks(fields[p], p, 1, 1, 64 if p == 0 else 32)
        masks.append(m)
    return fields, prog["resid"], prog["dims"], prog["base"], masks


SB_PROGRAMS = [(701, 8, False), (702, 8, True), (703, 10, True),
               (704, 12, False), (705, 12, True)]


@pytest.mark.parametrize("seed,bd,interintra", SB_PROGRAMS)
def test_level_order_gives_sequential_planes(seed, bd, interintra):
    """On a seeded SB program (inter blocks keeping the base, partial
    SBs, interintra units), the plain executor on each plane's records
    in level order, SB by SB, equals it in decode order, exactly."""
    fields, resid, dims, base, masks = _sb_program_inputs(seed, bd,
                                                          interintra)
    _h, _w, spans, order = sb_schedule(fields, dims, 64)
    assert int(spans[:, :, 3].sum()) < sum(f.shape[0] for f in fields)
    t = [torch.from_numpy(f) for f in fields]
    r = [torch.from_numpy(x) for x in resid]
    mk = [None if m is None else torch.from_numpy(m) for m in masks]
    want = strip_exec_frame_plain(t, r, dims, bd,
                                  [torch.from_numpy(b.copy()) for b in base],
                                  mk)
    assert interintra == any(m is not None for m in masks)
    for p, fp in enumerate(fields):
        _lv, at = _record_levels(spans[p], order, fp.shape[0])
        perm = torch.from_numpy(fp[np.argsort(at)])
        got = strip_exec_plain(perm, r[p], dims[p], bd,
                               want[0] if p else None,
                               torch.from_numpy(base[p].copy()), mk[p])
        _assert_equal(got.numpy(), want[p].numpy(), f"plane {p}")


# A sparse inter frame: units in a few SBs of a grid of 8 x 15 SBs (the
# last row and column partial), in runs side by side, on diagonals both
# ways (the above-right and the left waits after runs of empty SBs), at
# a row's end, in luma alone at (0, 0) and in chroma alone at (5, 3)
_SPARSE = {(1, 3), (2, 2), (3, 1), (2, 7), (2, 8), (4, 5), (5, 6), (3, 14),
           (7, 14), (6, 10), (6, 11), (6, 12)}
LAYOUTS = {"sparse": (_SPARSE | {(0, 0)}, _SPARSE | {(5, 3)},
                      _SPARSE | {(5, 3)}),
           # the sequential schedule: one SB a plane, luma without units
           "chroma, sequential": (set(), {(5, 3)}, {(5, 3)}),
           "none": (set(), set(), set())}
# seed, bits, SB size, interintra units (the scan's instantiation), layout
SPARSE_PROGRAMS = [(801, 8, 64, False, "sparse"), (802, 10, 64, True, "sparse"),
                   (803, 8, 128, False, "sparse"),
                   (804, 10, 128, True, "sparse"),
                   (812, 8, 64, True, "chroma, sequential"),
                   (806, 8, 128, False, "none")]


def _sparse_grid(sb, layout):
    """`random_sb_program`'s size, SB size and occupied SBs for a sparse
    program: 8 x 15 SBs, the last row and column partial."""
    q = sb // 4
    return {"mi_rows": 8 * q - 3, "mi_cols": 15 * q - 3, "sb": sb,
            "occupied": LAYOUTS[layout]}


def _held_sbs(fields, sb):
    """Each plane's set of the (row, column) of the SBs that hold units."""
    return [{(int(y) // (sb >> (p > 0)), int(x) // (sb >> (p > 0)))
             for x, y in f[:, [R.F_X, R.F_Y]]} for p, f in enumerate(fields)]


@pytest.mark.parametrize("seed,bd,sb,interintra,layout", SPARSE_PROGRAMS)
def test_host_half_counts_the_empty_sbs(seed, bd, sb, interintra, layout):
    """The host half of an inter frame (`InterRecon.prepare`) on a sparse
    program counts the (plane, SB) pairs of its schedule that hold no
    unit as "strip.empty_sbs": all but the SBs that hold units, one SB a
    plane under the sequential schedule, and none for a frame without
    units, which launches nothing.  The program covers what the card
    test needs: chroma CfL, in the SB of chroma alone too, and
    interintra units where asked."""
    grid = _sparse_grid(sb, layout)
    prog = random_sb_program(seed, bd=bd, interintra=interintra, **grid)
    ir = InterRecon(grid["mi_rows"], grid["mi_cols"], 1, 1, bd, 3, sb,
                    torch.device("cpu"))
    before = trace.counters()["strip.empty_sbs"]
    fields, _resid, masks, (sbh, sbw, spans, _order) = ir.prepare(
        prog["units"], np.zeros((0, 8), np.int32), np.zeros(0, np.int32),
        intrabc="sequential" in layout)
    got = trace.counters()["strip.empty_sbs"] - before
    held = _held_sbs(fields, sb)
    assert all(h <= o for h, o in zip(held, LAYOUTS[layout]))
    if layout == "none":
        assert got == 0 and not any(held)
        return
    if "sequential" in layout:
        assert (sbh, sbw) == ir.dims[0] and got == 1 and not held[0]
    else:
        cols = 15
        rows = spans.shape[1] // cols
        assert (sbh, sbw, rows) == (sb, sb, 8)
        assert got == sum(rows * cols - len(h) for h in held)
        assert [{divmod(k, cols) for k in np.flatnonzero(sp[:, 1] > sp[:, 0])}
                for sp in spans] == held
        assert (0, 0) in held[0] - held[1] and (3, 14) in held[0]
    assert (5, 3) in held[1] - held[0]
    cfl = [(int(y) // (sb // 2), int(x) // (sb // 2))
           for p in (1, 2) for x, y, c, a in fields[p][
               :, [R.F_X, R.F_Y, R.F_CLS, R.F_ALPHA]]
           if c == R.K_CFL and a != 0]
    assert (5, 3) in cfl
    assert interintra == any(m is not None for m in masks)


@pytest.mark.parametrize("seed", [711, 712])
def test_sequential_schedule_keeps_decode_order(seed):
    """An intrabc frame (a copy's source may lie anywhere above) takes
    the sequential schedule from `IntraRecon.prepare`: one SB a plane
    holding every record, no levels, so the kernel runs the records one
    after another in decode order; the SB schedule refuses it.  The
    frame: a seeded SB program whose luma units from the middle of
    decode order on copy, where they can, from a source above them."""
    prog = random_sb_program(seed)
    units, dims = prog["units"].copy(), prog["dims"]
    rng = np.random.default_rng(seed)
    luma = np.flatnonzero(units[:, 0] == 0)
    for u in (units[k] for k in luma[luma.size // 2:]):
        x, y, w, h = (int(v) for v in u[1:5])
        if y >= h + 2 and rng.random() < 0.5:
            u[5:21] = 0
            u[5], u[6] = 11, int(rng.integers(0, dims[0][1] - w - 1))
            u[11:16] = [128, 0, 64, 64, int(rng.integers(0, y - h - 1))]
    ir = IntraRecon(37, 45, 1, 1, 8, 3, 64, torch.device("cpu"))
    prep = ir.prepare(units, np.zeros((0, 8), np.int32),
                      np.zeros(0, np.int32), intrabc=True)
    fields, _resid, _masks, (sbh, sbw, spans, order) = prep
    assert (sbh, sbw) == dims[0] and order.size == 0
    assert spans.tolist() == [[[0, f.shape[0], 0, 0]] for f in fields]
    assert np.sum(fields[0][:, R.F_CLS] == R.K_IBC) > 5
    with pytest.raises(ValueError, match="sequential schedule"):
        sb_schedule(fields, dims, 64)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_program_frame_keeps_the_program(seed):
    """The whole-frame form of a program reconstructs its plane as the
    program does alone, its luma tiles giving exactly prog["luma"]."""
    prog = random_program(seed)
    pf = program_frame(prog)
    fields = [torch.from_numpy(f) for f in R.preprocess_units(
        pf["units"], prog["dims"])]
    got = strip_exec_frame(fields, [torch.from_numpy(r) for r in pf["resid"]],
                           prog["dims"], 8, None)
    _assert_equal(got[prog["plane"]].numpy(), _plain(prog).numpy(),
                  f"plane {prog['plane']}")
    if prog["plane"]:
        _assert_equal(got[0].numpy(), prog["luma"], "luma tiles")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_vs_plain(seed, cuda_device):
    """The kernel on a program's whole frame under the sequential
    schedule, against its plain version."""
    prog = random_program(seed, n_rand=64)
    pf = program_frame(prog)
    fields = R.preprocess_units(pf["units"], prog["dims"])
    schedule = schedule_to(sequential_schedule(fields, prog["dims"]),
                           cuda_device)
    t = [torch.from_numpy(f).to(cuda_device) for f in fields]
    r = [torch.from_numpy(x).to(cuda_device) for x in pf["resid"]]
    got = strip_exec_frame(t, r, prog["dims"], 8, schedule)
    torch.cuda.synchronize()
    want = strip_exec_frame_plain(t, r, prog["dims"], 8)
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.cpu().numpy(), b.cpu().numpy(), f"plane {p}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,bd", [(301, 10), (305, 10), (304, 12),
                                     (317, 12)])
def test_kernel_vs_plain_high_bit_depth(seed, bd, cuda_device):
    """The kernel at 10 and 12 bits on a program's whole frame under the
    sequential schedule, against its plain version."""
    prog = random_program(seed, n_rand=64, bd=bd)
    pf = program_frame(prog)
    fields = R.preprocess_units(pf["units"], prog["dims"])
    schedule = schedule_to(sequential_schedule(fields, prog["dims"]),
                           cuda_device)
    t = [torch.from_numpy(f).to(cuda_device) for f in fields]
    r = [torch.from_numpy(x).to(cuda_device) for x in pf["resid"]]
    got = strip_exec_frame(t, r, prog["dims"], bd, schedule)
    torch.cuda.synchronize()
    want = strip_exec_frame_plain(t, r, prog["dims"], bd)
    assert max(int(w.max()) for w in want) > 255
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.cpu().numpy(), b.cpu().numpy(), f"plane {p}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,bd,interintra", SB_PROGRAMS)
def test_kernel_vs_plain_sb_programs(seed, bd, interintra, cuda_device):
    """The kernel on a seeded SB program under the SB schedule, units of
    a level at once, in place on its base planes with interintra masks,
    against its plain version; `strip.units` and `strip.levels` count
    the launch's records and the levels of its SBs."""
    from easyav1_tpu_torch import trace

    fields, resid, dims, base, masks = _sb_program_inputs(seed, bd,
                                                          interintra)
    schedule = sb_schedule(fields, dims, 64)
    t = [torch.from_numpy(f).to(cuda_device) for f in fields]
    r = [torch.from_numpy(x).to(cuda_device) for x in resid]
    mk = [None if m is None else torch.from_numpy(m).to(cuda_device)
          for m in masks]
    before = trace.counters()
    got = strip_exec_frame(t, r, dims, bd, schedule_to(schedule, cuda_device),
                           [torch.from_numpy(b.copy()).to(cuda_device)
                            for b in base], mk)
    after = trace.counters()
    torch.cuda.synchronize()
    want = strip_exec_frame_plain(t, r, dims, bd,
                                  [torch.from_numpy(b.copy()).to(cuda_device)
                                   for b in base], mk)
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.cpu().numpy(), b.cpu().numpy(), f"plane {p}")
    n = sum(f.shape[0] for f in fields)
    assert after["strip.units"] - before["strip.units"] == n
    assert after["strip.levels"] - before["strip.levels"] == \
        int(schedule[2][:, :, 3].sum())
    assert after["launches.intra_wavefront_kernel"] \
        - before["launches.intra_wavefront_kernel"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["bench4k10", "bench_grain", "bench_inter"])
def test_kernel_vs_plain_bench_key_frames(tag, cuda_device):
    """The kernel on the key frames of the three configurations' streams
    (4K 10-bit, 1080p grain, 1080p inter) under their SB schedule,
    against its plain version on the card, exactly."""
    key = first_frame_inputs(f"tests/data/bench/{BENCH_KEYS[tag]}",
                             cuda_device)
    assert key is not None
    bd = key["seq"].color.bitdepth
    dims = key["recon"].dims
    got = strip_exec_frame(key["fields"], key["resid"], dims, bd,
                           key["schedule"])
    torch.cuda.synchronize()
    want = strip_exec_frame_plain(key["fields"], key["resid"], dims, bd)
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.cpu().numpy(), b.cpu().numpy(), f"{tag} plane {p}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,bd,sb,interintra,layout", SPARSE_PROGRAMS)
def test_kernel_passes_over_empty_sbs(seed, bd, sb, interintra, layout,
                                      cuda_device):
    """The kernel in place on a sparse program's random base planes
    (units in a few SBs: side by side and on diagonals after runs of
    empty SBs, at a row's end, in luma alone and in chroma alone, CfL;
    64- and 128-pixel SBs, 8 and 10 bits, interintra masks, the
    sequential schedule), against its plain version, exactly, every
    plane; "strip.empty_sbs" rises by the schedule's (plane, SB) pairs
    without units.  A frame without units launches nothing, counts in
    "strip.skipped", and hands back its base untouched."""
    fields, resid, dims, base, masks = _sb_program_inputs(
        seed, bd, interintra, **_sparse_grid(sb, layout))
    t = [torch.from_numpy(f).to(cuda_device) for f in fields]
    r = [torch.from_numpy(x).to(cuda_device) for x in resid]
    mk = [None if m is None else torch.from_numpy(m).to(cuda_device)
          for m in masks]
    before = trace.counters()
    schedule = (sequential_schedule(fields, dims) if "sequential" in layout
                else sb_schedule(fields, dims, sb))
    got = strip_exec_frame(t, r, dims, bd, schedule_to(schedule, cuda_device),
                           [torch.from_numpy(b.copy()).to(cuda_device)
                            for b in base], mk)
    after = trace.counters()
    torch.cuda.synchronize()
    want = strip_exec_frame_plain(t, r, dims, bd,
                                  [torch.from_numpy(b.copy()).to(cuda_device)
                                   for b in base], mk)
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.cpu().numpy(), b.cpu().numpy(), f"plane {p}")
    rose = {k: after[k] - before[k] for k in (
        "launches.intra_wavefront_kernel", "strip.skipped", "strip.empty_sbs")}
    spans = schedule[2]
    if layout == "none":
        assert rose == {"launches.intra_wavefront_kernel": 0,
                        "strip.skipped": 1, "strip.empty_sbs": 0}
        for p, (a, b) in enumerate(zip(got, base)):
            _assert_equal(a.cpu().numpy(), b, f"plane {p} base")
        return
    empty = int(np.count_nonzero(spans[:, :, 0] == spans[:, :, 1]))
    assert rose == {"launches.intra_wavefront_kernel": 1, "strip.skipped": 0,
                    "strip.empty_sbs": empty}
    assert empty == (1 if "sequential" in layout else 3 * 120 - sum(
        len(h) for h in _held_sbs(fields, sb)))
