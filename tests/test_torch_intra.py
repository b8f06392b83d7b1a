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
- the CUDA kernel against its plain version (needs the card).
"""

import ctypes
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
from easyav1_tpu_torch.native.pipe import export_units, first_frame_inputs
from easyav1_tpu_torch.unit_programs import (MI_COLS, MI_ROWS, program_frame,
                                             random_program)
from easyav1_tpu_torch.video.av1.recon import records as R
from easyav1_tpu_torch.video.av1.recon.intra_exec import IntraRecon
from easyav1_tpu_torch.video.av1.recon.intra_strip import (
    sb_grid, sb_schedule, sequential_schedule, strip_exec_frame,
    strip_exec_frame_plain, strip_exec_plain)

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
    _sbh, _sbw, spans = sb_schedule(fields, dims, sb)
    rows, cols = sb_grid(dims, sb, sb)[0][:2]
    resid = key["resid"]
    want = strip_exec_frame_plain(key["fields"], resid, dims, 8)
    for p, fp in enumerate(fields):
        perm = torch.from_numpy(_wavefront_order(fp, spans[p], rows, cols))
        got = strip_exec_plain(perm, resid[p], dims[p], 8,
                               want[0] if p else None)
        _assert_equal(got.numpy(), want[p].numpy(), f"{tag} plane {p}")


@pytest.mark.parametrize("tag", sorted(KEY_FRAMES)[:2])
def test_sb_spans_match_brute_force(tag):
    """(c) Each SB's span is the run of records whose top-left pixel
    lies in it, found by a scan of every SB; empty SBs have empty
    spans."""
    _key, fields, dims, sb = _key_inputs(tag)
    _sbh, _sbw, spans = sb_schedule(fields, dims, sb)
    rows, cols = -(-dims[0][0] // sb), -(-dims[0][1] // sb)
    assert spans.shape == (len(fields), rows * cols, 2)
    for p, fp in enumerate(fields):
        s = sb >> (p > 0)
        for r in range(rows):
            for c in range(cols):
                idx = np.flatnonzero((fp[:, R.F_Y] // s == r)
                                     & (fp[:, R.F_X] // s == c))
                b, e = spans[p, r * cols + c]
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
    assert sb_schedule([f[:2]], [(64, 128)], 64)[2].tolist() == [
        [[0, 2], [0, 0]]]
    sbh, sbw, spans = sequential_schedule([f, f[:1]], [(64, 128), (32, 64)])
    assert (sbh, sbw) == (64, 128)
    assert spans.tolist() == [[[0, 3]], [[0, 1]]]


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
    sbh, sbw, spans = sequential_schedule(fields, prog["dims"])
    t = [torch.from_numpy(f).to(cuda_device) for f in fields]
    r = [torch.from_numpy(x).to(cuda_device) for x in pf["resid"]]
    got = strip_exec_frame(t, r, prog["dims"], 8,
                           (sbh, sbw, torch.from_numpy(spans).to(cuda_device)))
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
    sbh, sbw, spans = sequential_schedule(fields, prog["dims"])
    t = [torch.from_numpy(f).to(cuda_device) for f in fields]
    r = [torch.from_numpy(x).to(cuda_device) for x in pf["resid"]]
    got = strip_exec_frame(t, r, prog["dims"], bd,
                           (sbh, sbw, torch.from_numpy(spans).to(cuda_device)))
    torch.cuda.synchronize()
    want = strip_exec_frame_plain(t, r, prog["dims"], bd)
    assert max(int(w.max()) for w in want) > 255
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.cpu().numpy(), b.cpu().numpy(), f"plane {p}")
