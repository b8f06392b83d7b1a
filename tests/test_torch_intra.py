"""The port's intra strip executor against the JAX package, exactly.

- `strip_exec_plain` against `exec_ref.UnitExecutor` on seeded random
  unit programs of every class;
- `strip_exec_plain` against the Pallas strip kernel in interpret mode;
- `IntraRecon` (the whole device intra recon: records, host residual,
  luma then chroma) against the native C recon with LF and CDEF off, on
  real libaom key frames;
- the CUDA kernel against its plain version (needs the card).
"""

import ctypes

import numpy as np
import pytest
import torch

import easyav1_tpu.native as nat
from easyav1_tpu.container.webm import TrackType, WebMDemuxer
from easyav1_tpu.video.av1.backend import AV1Backend
from easyav1_tpu.video.av1.recon import jax_exec as JX
from easyav1_tpu.video.av1.recon.exec_ref import UnitExecutor
from easyav1_tpu_torch.native import export_units
from easyav1_tpu_torch.unit_programs import MI_COLS, MI_ROWS, random_program
from easyav1_tpu_torch.video.av1.recon.intra_exec import IntraRecon
from easyav1_tpu_torch.video.av1.recon.intra_strip import (strip_exec,
                                                           strip_exec_plain)

from test_av1_real import real_fixture

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
    path, _ = real_fixture(tag, w, h)
    lib, seq, hdr, tiles = _first_keyframe(path)
    out, bufs, _blob, (fp_rc, _keep) = nat._run_tiles(lib, seq, hdr, tiles)
    rp = nat._build_rp(seq, hdr)
    rp.lf_level = (ctypes.c_int32 * 4)(0, 0, 0, 0)
    rp.enable_cdef = 0
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    ir = IntraRecon(hdr.mi_rows, hdr.mi_cols, ssx, ssy, seq.color.bitdepth,
                    seq.color.num_planes, torch.device("cpu"))
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


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_vs_plain(seed, cuda_device):
    prog = random_program(seed, n_rand=64)
    plane = prog["plane"]
    fields = JX.preprocess_units(prog["units"], prog["dims"], pad=0)[plane]
    luma = torch.from_numpy(prog["luma"]).to(cuda_device) if plane else None
    got = strip_exec([torch.from_numpy(fields).to(cuda_device)],
                     [torch.from_numpy(prog["resid"][plane]).to(cuda_device)],
                     prog["dims"][plane], 8, luma)[0]
    torch.cuda.synchronize()
    _assert_equal(got.cpu().numpy(), _plain(prog, cuda_device).cpu().numpy(),
                  f"plane {plane}")
