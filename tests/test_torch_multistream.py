"""The port's multi-stream postfilter: LF + CDEF over a leading stream
axis, against single-stream calls and against the JAX package.

- The stream-axis `lf_torch.pass_body`, `cdef_torch.find_dirs`,
  `filter_plane` and `postfilter.postfilter_apply` (with `stack_maps`)
  equal S single-stream calls exactly, on seeded planes and maps at 8, 10
  and 12 bits and odd sizes, with streams whose deblocking or CDEF is off
  and streams of different CDEF damping in one batch.
- `postfilter_torch.make_postfilter` and `MultiStreamPostfilter` equal the
  JAX package's on their own example arguments.
- `multistream_av1.run_multistream` on TUs of the JAX package's
  `make_stream_tu` equals the JAX package's `batched_postfilter` on a
  dp mesh of the virtual CPU devices, and `run_multistream_real` on four
  real streams is hash-equal to the port's native C session.
"""

import copy

import numpy as np
import pytest
import torch

from easyav1_tpu_torch.parallel import multistream_av1 as ms
from easyav1_tpu_torch.video.av1.recon import (cdef_torch, lf_torch,
                                               postfilter_torch)
from easyav1_tpu_torch.video.av1.recon.postfilter import (postfilter_apply,
                                                          stack_maps,
                                                          upload_maps)
from easyav1_tpu_torch import convert

from fixtures import make_fixture
from test_torch_fixtures import SMOKE, steady

CPU = torch.device("cpu")
TABS = convert.tables(CPU)
# 4:2:0 luma sizes: odd, a multiple of 4 that overhangs the 8x8 unit
# grid, and one on it
PLANE_SIZES = [(37, 53), (52, 68), (64, 96)]
STREAMS = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _planes(rng, bd, shape, n=STREAMS):
    return torch.from_numpy(
        rng.integers(0, 1 << bd, (n, *shape)).astype(np.int32))


def _lf_maps(rng, bd, ph, pw):
    """One plane's seeded deblocking maps, as `host_maps` lays them: uint8
    sizes and levels a 4x4-cell row of lines and edge, and a LUT."""
    s = 1 << (bd - 8)
    nev, neh = (pw + 3) // 4 - 1, (ph + 3) // 4 - 1
    rv, rh = (ph + 3) // 4, (pw + 3) // 4
    lut = np.stack([rng.integers(1, 10 * s, 64),
                    rng.integers(5 * s, 60 * s, 64),
                    rng.integers(0, 4 * s, 64)]).astype(np.int32)
    sizes = [0, 4, 6, 8, 14]
    return {"sv": rng.choice(sizes, (rv, nev)).astype(np.uint8),
            "lv": rng.integers(0, 64, (rv, nev)).astype(np.uint8),
            "sh": rng.choice(sizes, (rh, neh)).astype(np.uint8),
            "lh": rng.integers(0, 64, (rh, neh)).astype(np.uint8),
            "lut": lut}


def _host_maps(rng, bd, dims, lf=True, cdef=True, damping=5):
    """Seeded maps of one frame in `postfilter.host_maps`'s layout."""
    maps = {"bd": bd, "lf": None, "cdef": None}
    if lf:
        maps["lf"] = [_lf_maps(rng, bd, ph, pw) for ph, pw in dims]
    if cdef:
        cs = bd - 8
        u = ((dims[0][0] + 7) // 8, (dims[0][1] + 7) // 8)
        maps["cdef"] = {
            "pri_y": (rng.integers(0, 16, u) << cs).astype(np.int32),
            "sec_y": (rng.choice([0, 1, 2, 4], u) << cs).astype(np.int32),
            "pri_uv": (rng.integers(0, 16, u) << cs).astype(np.int32),
            "sec_uv": (rng.choice([0, 1, 2, 4], u) << cs).astype(np.int32),
            "filt": rng.integers(0, 2, u).astype(np.int32),
            "cs": cs, "damping": damping + cs, "ss": (1, 1)}
    return maps


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} against {b.shape}"
    bad = np.argwhere(a != b)
    assert not len(bad), (f"{what}: {len(bad)} differ, first at "
                          f"{bad[0].tolist()}: {a[tuple(bad[0])]} against "
                          f"{b[tuple(bad[0])]}")


# ------------------------------------------------------- the stream axis

@pytest.mark.parametrize("shape", PLANE_SIZES)
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_pass_body_stream_axis(bd, shape):
    rng = np.random.default_rng(bd * 1000 + shape[1])
    planes = _planes(rng, bd, shape)
    m = [_lf_maps(rng, bd, *shape) for _ in range(STREAMS)]
    stack = {k: torch.from_numpy(np.stack([d[k] for d in m])) for k in m[0]}
    H, W = shape
    sv, lv = lf_torch.expand_maps(stack["sv"], stack["lv"], stack["lut"], H)
    sh, lh = lf_torch.expand_maps(stack["sh"], stack["lh"], stack["lut"], W)
    got = lf_torch.pass_body(planes, sv, *lv.unbind(1), bd)
    back = lf_torch.pass_body(got.transpose(-1, -2), sh, *lh.unbind(1),
                              bd).transpose(-1, -2)
    for s in range(STREAMS):
        t = {k: torch.from_numpy(v) for k, v in m[s].items()}
        sv, lv = lf_torch.expand_maps(t["sv"], t["lv"], t["lut"], H)
        sh, lh = lf_torch.expand_maps(t["sh"], t["lh"], t["lut"], W)
        one = lf_torch.pass_body(planes[s], sv, *lv, bd)
        _eq(got[s], one, f"vertical pass, stream {s}")
        one = lf_torch.pass_body(one.T, sh, *lh, bd).T
        _eq(back[s], one, f"both passes, stream {s}")


@pytest.mark.parametrize("shape", PLANE_SIZES)
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_find_dirs_stream_axis(bd, shape):
    rng = np.random.default_rng(bd * 100 + shape[0])
    planes = _planes(rng, bd, shape)
    uh, uw = (shape[0] + 7) // 8, (shape[1] + 7) // 8
    dirs, var = cdef_torch.find_dirs(planes, uh, uw, bd - 8, TABS)
    assert dirs.shape == var.shape == (STREAMS, uh, uw)
    for s in range(STREAMS):
        d1, v1 = cdef_torch.find_dirs(planes[s], uh, uw, bd - 8, TABS)
        _eq(dirs[s], d1, f"dir, stream {s}")
        _eq(var[s], v1, f"var, stream {s}")


@pytest.mark.parametrize("p", [0, 1])
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_filter_plane_stream_axis_mixed_damping(bd, p):
    """Each stream its own damping (an [S, 1, 1] tensor) against one call
    a stream at that damping."""
    rng = np.random.default_rng(7 * bd + p)
    luma = (52, 68)
    shape = luma if p == 0 else (luma[0] // 2, luma[1] // 2)
    planes = _planes(rng, bd, shape)
    m = [_host_maps(rng, bd, [luma], lf=False, damping=3 + s)["cdef"]
         for s in range(STREAMS)]
    st = {k: torch.from_numpy(np.stack([d[k] for d in m]))
          for k in ("pri_y", "sec_y", "pri_uv", "sec_uv", "filt")}
    uh, uw = st["filt"].shape[-2:]
    dirs = torch.from_numpy(rng.integers(0, 8, (STREAMS, uh, uw)).astype(
        np.int32))
    var = torch.from_numpy(rng.integers(0, 1 << 14, (STREAMS, uh, uw)).astype(
        np.int32))
    damp = torch.tensor([d["damping"] for d in m],
                        dtype=torch.int32).reshape(-1, 1, 1)
    pri, sec = ("pri_y", "sec_y") if p == 0 else ("pri_uv", "sec_uv")
    got = cdef_torch.filter_plane(planes, dirs, var, st[pri], st[sec],
                                  st["filt"], 1, 1, p, bd, damp, TABS)
    for s in range(STREAMS):
        one = cdef_torch.filter_plane(planes[s], dirs[s], var[s], st[pri][s],
                                      st[sec][s], st["filt"][s], 1, 1, p, bd,
                                      m[s]["damping"], TABS)
        _eq(got[s], one, f"stream {s}")


MIXES = {
    "all on": [dict(), dict(damping=5), dict()],
    "LF off in one": [dict(), dict(lf=False), dict()],
    "CDEF off in one": [dict(cdef=False), dict(), dict(lf=False)],
    "damping by stream": [dict(damping=3), dict(damping=6),
                          dict(damping=4, lf=False)],
}


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_postfilter_apply_stream_axis(bd, mix):
    rng = np.random.default_rng(bd)
    dims = [(52, 68), (26, 34), (26, 34)]
    maps = [_host_maps(rng, bd, dims, **kw) for kw in MIXES[mix]]
    planes = [_planes(rng, bd, d) for d in dims]
    got, debl = postfilter_apply(planes, stack_maps(maps, dims, CPU),
                                 want_deblocked=True)
    for s, m in enumerate(maps):
        one, one_debl = postfilter_apply([p[s] for p in planes],
                                         upload_maps(m, CPU),
                                         want_deblocked=True)
        for p in range(3):
            _eq(got[p][s], one[p], f"stream {s} plane {p}")
            _eq(debl[p][s], one_debl[p], f"deblocked, stream {s} plane {p}")


def test_stack_maps_zero_maps_and_one_bit_depth():
    rng = np.random.default_rng(3)
    dims = [(52, 68), (26, 34), (26, 34)]
    off = _host_maps(rng, 8, dims, lf=False, cdef=False)
    st = stack_maps([off, off], dims, CPU)
    assert st["lf"] is None and st["cdef"] is None
    on = _host_maps(rng, 8, dims)
    st = stack_maps([off, on], dims, CPU)
    assert st["lf"][0]["lv"].shape == (2, 13, 16)
    assert st["lf"][0]["lut"].shape == (2, 3, 64)
    assert not st["lf"][1]["sv"][0].any() and not st["cdef"]["filt"][0].any()
    _eq(st["lf"][1]["lh"][1], on["lf"][1]["lh"], "stream 1's map")
    assert st["cdef"]["damping"].flatten().tolist() == [5, 5]
    with pytest.raises(ValueError):
        stack_maps([off, _host_maps(rng, 10, dims)], dims, CPU)


# ------------------------------------------------- against the JAX package

def test_make_postfilter_and_multistream_vs_jax():
    import jax

    from easyav1_tpu.parallel.mesh import make_mesh
    from easyav1_tpu.video.av1.recon import postfilter_jax

    fn, args = postfilter_jax.make_postfilter(64, 64)
    want = np.asarray(jax.jit(fn)(*args))
    fn_t, args_t = postfilter_torch.make_postfilter(64, 64)
    for a, b in zip(args, args_t):
        _eq(a, b, "example arguments")
    _eq(fn_t(*[torch.as_tensor(a) for a in args_t]), want, "one step")

    ref = postfilter_jax.MultiStreamPostfilter(make_mesh(2, tp=1), 2, 64, 64)
    want = np.asarray(ref.step(*ref.example_inputs()))
    port = postfilter_torch.MultiStreamPostfilter(2, 64, 64, device="cpu")
    inputs = port.example_inputs()
    for a, b in zip(ref.example_inputs(), inputs):
        _eq(a, b, "example inputs")
    _eq(port.step(*inputs), want, "two streams")


def test_run_multistream_vs_jax_batched_postfilter():
    """Three synthetic streams of the JAX package's encoder: its Python
    decode and dp-sharded vmapped postfilter against the port's C decode
    and stream-axis postfilter (which also checks each stream against the
    port's C decode with LF and CDEF on)."""
    import jax

    from easyav1_tpu.parallel import multistream_av1 as ref
    from easyav1_tpu.parallel.mesh import make_mesh

    n = 3
    tus = [ref.make_stream_tu(s) for s in range(n)]
    want = ref.batched_postfilter(make_mesh(n, tp=1),
                                  [ref.decode_tu_unfiltered(tu)
                                   for tu in tus])
    assert len(jax.devices()) >= n
    got = ms.run_multistream(tus, device="cpu", check=True)
    for s in range(n):
        for p in range(3):
            _eq(got[s][p], want[s][p], f"stream {s} plane {p}")


def _real_streams():
    return [steady(make_fixture, w=320, h=180, fps=30, frames=2, gop=1,
                   crf=30 + 4 * s, audio_secs=0, content=1)
            for s in range(4)]


def test_run_multistream_real_hash_equals_native_session():
    ns, total, wall = ms.run_multistream_real(_real_streams(), max_frames=2,
                                              device="cpu")
    assert (ns, total) == (4, 8) and wall > 0


def test_batched_postfilter_loop_equals_real():
    frames = [ms.decode_frames_unfiltered_native(p, 1)[0]
              for p in _real_streams()[:2]]
    # one stream again with CDEF damping raised and deblocking off
    seq, hdr, planes, grids, skip, cdef = frames[1]
    hdr = copy.deepcopy(hdr)
    hdr.cdef.damping += 1
    hdr.lf.level = [0, 0, 0, 0]
    frames.append((seq, hdr, planes, grids, skip, cdef))
    real = ms.batched_postfilter_real(frames, "cpu")
    loop = ms.batched_postfilter_loop(frames, "cpu")
    for p in range(3):
        for s in range(3):
            _eq(real[p][s], loop[p][s], f"stream {s} plane {p}")


def test_batch_takes_one_geometry_and_intra_frames():
    a = ms.decode_frames_unfiltered_native(_real_streams()[0], 1)[0]
    small = a[:2] + ([p[:64] for p in a[2]],) + a[3:]
    with pytest.raises(ValueError):
        ms.batched_postfilter_real([a, small], "cpu")
    with pytest.raises(ValueError):
        ms.decode_frames_unfiltered_native(SMOKE / "inter_modes_96x96.webm",
                                           2)


@pytest.mark.parametrize("make", [
    lambda: postfilter_torch.MultiStreamPostfilter(2, 64, 64),
    lambda: ms.batched_postfilter_real([]),
    lambda: ms.batched_postfilter_loop([]),
    lambda: ms.run_multistream_real([]),
], ids=["MultiStreamPostfilter", "batched_postfilter_real",
        "batched_postfilter_loop", "run_multistream_real"])
def test_entry_points_default_to_cuda(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


NEW_MODULES = ["easyav1_tpu_torch/parallel/multistream_av1.py",
               "easyav1_tpu_torch/parallel/mesh.py",
               "easyav1_tpu_torch/audio/vorbis/device.py",
               "easyav1_tpu_torch/video/av1/recon/postfilter_torch.py"]


@pytest.mark.parametrize("path", NEW_MODULES)
def test_new_modules_are_in_the_isolation_scan(path):
    from test_torch_isolation import SOURCES, _imported

    assert path in SOURCES
    assert not [m for m in _imported(path)
                if m.split(".")[0] in ("jax", "jaxlib", "easyav1_tpu")]


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_multistream_postfilter_on_the_card(cuda_device):
    port = postfilter_torch.MultiStreamPostfilter(4, 64, 96,
                                                  device=cuda_device)
    cpu = postfilter_torch.MultiStreamPostfilter(4, 64, 96, device="cpu")
    inputs = port.example_inputs()
    _eq(port.step(*inputs).cpu(), cpu.step(*inputs), "four streams")


@pytest.mark.cuda
def test_batched_postfilter_on_the_card(cuda_device):
    """A 1080p key frame with deblocking on and one with it off (CDEF
    damping 6 and 4), the committed streams."""
    bench = SMOKE.parent / "bench"
    frames = [ms.decode_frames_unfiltered_native(bench / name, 1)[0]
              for name in ("bench_av1_intra_lf_1920x1080_8.webm",
                           "bench_av1_intra_1920x1080_30.webm")]
    real = ms.batched_postfilter_real(frames, cuda_device)
    loop = ms.batched_postfilter_loop(frames, "cpu")
    for p in range(3):
        for s in range(len(frames)):
            _eq(real[p][s].cpu(), loop[p][s], f"stream {s} plane {p}")
