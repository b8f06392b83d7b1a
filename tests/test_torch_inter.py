"""The port's inter and intrabc recon against the JAX package, exactly.

- each plain MC function (`inter_mc.mc_single`, ...) against its JAX jit
  function (`mc_jax._mc_single_kernel`, ...) on the units of a seeded
  random MC program, one shape each; the JAX planes carry the PAD margin
  and the ES overhang, which the test maps;
- `mc_plan.export_inter_plan` against `mc_jax.export_inter_plan` on the
  block exports of cached inter fixtures;
- the extended `strip_exec_plain` (intrabc, interintra, a base plane)
  against `jax_exec._scan_kernel` on random programs, one shape;
- the port on the CPU against its native C session, every frame equal
  and no fallback, on the fixtures `test_mc_jax.py` builds: plain inter,
  masked compound, OBMC, warp and interintra;
- `InterRecon.run` against `DeviceInterRecon.run` on one frame;
- the CUDA kernels against their plain versions (needs the card).

The host side of the MC kernels (bucket tables, work indices, the OBMC
grouping) is held in test_torch_mc_tables.py.
"""

import os

import numpy as np
import pytest
import torch

import easyav1_tpu_torch
from easyav1_tpu.video.av1.recon import jax_exec as JX
from easyav1_tpu.video.av1.recon import mc_jax as MJ
from easyav1_tpu_torch import trace
from easyav1_tpu_torch.api import native_session
from easyav1_tpu_torch.native import pipe
from easyav1_tpu_torch.unit_programs import (
    MI_COLS, MI_ROWS, random_ibc_program, random_interintra_program,
    random_mc_program)
from easyav1_tpu_torch.video.av1.recon import inter_mc, intra_strip
from easyav1_tpu_torch.video.av1.recon import mc_plan as MP
from easyav1_tpu_torch.video.av1.recon import records as R
from easyav1_tpu_torch.video.av1.recon.inter_exec import InterRecon, ii_masks

from test_torch_fixtures import steady
from test_torch_pipe import _assert_frames_equal, _decode, _port

PAD = JX.PAD
# compound, warps and OBMC, 8 frames (the smoke run's fourth stream)
SMOKE_STREAM = os.path.join(os.path.dirname(__file__), "data", "smoke",
                            "inter_modes_96x96.webm")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_equal(got, want, what):
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert d.max() == 0, (f"{what}: maxdiff {d.max()} at "
                          f"{np.argwhere(d > 0)[:4].tolist()}")


# ------------------------------------------------- plain MC against JAX

# (plan entry, bucket) of random_mc_program(14): one shape a function
MC_CASES = {
    "single": ("singles", (0, 16, 4)),
    "pair": ("pairs", (0, 8, 4)),
    "warp": ("warps", 0),
    "obmc_above": ("obmc_above", (0, 8, 2)),
    "obmc_left": ("obmc_left", (0, 8, 4)),
    "obmc_resid": ("obmc_resid", (0, 16, 4)),
}


@pytest.mark.parametrize("kind", sorted(MC_CASES))
def test_plain_mc_vs_jax(kind):
    """One bucket through the plain version and through the JAX jit
    function on the same plane, residual and references."""
    import jax.numpy as jnp

    prog = random_mc_program(14)
    name, key = MC_CASES[kind]
    units = prog["plan"][name][key]
    assert units.shape[0] > 0
    rng = np.random.default_rng(5)
    ph, pw = prog["dims"][0]
    base = rng.integers(0, 256, (ph, pw)).astype(np.int32)
    resid = prog["resid"][0]
    refs = np.stack(prog["refs"][0])
    ns, rh, rw = refs.shape
    php, pwp = JX.pad_dims(ph, pw, 64)
    jplane = np.zeros((php, pwp), np.int32)
    jplane[PAD:PAD + ph, PAD:PAD + pw] = base
    jres = np.zeros((php, pwp), np.int32)
    jres[PAD:PAD + ph, PAD:PAD + pw] = resid
    jrefs = jnp.asarray(refs.astype(np.int32))
    plane = torch.from_numpy(base.copy())
    tres = torch.from_numpy(resid)
    trefs = torch.from_numpy(refs)
    tu = torch.from_numpy(units)
    n = units.shape[0]
    if kind == "single":
        _, w, h = key
        want = MJ._mc_single_kernel(php, pwp, rh, rw, ns, w, h, n, 8)(
            jnp.asarray(jplane), jnp.asarray(jres), jrefs,
            jnp.asarray(units))
        inter_mc.mc_single(plane, tres, trefs, tu, w, h, 8)
    elif kind == "pair":
        _, w, h = key
        masks = prog["plan"]["pair_masks"][key]
        assert np.any(units[:, MP.P_MODE] == 1) \
            and np.any(units[:, MP.P_MODE] == 0)
        want = MJ._mc_pair_kernel(php, pwp, rh, rw, ns, w, h, n,
                                  masks.shape[0], 8)(
            jnp.asarray(jplane), jnp.asarray(jres), jrefs,
            jnp.asarray(units), jnp.asarray(masks))
        inter_mc.mc_pair(plane, tres, trefs, tu, torch.from_numpy(masks),
                         w, h, 8)
    elif kind == "warp":
        want = MJ._mc_warp_kernel(php, pwp, rh, rw, ns, n, 8)(
            jnp.asarray(jplane), jnp.asarray(jres), jrefs,
            jnp.asarray(units))
        wf = torch.from_numpy(
            easyav1_tpu_torch.convert.reference_tables()["warped_filter"])
        inter_mc.mc_warp(plane, tres, trefs, tu, wf, 8)
    elif kind.startswith("obmc_") and kind != "obmc_resid":
        _, w, h = key
        left = kind == "obmc_left"
        want = MJ._obmc_overlay_kernel(php, pwp, rh, rw, ns, w, h, n, 8,
                                       left)(
            jnp.asarray(jplane), jrefs, jnp.asarray(units))
        masks = torch.from_numpy(
            easyav1_tpu_torch.convert.reference_tables()["obmc_masks"])
        inter_mc.obmc_overlay(plane, trefs, tu, w, h, 8, left, masks)
    else:
        _, w, h = key
        fpad = np.ones((n, 3), np.int32)
        fpad[:, :2] = units
        want = MJ._obmc_resid_kernel(php, pwp, w, h, n, 8)(
            jnp.asarray(jplane), jnp.asarray(jres), jnp.asarray(fpad))
        inter_mc.obmc_resid(plane, tres, tu, w, h, 8)
    want = np.asarray(want)[PAD:PAD + ph, PAD:PAD + pw]
    assert not np.array_equal(want, base), "the units wrote nothing"
    _assert_equal(plane.numpy(), want, kind)


def test_mc_units_plain_keeps_unit_order():
    """The frame form runs the buckets as the reference does: equal to
    the per-bucket plain functions called in the plan's order, and the
    kernel's work indices cover every unit pixel exactly once."""
    prog = random_mc_program(12)
    planes = [torch.zeros(d, dtype=torch.int32) for d in prog["dims"]]
    resid = [torch.from_numpy(r) for r in prog["resid"]]
    refs = [[torch.from_numpy(r) for r in rs] for rs in prog["refs"]]
    got = inter_mc.mc_units(planes, resid, refs, prog["plan"], 8)
    got = inter_mc.obmc(got, resid, refs, prog["plan"], 8)
    want = [torch.zeros(d, dtype=torch.int32) for d in prog["dims"]]
    stk = [torch.stack(r) for r in refs]
    plan = prog["plan"]
    for (p, w, h), f in sorted(plan["singles"].items()):
        inter_mc.mc_single(want[p], resid[p], stk[p], torch.from_numpy(f),
                           w, h, 8)
    for (p, w, h), f in sorted(plan["pairs"].items()):
        m = plan["pair_masks"].get((p, w, h), np.zeros((1, h, w), np.int32))
        inter_mc.mc_pair(want[p], resid[p], stk[p], torch.from_numpy(f),
                         torch.from_numpy(m), w, h, 8)
    wf = torch.from_numpy(
        easyav1_tpu_torch.convert.reference_tables()["warped_filter"])
    for p, f in sorted(plan["warps"].items()):
        inter_mc.mc_warp(want[p], resid[p], stk[p], torch.from_numpy(f),
                         wf, 8)
    for p, (a, b) in enumerate(zip(got, inter_mc.obmc_plain(
            want, resid, refs, plan, 8))):
        _assert_equal(a.numpy(), b.numpy(), f"plane {p}")
    # the work indices cover each unit's rect exactly once, overhang
    # included
    tabs = inter_mc.mc_tables(plan)
    shape = [(h + 128, w + 128) for h, w in prog["dims"]]
    cover = [np.zeros(d, np.int32) for d in shape]
    want = [np.zeros(d, np.int32) for d in shape]
    src = {inter_mc.K_SINGLE: (tabs["singles"], MP.S_X, MP.S_Y),
           inter_mc.K_PAIR: (tabs["pairs"], MP.P_X, MP.P_Y),
           inter_mc.K_WARP: (tabs["warps"], MP.W_X, MP.W_Y)}
    it = inter_mc.work_items(tabs["buckets"], tabs["n_tiles"],
                             np.arange(tabs["n_tiles"]))
    for b, u, ox, oy, tw, th in zip(it["bucket"], it["unit"], it["ox"],
                                    it["oy"], it["tw"], it["th"]):
        kind, p, w, h = tabs["buckets"][b, :4]
        t, xc, yc = src[kind]
        x, y = t[u, xc] + ox, t[u, yc] + oy
        assert tw <= inter_mc.TILE and tw * th <= 256
        cover[p][y:y + th, x:x + tw] += 1
        if ox == oy == 0:
            want[p][t[u, yc]:t[u, yc] + h, t[u, xc]:t[u, xc] + w] += 1
    for p in range(3):
        assert np.array_equal(cover[p], want[p]), f"plane {p}"
        assert cover[p].max() == 1


# ------------------------------------------------ the planner against JAX

def _plan_fixtures():
    from test_av1_inter_real import COMP_SCOPE, inter_fixture
    return {
        "comp_masked": lambda: steady(
            inter_fixture, "comp_masked", frames=8, crf=30, scope=COMP_SCOPE, extra=(
                "vopt:aom-params=enable-interintra-comp=0:"
                "enable-dist-wtd-comp=0:enable-obmc=0:"
                "enable-warped-motion=0:enable-global-motion=0",))[0],
        "comp_mm": lambda: steady(
            inter_fixture, "comp_mm", frames=6, scope=COMP_SCOPE, extra=(
                "vopt:aom-params=enable-masked-comp=0:"
                "enable-interintra-comp=0:enable-onesided-comp=0:"
                "enable-dist-wtd-comp=0",))[0],
        "obmc": _obmc_fixture,
    }


def _obmc_fixture():
    from test_av1_inter_real import inter_fixture
    return steady(
        inter_fixture, "obmc_nojnt", w=192, h=128, crf=26, frames=8,
        extra=("vopt:cpu-used=1",
               "vopt:aom-params=enable-global-motion=0:"
               "enable-warped-motion=0:enable-interintra-comp=0:"
               "enable-dist-wtd-comp=0",))[0]


def _warp_fixture():
    from test_av1_inter_real import inter_fixture
    return steady(
        inter_fixture, "warp_nojnt", w=192, h=128, crf=26, frames=8,
        extra=("vopt:cpu-used=1",
               "vopt:aom-params=enable-global-motion=0:"
               "enable-interintra-comp=0:enable-dist-wtd-comp=0",))[0]


def _plain_fixture():
    from fixtures import make_fixture
    from test_mc_jax import _VOPTS
    return steady(make_fixture, w=320, h=180, fps=30, frames=12, gop=999, crf=30,
                        audio_secs=0, content=1, vopt=_VOPTS)


def _masked_fixture():
    from test_av1_inter_real import COMP_SCOPE, inter_fixture
    return steady(
        inter_fixture, "comp_masked", frames=8, crf=30, scope=COMP_SCOPE, extra=(
            "vopt:aom-params=enable-interintra-comp=0:"
            "enable-dist-wtd-comp=0:enable-obmc=0:"
            "enable-warped-motion=0:enable-global-motion=0",))[0]


def _interintra_tus():
    """The dense synthetic interintra stream of
    test_mc_jax.test_device_interintra_bitexact (same blocks, same
    seed): a key frame, then one inter frame of 16x16 blocks, most of
    them interintra."""
    import fuzz_tmv_future as FZ
    from easyav1_tpu.video.av1 import constants as C
    from easyav1_tpu.video.av1.av1_enc_inter import (InterEncBlock,
                                                     encode_ref_sequence)
    from easyav1_tpu.video.av1.wedge import wedge_allowed

    rng = np.random.default_rng(5)
    blocks = []
    for r in range(0, 24, 4):
        for c in range(0, 24, 4):
            mode = int(rng.choice([C.NEWMV, C.NEARESTMV]))
            b = InterEncBlock(r=r, c=c, bsize=C.BLOCK_16X16,
                              is_inter=True, ref=C.LAST_FRAME,
                              mode=mode, skip=bool(rng.random() < 0.3))
            if mode == C.NEWMV:
                b.mv = (2 * int(rng.integers(-30, 31)),
                        2 * int(rng.integers(-30, 31)))
            if rng.random() < 0.8:
                b.interintra_mode = int(rng.integers(0, 4))
                if wedge_allowed(C.BLOCK_16X16) and rng.random() < 0.5:
                    b.ii_wedge = 1
                    b.ii_wedge_idx = int(rng.integers(0, 16))
            if not b.skip:
                b.luma_coeffs = [[(int(rng.integers(1, 9)),
                                   int(rng.integers(0, 2)))
                                  for _ in range(3)]]
            blocks.append(b)
    frames = [dict(type=C.KEY_FRAME, blocks=FZ.keyblocks(rng),
                   order_hint=0),
              dict(type=C.INTER_FRAME, blocks=blocks, order_hint=1,
                   refresh=2, ref_idx=[0] * 7, err=False)]
    return encode_ref_sequence(FZ.W, FZ.H, 70, frames, carry=True,
                               interintra=True)


def _spy_plans(monkeypatch, check=None):
    """Count what the port's planner emits (and run `check` on each
    call's arguments and result)."""
    seen = {"frames": 0, "pairs": 0, "warps": 0, "overlays": 0,
            "singles": 0}
    orig = pipe.export_inter_plan

    def spy(*a, **k):
        plan = orig(*a, **k)
        if check is not None:
            check(a, k, plan)
        if plan is not None:
            seen["frames"] += 1
            seen["singles"] += sum(v.shape[0]
                                   for v in plan["singles"].values())
            seen["pairs"] += sum(v.shape[0] for v in plan["pairs"].values())
            seen["warps"] += sum(v.shape[0] for v in plan["warps"].values())
            seen["overlays"] += sum(
                v.shape[0] for d in ("obmc_above", "obmc_left")
                for v in plan[d].values())
        return plan

    monkeypatch.setattr(pipe, "export_inter_plan", spy)
    return seen


def _assert_plans_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got["slots"] == want["slots"]
    for k in want:
        if k == "slots":
            continue
        assert sorted(got[k]) == sorted(want[k]), k
        for key in want[k]:
            assert np.array_equal(got[k][key], want[k][key]), (k, key)


@pytest.mark.parametrize("tag", ["comp_masked", "comp_mm", "obmc"])
def test_export_inter_plan_vs_jax(tag, monkeypatch):
    """Every inter frame's plan, from the same block export and the same
    host references, equals the reference planner's."""
    path = _plan_fixtures()[tag]()

    def check(a, k, plan):
        _assert_plans_equal(plan, MJ.export_inter_plan(*a, **k))

    seen = _spy_plans(monkeypatch, check)
    _port(path)
    assert seen["frames"] >= 3 and seen["singles"] > 0, seen
    if tag != "obmc":
        assert seen["pairs"] > 0, seen
    if tag == "obmc":
        assert seen["overlays"] > 0, seen


# ------------------------------------------- the strip executor against JAX

N_FIELDS = 256      # fixed record count and mask stack: one compile
N_MASKS = 64


def _scan_case(prog):
    """(port fields, masks, JAX fields, masks) of a luma program, the
    interintra packs turned into mask indices by the port's `ii_masks`,
    held against the reference's `_ii_masks`."""
    dims = prog["dims"]
    f = R.preprocess_units(prog["units"], dims)[0]
    fj = JX.preprocess_units(prog["units"], dims, pad=PAD)[0]
    f, masks = ii_masks(f, 0, 1, 1, 64)
    dr = MJ.DeviceInterRecon(MI_ROWS, MI_COLS, 1, 1)
    fj, mj = dr._ii_masks(fj, 0, 64)
    assert np.array_equal(f[:, R.F_RES], fj[:, JX.F_RES])
    mpad = np.zeros((N_MASKS, 64, 64), np.int32)
    if masks is not None:
        assert np.array_equal(masks, mj[:masks.shape[0]])
        mpad[:masks.shape[0]] = masks
    fpad = np.zeros((N_FIELDS, JX.NF), np.int32)
    fpad[:fj.shape[0]] = fj
    return f, masks, fpad, mpad


@pytest.mark.parametrize("kind,seed", [("ibc", 301), ("ibc", 305),
                                       ("interintra", 310),
                                       ("interintra", 312)])
def test_plain_scan_vs_jax(kind, seed):
    """The extended plain executor against `_scan_kernel` (luma, one
    shape): intrabc units reading the partly reconstructed plane, and
    interintra units blending with a base plane."""
    import jax.numpy as jnp

    prog = (random_ibc_program(seed) if kind == "ibc"
            else random_interintra_program(seed))
    assert prog["plane"] == 0
    ph, pw = prog["dims"][0]
    base = (prog["base"][0] if kind == "interintra"
            else np.zeros((ph, pw), np.int32))
    f, masks, fpad, mpad = _scan_case(prog)
    if kind == "ibc":
        assert np.sum(f[:, R.F_CLS] == R.K_IBC) >= 20
    else:
        assert masks is not None and masks.shape[0] >= 4
    intra_strip.check_units(f, (ph, pw), False,
                            0 if masks is None else masks.shape[0], 64)
    php, pwp = JX.pad_dims(ph, pw, 64)
    jplane = np.zeros((php, pwp), np.int32)
    jplane[PAD:PAD + ph, PAD:PAD + pw] = base
    jres = np.zeros((php, pwp), np.int32)
    jres[PAD:PAD + ph, PAD:PAD + pw] = prog["resid"][0]
    k = JX._scan_kernel(64, php, pwp, 8, False, 1, 1, n_masks=N_MASKS)
    want = np.asarray(k(jnp.asarray(jplane), jnp.asarray(jres),
                        jnp.asarray(fpad), jnp.asarray(mpad)))
    got = intra_strip.strip_exec_plain(
        torch.from_numpy(f), torch.from_numpy(prog["resid"][0]), (ph, pw), 8,
        base=torch.from_numpy(base.copy()),
        masks=None if masks is None else torch.from_numpy(masks))
    _assert_equal(got.numpy(), want[PAD:PAD + ph, PAD:PAD + pw], kind)


def test_intrabc_needs_the_sequential_schedule():
    prog = random_ibc_program(301)
    fields = R.preprocess_units(prog["units"], prog["dims"])
    with pytest.raises(ValueError, match="sequential schedule"):
        intra_strip.sb_schedule(fields, prog["dims"], 64)
    f = fields[0].copy()
    f[np.argmax(f[:, R.F_CLS] == R.K_IBC), R.F_DX] = -9
    with pytest.raises(ValueError, match="out of range"):
        intra_strip.check_units(f, prog["dims"][0], False)
    f = fields[0].copy()
    f[0, R.F_RES] = 1
    with pytest.raises(ValueError, match="out of range"):
        intra_strip.check_units(f, prog["dims"][0], False)


# ------------------------------------------ the port against native C

PIPE_FIXTURES = {
    "plain": _plain_fixture,
    "masked": _masked_fixture,
    "obmc": _obmc_fixture,
    "warp": _warp_fixture,
}


@pytest.mark.parametrize("tag", sorted(PIPE_FIXTURES))
def test_port_vs_native(tag, monkeypatch):
    """Every frame through the port on the CPU equals the native C
    session's, with no fallback, and the planner emitted the fixture's
    kind of unit."""
    path = str(PIPE_FIXTURES[tag]())
    seen = _spy_plans(monkeypatch)
    got = _port(path)
    stats = dict(easyav1_tpu_torch.stats)
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    want = _decode(lambda: native_session(path))
    _assert_frames_equal(got, want)
    assert stats == {"frames": len(want), "fallbacks": 0}
    assert seen["frames"] >= len(want) - 2
    # libaom emits compound but no wedge or diffwtd block in "masked":
    # the random MC programs hold the mask blend
    assert {"plain": seen["singles"], "masked": seen["pairs"],
            "obmc": seen["overlays"], "warp": seen["warps"]}[tag] > 0, seen


@pytest.mark.parametrize("tag,kw", [
    ("comp_masked_all", {"crf": 26}),                  # + OBMC, warp, jnt
    ("comp_masked_odd", {"w": 94, "h": 98, "crf": 30}),
])
def test_masked_compound_streams_vs_native(tag, kw, monkeypatch):
    """The other two masked-compound encodes of test_av1_inter_real.py
    (every compound tool on, and an odd size with partial superblocks):
    equal to the native C session with no fallback.  Like "masked"
    above, libaom puts no wedge or diffwtd pair in them; the streams of
    test_masked_pair_streams_vs_native_and_dav1d have them."""
    from test_av1_inter_real import COMP_SCOPE, MASKED_BASE, inter_fixture

    path = str(steady(inter_fixture, tag, frames=8, scope=COMP_SCOPE, extra=(
        "vopt:aom-params=" + MASKED_BASE,), **kw)[0])
    masked = []
    orig = pipe.export_inter_plan

    def spy(*a, **k):
        plan = orig(*a, **k)
        if plan is not None:
            masked.append(sum(int((v[:, MP.P_MODE] == 1).sum())
                              for v in plan["pairs"].values()))
        return plan

    monkeypatch.setattr(pipe, "export_inter_plan", spy)
    got = _port(path)
    stats = dict(easyav1_tpu_torch.stats)
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    _assert_frames_equal(got, _decode(lambda: native_session(path)))
    assert stats == {"frames": 8, "fallbacks": 0}
    assert len(masked) == 7
    assert sum(masked) == 0


@pytest.mark.parametrize("name,frames,decoded,wedge,diffwtd", [
    ("comp_masked_320x192.webm", 10, 10, 1, 22),
    ("comp_wedge_320x192.webm", 12, 13, 2, 4),      # one hidden frame
])
def test_masked_pair_streams_vs_native_and_dav1d(name, frames, decoded,
                                                 wedge, diffwtd,
                                                 monkeypatch):
    """The in-repo libaom streams whose plans carry wedge and diffwtd
    pairs (tools/build/make_fixture w=320 h=192 fps=10 gop=100
    audio_secs=0, restoration, palette, filter-intra and intrabc off,
    lag-in-frames=8 auto-alt-ref=1, aom-params enable-interintra-comp=0:
    enable-masked-comp=1:enable-diff-wtd-comp=1:enable-interinter-wedge=1:
    enable-obmc=0:enable-warped-motion=0:enable-global-motion=0; the
    first with frames=10 crf=28 cpu-used=1 content=2, the second with
    frames=12 crf=12 cpu-used=0 content=0): the mask blends on real
    blocks, equal to the native C session and to dav1d, no fallback."""
    from test_torch_pipe import SMOKE, _dav1d_frames

    path = os.path.join(SMOKE, name)
    kinds, masked = [], []
    orig = pipe.export_inter_plan

    def spy(seq, hdr, blocks, *a, **k):
        kinds.extend(int(b[MP.B_COMP_TYPE]) for b in blocks)
        plan = orig(seq, hdr, blocks, *a, **k)
        masked.append(sum(int((v[:, MP.P_MODE] == 1).sum())
                          for v in plan["pairs"].values()))
        return plan

    monkeypatch.setattr(pipe, "export_inter_plan", spy)
    got = _port(path)
    stats = dict(easyav1_tpu_torch.stats)
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    _assert_frames_equal(got, _decode(lambda: native_session(path)))
    _assert_frames_equal(got, _dav1d_frames(path, name.split(".")[0]))
    assert len(got) == frames
    assert stats == {"frames": decoded, "fallbacks": 0}
    assert kinds.count(MP.COMP_WEDGE) == wedge
    assert kinds.count(MP.COMP_DIFFWTD) == diffwtd
    # a masked block gives one masked unit a plane it covers
    assert sum(masked) >= wedge + diffwtd


def test_interintra_stream_vs_native(monkeypatch):
    """The dense interintra stream: interintra units blend on the port."""
    from easyav1_tpu.container.webm import TrackInfo
    from easyav1_tpu_torch.video.av1.backend import AV1Backend

    tus = _interintra_tus()
    seen = {"ii": 0}
    orig = InterRecon.prepare

    def spy(self, *a, **k):
        prep = orig(self, *a, **k)
        seen["ii"] += sum(m.shape[0] for m in prep[2] if m is not None)
        return prep

    monkeypatch.setattr(InterRecon, "prepare", spy)
    track = TrackInfo(number=1, type=None, codec_id="V_AV1")

    def decode(device):
        be = AV1Backend(track, device)
        return [[np.array(p, copy=True) for p in f.data]
                for tu in tus for f in be.decode([tu], 0)]

    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    got = decode(torch.device("cpu"))
    assert easyav1_tpu_torch.stats == {"frames": 2, "fallbacks": 0}
    _assert_frames_equal(got, decode(None))
    assert seen["ii"] >= 10


def test_stage_log_times_every_stage():
    """Traced (`trace.start()`), every covered frame has a "frame" span
    with a span a stage; inter frames have the MC stages too."""
    trace.start()
    try:
        _port(SMOKE_STREAM)
    finally:
        spans = trace.stop()
    frames = [sp for sp in spans if sp.name == "frame"]
    assert len(frames) == easyav1_tpu_torch.stats["frames"] == 8
    stages = [{c.name for c in spans if c.parent == f.id} for f in frames]
    assert stages[0] == {"entropy", "prepare", "compose", "upload",
                         "intra", "lf_cdef", "tail"}
    assert all(d == {"entropy", "plan", "prepare", "compose", "upload",
                     "mc", "intra", "lf_cdef", "tail"} for d in stages[1:])
    assert all(sp.end_ns >= sp.start_ns for sp in spans)


# --------------------------------------- InterRecon against DeviceInterRecon

def test_inter_recon_vs_device_inter_recon(monkeypatch):
    """One inter frame of a 96x96 stream with compound blocks: the
    port's InterRecon and the reference's DeviceInterRecon on the same
    export give the same planes before the postfilters."""
    from test_av1_inter_real import COMP_SCOPE, inter_fixture

    path, _ = steady(
        inter_fixture, "comp_basic", frames=6, scope=COMP_SCOPE, extra=(
            "vopt:aom-params=enable-masked-comp=0:"
            "enable-interintra-comp=0:enable-onesided-comp=0:"
            "enable-dist-wtd-comp=0:enable-obmc=0:enable-warped-motion=0:"
            "enable-global-motion=0",))
    done = []
    orig = pipe._inter_frame

    def hook(lib, seq, hdr, out, bufs, rp, refs, device, clock, *rest):
        if not done:
            done.append(_compare_recons(lib, seq, hdr, out, bufs, rp, refs))
        return orig(lib, seq, hdr, out, bufs, rp, refs, device, clock, *rest)

    monkeypatch.setattr(pipe, "_inter_frame", hook)
    _port(path)
    assert done and done[0] > 0


def _compare_recons(lib, seq, hdr, out, bufs, rp, refs):
    """The frame through both recons; returns its MC unit count."""
    import easyav1_tpu_torch.native as nat

    ref_dims = [None if refs[s] is None else (refs[s][0][1], refs[s][0][2])
                for s in range(8)]
    host = [None if refs[s] is None else [r.host() for r, _w, _h in refs[s]]
            for s in range(8)]
    args = (seq, hdr, bufs["blocks"][:out.n_blocks], bufs["ref0"],
            bufs["mvs"], bufs["interp"], ref_dims)
    kw = {"ref_planes": host, "bsize_g": bufs["grids"]["bsize"]}
    plan = MP.export_inter_plan(*args, **kw)
    assert plan is not None
    units = pipe.export_units(lib, hdr, out, rp)
    txs, coeffs = bufs["txs"][:out.n_txs], bufs["coeffs"][:out.coeffs_used]
    lit = nat._export_literals(lib, rp, out)
    ssx, ssy = seq.color.subsampling_x, seq.color.subsampling_y
    w, h = hdr.frame_width, hdr.frame_height
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    refs_np = [[np.ascontiguousarray(host[s][p][:lh, :lw])
                for s in plan["slots"]]
               for p, (lw, lh) in enumerate([(w, h), (cw, ch), (cw, ch)])]
    ir = InterRecon(hdr.mi_rows, hdr.mi_cols, ssx, ssy, 8, 3,
                    128 if seq.use_128x128_superblock else 64,
                    torch.device("cpu"))
    got = ir.run(units, txs, coeffs, plan,
                 [[torch.from_numpy(a.astype(np.uint8)) for a in r]
                  for r in refs_np], literals=lit)
    dr = MJ.DeviceInterRecon(hdr.mi_rows, hdr.mi_cols, ssx, ssy, 8, 3)
    want = dr.crop(dr.run(units, txs, coeffs, MJ.export_inter_plan(
        *args, **kw), refs_np, (w, h), literals=lit))
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.numpy(), b, f"plane {p}")
    return sum(v.shape[0] for v in plan["singles"].values()) + sum(
        v.shape[0] for v in plan["pairs"].values())


# ----------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_mc_kernels_vs_plain(seed, cuda_device):
    """Kernels 6a and 6b on a random MC program against their plain
    versions, exactly."""
    prog = random_mc_program(seed, 416, 240)

    def run(dev, fn_mc, fn_obmc):
        planes = [torch.zeros(d, dtype=torch.int32, device=dev)
                  for d in prog["dims"]]
        resid = [torch.from_numpy(r).to(dev) for r in prog["resid"]]
        refs = [[torch.from_numpy(r).to(dev) for r in rs]
                for rs in prog["refs"]]
        planes = fn_mc(planes, resid, refs, prog["plan"], 8)
        return fn_obmc(planes, resid, refs, prog["plan"], 8)

    got = run(cuda_device, inter_mc.mc_units, inter_mc.obmc)
    want = run(cuda_device, inter_mc.mc_units_plain, inter_mc.obmc_plain)
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.cpu().numpy(), b.cpu().numpy(), f"plane {p}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,seed", [("ibc", 301), ("ibc", 303),
                                       ("interintra", 310),
                                       ("interintra", 311)])
def test_strip_kernel_scan_units_vs_plain(kind, seed, cuda_device):
    """The strip kernel with intrabc units (sequential schedule) and
    interintra units (in place on a base), against its plain version."""
    from easyav1_tpu_torch.unit_programs import program_frame

    prog = (random_ibc_program(seed) if kind == "ibc"
            else random_interintra_program(seed))
    pf = program_frame(prog)
    fields = R.preprocess_units(pf["units"], prog["dims"])
    masks = []
    for p in range(3):
        fields[p], m = ii_masks(fields[p], p, 1, 1, 64 if p == 0 else 32)
        masks.append(None if m is None else
                     torch.from_numpy(m).to(cuda_device))
    sbh, sbw, spans = intra_strip.sequential_schedule(fields, prog["dims"])
    t = [torch.from_numpy(f).to(cuda_device) for f in fields]
    r = [torch.from_numpy(x).to(cuda_device) for x in pf["resid"]]
    base = prog.get("base", [np.zeros(d, np.int32) for d in prog["dims"]])
    b1 = [torch.from_numpy(b.copy()).to(cuda_device) for b in base]
    b2 = [x.clone() for x in b1]
    got = intra_strip.strip_exec_frame(
        t, r, prog["dims"], 8,
        (sbh, sbw, torch.from_numpy(spans).to(cuda_device)), base=b1,
        masks=masks)
    torch.cuda.synchronize()
    want = intra_strip.strip_exec_frame_plain(t, r, prog["dims"], 8, b2,
                                              masks)
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.cpu().numpy(), b.cpu().numpy(), f"plane {p}")


@pytest.mark.cuda
def test_port_on_card_vs_native(cuda_device):
    """The committed compound, warp and OBMC stream on the card."""
    path = SMOKE_STREAM
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    got = _decode(lambda: easyav1_tpu_torch.EasyAV1(path, device="cuda"))
    assert easyav1_tpu_torch.stats["fallbacks"] == 0
    os.environ.pop("EASYAV1_PIPE", None)
    _assert_frames_equal(got, _decode(lambda: native_session(path)))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,w,h,bd", [(21, 416, 240, 10),
                                         (22, 416, 240, 12),
                                         (5, 99, 75, 10)])
def test_mc_kernels_uint16_vs_plain(seed, w, h, bd, cuda_device):
    """The uint16 instantiations of 6a and 6b on a random 10- or 12-bit
    MC program against their plain versions, exactly."""
    prog = random_mc_program(seed, w, h, bd=bd)

    def run(fn_mc, fn_obmc):
        dev = cuda_device
        planes = [torch.zeros(d, dtype=torch.int32, device=dev)
                  for d in prog["dims"]]
        resid = [torch.from_numpy(r).to(dev) for r in prog["resid"]]
        refs = [[torch.from_numpy(r).to(dev) for r in rs]
                for rs in prog["refs"]]
        planes = fn_mc(planes, resid, refs, prog["plan"], bd)
        return fn_obmc(planes, resid, refs, prog["plan"], bd)

    got = run(inter_mc.mc_units, inter_mc.obmc)
    want = run(inter_mc.mc_units_plain, inter_mc.obmc_plain)
    for p, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a.cpu().numpy(), b.cpu().numpy(), f"plane {p}")


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("hbd_10i.webm", 4), ("hbd_10p.webm", 4),
                                    ("hbd_10pf.webm", 4),
                                    ("hbd_12i.webm", 4),
                                    ("hbd_12p.webm", 8)])
def test_hbd_stream_on_card_vs_native(name, n, cuda_device):
    """The committed 10- and 12-bit streams on the card: uint16 frames,
    no fallback, equal to the native C session."""
    path = os.path.join(os.path.dirname(SMOKE_STREAM), name)
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    got = _decode(lambda: easyav1_tpu_torch.EasyAV1(path, device="cuda"))
    assert easyav1_tpu_torch.stats == {"frames": n, "fallbacks": 0}
    assert got[0][0].dtype == np.uint16
    os.environ.pop("EASYAV1_PIPE", None)
    _assert_frames_equal(got, _decode(lambda: native_session(path)))
