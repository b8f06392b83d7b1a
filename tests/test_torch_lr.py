"""The port's loop restoration (`recon/lr_torch.py`) against the JAX
package's device path (`lr_jax.DeviceLoopRestoration.apply_device`) and
its host reference (`lr_ref.LoopRestoration`), on seeded planes: the
cases of tests/test_lr_jax.py.  Tolerance 0: the arithmetic is
integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyav1_tpu.video.av1 import constants as C
from easyav1_tpu.video.av1 import lr_ref
from easyav1_tpu.video.av1.recon.lr_jax import DeviceLoopRestoration
from easyav1_tpu_torch.video.av1.recon import lr_torch

from test_lr_jax import _Hdr, _Plan, _Seq, _mk

W, S = C.RESTORE_WIENER, C.RESTORE_SGRPROJ


def _hold(w, h, types, sizes, plan, bd=8, ssx=1, ssy=1, seed=3, pad=(8, 16)):
    """lr_torch on mi-padded planes equals lr_ref (host, in place) and
    lr_jax's device path, and leaves the padding and its inputs alone."""
    seq = _Seq(ssx=ssx, ssy=ssy)
    hdr = _Hdr(w, h, types, sizes)
    planes, debl = _mk(w, h, bd=bd, ssx=ssx, ssy=ssy, seed=seed)
    want = [p.copy() for p in planes]
    lr_ref.LoopRestoration(hdr, seq, plan, bd).apply(want, debl)
    padded = [np.pad(p, ((0, pad[0]), (0, pad[1])), constant_values=3)
              for p in planes]
    jax_got = DeviceLoopRestoration(hdr, seq, plan, bd).apply_device(
        [jnp.asarray(p) for p in padded], [jnp.asarray(d) for d in debl])
    tin = [torch.from_numpy(p.copy()) for p in padded]
    got = lr_torch.LoopRestoration(hdr, seq, plan, bd).apply(
        tin, [torch.from_numpy(d) for d in debl])
    for i in range(3):
        g = got[i].numpy()
        assert g.dtype == np.int32
        assert np.array_equal(g, np.asarray(jax_got[i])), f"plane {i} vs jax"
        ph, pw = planes[i].shape
        d = np.abs(g[:ph, :pw] - want[i])
        assert d.max() == 0, (f"plane {i} vs lr_ref: maxdiff {d.max()} at "
                              f"{np.argwhere(d > 0)[:4].tolist()}")
        assert (g[ph:] == 3).all() and (g[:, pw:] == 3).all()
        assert np.array_equal(tin[i].numpy(), padded[i]), "input written"


def _mixed_plan(seed):
    plan = _Plan()
    rng = np.random.default_rng(seed)
    for urow in range(3):
        for ucol in range(3):
            k = (urow + ucol) % 3
            if k == 0:
                plan.lr_type[(0, urow, ucol)] = W
                plan.lr_wiener[(0, urow, ucol)] = [
                    [int(rng.integers(-5, 6)), int(rng.integers(-16, 17)),
                     int(rng.integers(-20, 48))] for _ in range(2)]
            elif k == 1:
                plan.lr_type[(0, urow, ucol)] = S
                plan.lr_sgr[(0, urow, ucol)] = (
                    int(rng.integers(0, 16)), int(rng.integers(-50, 32)),
                    int(rng.integers(-20, 80)))
    return plan


def test_tables_are_the_reference_copies():
    assert lr_torch.SGR_RADII == lr_ref.SGR_RADII
    assert lr_torch.SGR_S == lr_ref.SGR_S
    assert lr_torch._DIV_LUT == lr_ref._DIV_LUT


def test_wiener_luma():
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = W
    plan.lr_wiener[(0, 0, 0)] = [[2, -5, 20], [-1, 3, 10]]
    _hold(64, 64, [W, 0, 0], [256, 128, 128], plan)


def test_wiener_chroma():
    plan = _Plan()
    plan.lr_type[(1, 0, 0)] = W
    plan.lr_wiener[(1, 0, 0)] = [[0, -3, 30], [0, 8, -10]]
    plan.lr_type[(2, 0, 0)] = W
    plan.lr_wiener[(2, 0, 0)] = [[0, 0, 15], [0, -7, 46]]
    _hold(64, 64, [0, W, W], [256, 128, 128], plan)


@pytest.mark.parametrize("sgr_set,xq0,xq1", [(0, 20, 40), (9, -10, 7),
                                             (11, 0, 60), (14, -30, 0)])
def test_sgr_sets(sgr_set, xq0, xq1):
    """Both radii, radius 1 only, radius 2 only."""
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = S
    plan.lr_sgr[(0, 0, 0)] = (sgr_set, xq0, xq1)
    _hold(64, 64, [S, 0, 0], [256, 128, 128], plan)


def test_sgr_flat_extremes_pass_2_to_the_31():
    """Half black, half white in every window: the variance p is at its
    largest and p * s needs more than 31 bits."""
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = S
    plan.lr_sgr[(0, 0, 0)] = (0, 20, 40)      # s = 140 and 3236
    seq, hdr = _Seq(), _Hdr(64, 64, [S, 0, 0], [256, 128, 128])
    planes, _ = _mk(64, 64)
    planes[0][:] = 0
    planes[0][::2] = 255
    planes[0][:, 1::4] = 255
    want = [p.copy() for p in planes]
    lr_ref.LoopRestoration(hdr, seq, plan, 8).apply(want, planes)
    tp = [torch.from_numpy(p) for p in planes]
    got = lr_torch.LoopRestoration(hdr, seq, plan, 8).apply(tp, tp)
    jax_got = DeviceLoopRestoration(hdr, seq, plan, 8).apply_device(
        [jnp.asarray(p) for p in planes], [jnp.asarray(p) for p in planes])
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[0].numpy(), np.asarray(jax_got[0]))


def test_multi_unit_mixed():
    """Several stripes and unit columns, Wiener and SGR units
    interleaved, some units absent (passed through)."""
    _hold(192, 160, [C.RESTORE_SWITCHABLE, 0, 0], [64, 64, 64],
          _mixed_plan(11))


def test_odd_dims():
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = W
    plan.lr_wiener[(0, 0, 0)] = [[5, -10, 30], [2, 2, 2]]
    plan.lr_type[(0, 1, 0)] = S
    plan.lr_sgr[(0, 1, 0)] = (3, 10, 20)
    _hold(100, 132, [C.RESTORE_SWITCHABLE, 0, 0], [64, 64, 64], plan)


def test_10bit():
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = W
    plan.lr_wiener[(0, 0, 0)] = [[-3, 12, 24], [4, -8, 40]]
    plan.lr_type[(0, 0, 1)] = S
    plan.lr_sgr[(0, 0, 1)] = (5, 15, 25)
    _hold(192, 64, [C.RESTORE_SWITCHABLE, 0, 0], [64, 64, 64], plan, bd=10)


def test_12bit_sgr_and_wiener():
    plan = _Plan()
    plan.lr_type[(0, 0, 0)] = S
    plan.lr_sgr[(0, 0, 0)] = (0, 25, 30)
    plan.lr_type[(1, 0, 0)] = W
    plan.lr_wiener[(1, 0, 0)] = [[0, -3, 30], [0, 8, -10]]
    _hold(64, 64, [S, W, 0], [256, 128, 128], plan, bd=12)


def test_chroma_sgr_420():
    plan = _Plan()
    plan.lr_type[(1, 0, 0)] = S
    plan.lr_sgr[(1, 0, 0)] = (7, 12, 18)
    _hold(128, 128, [0, S, 0], [256, 128, 128], plan)


def test_all_planes_mixed_180x150():
    """The case of test_lr_jax_apply_device_parity: three planes, odd
    visible size inside mi-padded planes."""
    plan = _mixed_plan(17)
    plan.lr_type[(1, 0, 0)] = S
    plan.lr_sgr[(1, 0, 0)] = (7, 12, 18)
    plan.lr_type[(2, 0, 0)] = W
    plan.lr_wiener[(2, 0, 0)] = [[0, 0, 15], [0, -7, 46]]
    _hold(180, 150, [C.RESTORE_SWITCHABLE, S, W], [64, 64, 64], plan)


def test_444_planes():
    plan = _mixed_plan(5)
    plan.lr_type[(1, 1, 0)] = S
    plan.lr_sgr[(1, 1, 0)] = (12, 0, 50)
    _hold(130, 90, [C.RESTORE_SWITCHABLE, S, 0], [64, 64, 64], plan,
          ssx=0, ssy=0)


def test_frame_without_units_is_passed_through():
    tp = [torch.from_numpy(p) for p in _mk(64, 64)[0]]
    got = lr_torch.LoopRestoration(_Hdr(64, 64, [W, S, 0], [64, 64, 64]),
                                   _Seq(), _Plan(), 8).apply(tp, tp)
    assert all(a is b for a, b in zip(got, tp))


def test_lr_plan_from_the_decoder_records():
    """The C decoder's [n, 13] unit records become the plan's dicts."""
    from types import SimpleNamespace
    recs = np.zeros((4, 13), np.int32)
    recs[0, :10] = [0, 0, 0, W, 2, -5, 20, -1, 3, 10]
    recs[1, :4] = [0, 0, 1, 0]
    recs[2, [0, 1, 2, 3, 10, 11, 12]] = [1, 0, 0, S, 9, -10, 7]
    recs[3, :4] = [2, 0, 0, W]          # past n_lr_units
    plan = lr_torch.lr_plan(SimpleNamespace(n_lr_units=3), {"lr": recs})
    assert plan.lr_type == {(0, 0, 0): W, (0, 0, 1): 0, (1, 0, 0): S}
    assert plan.lr_wiener == {(0, 0, 0): [[2, -5, 20], [-1, 3, 10]]}
    assert plan.lr_sgr == {(1, 0, 0): (9, -10, 7)}
