"""The port's loop restoration (`recon/lr_torch.py`) against the JAX
package's device path (`lr_jax.DeviceLoopRestoration.apply_device`) and
its host reference (`lr_ref.LoopRestoration`), on seeded planes: the
cases of tests/test_lr_jax.py; above 8 bits against lr_ref with the
spec's SGR rounding (`_lr_ref_spec`).  Tolerance 0: the arithmetic is
integer.

The kernel's source, `csrc/lr.cu`, compiled by g++ against
tools/cuda_host_shim (each CUDA thread an OS thread, `__syncthreads` a
barrier), against the plain version (`LoopRestoration.apply_plain`) on
seeded frames (`unit_programs.random_lr_case`): Wiener luma and chroma,
every SGR set at 8, 10 and 12 bits, the flat extremes, mixed units,
a last unit wider than the unit size, 4:4:4 and 4:2:2, a superres
width; its per-unit table against the per-column maps of
`stripe_params`; and the wrapper `lr_launch` on the CPU.  What nvcc
accepts and how fast it runs show only on the card
(tests/test_torch_lr_card.py, `chip_smoke.py`)."""

import ctypes
import functools
import inspect
import os
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyav1_tpu.video.av1 import constants as C
from easyav1_tpu.video.av1 import lr_ref
from easyav1_tpu.video.av1.recon.lr_jax import DeviceLoopRestoration
from easyav1_tpu_torch import trace
from easyav1_tpu_torch.unit_programs import random_lr_case
from easyav1_tpu_torch.video.av1.recon import lr_torch

from test_lr_jax import _Hdr, _Plan, _Seq, _mk

W, S = C.RESTORE_WIENER, C.RESTORE_SGRPROJ


@functools.lru_cache(maxsize=None)
def _lr_ref_spec():
    """lr_ref with the spec's SGR above 8 bits (7.17.3): the variance
    takes the box sum rounded to 8 bits, b2 the sum itself.  lr_ref,
    lr_jax and the JAX package's C decoder round the sum for both, and
    differ from dav1d there (the 4K 10-bit bench stream's SGR units);
    the port follows the spec."""
    src = inspect.getsource(lr_ref)
    old = ("                b = (b + (1 << (bd - 9))) >> (bd - 8)\n"
           "            p = np.maximum(0, a * n - b * b)\n")
    assert src.count(old) == 1
    src = src.replace(old, "                d = (b + (1 << (bd - 9))) >> (bd - 8)\n"
                           "            else:\n"
                           "                d = b\n"
                           "            p = np.maximum(0, a * n - d * d)\n")
    mod = types.ModuleType("lr_ref_spec")
    exec(compile(src, "lr_ref_spec", "exec"), mod.__dict__)
    return mod


def _hold(w, h, types_, sizes, plan, bd=8, ssx=1, ssy=1, seed=3,
          pad=(8, 16)):
    """lr_torch on mi-padded planes equals lr_ref (host, in place) and,
    at 8 bits, lr_jax's device path (above 8 bits lr_ref with the spec's
    SGR, `_lr_ref_spec`), and leaves the padding and its inputs
    alone."""
    seq = _Seq(ssx=ssx, ssy=ssy)
    hdr = _Hdr(w, h, types_, sizes)
    planes, debl = _mk(w, h, bd=bd, ssx=ssx, ssy=ssy, seed=seed)
    want = [p.copy() for p in planes]
    ref = lr_ref if bd == 8 else _lr_ref_spec()
    ref.LoopRestoration(hdr, seq, plan, bd).apply(want, debl)
    padded = [np.pad(p, ((0, pad[0]), (0, pad[1])), constant_values=3)
              for p in planes]
    if bd == 8:
        jax_got = DeviceLoopRestoration(hdr, seq, plan, bd).apply_device(
            [jnp.asarray(p) for p in padded], [jnp.asarray(d) for d in debl])
    tin = [torch.from_numpy(p.copy()) for p in padded]
    got = lr_torch.LoopRestoration(hdr, seq, plan, bd).apply(
        tin, [torch.from_numpy(d) for d in debl])
    for i in range(3):
        g = got[i].numpy()
        assert g.dtype == np.int32
        if bd == 8:
            assert np.array_equal(g, np.asarray(jax_got[i])), \
                f"plane {i} vs jax"
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


# --------------------------------------- the kernel's source on the host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/lr.cu built by g++ against tools/cuda_host_shim."""
    tmp = tmp_path_factory.mktemp("lr_kernel")
    src, out = tmp / "lr_host.cpp", tmp / "lr_host.so"
    src.write_text(
        "#include <cuda_runtime.h>\n"
        "#define LR_LAUNCH(kernel, grid, threads, stream, ...) "
        "host_launch(grid, threads, [=] { kernel(__VA_ARGS__); })\n"
        f'#include "{os.path.join(REPO, "easyav1_tpu_torch", "csrc")}'
        '/lr.cu"\n')
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-pthread", "-Wno-unknown-pragmas", "-I",
                    os.path.join(REPO, "tools", "cuda_host_shim"), str(src),
                    "-o", str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lr_frame_launch.restype = ci
    lib.lr_frame_launch.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ci),
                                    ci, vp, ci, vp]
    return lib


def host_launch(lib, lr, planes, deblocked, ints=None):
    """`lr_launch`'s one launch through a host build of the source:
    (return code, planes); the planes that restore are new, filled with
    -7 before the launch."""
    dims, table = lr.unit_table()
    ints = lr_torch.launch_dims(dims, planes, deblocked) if ints is None \
        else ints
    out, ptrs = list(planes), []
    for d in dims:
        p = d[0]
        out[p] = torch.full_like(planes[p], -7)
        ptrs += [planes[p].data_ptr(), deblocked[p].data_ptr(),
                 out[p].data_ptr()]
    tab = torch.from_numpy(table)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    rc = lib.lr_frame_launch((vp * len(ptrs))(*ptrs),
                             (ci * len(ints))(*ints), len(dims),
                             tab.data_ptr(), lr.bd, None)
    return rc, out


def _case(**kw):
    hdr, seq, plan, planes, debl = random_lr_case(**kw)
    return (lr_torch.LoopRestoration(hdr, seq, plan, kw.get("bd", 8)),
            [torch.from_numpy(p) for p in planes],
            [torch.from_numpy(d) for d in debl])


MIXED = ((W, S, 0), (S, W, 0), (W, 0, S))
# seeded frames: mi-padded planes with padding beyond (the snapshot
# without it), several stripes and unit columns
HOST_CASES = {
    "wiener-luma": dict(seed=1, width=64, height=64, kinds=((W,), (), ()),
                        pad=(8, 16)),
    "wiener-chroma": dict(seed=2, width=64, height=64, kinds=((), (W,), (W,)),
                          pad=(8, 16)),
    "mixed-8bit": dict(seed=3, width=192, height=160, kinds=MIXED,
                       pad=(8, 16)),
    "mixed-10bit": dict(seed=4, width=180, height=150, bd=10, kinds=MIXED,
                        pad=(0, 8)),
    "mixed-12bit": dict(seed=5, width=100, height=132, bd=12, kinds=MIXED),
    # luma: one unit row of 90 rows, the last unit column 86 wide
    "last-unit-wider": dict(seed=6, width=150, height=90, bd=10,
                            kinds=((S, W), (W, S), (S,))),
    "444": dict(seed=7, width=130, height=90, bd=10, ss=(0, 0), kinds=MIXED,
                pad=(8, 0)),
    "422": dict(seed=8, width=120, height=70, ss=(1, 0), kinds=MIXED),
    # as superres leaves the planes: exactly the upscaled width; chroma
    # units of 32
    "superres-width": dict(seed=9, width=181, height=70, kinds=MIXED,
                           unit_sizes=(64, 32, 32), align=1),
}


def _hold_host(lib, lr, planes, debl, changes=True):
    """The source's planes equal the plain version's, which restore
    some sample unless `changes` is False."""
    rc, got = host_launch(lib, lr, planes, debl)
    assert rc == 0
    want = lr.apply_plain(planes, debl)
    changed = 0
    for p in range(3):
        bad = torch.nonzero(got[p] != want[p])
        assert not len(bad), (f"plane {p}: {len(bad)} differ, first at "
                              f"{bad[0].tolist()}")
        changed += int((want[p] != planes[p]).sum())
    assert changed > 0 or not changes


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_kernel_source_on_the_host(host_lib, name):
    _hold_host(host_lib, *_case(**HOST_CASES[name]))


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("sgr_set", range(16))
def test_kernel_source_on_every_sgr_set(host_lib, sgr_set, bd):
    """Radii (2, 1), (0, 1) and (2, 0); luma and chroma SGR, on planes
    of small variance (on uniform noise a2 saturates and SGR keeps every
    sample)."""
    lr, planes, debl = _case(seed=20 + sgr_set, width=64, height=48, bd=bd,
                             kinds=((S,), (S, 0), ()), sgr_set=sgr_set)
    rng = np.random.default_rng(sgr_set)
    for x, d in zip(planes, debl):
        ramp = np.add.outer(np.arange(x.shape[0]), np.arange(x.shape[1]))
        x[:] = torch.from_numpy(((ramp << (bd - 6)) + rng.integers(
            0, 4 << (bd - 8), x.shape)).astype(np.int32))
        d[:] = x[:d.shape[0], :d.shape[1]]
    _hold_host(host_lib, lr, planes, debl)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("sgr_set", [0, 10, 14])
def test_kernel_source_on_the_flat_extremes(host_lib, sgr_set, bd):
    """`test_sgr_flat_extremes_pass_2_to_the_31` at each bit depth: the
    variance at its largest, p * s past 32 bits (a2 saturates: every
    sample may keep its value)."""
    lr, planes, _ = _case(seed=40, width=64, height=64, bd=bd,
                          kinds=((S,), (), ()), sgr_set=sgr_set)
    x = planes[0]
    x[:] = 0
    x[::2] = (1 << bd) - 1
    x[:, 1::4] = (1 << bd) - 1
    _hold_host(host_lib, lr, planes, planes, changes=False)


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_unit_table_expands_to_stripe_params(name):
    """Each stripe and column of the table, looked up as the kernel does
    (the stripe's unit row, the column's unit, the last absorbing the
    remainder), gives `stripe_params`' per-column maps; units of the plan
    outside the unit grid are read by neither."""
    lr = _case(**HOST_CASES[name])[0]
    lr.plan.lr_type[(0, 40, 0)] = S
    lr.plan.lr_sgr[(0, 40, 0)] = (3, 1, 1)
    dims, table = lr.unit_table()
    assert table.dtype == np.int32 and table.shape[1] == lr_torch.LR_ENTRY
    assert [d[0] for d in dims] == [p for p, kind in enumerate(
        HOST_CASES[name]["kinds"]) if kind]
    for plane, ph, pw, sh, off, unit, rows, cols, first in dims:
        spans, m = lr.stripe_params(plane)
        for s, span in enumerate(spans):
            if span is None:
                continue
            urow = min(rows - 1, s * sh // unit)
            ucol = np.minimum(cols - 1, np.arange(pw) // unit)
            e = table[first + urow * cols + ucol]             # [pw, 20]
            assert np.array_equal(e[:, 0] == W, m["is_w"][s])
            assert np.array_equal(e[:, 0] == S, m["is_s"][s])
            w = e[:, 0] == W
            assert np.array_equal(np.where(w, e[:, 1:8].T, 0), m["FH"][s])
            assert np.array_equal(np.where(w, e[:, 8:15].T, 0), m["FV"][s])
            sg = e[:, 0] == S
            radii = np.array(lr_torch.SGR_RADII)[e[:, 15]]
            sv = np.array(lr_torch.SGR_S)[e[:, 15]]
            for k in (0, 1):
                assert np.array_equal(sg & (radii[:, k] != 0),
                                      m[f"r{k}c"][s])
                assert np.array_equal(np.where(sg, sv[:, k], 0),
                                      m[f"s{k}c"][s])
                assert np.array_equal(np.where(sg, e[:, 16 + k], 0),
                                      m[f"w{k}c"][s])


def test_lr_launch_on_the_cpu_takes_the_plain_version():
    lr, planes, debl = _case(**HOST_CASES["mixed-8bit"])
    before = trace.counters()
    got = lr_torch.lr_launch(lr, planes, debl)
    want = lr.apply_plain(planes, debl)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(lr.apply(planes, debl),
                                                 want))
    assert trace.counters()["launches.lr_frame_kernel"] \
        == before["launches.lr_frame_kernel"]


def _bad(what, planes, debl):
    if what == "uint8 plane":
        planes[1] = planes[1].to(torch.uint8)
    elif what == "3-D plane":
        planes[0] = planes[0][None]
    elif what == "short snapshot":
        debl[2] = debl[2][:-9]
    elif what == "int64 snapshot":
        debl[0] = debl[0].long()
    elif what == "meta tensors":
        planes[:] = [torch.empty_like(p, device="meta") for p in planes]
        debl[:] = [torch.empty_like(p, device="meta") for p in debl]


@pytest.mark.parametrize("what", ["uint8 plane", "3-D plane",
                                  "short snapshot", "int64 snapshot",
                                  "meta tensors"])
def test_lr_launch_refuses_what_the_kernel_does_not_take(what):
    lr, planes, debl = _case(**HOST_CASES["mixed-8bit"])
    _bad(what, planes, debl)
    with pytest.raises(ValueError):
        lr_torch.lr_launch(lr, planes, debl)


@pytest.mark.parametrize("field,value", [(-1, 9), (5, 48), (6, 6), (7, 48),
                                         (3, 10 ** 6), (4, 0)])
def test_launcher_refuses_bad_dims(host_lib, field, value):
    """A bit depth of 9, a stripe height of 48 or an offset not its
    eighth, a unit of 48, ph past the plane's rows, pw 0: refused before
    any CTA runs (cudaErrorInvalidValue), the outputs untouched."""
    lr, planes, debl = _case(**HOST_CASES["wiener-luma"])
    ints = lr_torch.launch_dims(lr.unit_table()[0], planes, debl)
    if field == -1:
        lr.bd = value
    else:
        ints[field] = value
    rc, got = host_launch(host_lib, lr, planes, debl, ints)
    assert rc == 1 and (got[0] == -7).all()
