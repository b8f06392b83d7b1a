"""The host side of the MC kernels 6a and 6b (`inter_mc.mc_tables`,
`work_items`, `obmc_tables`), on the CPU.

- `work_items`, the numpy twin of the kernels' work-index arithmetic
  (bucket by bisection, unit, tile offset, mask offset), against an
  explicit expansion of every tile of every unit: on seeded random MC
  programs, on the real plans of cached inter fixtures, and on buckets
  made by hand (2x2, 4x4, 4x16, 128x128, empty kinds, a single bucket);
- the single upload buffer holds the plan's tables as they are;
- every OBMC overlay goes to exactly one OBMC block, whose rect holds
  it, and a plan that breaks this raises;
- OBMC block by block (above, left, residual), the order of kernel 6b,
  equals `obmc_plain`'s three passes, tolerance 0 (integer arithmetic).
"""

import numpy as np
import pytest
import torch

from easyav1_tpu_torch import convert
from easyav1_tpu_torch.native import pipe
from easyav1_tpu_torch.unit_programs import random_mc_program
from easyav1_tpu_torch.video.av1.recon import inter_mc
from easyav1_tpu_torch.video.av1.recon import mc_plan as MP
from easyav1_tpu_torch.video.av1.recon.inter_mc import (
    B_H, B_KIND, B_MASK, B_PLANE, B_TILE, B_UNIT, B_W, K_NA, K_NL, K_OV,
    K_PAIR, K_SINGLE, K_WARP, NB, O_H, O_W)

from test_torch_inter import SMOKE_STREAM, _obmc_fixture, _warp_fixture
from test_torch_pipe import _port


def _expand(buckets, n_tiles):
    """Every tile of every unit, bucket by bucket, in work-index order:
    rows of (bucket, unit, ox, oy, tw, th, mask)."""
    rows = []
    ends = np.append(buckets[1:, B_TILE], n_tiles)
    for b, (row, end) in enumerate(zip(buckets, ends)):
        w, h = int(row[B_W]), int(row[B_H])
        tw, th = inter_mc.tile_dims(w, h)
        per = (w // tw) * (h // th)
        n_units, rest = divmod(int(end) - int(row[B_TILE]), per)
        assert rest == 0
        for u in range(n_units):
            for oy in range(0, h, th):
                for ox in range(0, w, tw):
                    rows.append((b, row[B_UNIT] + u, ox, oy, tw, th,
                                 row[B_MASK]))
    return np.asarray(rows, np.int64).reshape(-1, 7)


def _assert_work_items(buckets, n_tiles):
    want = _expand(buckets, n_tiles)
    assert want.shape[0] == n_tiles
    got = inter_mc.work_items(buckets, n_tiles, np.arange(n_tiles))
    for k, name in enumerate(("bucket", "unit", "ox", "oy", "tw", "th",
                              "mask")):
        assert np.array_equal(got[name], want[:, k]), name


def _assert_mc_tables(plan):
    """The buffer's sections are the plan's buckets in sorted order, the
    bucket rows index them, and the work indices expand to every tile."""
    tabs = inter_mc.mc_tables(plan)
    n_b, n_tiles, *offs, n_warps = tabs["layout"]
    assert (n_b, n_tiles) == (tabs["buckets"].shape[0], tabs["n_tiles"])
    assert tabs["host"].dtype == torch.int32
    assert tabs["host"].numpy().ctypes.data == tabs["buf"].ctypes.data
    first = {K_SINGLE: 0, K_PAIR: 0, K_WARP: 0}
    rows = iter(tabs["buckets"])
    for kind, name in ((K_SINGLE, "singles"), (K_PAIR, "pairs"),
                       (K_WARP, "warps")):
        assert tabs["buf"][offs[kind + 1]:].ctypes.data \
            == tabs[name].ctypes.data or tabs[name].size == 0
        for key in sorted(plan[name]):
            f = plan[name][key]
            row = next(rows)
            p, w, h = (key, 8, 8) if kind == K_WARP else key
            assert tuple(row[:5]) == (kind, p, w, h, first[kind])
            assert np.array_equal(tabs[name][first[kind]:first[kind]
                                             + f.shape[0]], f)
            if kind == K_PAIR and key in plan["pair_masks"]:
                m = plan["pair_masks"][key]
                got = tabs["masks"][row[B_MASK]:row[B_MASK] + m.size]
                assert got.dtype == np.uint8
                assert np.array_equal(got.reshape(m.shape), m)
            first[kind] += f.shape[0]
    assert next(rows, None) is None
    assert n_warps == first[K_WARP]
    _assert_work_items(tabs["buckets"], n_tiles)
    return tabs


@pytest.mark.parametrize("seed,width,height", [(12, 100, 76), (14, 100, 76),
                                               (21, 416, 240), (5, 99, 75)])
def test_mc_tables_on_random_programs(seed, width, height):
    plan = random_mc_program(seed, width, height)["plan"]
    tabs = _assert_mc_tables(plan)
    kinds = set(tabs["buckets"][:, B_KIND])
    assert kinds >= {K_SINGLE, K_PAIR}
    assert tabs["n_tiles"] > sum(
        f.shape[0] for name in ("singles", "pairs", "warps")
        for f in plan[name].values()) or max(tabs["buckets"][:, B_W]) <= 16


def _bucket_rows(sizes):
    """Bucket rows of (kind, plane, w, h, units), first units and work
    indices filled in as `mc_tables` does."""
    rows, first, tile = [], {}, 0
    for kind, p, w, h, n in sizes:
        tw, th = inter_mc.tile_dims(w, h)
        rows.append((kind, p, w, h, first.get(kind, 0), tile, 7 * len(rows),
                     0))
        first[kind] = first.get(kind, 0) + n
        tile += n * (w // tw) * (h // th)
    return np.asarray(rows, np.int32).reshape(-1, NB), tile


@pytest.mark.parametrize("sizes", [
    [(K_SINGLE, 1, 2, 2, 4), (K_SINGLE, 1, 2, 8, 2), (K_SINGLE, 2, 8, 2, 1)],
    [(K_SINGLE, 0, 4, 4, 5)],
    [(K_SINGLE, 1, 4, 16, 3), (K_SINGLE, 2, 4, 4, 1)],
    [(K_SINGLE, 0, 128, 128, 2), (K_PAIR, 0, 128, 128, 1)],
    # empty buckets first, between and last
    [(K_SINGLE, 0, 8, 8, 0), (K_SINGLE, 0, 16, 64, 2), (K_PAIR, 0, 4, 8, 0),
     (K_PAIR, 1, 32, 8, 0), (K_PAIR, 2, 64, 128, 1), (K_WARP, 0, 8, 8, 9),
     (K_WARP, 1, 8, 8, 0)],
    [(K_WARP, 2, 8, 8, 1)],
], ids=["2x2", "4x4", "4x16", "128x128", "empty_kinds", "one_warp"])
def test_work_items_on_made_buckets(sizes):
    buckets, n_tiles = _bucket_rows(sizes)
    _assert_work_items(buckets, n_tiles)
    # each tile is at most 16 wide and 256 pixels, and cuts its unit evenly
    it = inter_mc.work_items(buckets, n_tiles, np.arange(n_tiles))
    assert np.all(it["tw"] <= 16) and np.all(it["tw"] * it["th"] <= 256)
    assert np.all(it["ox"] % it["tw"] == 0) and np.all(it["oy"] % it["th"] == 0)


def test_tile_dims():
    assert inter_mc.tile_dims(2, 2) == (2, 2)
    assert inter_mc.tile_dims(4, 4) == (4, 4)
    assert inter_mc.tile_dims(4, 16) == (4, 16)
    assert inter_mc.tile_dims(8, 32) == (8, 32)
    assert inter_mc.tile_dims(8, 64) == (8, 32)
    assert inter_mc.tile_dims(16, 64) == (16, 16)
    assert inter_mc.tile_dims(128, 128) == (16, 16)
    assert inter_mc.tile_dims(128, 4) == (16, 4)


def test_mc_tables_refuses_what_the_kernel_cannot_take():
    plan = random_mc_program(12)["plan"]
    key = next(k for k, f in sorted(plan["pairs"].items())
               if np.any(f[:, MP.P_MODE] == 1))
    bad = dict(plan, pair_masks={k: v for k, v in plan["pair_masks"].items()
                                 if k != key})
    with pytest.raises(ValueError, match="mask"):
        inter_mc.mc_tables(bad)
    key = sorted(plan["singles"])[0]
    bad = dict(plan, singles={**plan["singles"],
                              (0, 12, 8): plan["singles"][key]})
    with pytest.raises(ValueError, match="powers of two"):
        inter_mc.mc_tables(bad)
    empty = {k: {} for k in plan if k != "slots"}
    assert inter_mc.mc_tables(empty)["n_tiles"] == 0


def _assert_obmc_tables(plan):
    """Every overlay of the plan sits in exactly one block's list, the
    block's rect holds it, above overlays come before left ones, and the
    work indices expand to every tile of every block."""
    tabs = inter_mc.obmc_tables(plan)
    blocks, ov = tabs["blocks"], tabs["overlays"]
    n_ov = sum(f.shape[0] for d in ("obmc_above", "obmc_left")
               for f in plan[d].values())
    assert ov.shape[0] == n_ov
    assert blocks.shape[0] == sum(r.shape[0]
                                  for r in plan["obmc_resid"].values())
    # the lists tile the overlay table: each overlay in one list
    counts = blocks[:, K_NA] + blocks[:, K_NL]
    assert np.array_equal(blocks[:, K_OV], np.cumsum(counts) - counts)
    assert counts.sum() == n_ov
    ends = np.append(tabs["buckets"][1:, B_UNIT], blocks.shape[0])
    seen = []
    for row, end in zip(tabs["buckets"], ends):
        p, w, h = (int(v) for v in row[B_PLANE:B_H + 1])
        rects = plan["obmc_resid"][(p, w, h)]
        assert np.array_equal(blocks[row[B_UNIT]:end, :2], rects)
        for x, y, first, na, nl in blocks[row[B_UNIT]:end]:
            for k in range(first, first + na + nl):
                o = ov[k]
                assert x <= o[MP.S_X] and o[MP.S_X] + o[O_W] <= x + w
                assert y <= o[MP.S_Y] and o[MP.S_Y] + o[O_H] <= y + h
                name = "obmc_above" if k < first + na else "obmc_left"
                seen.append((name, p, int(o[O_W]), int(o[O_H]),
                             tuple(o[:MP.NS])))
    want = [(name, p, w, h, tuple(u)) for name in ("obmc_above", "obmc_left")
            for (p, w, h), f in plan[name].items() for u in f]
    assert sorted(seen) == sorted(want)
    _assert_work_items(tabs["buckets"], tabs["n_tiles"])
    return tabs


@pytest.mark.parametrize("seed,width,height", [(12, 100, 76), (21, 416, 240),
                                               (7, 201, 133)])
def test_obmc_tables_on_random_programs(seed, width, height):
    tabs = _assert_obmc_tables(random_mc_program(seed, width, height)["plan"])
    assert tabs["overlays"].shape[0] > 0


def test_obmc_tables_refuses_an_overlay_outside_every_block():
    plan = random_mc_program(12)["plan"]
    key = sorted(plan["obmc_above"])[0]
    moved = plan["obmc_above"][key].copy()
    moved[0, MP.S_X] += 2                 # off its block's left edge
    moved[0, MP.S_Y] += 1000
    with pytest.raises(ValueError, match="outside every OBMC block"):
        inter_mc.obmc_tables(dict(plan, obmc_above={
            **plan["obmc_above"], key: moved}))
    key = sorted(plan["obmc_resid"])[0]
    twice = np.concatenate([plan["obmc_resid"][key]] * 2)
    with pytest.raises(ValueError, match="overlap"):
        inter_mc.obmc_tables(dict(plan, obmc_resid={
            **plan["obmc_resid"], key: twice}))


def _obmc_blocks_plain(planes, resid, refs, plan, bd):
    """OBMC in kernel 6b's order, in place: block by block of
    `obmc_tables`, its above overlays, its left overlays, then its
    residual."""
    stk = [torch.stack(list(r)) for r in refs]
    masks = convert.tables(planes[0].device)["obmc_masks"]
    tabs = inter_mc.obmc_tables(plan)
    ends = np.append(tabs["buckets"][1:, B_UNIT], tabs["blocks"].shape[0])
    for b, end in zip(tabs["buckets"], ends):
        p, w, h = (int(v) for v in b[B_PLANE:B_H + 1])
        for blk in tabs["blocks"][b[B_UNIT]:end]:
            first, na, nl = (int(v) for v in blk[K_OV:])
            for k in range(first, first + na + nl):
                o = tabs["overlays"][k]
                inter_mc.obmc_overlay(
                    planes[p], stk[p], torch.from_numpy(o[None, :MP.NS]),
                    int(o[O_W]), int(o[O_H]), bd, k >= first + na, masks)
            inter_mc.obmc_resid(planes[p], resid[p],
                                torch.from_numpy(blk[None, :2].copy()), w, h,
                                bd)
    return planes


@pytest.mark.parametrize("seed,width,height", [(12, 100, 76), (14, 100, 76),
                                               (7, 201, 133)])
def test_obmc_block_order_equals_three_passes(seed, width, height):
    """Kernel 6b's order of work, in plain torch, against the
    reference's three passes, exactly."""
    prog = random_mc_program(seed, width, height)
    resid = [torch.from_numpy(r) for r in prog["resid"]]
    refs = [[torch.from_numpy(r) for r in rs] for rs in prog["refs"]]

    def run(fn):
        planes = inter_mc.mc_units_plain(
            [torch.zeros(d, dtype=torch.int32) for d in prog["dims"]], resid,
            refs, prog["plan"], 8)
        before = [p.clone() for p in planes]
        return before, fn(planes, resid, refs, prog["plan"], 8)

    before, want = run(inter_mc.obmc_plain)
    _, got = run(_obmc_blocks_plain)
    assert any(not torch.equal(a, b) for a, b in zip(before, want))
    for p, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"plane {p}"


REAL = {"obmc": _obmc_fixture, "warp": _warp_fixture,
        "smoke": lambda: SMOKE_STREAM}


@pytest.mark.parametrize("tag", sorted(REAL))
def test_tables_on_real_plans(tag, monkeypatch):
    """Both kernels' tables on every inter frame's plan of a real
    stream, while the port decodes it."""
    seen = {"frames": 0, "overlays": 0, "warps": 0}
    orig = pipe.export_inter_plan

    def spy(*a, **k):
        plan = orig(*a, **k)
        if plan is not None:
            mc = _assert_mc_tables(plan)
            ob = _assert_obmc_tables(plan)
            seen["frames"] += 1
            seen["overlays"] += ob["overlays"].shape[0]
            seen["warps"] += mc["warps"].shape[0]
        return plan

    monkeypatch.setattr(pipe, "export_inter_plan", spy)
    _port(str(REAL[tag]()))
    assert seen["frames"] >= 3
    assert seen["overlays" if tag != "warp" else "warps"] > 0, seen
