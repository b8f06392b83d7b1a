"""The correctness check fails a run whose timed path is broken.

On the CPU (`device="cpu"`, the small streams): a sound run is correct;
each fault of `plants.FAULTS` and each control of `plants.CONTROLS`,
planted under the timed path, makes `correct` false.  On the card
(marked `cuda`; they skip without one): each control in each cell of
BENCHMARK.json at the cell's own size, on three seeds, with the readings
printed:

    python -m pytest benchmark/tests/test_bench_faults.py -m cuda -s
"""

from __future__ import annotations

import json

import pytest

from bench_tiny import REPO, TINY, make_root

import harness
import plants

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CONTROL_SEEDS = (2**31 + 101, 3 * 10**9 + 7, 4_000_000_037)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("faults"))


def _run(root, cell, plant=None, device="cpu", seconds=1.0, seed=2**31 + 9):
    if plant is None:
        return harness.run_cell(cell, seed, seconds, False, device=device,
                                root=root)
    with plant():
        return harness.run_cell(cell, seed, seconds, False, device=device,
                                root=root)


@pytest.mark.parametrize("stream", TINY)
def test_a_sound_run_is_correct(root, stream):
    out = _run(root, f"{stream}.playback")
    assert out["correct"] and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(plants.FAULTS))
@pytest.mark.parametrize("stream", TINY)
def test_each_fault_fails(root, stream, fault):
    out = _run(root, f"{stream}.playback", plants.FAULTS[fault])
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["mismatched_frames"]["value"] > 0


@pytest.mark.parametrize("control", sorted(plants.CONTROLS))
@pytest.mark.parametrize("stream", TINY)
def test_each_control_fails(root, stream, control):
    out = _run(root, f"{stream}.playback", plants.CONTROLS[control])
    assert not out["correct"]
    assert out["checks"]["mismatched_frames"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("control", sorted(plants.CONTROLS))
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_at_the_cells_size(cell, control):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in CONTROL_SEEDS:
        out = _run(REPO, cell, plants.CONTROLS[control], device="cuda",
                   seconds=SPEC["run_seconds"], seed=seed)
        print(json.dumps({"cell": cell, "control": control, "seed": seed,
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
        assert not out["correct"]
        assert out["checks"]["mismatched_frames"]["value"] > 0
