"""CPU tests of the `resident` mix (`traffic/resident.py`): on the small
streams of `bench_tiny.py`, the player's thread never downloads a frame,
every delivered frame is hashed, on the hashing thread, and a fault
planted where frames are produced is caught as it is in playback.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json

import pytest

from bench_tiny import REPO, TINY, make_root

import harness
import plants

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "av1-1080p-8bit.resident"
SEED = 2**31 + 13


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """bench_tiny's root with a `<stream>.resident` cell a small stream."""
    dst = make_root(tmp_path_factory.mktemp("resident"))
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    for name in TINY:
        spec["workloads"].append({
            "name": f"{name}.resident", "config": name,
            "traffic": "resident", "chips": 1,
            "why": "a small stream for the CPU tests"})
    (dst / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dst


def _run(root, stream, seconds=1.0):
    return harness.run_cell(f"{stream}.resident", SEED, seconds, False,
                            device="cpu", root=root)


def test_the_cell_plays_the_1080p_stream_resident():
    c = harness.find_cell(SPEC, CELL)
    assert c.chips == 1 and len(c.config["frames"]) == 60
    assert c.traffic["session"] == {"resident": True}
    assert c.traffic_code is not None and c.traffic_code.name == \
        "resident.py"
    assert [m["name"] for m in c.metrics[False]] == [
        "kernel_ms_per_frame", "setup_s"]
    assert c.metrics[True]


@pytest.mark.parametrize("stream", TINY)
def test_the_player_never_downloads_and_every_frame_is_hashed(
        root, stream, monkeypatch):
    from easyav1_tpu_torch.native.pipe import LazyPlanes
    handed = []
    add = harness.Window.add

    def spy(self, t0, t1, rec):
        # the player's thread, as its step returns
        p = rec["planes"]
        handed.append((type(p) is LazyPlanes, p is not None
                       and p.materialised))
        add(self, t0, t1, rec)

    monkeypatch.setattr(harness.Window, "add", spy)
    out = _run(root, stream)
    assert out["correct"] and out["failed"] == 0
    assert out["attempted"] == len(handed) > 0
    assert handed == [(True, False)] * len(handed)
    assert all(v["value"] == 0 for v in out["checks"].values())
    # the mix puts the harness's player back
    assert harness.Player.__name__ == "Player"


@pytest.mark.parametrize("stream", TINY)
def test_a_stale_frame_is_caught_in_resident_mode(root, stream):
    with plants.stale():
        out = _run(root, stream)
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["mismatched_frames"]["value"] > 0
