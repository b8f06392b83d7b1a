"""CPU tests of the film grain cell: its configuration's grain facts
against the stream's headers, its entries in BENCHMARK.json and their
readers, and the grain roofline's byte floor and share on synthetic
runs.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json

import pytest

from bench_tiny import BENCH, REPO

import grain_facts
import harness
import readers

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "av1-1080p-8bit-grain.playback"
CONFIG = BENCH / "configs" / "av1-1080p-8bit-grain.json"
METRICS = ("grain.kernel_ms", "grain_roofline")


def _roofline():
    return harness._module(BENCH / "metrics" / "grain_roofline.py",
                           "benchmark_metric_")


def test_the_grain_facts_are_the_headers():
    cfg = harness.load_config(CONFIG, REPO)
    got = [f["grain"] for f in cfg["frames"]]
    assert got == grain_facts.shown_grain(str(REPO / cfg["stream"]))
    # the stream grains every plane of every frame
    assert got == [[0, 1, 2]] * 8


def test_the_cell_resolves_to_its_readers():
    c = harness.find_cell(SPEC, CELL)
    assert c.chips == 1 and len(c.config["frames"]) == 8
    layer = [m["name"] for m in c.metrics[True]]
    assert set(METRICS) <= set(layer)
    assert [m["name"] for m in c.metrics[False]] == [
        "kernel_ms_per_frame", "setup_s"]
    for name in METRICS:
        assert callable(harness.metric_reader(name))
    for other in {w["name"] for w in SPEC["workloads"]} - {CELL}:
        names = {m["name"] for m in harness.find_cell(SPEC, other)
                 .metrics[True]}
        assert not names & set(METRICS), other


def test_the_grain_metrics_name_the_kernel():
    spec = json.loads((BENCH / "metrics" / "grain.kernel_ms.json")
                      .read_text())
    assert spec == {"reader": "device_ms", "names": ["fg_frame_kernel"]}
    src = (REPO / "easyav1_tpu_torch" / "csrc" / "fg.cu").read_text()
    assert _roofline().KERNEL == "fg_frame_kernel" and \
        "fg_frame_kernel" in src


@pytest.mark.parametrize("planes,bd,want", [
    ([0, 1, 2], 8, 6_220_800),
    ([0], 8, 2 * 2_073_600),
    ([1, 2], 8, 2 * 2 * 518_400 + 2_073_600),   # luma read for scaling
    ([], 8, 0),
    ([0, 1, 2], 10, 2 * 6_220_800)])
def test_the_byte_floor_of_a_1080p_frame(planes, bd, want):
    cfg = {"width": 1920, "height": 1080, "subsampling": [1, 1],
           "bit_depth": bd}
    assert _roofline().grain_bytes(cfg, {"grain": planes}) == want
    assert _roofline().grain_bytes(cfg, {}) == 0


def _run(events, indices, frames):
    cfg = {"width": 16, "height": 8, "subsampling": [1, 1], "bit_depth": 8,
           "frames": frames}
    return harness.Readings(config=cfg, profile={
        "window": None, "device_events": events, "host_spans": [],
        "frame_indices": indices})


def test_the_share_on_a_synthetic_run():
    frames = [{"grain": [0, 1, 2]}, {"grain": []}, {"grain": [1]}]
    # 16x8 4:2:0: 128 luma, 32 a chroma plane; frame 0: 2 x 192 bytes,
    # frame 2: 2 x 32 + 128 (luma read for the scaling)
    need = 2 * 192 + (2 * 32 + 128)
    events = [("void (anonymous namespace)::fg_frame_kernel<unsigned "
               "char>(Frame)", 0, 300), ("lr_frame_kernel", 0, 1000),
              ("fg_frame_kernel<unsigned char>", 5000, 500)]
    run = _run(events, [0, 1, 2], frames)
    share = _roofline().read(run, {})
    assert share == pytest.approx(
        100 * need / readers.HBM_BYTES_PER_S / 800e-9)
    got = harness.metric_reader("grain.kernel_ms")(run)
    assert got == pytest.approx(800e-6 / 3)


def test_the_share_is_none_without_the_kernel_or_grain():
    frames = [{"grain": [0, 1, 2]}, {"grain": []}]
    no_kernel = _run([("lr_frame_kernel", 0, 100)], [0, 1], frames)
    assert _roofline().read(no_kernel, {}) is None
    assert harness.metric_reader("grain.kernel_ms")(no_kernel) is None
    no_grain = _run([("fg_frame_kernel", 0, 100)], [1, 1], frames)
    assert _roofline().read(no_grain, {}) is None
    assert _roofline().read(harness.Readings(config={}), {}) is None
