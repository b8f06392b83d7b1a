"""CPU tests of the 8K 10-bit cell: its configuration's file, its entries
in BENCHMARK.json, and the two per-layer metrics it adds, on synthetic
runs.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json

from bench_tiny import BENCH, REPO

import harness

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "av1-4320p-10bit.playback"
CONFIG = BENCH / "configs" / "av1-4320p-10bit.json"
METRICS = {"strip.kernel_ms": ["intra_wavefront_kernel"],
           "postfilter.kernel_ms": ["lf_frame_kernel", "cdef_dirs_kernel",
                                    "cdef_filter_kernel",
                                    "lr_frame_kernel"]}


def test_the_configuration_is_pinned_and_states_its_cuts():
    # load_config raises unless the stream's sha256 is the pinned one
    cfg = harness.load_config(CONFIG, REPO)
    assert cfg["stream"] == "tests/data/bench/bench_av1_10bit_7680x4320_8.webm"
    assert (cfg["width"], cfg["height"], cfg["bit_depth"],
            cfg["subsampling"]) == (7680, 4320, 10, [1, 1])
    assert len(cfg["frames"]) == cfg["gop"] == 8
    assert [f["key"] for f in cfg["frames"]] == [True] + [False] * 7
    conf = {c["name"]: c for c in SPEC["configs"]}["av1-4320p-10bit"]
    assert conf["file"] == str(CONFIG.relative_to(REPO))
    assert conf["reduced"] == cfg["reduced"] == ["gop", "content"]
    assert sorted(cfg["assumed"]) == ["filters", "gop", "rate", "tiles"]
    assert "2x2 tiles" in cfg["format"] and "level 6.0" in cfg["source"]


def test_the_cell_resolves_to_its_readers():
    c = harness.find_cell(SPEC, CELL)
    assert c.chips == 1 and c.traffic_code is None
    assert c.traffic["session"] == {}
    assert [m["name"] for m in c.metrics[False]] == [
        "kernel_ms_per_frame", "setup_s"]
    assert set(METRICS) <= {m["name"] for m in c.metrics[True]}


def test_the_new_metrics_name_the_kernels():
    for name, kernels in METRICS.items():
        spec = json.loads((BENCH / "metrics" / f"{name}.json").read_text())
        assert spec == {"reader": "device_ms", "names": kernels}
        for k in kernels:
            assert any(f"{k}(" in f.read_text() for f in
                       (REPO / "easyav1_tpu_torch" / "csrc").glob("*.cu"))


def test_the_new_metrics_read_their_kernels_alone():
    """Each reads the union of its kernels' device time a frame, in ms,
    and nothing of the others."""
    ms = 1_000_000
    events = [("void intra_wavefront_kernel<false>(Args)", 0, 3 * ms),
              ("mc_kernel", 4 * ms, ms),
              ("lf_frame_kernel(Frame)", 5 * ms, ms),
              ("cdef_dirs_kernel(Dirs)", 6 * ms, ms),
              ("cdef_filter_kernel(Filter)", 6 * ms, 2 * ms),
              ("lr_frame_kernel(Frame)", 8 * ms, ms),
              ("Memcpy HtoD (Pageable -> Device)", 9 * ms, 9 * ms)]
    run = harness.Readings(config={}, profile={
        "window": None, "device_events": events, "host_spans": [],
        "frame_indices": [0, 1]})
    got = {n: harness.metric_reader(n)(run) for n in METRICS}
    assert got == {"strip.kernel_ms": 1.5, "postfilter.kernel_ms": 2.0}
    run.profile["device_events"] = events[1:2]
    assert all(harness.metric_reader(n)(run) is None for n in METRICS)
