"""CPU tests of the benchmark's harness: the specification, the pins, the
readers' arithmetic, data-driven cells and metrics, the result line and
the module checks.  Runs on the CPU at the small streams' size:

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench_tiny import BENCH, REPO, TINY, make_root

import harness
import readers
import reference

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


# ------------------------------------------------------------ the spec


def test_spec_keys_and_names():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"] + SPEC["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] == "kernel_ms_per_frame"
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_every_file_the_spec_names_exists():
    for c in SPEC["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        harness.metric_reader(m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = harness.find_cell(SPEC, cell)
    e2e = [m["name"] for m in c.metrics[False]]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.metrics[True]


@pytest.mark.parametrize("metric", sorted(
    f.stem for f in (BENCH / "metrics").glob("*.json")))
def test_every_metric_file_names_a_reader(metric):
    """Each metric's file, listed in BENCHMARK.json or kept for a later
    cell, names a reader of readers.READERS."""
    spec = json.loads((BENCH / "metrics" / f"{metric}.json").read_text())
    assert spec["reader"] in readers.READERS
    assert callable(harness.metric_reader(metric))


def test_byte_floor_names_the_profiled_kernels():
    spec = json.loads((BENCH / "metrics" /
                       "lf_cdef_roofline.json").read_text())
    assert spec["kernels"] == ["lf_frame_kernel", "cdef_dirs_kernel",
                               "cdef_filter_kernel"]
    for k in spec["kernels"]:
        cu = "loopfilter.cu" if k.startswith("lf") else "cdef.cu"
        assert k in (REPO / "easyav1_tpu_torch" / "csrc" / cu).read_text()


# ------------------------------------------------------------ the pins


@pytest.mark.parametrize("conf", sorted(
    str(f.relative_to(REPO)) for f in (BENCH / "configs").glob("*.json")))
def test_streams_are_pinned(conf):
    cfg = harness.load_config(REPO / conf, REPO)
    data = (REPO / cfg["stream"]).read_bytes()
    assert hashlib.sha256(data).hexdigest() == cfg["sha256"]
    assert not (BENCH / Path(cfg["stream"]).name).exists()
    assert len({f["sha256"] for f in cfg["frames"]}) == len(cfg["frames"])


def test_a_stream_that_differs_from_its_pin_is_refused(root):
    cfg = json.loads((root / "benchmark" / "configs" /
                      f"{TINY[0]}.json").read_text())
    stream = root / cfg["stream"]
    data = bytearray(stream.read_bytes())
    data[-1] ^= 1
    stream.write_bytes(bytes(data))
    try:
        with pytest.raises(ValueError, match="sha256"):
            harness.load_config(root / "benchmark" / "configs" /
                                f"{TINY[0]}.json", root)
    finally:
        data[-1] ^= 1
        stream.write_bytes(bytes(data))


# ------------------------------------------------------------ readers


def _readings(**kw):
    cfg = {"width": 16, "height": 8, "subsampling": [1, 1], "bit_depth": 8,
           "frames": [{"decoded": [{"deblock": [0, 1, 2],
                                    "cdef": [0, 1, 2]}]},
                      {"decoded": [{"deblock": [], "cdef": [1, 2]}]},
                      {"decoded": []}]}
    return harness.Readings(config=kw.pop("config", cfg), **kw)


def test_window_readers():
    r = _readings(n_frames=4, window_s=2.0, cpu_s=0.1, setup_s=3.5,
                  frame_s=[0.01, 0.02, 0.03, 0.04])
    assert readers.fps(r, {}) == 2.0
    assert readers.cpu_ms_per_frame(r, {}) == pytest.approx(25.0)
    assert readers.setup_s(r, {}) == 3.5
    assert readers.frame_ms_percentile(r, {"q": 50}) == pytest.approx(25.0)
    assert readers.frame_ms_percentile(r, {"q": 95}) == pytest.approx(38.5)


def _profile():
    # window [0, 100); device busy [10, 30) and [20, 40) (overlap), [90,
    # 110) clipped to [90, 100): busy 40, idle 60
    return {"window": (0, 100),
            "device_events": [("lf_frame_kernel(Frame)", 10, 20),
                              ("cdef_filter_kernel(Filter)", 20, 20),
                              ("Memcpy DtoH", 90, 20)],
            "host_spans": [("entropy", 0, 10), ("lf_cdef", 10, 50),
                           ("tail", 50, 95)],
            "frame_indices": [0, 1]}


def test_idle_union_and_gaps():
    assert readers.union([(5, 9), (0, 3), (2, 4), (9, 9)]) == [(0, 4),
                                                               (5, 9)]
    p = _profile()
    assert readers.busy_ns(p) == 40
    gaps = dict(readers.idle_gaps(p))
    # idle [0, 10) in entropy, [40, 50) in lf_cdef, [50, 90) in tail
    assert gaps == pytest.approx({"entropy": 10e-9, "lf_cdef": 10e-9,
                                  "tail": 40e-9})
    p["host_spans"] = []
    assert dict(readers.idle_gaps(p)) == pytest.approx(
        {"outside the pipe": 60e-9})
    ops = readers.device_ops(_profile())
    assert [n for n, _ in ops][0] == "lf_frame_kernel(Frame)"


@pytest.mark.parametrize("spec, ns", [
    ({}, 40), ({"names": ["lf_frame_kernel"]}, 20), ({"names": ["kernel"]}, 30),
    ({"names": ["Memcpy DtoH"]}, 10), ({"skip": ["Memcpy", "Memset"]}, 30),
    ({"names": ["kernel"], "skip": ["cdef"]}, 20)])
def test_device_ms_is_the_busy_union_a_frame(spec, ns):
    """Traced: the chosen operations' union inside the window (here [0,
    100)), in ms, over the profiled window's two frames."""
    got = readers.device_ms(_readings(profile=_profile()), spec)
    assert got == pytest.approx(ns * 1e-6 / 2)


def test_device_ms_untraced_counts_every_operation_whole():
    """Untraced (no window on the profiler's clock): each operation counts
    whole; nothing to read gives None, never 0."""
    p = {**_profile(), "window": None}
    assert readers.device_ms(_readings(profile=p), {}) == \
        pytest.approx(50e-6 / 2)
    assert readers.busy_ns(p) == 50
    assert readers.device_ms(_readings(profile=p), {"names": ["absent"]}) \
        is None
    assert readers.device_ms(_readings(profile={**p, "device_events": []}),
                             {}) is None
    assert readers.device_ms(_readings(), {}) is None


def test_byte_floor_from_frame_shapes():
    r = _readings()
    luma, chroma = 16 * 8, 8 * 4
    cfg = r.config
    assert readers.lf_cdef_bytes(cfg, cfg["frames"][0]) == \
        2 * (luma + 2 * chroma) + luma + 2 * (luma + 2 * chroma)
    assert readers.lf_cdef_bytes(cfg, cfg["frames"][1]) == \
        luma + 2 * 2 * chroma
    assert readers.lf_cdef_bytes(cfg, cfg["frames"][2]) == 0
    hbd = {**cfg, "bit_depth": 10}
    assert readers.lf_cdef_bytes(hbd, cfg["frames"][1]) == \
        2 * (luma + 2 * 2 * chroma)


def test_roofline_share():
    r = _readings(profile=_profile())
    spec = {"kernels": ["lf_frame_kernel", "cdef_filter_kernel"],
            "bytes": "lf_cdef"}
    need = sum(readers.lf_cdef_bytes(r.config, r.config["frames"][i])
               for i in (0, 1))
    want = 100 * need / readers.HBM_BYTES_PER_S / 40e-9
    assert readers.byte_roofline(r, spec) == pytest.approx(want)
    assert readers.byte_roofline(r, {**spec, "kernels": ["absent"]}) is None
    assert readers.byte_roofline(_readings(), spec) is None


# ------------------------------------------------------------ reference


def test_frame_digest_is_the_oracle_layout():
    import numpy as np
    y = np.arange(6, dtype=np.uint16).reshape(2, 3)
    u = np.array([[7]], np.uint16)
    assert reference.frame_digest([y, u]) == hashlib.sha256(
        y.astype("<u2").tobytes() + u.astype("<u2").tobytes()).hexdigest()
    assert reference.frame_digest([y[:, :2]]) == hashlib.sha256(
        y[:, :2].astype("<u2").tobytes()).hexdigest()


def test_compare_counts_each_fault():
    import numpy as np
    a, b = np.zeros((2, 2), np.uint8), np.ones((2, 2), np.uint8)
    table = [{"sha256": reference.frame_digest([a]), "pts": 0},
             {"sha256": reference.frame_digest([b]), "pts": 33},
             {"sha256": reference.frame_digest([b, b]), "pts": 67}]
    frames = [{"pos": 0, "index": 0, "got": True, "timestamp": 0},
              {"pos": 1, "index": 1, "got": True, "timestamp": 33},
              {"pos": 2, "index": 2, "got": False, "timestamp": None},
              {"pos": 3, "index": 0, "got": True, "timestamp": 5},
              {"pos": 4, "index": 1, "got": True, "timestamp": 34},
              {"pos": 5, "index": 2, "got": True, "timestamp": 67}]
    digests = {0: table[0]["sha256"], 1: reference.frame_digest([a]),
               3: table[0]["sha256"], 4: table[1]["sha256"]}
    assert reference.compare(frames, digests, table) == {
        "mismatched_frames": 1, "missing_frames": 1, "wrong_timestamps": 2,
        "unhashed_frames": 1, "failed_frames": 5}


def test_the_window_hashes_every_delivered_frame():
    import numpy as np
    w = harness.Window()
    w.start()
    cpu0 = w.hash_cpu_s()
    planes = [[np.full((64, 64), k, np.uint8), np.full((32, 32), k, np.uint8)]
              for k in range(12)]
    for k in range(12):
        w.add(0.0, 1.0, {"index": k % 3, "timestamp": k,
                         "planes": planes[k] if k != 7 else None})
    w.close()
    assert w.hash_cpu_s() >= cpu0
    assert sorted(w.digests) == [k for k in range(12) if k != 7]
    for k, d in w.digests.items():
        assert d == reference.frame_digest(planes[k])
    assert [f["got"] for f in w.frames] == [k != 7 for k in range(12)]
    assert w.frame_s == [1.0] * 12


# ------------------------------------------------------------ runs


def test_added_config_traffic_cell_and_metrics_need_no_edit(root):
    """A later change adds a configuration (make_root's small streams), a
    traffic mix, a cell and two metrics as files and entries."""
    owned = {p.name: p.read_bytes() for p in BENCH.glob("*.py")}
    (root / "benchmark" / "traffic" / "playback2.json").write_text(
        json.dumps({"session": {}, "warmup_passes": 2}))
    (root / "benchmark" / "metrics" / "frame_ms_p50.json").write_text(
        json.dumps({"reader": "frame_ms_percentile", "q": 50}))
    (root / "benchmark" / "metrics" / "stage_spans.py").write_text(
        "def read(run, spec):\n"
        "    return float(len(run.profile['host_spans'])) or None\n")
    # a mix that needs code: its own play_cell, here one that records
    # that it ran
    (root / "benchmark" / "traffic" / "playback3.json").write_text(
        json.dumps({"session": {}, "warmup_passes": 1}))
    (root / "benchmark" / "traffic" / "playback3.py").write_text(
        "import harness\n"
        "def play_cell(cell, *a):\n"
        "    cell.traffic['played_by'] = __name__\n"
        "    harness.play_cell(cell, *a)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = f"{TINY[0]}.playback2"
    spec["workloads"].append({"name": cell, "config": TINY[0],
                              "traffic": "playback2", "chips": 1,
                              "why": "added"})
    spec["end_to_end"].append({"name": "frame_ms_p50", "unit": "ms",
                               "better": "lower", "bound": 0.05,
                               "source": "host_clock", "workloads": [cell]})
    spec["per_layer"].append({
        "name": "stage_spans", "unit": "spans", "better": "lower",
        "source": "program_span", "layer": "pipe",
        "moves": "frame_ms_p50", "workloads": [cell]})
    spec["workloads"].append({"name": f"{TINY[0]}.playback3",
                              "config": TINY[0], "traffic": "playback3",
                              "chips": 1, "why": "added"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    played = []
    real = harness.play_cell
    harness.play_cell = lambda cell, *a: (played.append(
        cell.traffic.get("played_by")), real(cell, *a))
    try:
        coded = harness.run_cell(f"{TINY[0]}.playback3", 7, 0.5, False,
                                 device="cpu", root=root)
    finally:
        harness.play_cell = real
    assert coded["correct"] and played == ["benchmark_traffic_playback3"]
    out = harness.run_cell(cell, 7, 0.5, False, device="cpu", root=root)
    assert out["correct"] and out["attempted"] % 8 == 0
    # no device on the CPU: kernel_ms_per_frame has nothing to read
    assert set(out["metrics"]) == {"setup_s", "frame_ms_p50"}
    assert out["metrics"]["frame_ms_p50"]["value"] > 0
    traced = harness.run_cell(cell, 7, 1.0, True, device="cpu", root=root)
    assert traced["correct"]
    assert traced["metrics"]["stage_spans"]["value"] >= traced["attempted"]
    for name, data in owned.items():
        assert (root / "benchmark" / name).read_bytes() == data


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(root, trace):
    out = harness.run_cell(f"{TINY[1]}.playback", 2**31 + 11, 1.0, trace,
                           device="cpu", root=root)
    keys = RESULT_KEYS + (["breakdown"] if trace else []) + ["host",
                                                           "checks"]
    assert list(out) == keys
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 8
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert set(out["checks"]) == {"mismatched_frames", "missing_frames",
                                  "wrong_timestamps", "unhashed_frames"}
    assert all(c == {"value": 0, "limit": 0} for c in out["checks"].values())
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device events on the CPU: the window is one idle gap, split
        # by the pipe stages the span clock kept
        assert "entropy" in dict(out["breakdown"]["idle_gaps"])
        assert "busy_s" in out["device"] and out["device"]["window_s"] > 0
    # the device metrics read nothing on the CPU; the host's readings stay
    assert set(out["metrics"]) == (set() if trace else {"setup_s"})
    assert out["host"]["fps"] > 0 and out["host"]["host_cpu_ms_per_frame"] > 0
    json.dumps(out)


def test_the_seed_sets_the_first_frame_of_the_window(root):
    import easyav1_tpu_torch as port
    firsts = []
    for seed in (3, 2**31 + 3, 2**33 + 4):
        cell = harness.find_cell(harness.load_spec(root),
                                 f"{TINY[0]}.playback", root)
        window = harness.Window()
        window.start()
        av = port.EasyAV1(str(root / cell.config["stream"]), device="cpu")
        try:
            harness.play_cell(cell, av, seed, 0.1, False,
                              harness.Readings(config=cell.config), window,
                              False, lambda: 0.0)
        finally:
            av.close()
            window.close()
        firsts.append(window.frames[0]["index"])
        assert len(window.frames) % 8 == 0
        assert len(window.digests) == len(window.frames)
        assert reference.compare(window.frames, window.digests,
                                 cell.config["frames"])["failed_frames"] == 0
    # warm-up: a pass, the seek to frame 0, then seed % 8 frames
    assert firsts == [4, (2**31 + 4) % 8, (2**33 + 5) % 8]


def _played(root, seed, seconds, trace, since_start=lambda: 0.0):
    import easyav1_tpu_torch as port
    cell = harness.find_cell(harness.load_spec(root), f"{TINY[0]}.playback",
                             root)
    run, window = harness.Readings(config=cell.config), harness.Window()
    window.start()
    av = port.EasyAV1(str(root / cell.config["stream"]), device="cpu")
    try:
        harness.play_cell(cell, av, seed, seconds, trace, run, window, False,
                          since_start)
    finally:
        av.close()
        window.close()
    return run, window


def test_setup_ends_before_the_seeds_frames(root):
    """set-up's clock stops after the fixed warm-up (a pass and the seek),
    whatever the seed: the seed's frames are outside it."""
    steps = []
    real = harness.Player.step

    def step(self):
        steps.append(1)
        return real(self)
    for seed in (0, 5, 2**31 + 6):
        at = []
        steps.clear()
        harness.Player.step = step
        try:
            _played(root, seed, 0.1, False, lambda: at.append(len(steps)))
        finally:
            harness.Player.step = real
        assert at == [8 + 1]


def test_a_traced_run_keeps_the_pipe_stages_host_spans(root):
    """breakdown's idle gaps are labelled by the pipe's stages through the
    harness's span clock, which stands in for `pipe._Stages`: a traced
    run keeps a span of each stage of every frame."""
    run, window = _played(root, 3, 0.4, True)
    names = [n for n, _, _ in run.profile["host_spans"]]
    assert {"entropy", "plan", "prepare", "upload", "tail"} <= set(names)
    assert names.count("tail") == len(run.profile["frame_indices"])
    starts = [a for _, a, _ in run.profile["host_spans"]]
    assert starts == sorted(starts)
    assert all(a <= b for _, a, b in run.profile["host_spans"])


def test_run_refuses_without_a_card():
    r = subprocess.run([sys.executable, str(BENCH / "run.py"),
                        "--workload", SPEC["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=REPO)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_refuses_in_a_bare_directory(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/: no stream, no
    port."""
    shutil = __import__("shutil")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        SPEC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path,
                       env={"PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and r.stdout.strip() == ""
    with pytest.raises(FileNotFoundError):
        harness.run_cell(SPEC["workloads"][0]["name"], 1, 1.0, False,
                         device="cpu", root=tmp_path)


# ------------------------------------------------------------ modules


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules(["jax.numpy", "os"]) == ["jax"]
    assert harness.forbidden_modules(["easyav1_tpu.api"]) == ["easyav1_tpu"]
    assert harness.forbidden_modules(["easyav1_tpu_torch.api",
                                      "jaxtyping", "flaxen"]) == []


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    tops = set(_imports(BENCH / "reference.py"))
    assert harness.PORT not in tops
    assert tops <= {"__future__", "hashlib", "typing", "numpy"}


def test_a_run_loads_no_jax_module(root):
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(REPO)!r}]\n"
            "import harness, reference\n"
            "from pathlib import Path\n"
            f"out = harness.run_cell({TINY[0] + '.playback'!r}, 5, 0.2, "
            f"False, device='cpu', root=Path({str(root)!r}))\n"
            "assert out['correct']\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True)
    tops = set(json.loads(r.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert harness.PORT in tops
    assert not tops & set(harness.FORBIDDEN)
