"""A copy of the benchmark in a temporary root, with cells of its own on
the small streams of tests/data/smoke (frame tables in `configs/` here),
for the CPU tests.  `make_root` adds them the way a later change would:
as files and entries, the harness's own files copied unchanged."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
TINY = ("inter_modes_96x96", "hbd_modes10_96x96")

for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)


def make_root(dst: Path) -> Path:
    """A root holding BENCHMARK.json, a copy of benchmark/ and the small
    streams, with a config and a `<stream>.playback` cell for each of
    TINY, listed in every per-layer metric's cells."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    for name in TINY:
        cfg = json.loads((BENCH / "tests" / "configs" /
                          f"{name}.json").read_text())
        stream = dst / cfg["stream"]
        stream.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / cfg["stream"], stream)
        shutil.copy(BENCH / "tests" / "configs" / f"{name}.json",
                    dst / "benchmark" / "configs" / f"{name}.json")
        spec["configs"].append({
            "name": name, "source": cfg["source"],
            "file": f"benchmark/configs/{name}.json", "reduced": [],
            "why": "a small stream for the CPU tests"})
        spec["workloads"].append({
            "name": f"{name}.playback", "config": name,
            "traffic": "playback", "chips": 1,
            "why": "a small stream for the CPU tests"})
        for m in spec["per_layer"]:
            m["workloads"].append(f"{name}.playback")
    (dst / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dst
