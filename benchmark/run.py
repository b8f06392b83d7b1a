"""Run one cell of the benchmark of easyav1_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result: {"correct", "attempted",
"failed", "metrics", "device", ["breakdown",] "host", "checks"}; with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
ones; "host" holds the window's rate and CPU time a frame.  Each number
the correctness check compares is printed beside its limit as the last
lines of standard error and under "checks".  Exits non-zero, with no
result, without the CUDA devices the cell asks for, when a module of jax
or of the JAX package is loaded, or when anything it needs is missing.
"""

import os
import sys
import time

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (/proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    chips = {w["name"]: w["chips"]
             for w in harness.load_spec()["workloads"]}.get(a.workload)
    if chips is None:
        sys.exit(f"no workload {a.workload!r} in BENCHMARK.json")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.exit(f"{a.workload} needs {chips} CUDA device(s); "
                 f"{torch.cuda.device_count()} available")
    out = harness.run_cell(
        a.workload, a.seed, a.seconds, bool(a.trace),
        since_start=lambda: _AGE0 + time.perf_counter() - _T0)
    bad = harness.forbidden_modules()
    if bad:
        sys.exit(f"loaded modules of {', '.join(bad)}: no result")
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
