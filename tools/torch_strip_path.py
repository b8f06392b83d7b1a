"""The strip kernel on streams' key frames, on the card: its time alone
and the dependency path of its SB wavefront, over the whole frame and
inside each tile.

    python3 tools/torch_strip_path.py STREAM [STREAM ...] [--reps 10]

For each stream, the key frame's inputs as the main pipe makes them
(`pipe.first_frame_inputs`: the tile-parallel entropy decode where the
frame has tiles, the host prepare, the SB schedule), then the strip
kernel under that schedule, timed over --reps launches by CUDA events
(`chip_smoke.cuda_ms`).  From the schedule, the luma plane's SB grid,
each SB's units and levels (`intra_strip.sb_schedule`): the wavefront's
steps (C + 2(R - 1) on an R x C grid: SB (r, c) waits for (r, c - 1) and
(r - 1, c + 1)), and the units and levels on its longest path; then the
same for each tile alone, the path a wavefront bounded by the tile would
run (the frame's tiles one after another on the same SM count would take
the longest of them).  Prints one JSON line a stream.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def longest_path(weights: np.ndarray) -> int:
    """The heaviest path through an R x C grid of SB weights under the
    wavefront's rule: SB (r, c) starts once (r, c - 1) and (r - 1, c + 1)
    (or (r - 1, c) in the last column) are whole."""
    rows, cols = weights.shape
    d = np.zeros((rows, cols), np.int64)
    for r in range(rows):
        for c in range(cols):
            left = d[r, c - 1] if c else 0
            up = d[r - 1, min(c + 1, cols - 1)] if r else 0
            d[r, c] = weights[r, c] + max(left, up)
    return int(d.max())


def wavefront(units: np.ndarray, levels: np.ndarray) -> dict:
    rows, cols = units.shape
    return {"grid": [rows, cols], "steps": cols + 2 * (rows - 1),
            "units": int(units.sum()), "levels": int(levels.sum()),
            "path_units": longest_path(units),
            "path_levels": longest_path(levels)}


def key_frame(path, dev, reps):
    import chip_smoke as S
    from easyav1_tpu_torch.video.av1.recon import intra_strip

    fr = S.Frame.key_frame(path, dev)
    hdr = fr.key["hdr"]
    sbh, sbw, spans, _order = fr.wavefront
    spans = spans.cpu().numpy()
    rows, cols = intra_strip.sb_grid(fr.dims, sbh, sbw)[0][:2]
    units = (spans[0, :, 1] - spans[0, :, 0]).reshape(rows, cols)
    levels = spans[0, :, 3].reshape(rows, cols)
    t = hdr.tile
    sb_cols = [min(s, cols) for s in t.col_starts]
    sb_rows = [min(s, rows) for s in t.row_starts]
    tiles = [wavefront(units[r0:r1, c0:c1], levels[r0:r1, c0:c1])
             for r0, r1 in zip(sb_rows, sb_rows[1:])
             for c0, c1 in zip(sb_cols, sb_cols[1:])]
    ms = S.cuda_ms(lambda: fr.run(fr.wavefront), reps)
    return {"stream": os.path.relpath(path, REPO),
            "size": [hdr.upscaled_width, hdr.frame_height],
            "sb": sbh, "tiles": [t.cols, t.rows], "ms": ms, "reps": reps,
            "units_all_planes": int((spans[:, :, 1] - spans[:, :, 0]).sum()),
            "levels_all_planes": int(spans[:, :, 3].sum()),
            "luma": wavefront(units, levels), "by_tile": tiles}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("streams", nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for path in a.streams:
        out = key_frame(os.path.abspath(path), dev, a.reps)
        print(json.dumps({"card": card, **out}), flush=True)


if __name__ == "__main__":
    main()
