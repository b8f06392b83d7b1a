"""Add to a configuration's frame table the planes each shown frame's film
grain covers, for the byte floor of the grain roofline.

    python3 benchmark/grain_facts.py benchmark/configs/<name>.json

Run it after `make_config.py`, which writes the frame table.  Each entry
of "frames" gets "grain": the planes (0 luma, 1 Cb, 2 Cr) to which the
shown frame's header applies film grain (`fg_plain.planes_grained`:
luma where it has scaling points, each chroma plane where it has its own
or takes luma's), or [] where it applies none or shows an existing frame
again.  The headers are read by the port's own parser
(`unit_programs.stream_grain`, which refreshes the references after each
frame as the decoder does: a later header is read against them); the
run never calls this script.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shown_grain(stream: str) -> list:
    """The planes each shown frame grains, in display order."""
    sys.path.insert(0, ROOT)
    from easyav1_tpu_torch.unit_programs import stream_grain
    from easyav1_tpu_torch.video.av1.recon.fg_plain import planes_grained

    return [[] if fg is None or not fg.apply_grain else
            planes_grained(fg, seq.color.mono_chrome, seq.color.num_planes)
            for fg, seq in stream_grain(stream, shown=True)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    a = ap.parse_args()
    with open(a.config) as f:
        cfg = json.load(f)
    facts = shown_grain(os.path.join(ROOT, cfg["stream"]))
    if len(facts) != len(cfg["frames"]):
        sys.exit(f"{cfg['stream']}: {len(facts)} shown frames, "
                 f"{len(cfg['frames'])} in the table")
    for frame, planes in zip(cfg["frames"], facts):
        frame["grain"] = planes
    with open(a.config, "w") as f:
        json.dump(cfg, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
