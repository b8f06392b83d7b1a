"""Fill a configuration's frame table from libdav1d and the stream's
headers.

    python3 benchmark/make_config.py benchmark/configs/<name>.json \
        [--oracle tools/build/oracle]

The file names its stream (a path from the root of the checkout) and the
stream's sha256.  This script checks the sha256, decodes the stream with
libdav1d through the oracle tool (`make -C tools` builds it), and writes
into the file the frame size, the bit depth and one entry a shown frame:
its timestamp in ms, libdav1d's sha256 of its samples (`reference.
frame_digest`), whether it is a key frame, and for each frame decoded
for it (a hidden frame before it, and itself unless it shows an existing
frame) the planes its header deblocks and CDEF-filters (for the byte
floor of the LF + CDEF roofline).  The headers are read by the port's own parser; that is
the only use of the port here, and the run never calls this script.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dav1d_frames(stream: str, oracle: str) -> dict:
    """The oracle's metadata, with each frame's sha256 of its tightly
    packed little-endian samples."""
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "o")
        subprocess.run([oracle, stream, prefix], check=True,
                       capture_output=True)
        with open(prefix + ".json") as f:
            meta = json.load(f)
        w, h, depth = meta["width"], meta["height"], meta["depth"]
        cw = (w + (1 << meta["ss_x"]) - 1) >> meta["ss_x"]
        ch = (h + (1 << meta["ss_y"]) - 1) >> meta["ss_y"]
        size = (w * h + 2 * cw * ch) * (2 if depth > 8 else 1)
        digests = []
        with open(prefix + ".yuv", "rb") as f:
            for _ in meta["frames"]:
                chunk = f.read(size)
                if len(chunk) != size:
                    sys.exit(f"{stream}: the oracle's output is short")
                digests.append(hashlib.sha256(chunk).hexdigest())
    meta["digests"] = digests
    return meta


def filter_planes(stream: str) -> list:
    """Per shown frame, in display order: the frames decoded for it (a
    hidden frame before it, and itself unless it shows an existing
    frame), each as {"deblock": planes, "cdef": planes} as its header
    sets them."""
    sys.path.insert(0, ROOT)
    from easyav1_tpu_torch.container.webm import TrackType, WebMDemuxer
    from easyav1_tpu_torch.video.av1.backend import AV1Backend

    shown, pending = [], []

    class Headers(AV1Backend):
        def _decode_frame(self, hdr, tile_payloads, ts):
            lv, ibc = hdr.lf.level, getattr(hdr, "allow_intrabc", False)
            n = self.seq.color.num_planes
            deblock = [p for p in range(n) if any(lv) and not ibc and (
                lv[0] or lv[1] if p == 0 else lv[p + 1])]
            cd = hdr.cdef
            cdef = []
            if (getattr(self.seq, "enable_cdef", False) and cd is not None
                    and not hdr.coded_lossless and not ibc):
                y = any(cd.y_pri_strength) or any(cd.y_sec_strength)
                uv = any(cd.uv_pri_strength) or any(cd.uv_sec_strength)
                cdef = [p for p in range(n) if (uv if p else y)]
            pending.append({"deblock": deblock, "cdef": cdef})
            if hdr.show_frame:
                shown.append(pending.copy())
                pending.clear()

        def _show_existing(self, hdr, ts):
            shown.append(pending.copy())
            pending.clear()

    dmx = WebMDemuxer(stream)
    vt = dmx.tracks_of_type(TrackType.VIDEO)[0]
    be = Headers(vt)
    while (p := dmx.read_packet()) is not None:
        if p.track == vt.number:
            be.decode(p.frames, 0)
    return shown


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--oracle", default=os.path.join(ROOT, "tools", "build",
                                                     "oracle"))
    a = ap.parse_args()
    with open(a.config) as f:
        cfg = json.load(f)
    stream = os.path.join(ROOT, cfg["stream"])
    with open(stream, "rb") as f:
        if hashlib.sha256(f.read()).hexdigest() != cfg["sha256"]:
            sys.exit(f"{stream}: sha256 differs from the configuration's")
    meta = dav1d_frames(stream, a.oracle)
    facts = filter_planes(stream)
    if len(facts) != len(meta["frames"]):
        sys.exit(f"{stream}: {len(facts)} headers, {len(meta['frames'])} "
                 "frames from libdav1d")
    cfg.update(width=meta["width"], height=meta["height"],
               bit_depth=meta["depth"], subsampling=[meta["ss_x"],
                                                     meta["ss_y"]])
    cfg["frames"] = [
        {"pts": fr["pts"], "key": bool(fr["key"]), "sha256": d,
         "decoded": decoded}
        for fr, d, decoded in zip(meta["frames"], meta["digests"], facts)]
    with open(a.config, "w") as f:
        json.dump(cfg, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
