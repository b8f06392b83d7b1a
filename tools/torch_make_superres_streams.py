#!/usr/bin/env python3
"""Write the port's two synthetic superres streams under tests/data/smoke/.

    JAX_PLATFORMS=cpu python3 tools/torch_make_superres_streams.py

libaom as built for this repository's tools refuses `superres-mode`, so
superres frames come from the JAX package's own minimal encoder
(`easyav1_tpu/video/av1/av1_enc.py::encode_frame(superres_denom=)`, as
`tests/test_av1_superres.py` uses it) and its WebM muxer.  This is the
only place where anything beside the tests calls the JAX package; the
port and `chip_smoke.py` only read the files written here:

- `superres_lr_1920x128.webm`: three key frames coded 1280 wide
  (denominator 12) and upscaled to 1920, with deblocking, CDEF and loop
  restoration (switchable luma with Wiener and SGR units, Wiener
  on U, SGR on V);
- `superres_lr_88x64.webm`: three key frames coded 64 wide (denominator
  11) and upscaled to 88, with deblocking, CDEF and a Wiener luma unit.

Each key frame is a whole temporal unit with its own sequence header.
The streams are deterministic (seeded numpy).
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from easyav1_tpu.container.mux import MuxTrack, WebMMuxer  # noqa: E402
from easyav1_tpu.container.webm import TrackType  # noqa: E402
from easyav1_tpu.video.av1 import constants as C  # noqa: E402
from easyav1_tpu.video.av1.av1_enc import (SimpleTileEncoder,  # noqa: E402
                                           encode_frame)
from test_av1_lr import blocks_with_texture  # noqa: E402

W, S = C.RESTORE_WIENER, C.RESTORE_SGRPROJ
OUT = REPO / "tests" / "data" / "smoke"


def emit_lr_superres(up_w, denom):
    """`SimpleTileEncoder._emit_lr` for a superres frame with more than
    one restoration unit a row: unit columns live in the upscaled frame,
    so a superblock's unit range scales by denom / 8 (spec 5.11.57).
    The encoder's own method counts units in the coded width, which is
    right only while there is one unit column."""
    from easyav1_tpu.video.av1.tile import (
        _SGR_RADII, _SGRPROJ_XQD_MAX, _SGRPROJ_XQD_MIN, _WIENER_TAPS_K,
        _WIENER_TAPS_MAX, _WIENER_TAPS_MIN)

    def _emit_lr(self, r, c):
        for plane in range(3):
            frt = (self.lr_types or [0, 0, 0])[plane]
            if frt == C.RESTORE_NONE:
                continue
            ss = 1 if plane else 0
            unit = 64
            ph, pw = (self.h + ss) >> ss, (up_w + ss) >> ss
            unit_rows = max((ph + (unit >> 1)) // unit, 1)
            unit_cols = max((pw + (unit >> 1)) // unit, 1)
            num = 4 >> ss
            ur0 = (r * num + unit - 1) // unit
            ur1 = min(unit_rows, ((r + 16) * num + unit - 1) // unit)
            den = unit * 8
            uc0 = (c * num * denom + den - 1) // den
            uc1 = min(unit_cols, ((c + 16) * num * denom + den - 1) // den)
            for urow in range(ur0, ur1):
                for ucol in range(uc0, uc1):
                    self._emit_lr_unit(
                        plane, frt, self.lr_units.get((plane, urow, ucol)),
                        _WIENER_TAPS_MIN, _WIENER_TAPS_MAX, _WIENER_TAPS_K,
                        _SGR_RADII, _SGRPROJ_XQD_MIN, _SGRPROJ_XQD_MAX)

    return _emit_lr


def frames(w, h, denom, n, **kw):
    wd = (w * 8 + denom // 2) // denom
    own = SimpleTileEncoder._emit_lr
    SimpleTileEncoder._emit_lr = emit_lr_superres(w, denom)
    try:
        return [encode_frame(
            w, h, 60, blocks_with_texture(2 * ((wd + 7) >> 3),
                                          2 * ((h + 7) >> 3), seed=40 + k),
            superres_denom=denom, **kw) for k in range(n)]
    finally:
        SimpleTileEncoder._emit_lr = own


def write(name, w, h, tus):
    mx = WebMMuxer()
    mx.add_track(MuxTrack(1, TrackType.VIDEO, "V_AV1", width=w, height=h))
    for k, tu in enumerate(tus):
        mx.add_packet(1, k * 100_000_000, [tu], keyframe=True)
    path = OUT / name
    path.write_bytes(mx.finalize())
    print(f"{path}: {len(tus)} frames, "
          f"{path.stat().st_size} bytes")


def main():
    wide_units = {}
    for ucol in range(30):       # 64-pixel units: 1920 / 64
        for urow in range(2):
            k = (urow + ucol) % 3
            if k == 0:
                wide_units[(0, urow, ucol)] = (
                    "wiener", [[2 - ucol % 5, -5 + ucol % 7, 20],
                               [-1, 3 + ucol % 4, 10 + urow]])
            elif k == 1:
                wide_units[(0, urow, ucol)] = ("sgr", ucol % 16, 12 - ucol,
                                               30 + urow)
    for ucol in range(15):       # chroma: 960 / 64
        wide_units[(1, 0, ucol)] = ("wiener", [[0, -3, 30 - ucol],
                                               [0, 8 - ucol, -10]])
        wide_units[(2, 0, ucol)] = ("sgr", (3 * ucol) % 16, 10 + ucol, 18)
    write("superres_lr_1920x128.webm", 1920, 128, frames(
        1920, 128, 12, 3, lf_levels=(12, 10), cdef=(3, [(4, 2, 3, 1)]),
        lr=[C.RESTORE_SWITCHABLE, W, S], lr_units=wide_units))
    write("superres_lr_88x64.webm", 88, 64, frames(
        88, 64, 11, 3, lf_levels=(10, 8), cdef=(3, [(4, 2, 3, 1)]),
        lr=[W, 0, 0],
        lr_units={(0, 0, 0): ("wiener", [[2, -5, 20], [-1, 3, 10]])}))


if __name__ == "__main__":
    main()
