"""The plain reference a run is judged by: libdav1d's decode of the
configuration's stream, held as one sha256 a shown frame in the
configuration's file (`make_config.py` wrote them), and the comparison of
the frames the timed path delivered with it: every frame's arrival,
timestamp and digest.  Imports hashlib and numpy only: nothing of the
program.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np


def frame_digest(planes: Sequence[np.ndarray]) -> str:
    """sha256 of a frame's planes in order, each tightly packed, samples
    little-endian (1 byte at 8 bits, 2 above): libdav1d's frame layout in
    the oracle's output."""
    h = hashlib.sha256()
    for p in planes:
        a = np.asarray(p)
        if a.dtype.itemsize > 1:
            a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        h.update(np.ascontiguousarray(a).data)
    return h.hexdigest()


def compare(frames: List[dict], digests: Dict[int, str],
            table: List[dict]) -> dict:
    """Counts of the window's frames that fail the reference, by their
    window position: those that never came, those whose timestamp is not
    the stream's, those whose digest is not libdav1d's, those that came
    and were not hashed ("unhashed_frames"), and all of them
    ("failed_frames").

    frames: one dict a frame the window asked for, in order: "pos", "index"
    (the frame of the stream due there), "got" and "timestamp" (ms).
    digests: `frame_digest` of the planes of each frame that came, by
    position.
    table: the configuration's "frames"."""
    missing = {f["pos"] for f in frames if not f["got"]}
    late = {f["pos"] for f in frames
            if f["got"] and f["timestamp"] != table[f["index"]]["pts"]}
    unhashed = {f["pos"] for f in frames
                if f["got"] and f["pos"] not in digests}
    wrong = {f["pos"] for f in frames if f["pos"] in digests
             and digests[f["pos"]] != table[f["index"]]["sha256"]}
    return {"mismatched_frames": len(wrong), "missing_frames": len(missing),
            "wrong_timestamps": len(late), "unhashed_frames": len(unhashed),
            "failed_frames": len(wrong | missing | late | unhashed)}
