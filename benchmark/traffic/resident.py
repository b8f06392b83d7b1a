"""The `resident` mix: the looping player of `harness.play_cell`, whose
frames stay on the card.

The session is opened with `resident=True` (`resident.json`), so each
frame's `data` is the port's `LazyPlanes`: device planes, downloaded only
when indexed.  The player hands the window that object itself and
indexes nothing, so its thread never downloads a frame, as a consumer on
the card (a game engine's texture, a GPU ingest pipeline) never does.
The window's hashing thread reads each frame later, on a thread of its
own (`reference.frame_digest` iterates the planes), which holds the mode
to its promise: a delivered frame's device planes still hold that frame
when a consumer reads them.  That read is a copy, which the kernel time
a frame leaves out; nothing else of the check runs on the card.
"""

from __future__ import annotations

import time

import harness


class ResidentPlayer(harness.Player):
    """`harness.Player` whose record holds the frame's `data` as it came:
    the planes, not yet downloaded."""

    def step(self):
        av, frame = self.av, None
        t0 = time.perf_counter()
        for _ in range(harness.MAX_CALLS):
            st = av.decode_next()
            if st == self.FINISHED:
                av.seek_to_timestamp(0)
            elif st != self.OK:
                break
            if av.has_video_frame():
                frame = av.get_video_frame()
                break
        t1 = time.perf_counter()
        rec = {"index": self.index,
               "planes": None if frame is None else frame.data,
               "timestamp": None if frame is None else frame.timestamp}
        self.index = (self.index + 1) % self.n
        return t0, t1, rec


def play_cell(*args) -> None:
    """`harness.play_cell` (set-up's warm-up, then the window) with the
    resident player in place of the harness's."""
    saved = harness.Player
    harness.Player = ResidentPlayer
    try:
        harness.play_cell(*args)
    finally:
        harness.Player = saved
