"""Faults and controls planted under the timed path, for the tests that
show the correctness check failing them.  Each is a context manager that
patches the port while it is open:

- faults, at the frame's production (`pipe.LazyPlanes`, which every frame
  the device makes passes through): `stale` (a step returns the state it
  had: the previous frame again), `half` (half of each frame's rows left
  out: the previous frame's), `altered` (one sample of each frame changed
  by one step);
- controls, each breaking the guarantee the configurations state
  (bit-exact to libdav1d) the way a faster path would: `no_cdef` (the
  program with its CDEF pass switched off, `postfilter.cdef_host_maps`),
  `precision` (every sample computed one precision lower: 7 bits for 8,
  two bits fewer above 8).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _produced(alter):
    """pipe.LazyPlanes whose device planes are alter(copies, state)."""
    from easyav1_tpu_torch.native import pipe
    state = {"n": 0, "prev": None}

    class Altered(pipe.LazyPlanes):
        __slots__ = ()

        def __init__(self, devs, eager=True):
            devs = alter([d.clone() for d in devs], state)
            state["n"] += 1
            state["prev"] = [d.clone() for d in devs]
            super().__init__(devs, eager)

    return _patched(pipe, "LazyPlanes", Altered)


def _same(prev, devs):
    return prev is not None and [p.shape for p in prev] == \
        [d.shape for d in devs]


def stale():
    return _produced(lambda devs, s: s["prev"] if _same(s["prev"], devs)
                     else devs)


def half():
    def alter(devs, s):
        out = []
        for i, d in enumerate(devs):
            x, h = d.to(torch.int32), d.shape[0] // 2
            x[h:] = (s["prev"][i][h:].to(torch.int32)
                     if _same(s["prev"], devs) else 0)
            out.append(x.to(d.dtype))
        return out
    return _produced(alter)


def altered():
    def alter(devs, s):
        y = devs[0].to(torch.int32)
        y[y.shape[0] // 2, y.shape[1] // 2] ^= 1
        devs[0] = y.to(devs[0].dtype)
        return devs
    return _produced(alter)


def no_cdef():
    from easyav1_tpu_torch.video.av1.recon import postfilter
    return _patched(postfilter, "cdef_host_maps", lambda *a, **k: None)


def precision():
    def alter(devs, s):
        drop = 1 if devs[0].dtype.itemsize == 1 else 2
        return [(d.to(torch.int32) >> drop << drop).to(d.dtype)
                for d in devs]
    return _produced(alter)


FAULTS = {"stale": stale, "half": half, "altered": altered}
CONTROLS = {"no_cdef": no_cdef, "precision": precision}
