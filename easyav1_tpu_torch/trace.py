"""The port's tracer: spans from the API call down to each stage of a
frame, and one snapshot of the port's counters.

Between `start()` and `stop()` every span the port opens is kept in
memory, and `stop()` returns them.  A span (`Span`) holds its name, the
frame it serves (the sequence number of the video packet, which the
caller's spans and the decode thread's spans share), the span that
caused it (the innermost span open on the same thread when it opened,
or the caller's span that handed a packet to the decode thread), the OS
thread (`threading.get_native_id()`), its start and end on
`time.perf_counter_ns()`, and a few attributes.  There is no exporter.
With tracing off, the default, each span site checks one module-level
flag and records nothing.  No span synchronises the device.

The spans, by layer:
- API, on the caller's thread: "decode_next", "wait" (the caller blocked
  on the decode thread), "demux", "seek", "get_video_frame";
- the decode thread: "decode" (one a packet), "headers", "motion_field",
  "tmvs";
- the pipe: one "frame" a frame that reaches `pipe.decode_and_recon`
  (attribute "kind", "key" for a frame coded intra or "inter", and
  "declined", the reason, where the C recon makes the frame), and under
  it the stages, each closed by a mark of `Stages`: "entropy", "plan",
  "prepare", "pack", "compose", "upload", "mc", "intra", "lf_cdef",
  "sr", "lr", "tail", "grain", and "recon" (the C recon: the postfilter
  pipe's, or a declined frame's), and inside "grain" "fg_templates"
  (the film grain templates, attribute "cached": whether the frame's
  parameters are the last frame's); "compose" is the residual composer
  (the host C composer inside the host prepare, or the device composer's
  kernel after the upload), "pack" the device composer's host packing of
  the coded rows; a stage marked twice in a frame has two spans;
- copies: "download" (`pipe.LazyPlanes`), on whichever thread indexes a
  frame first.  The spans inside which the port copies between host and
  device carry the bytes as "h2d_bytes" and "d2h_bytes".

`count(name, n)` adds to one of the port's counters, at the site that
does what it counts, and `counters()` reads them all: frames and
fallbacks of the pipe, each hand kernel's launches, the strip kernel's
units and levels, and the film grain template sets made.  Counters are
never reset: a reader takes the difference of two readings.  This module
imports nothing of the port, which every layer of it imports.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import Counter
from typing import Dict, List, Optional

# the one check of every span site
_on = False
_spans: List["Span"] = []
# each thread that opened a span: native id -> threading.get_ident()
_threads: Dict[int, int] = {}
_local = threading.local()
_ids = itertools.count(1)
# the counters: name -> count
_counts: Counter = Counter()
_counts_lock = threading.Lock()


class Span:
    """One span; as a context manager it opens on `__enter__` on the
    calling thread and closes on `__exit__`."""

    __slots__ = ("id", "name", "frame", "parent", "thread", "start_ns",
                 "end_ns", "attrs")

    def __init__(self, name: Optional[str], frame: Optional[int] = None,
                 parent: Optional[int] = None, attrs: Optional[dict] = None):
        self.name, self.frame, self.parent = name, frame, parent
        self.attrs = {} if attrs is None else attrs
        self.id = self.thread = self.start_ns = None
        self.end_ns = 0

    def __enter__(self) -> "Span":
        return _open(self)

    def __exit__(self, *exc) -> None:
        _close(self)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.thread = threading.get_native_id()
        _threads[_local.thread] = threading.get_ident()
        return _local.stack


def _open(sp: Span, keep: bool = True) -> Span:
    """Opens `sp` on this thread: its parent, unless given, is the
    innermost span open here, and so is its frame; `keep` False leaves it
    out of the trace until `_spans` is given it."""
    stack = _stack()
    if stack:
        top = stack[-1]
        if sp.parent is None:
            sp.parent = top.id
        if sp.frame is None:
            sp.frame = top.frame
    sp.id, sp.thread = next(_ids), _local.thread
    sp.start_ns = time.perf_counter_ns()
    stack.append(sp)
    if keep:
        _spans.append(sp)
    return sp


def _close(sp: Span) -> None:
    sp.end_ns = time.perf_counter_ns()
    stack = _local.stack
    if stack[-1] is sp:
        stack.pop()
    elif sp in stack:
        # a span left open by an exception below it
        del stack[stack.index(sp):]


_OFF = contextlib.nullcontext()


def span(name: str, frame: Optional[int] = None,
         cause: Optional[int] = None, **attrs):
    """A context manager that records a span while tracing is on and
    yields it (None while off).  frame: the packet's sequence number,
    else the parent's; cause: the id of the span that caused it, else
    the innermost span open on this thread."""
    if not _on:
        return _OFF
    return Span(name, frame, cause, attrs)


def spanned(name: str):
    """A decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def current() -> Optional[Span]:
    """The innermost span open on this thread, or None (also while
    tracing is off)."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def tag(frame: Optional[int] = None, **attrs) -> None:
    """Sets the frame and attributes of the innermost span open on this
    thread."""
    sp = current()
    if sp is not None:
        if frame is not None:
            sp.frame = frame
        sp.attrs.update(attrs)


def add(**counts: int) -> None:
    """Adds to numeric attributes of the innermost span open on this
    thread (the bytes a copy moved)."""
    sp = current()
    if sp is not None:
        for k, v in counts.items():
            sp.attrs[k] = sp.attrs.get(k, 0) + v


class Stages:
    """The stage clock of one frame, used as a context manager: a "frame"
    span, open from the clock's making to the end of its `with` block,
    and under it one span a stage, each `mark(name)` closing the stage
    that ran since the last mark (or since the clock was made) under
    that name."""

    def __init__(self):
        self._frame = self._stage = None
        if _on:
            self._frame = _open(Span("frame"))
            self._stage = _open(Span(None), keep=False)

    def tag(self, **attrs) -> None:
        """Sets attributes of the frame span."""
        if self._frame is not None:
            self._frame.attrs.update(attrs)

    def decline(self, reason: str) -> None:
        """The frame goes to the C recon, for `reason`."""
        self.tag(declined=reason)

    def mark(self, name: str, device=None) -> None:
        """Closes the running stage as `name` and opens the next; device
        is not read (no mark synchronises)."""
        if self._stage is None:
            return
        self._stage.name = name
        _close(self._stage)
        _spans.append(self._stage)
        self._stage = _open(Span(None), keep=False)

    def __enter__(self) -> "Stages":
        return self

    def __exit__(self, *exc) -> None:
        if self._frame is None:
            return
        # the time since the last mark belongs to no stage
        _close(self._stage)
        _close(self._frame)
        self._frame = self._stage = None


def start() -> None:
    """Starts keeping spans; those of an earlier trace are dropped."""
    global _on
    _spans.clear()
    _on = True


def stop() -> List[Span]:
    """Stops tracing and returns the trace's spans in the order they
    opened.  A span still open ends now; a span whose frame was never
    set takes its parent's."""
    global _on
    _on = False
    now = time.perf_counter_ns()
    spans, by_id = sorted(_spans, key=lambda sp: sp.id), {}
    _spans.clear()
    for sp in spans:
        if sp.end_ns == 0:
            sp.end_ns = now
        if sp.frame is None and sp.parent in by_id:
            sp.frame = by_id[sp.parent].frame
        by_id[sp.id] = sp
    return spans


def thread_ids() -> Dict[int, int]:
    """Each thread that opened a span: its native id ->
    `threading.get_ident()` (pthread_self), by which a profiler may name
    the thread instead."""
    return dict(_threads)


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name` (n = 0 makes it known to
    `counters()`)."""
    with _counts_lock:
        _counts[name] += n


def counters() -> Counter:
    """A copy of the port's counters, a name that was never counted
    reading 0: "pipe.frames" (frames that reached the pipe),
    "pipe.fallbacks" (those declined to the C recon), "fg.templates"
    (film grain template sets made), "strip.units" and "strip.levels"
    (the strip kernel's units launched, and its steps: the levels summed
    over the SBs, a unit each under the sequential schedule), and
    "launches.<kernel>" for each hand kernel, named as the profiler names
    it."""
    with _counts_lock:
        return Counter(_counts)
