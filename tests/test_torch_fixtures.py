"""The port's test fixtures, made once under the port's own names.

The JAX package's tests encode their fixtures into `tests/data/cache/`
under fixed names, test by test, and check only that a file exists: a
stream that another worker is still writing reads as a short file, and
in a fresh checkout, where the cache directory does not exist yet, the
helpers that do not create it fail (`avio_open (No such file or
directory)`).  The port's tests share none of those files.  `steady`
runs a fixture helper once across processes, under an `fcntl` lock,
with the cache of every test module pointing at a fresh temporary
directory, and moves that directory into `tests/data/cache/torch/` with
one `os.replace`: a reader sees all of a fixture's files or none.

The port's committed streams (`tests/data/smoke/`) need no encoder;
`smoke_oracle` decodes one with dav1d into the same cache.
"""

import fcntl
import hashlib
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import fixtures

SMOKE = Path(__file__).resolve().parent / "data" / "smoke"
PORT_CACHE = fixtures.CACHE / "torch"


def _encode(value, root: Path):
    """A helper's return value as JSON, its paths relative to root."""
    if isinstance(value, (tuple, list)):
        return {"seq": [_encode(v, root) for v in value],
                "tuple": isinstance(value, tuple)}
    if isinstance(value, (str, Path)):
        rel = Path(value).resolve().relative_to(root.resolve())
        return {"path": str(rel), "str": isinstance(value, str)}
    if value is None or isinstance(value, (int, float, bool)):
        return {"value": value}
    raise TypeError(f"a fixture helper returned {type(value).__name__}")


def _decode(doc, root: Path):
    if "seq" in doc:
        items = [_decode(v, root) for v in doc["seq"]]
        return tuple(items) if doc["tuple"] else items
    if "path" in doc:
        p = root / doc["path"]
        return str(p) if doc["str"] else p
    return doc["value"]


def _cache_holders():
    """The loaded modules that hold the fixture cache's path (`fixtures`
    and every test module that imported its CACHE)."""
    cache = fixtures.CACHE
    return [m for m in list(sys.modules.values())
            if getattr(m, "CACHE", None) is cache]


def steady(make, *args, **kw):
    """`make(*args, **kw)`, a helper that writes a fixture into the cache
    and returns its path (or a tuple or list holding paths), run once
    across processes: the first caller runs it with the cache pointing at
    a temporary directory and moves that directory to its own name under
    PORT_CACHE; every caller returns the helper's value with its paths
    there."""
    key = hashlib.sha1(repr((make.__module__, make.__qualname__, args,
                             sorted(kw.items()))).encode()).hexdigest()[:12]
    dest = PORT_CACHE / f"{make.__name__.strip('_')}_{key}"
    made = dest / "made.json"
    if not made.exists():
        PORT_CACHE.mkdir(parents=True, exist_ok=True)
        with open(PORT_CACHE / f".{dest.name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not made.exists():
                tmp = Path(tempfile.mkdtemp(prefix=".tmp_", dir=PORT_CACHE))
                cache, holders = fixtures.CACHE, _cache_holders()
                for m in holders:
                    m.CACHE = tmp
                try:
                    value = make(*args, **kw)
                finally:
                    for m in holders:
                        m.CACHE = cache
                (tmp / "made.json").write_text(
                    json.dumps(_encode(value, tmp)))
                os.replace(tmp, dest)
    return _decode(json.loads(made.read_text()), dest)


def _oracle(name, digest):
    """dav1d's decode of the committed stream tests/data/smoke/<name>
    into the cache: its prefix (.yuv, .json beside it).  `digest` (of the
    stream's bytes) keys the cache, so a stream made anew is decoded
    anew."""
    prefix = fixtures.CACHE / Path(name).stem
    subprocess.run([str(fixtures.tool("oracle")), str(SMOKE / name),
                    str(prefix)], check=True, capture_output=True)
    return prefix


def smoke_oracle(name):
    """The prefix of dav1d's decode of tests/data/smoke/<name>, made
    once (`steady`)."""
    digest = hashlib.sha1((SMOKE / name).read_bytes()).hexdigest()[:12]
    return steady(_oracle, name, digest)


# ------------------------------------------------------------- tests

def _slow_writer(tag, n_bytes):
    """A fixture helper that writes its file slowly, as an encoder does."""
    out = fixtures.CACHE / f"slow_{tag}.bin"
    with open(out, "wb") as f:
        for _ in range(n_bytes):
            f.write(b"x")
            f.flush()
            time.sleep(0.0005)
    return out, str(out)


def _count_calls(tag):
    """Appends to a log beside the port's cache each time it runs."""
    with open(PORT_CACHE / f"calls_{tag}.log", "a") as f:
        f.write("1\n")
    out = fixtures.CACHE / "one.txt"
    out.write_text(tag)
    return [out, 3, None]


def _race(tag, q):
    path, spath = steady(_slow_writer, tag, 200)
    q.put((path.stat().st_size, Path(spath) == path))


def test_concurrent_callers_see_whole_files():
    tag = f"race{os.getpid()}_{time.time_ns()}"
    # spawn: forking a process that holds jax's threads may deadlock
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_race, args=(tag, q)) for _ in range(4)]
    for p in procs:
        p.start()
    got = [q.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=120)
    assert got == [(200, True)] * 4


def test_helper_runs_once_and_values_round_trip():
    tag = f"once{os.getpid()}_{time.time_ns()}"
    first = steady(_count_calls, tag)
    again = steady(_count_calls, tag)
    assert first == again
    path, n, none = first
    assert isinstance(path, Path) and path.read_text() == tag
    assert (n, none) == (3, None)
    assert path.parent.parent == PORT_CACHE
    assert (PORT_CACHE / f"calls_{tag}.log").read_text() == "1\n"


def test_cache_is_restored_and_never_shared():
    import test_av1_hbd

    before = (fixtures.CACHE, test_av1_hbd.CACHE)
    path = steady(_count_calls, f"restore{os.getpid()}_{time.time_ns()}")[0]
    assert (fixtures.CACHE, test_av1_hbd.CACHE) == before
    assert path.parent.parent == PORT_CACHE != fixtures.CACHE


def test_smoke_oracle_reads_the_committed_stream():
    prefix = smoke_oracle("hbd_10i.webm")
    meta = json.loads(prefix.with_suffix(".json").read_text())
    assert (meta["width"], meta["height"], meta["depth"]) == (96, 96, 10)
    assert prefix.with_suffix(".yuv").stat().st_size == \
        meta["vframes"] * 96 * 96 * 3 // 2 * 2
