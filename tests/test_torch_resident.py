"""The port's resident decode and frame hash (`recon/resident.py`)
against the JAX package's (`resident.frame_hash_host`,
`frame_hash_device`) and the port's own `api.frame_hash`, on the CPU:
the plain torch hash (int64 masked to 32 bits) on seeded planes, and
`decode_resident` on the smoke streams, where no plane may be
materialised until a consumer indexes it."""

import os

import numpy as np
import pytest
import torch

import easyav1_tpu_torch
from easyav1_tpu.video.av1.recon import resident as ref_resident
from easyav1_tpu_torch import api
from easyav1_tpu_torch.native import pipe
from easyav1_tpu_torch.video.av1.recon import resident

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "tests", "data", "smoke")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _planes(seed, dims):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, d).astype(np.uint8) for d in dims]


HASH_DIMS = [
    [(66, 97), (33, 49), (33, 49)],          # odd 4:2:0
    [(1, 1)],                                # one pixel, monochrome
    [(7, 300), (7, 300), (7, 300)],          # 4:4:4
    [(135, 240), (68, 120), (68, 120)],
    [(3, 1031)],
    [(64, 64), (64, 32), (64, 32)],          # 4:2:2
]


@pytest.mark.parametrize("k", range(len(HASH_DIMS)))
def test_plain_hash_equals_reference_and_api(k):
    planes = _planes(k, HASH_DIMS[k])
    want = ref_resident.frame_hash_host(planes)
    assert api.frame_hash(planes) == want
    tp = [torch.from_numpy(p) for p in planes]
    got = resident.frame_hash_plain(tp)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert resident.hash_value(got) == want
    # a CPU tensor takes the plain version, and no kernel is launched
    before = resident.frame_hash_device.launches
    assert resident.hash_value(resident.frame_hash_device(tp)) == want
    assert resident.frame_hash_device.launches == before


def test_plain_hash_equals_the_jax_device_hash():
    import jax.numpy as jnp
    planes = _planes(9, HASH_DIMS[0])
    want = int(ref_resident.frame_hash_device(
        [jnp.asarray(p) for p in planes]))
    assert resident.hash_value(resident.frame_hash_plain(
        [torch.from_numpy(p) for p in planes])) == want


def test_hash_is_order_and_value_sensitive():
    planes = _planes(3, HASH_DIMS[0])
    h = api.frame_hash(planes)

    def plain(pl):
        return resident.hash_value(resident.frame_hash_plain(
            [torch.from_numpy(np.ascontiguousarray(p)) for p in pl]))

    assert plain(planes) == h
    assert plain([planes[0], planes[2], planes[1]]) != h
    moved = [p.copy() for p in planes]
    moved[0][5, 7], moved[0][5, 8] = moved[0][5, 8], moved[0][5, 7] ^ 1
    assert plain(moved) == api.frame_hash(moved) != h
    white = [np.full(d, 255, np.uint8) for d in HASH_DIMS[3]]
    assert plain(white) == api.frame_hash(white)


def test_hash_value_reads_a_negative_word():
    """The kernel's word comes back as int32."""
    assert resident.hash_value(torch.tensor(-1, dtype=torch.int32)) \
        == 0xFFFFFFFF
    assert resident.hash_value(torch.tensor(-2 ** 31, dtype=torch.int32)) \
        == 2 ** 31


def test_device_hash_refuses_what_the_kernel_does_not_take(monkeypatch):
    with pytest.raises(ValueError, match="different devices"):
        resident.frame_hash_device([torch.zeros(2, 2, dtype=torch.uint8),
                                    torch.zeros(2, 2, dtype=torch.uint8,
                                                device="meta")])
    with pytest.raises(ValueError, match="unsupported device"):
        resident.frame_hash_device([torch.zeros(2, 2, dtype=torch.uint8,
                                                device="meta")])


def _api_hashes(path, **kw):
    """Frame hashes and planes of a stream pulled through the API."""
    av = easyav1_tpu_torch.EasyAV1(path, **kw)
    hashes, frames = [], []
    try:
        for _ in range(256):
            if av.is_finished():
                break
            av.decode_next()
            while av.has_video_frame():
                f = av.get_video_frame()
                frames.append(f)
                hashes.append(api.frame_hash(f.data))
    finally:
        av.close()
    return hashes, frames


# the last has diffwtd pairs: their masks read the references' luma on
# the host, which pulls those planes alone and leaves the frames lazy
STREAMS = ["inter_modes_96x96.webm", "lreal_interlr_863022fc.webm",
           "fgreal_7cdd830f.webm", "superres_lr_88x64.webm",
           "comp_masked_320x192.webm"]


@pytest.mark.parametrize("name", STREAMS)
def test_decode_resident_hashes_and_lazy_planes(name, monkeypatch):
    monkeypatch.delenv("EASYAV1_PIPE", raising=False)
    path = os.path.join(SMOKE, name)
    want, _ = _api_hashes(path, device="cpu")
    native, _ = _api_hashes(path, device=None)
    assert want == native and len(want) > 0
    pulled = []
    host = pipe.DevRef.host

    def spy_host(self):
        pulled.append(self._host is None)
        return host(self)

    monkeypatch.setattr(pipe.DevRef, "host", spy_host)
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    n, wall, hashes, frames = resident.decode_resident(path, device="cpu")
    assert (sum(pulled) > 0) == name.startswith("comp_masked")
    assert easyav1_tpu_torch.stats["fallbacks"] == 0
    assert n == len(want) and hashes == want and wall > 0
    # nothing was downloaded: every frame still lies on the device only
    assert all(isinstance(f.data, pipe.LazyPlanes) for f in frames)
    assert not any(f.data.materialised for f in frames)
    # indexing one frame materialises that frame and no other
    assert api.frame_hash(frames[-1].data) == want[-1]
    assert [f.data.materialised for f in frames] \
        == [False] * (n - 1) + [True]
    assert frames[0].data[0].dtype == np.uint8
    assert len(frames[0].data) == 3 and frames[0].data.materialised


def test_decode_resident_max_frames_and_device_check():
    path = os.path.join(SMOKE, "inter_modes_96x96.webm")
    n, _, hashes, _ = resident.decode_resident(path, device="cpu",
                                               max_frames=3)
    assert n == 3 and hashes == _api_hashes(path, device="cpu")[0][:3]
    with pytest.raises(ValueError, match="torch device"):
        resident.decode_resident(path, device=None)


def test_resident_session_keeps_frames_on_the_device():
    """`EasyAV1(resident=True)`: frames come out lazy, equal to the
    normal session's once indexed; the normal session's are materialised
    when they come out."""
    path = os.path.join(SMOKE, "lreal_interlr_863022fc.webm")
    want, eager = _api_hashes(path, device="cpu")
    assert all(f.data.materialised for f in eager)
    av = easyav1_tpu_torch.EasyAV1(path, device="cpu", resident=True)
    frames = []
    try:
        while not av.is_finished() and len(frames) < 64:
            av.decode_next()
            while av.has_video_frame():
                frames.append(av.get_video_frame())
    finally:
        av.close()
    assert len(frames) == len(want)
    assert not any(f.data.materialised for f in frames)
    got = [resident.hash_value(resident.frame_hash_device(
        f.data.device_planes)) for f in frames]
    assert got == want
    assert not any(f.data.materialised for f in frames)


def test_resident_reference_is_downloaded_only_for_the_c_recon(monkeypatch):
    """In resident mode a reference's host plane is made from the device
    plane on demand: with one inter frame declined, the C recon pulls the
    references it reads, and every frame still equals the native
    decode."""
    from easyav1_tpu_torch.video.av1.recon.inter_exec import InterRecon

    path = os.path.join(SMOKE, "lreal_interlr_863022fc.webm")
    want, _ = _api_hashes(path, device=None)
    calls, made = [], {"host": 0}
    prepare, host = InterRecon.prepare, pipe.DevRef.host

    def decline(self, *a, **k):
        calls.append(1)
        return None if len(calls) == 2 else prepare(self, *a, **k)

    def spy_host(self):
        made["host"] += self._host is None
        return host(self)

    monkeypatch.setattr(pipe.DevRef, "host", spy_host)
    _, _, hashes, _ = resident.decode_resident(path, device="cpu")
    assert made["host"] == 0 and hashes == want
    monkeypatch.setattr(InterRecon, "prepare", decline)
    easyav1_tpu_torch.stats.update(frames=0, fallbacks=0)
    _, _, hashes, frames = resident.decode_resident(path, device="cpu")
    assert easyav1_tpu_torch.stats == {"frames": 4, "fallbacks": 1}
    assert made["host"] > 0 and hashes == want
    # the declined frame's planes are numpy; the others stayed lazy
    assert sum(isinstance(f.data, pipe.LazyPlanes) for f in frames) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(len(HASH_DIMS)))
def test_kernel_vs_plain_and_api(k, cuda_device):
    """The CUDA kernel against its plain version and `api.frame_hash`,
    on odd sizes, on planes that start off a 4-byte boundary and on
    rows with a pitch."""
    planes = _planes(k, HASH_DIMS[k])
    want = api.frame_hash(planes)
    tp = [torch.from_numpy(p).to(cuda_device) for p in planes]
    before = resident.frame_hash_device.launches
    got = resident.frame_hash_device(tp)
    torch.cuda.synchronize()
    assert resident.frame_hash_device.launches == before + 1
    assert resident.hash_value(got) == want
    assert resident.hash_value(resident.frame_hash_plain(tp)) == want
    # views: odd start, pitched rows
    if planes[0].shape[0] > 2 and planes[0].shape[1] > 8:
        views = [t[1:, 3:-2] for t in tp]
        want = api.frame_hash([v.cpu().numpy() for v in views])
        assert resident.hash_value(resident.frame_hash_device(views)) == want
