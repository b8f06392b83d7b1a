"""Film grain's kernel (`csrc/fg.cu`) on the card against its plain
version (`FilmGrain.apply_plain`, `fg_plain.apply`) on the card, bit for
bit, at the main path's sizes: 1920x1080 8-bit frames with both of the
1080p grain bench stream's parameter sets, and a 3840x2160 10-bit frame
with a seeded set (`unit_programs.random_fg_case`), one launch a frame.
The file imports no JAX, so that it runs on a machine without it:

    PYTHONPATH=. python -m pytest --noconftest tests/test_torch_fg_card.py -m cuda
"""

import os

import numpy as np
import pytest
import torch

from easyav1_tpu_torch import trace
from easyav1_tpu_torch.unit_programs import random_fg_case, stream_grain
from easyav1_tpu_torch.video.av1.recon import fg_torch

GRAIN_STREAM = os.path.join(os.path.dirname(__file__), "data", "bench",
                            "bench_av1_lr_grain_1920x1080_8.webm")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _hold(device, fg, seq, planes):
    grain = fg_torch.FilmGrain(fg, seq, seq.color.bitdepth, device)
    tp = [torch.from_numpy(p).to(device) for p in planes]
    kept = [t.clone() for t in tp]
    before = trace.counters()
    got = grain.apply(tp)
    assert trace.counters()["launches.fg_frame_kernel"] \
        == before["launches.fg_frame_kernel"] + 1
    want = grain.apply_plain(tp)
    torch.cuda.synchronize()
    for p in range(len(tp)):
        bad = torch.nonzero(got[p] != want[p])
        assert not len(bad), (f"plane {p}: {len(bad)} differ, first at "
                              f"{bad[0].tolist()}")
        assert torch.equal(tp[p], kept[p]), "input written"
    assert all(not torch.equal(g, t) for g, t in zip(got, tp))


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1])
def test_kernel_on_the_stream_parameters(cuda_device, which):
    fg, seq = stream_grain(GRAIN_STREAM)[which]
    rng = np.random.default_rng(which)
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((1080, 1920), (540, 960), (540, 960))]
    _hold(cuda_device, fg, seq, planes)


@pytest.mark.cuda
def test_kernel_at_4k_10bit(cuda_device):
    _hold(cuda_device, *random_fg_case(7, 3840, 2160, bd=10))
