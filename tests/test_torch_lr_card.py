"""Loop restoration's kernel (`csrc/lr.cu`) on the card against its plain
version (`LoopRestoration.apply_plain`) on the card, bit for bit, at the
main path's sizes: seeded 1920x1080 8-bit and 3840x2160 10-bit frames
(`unit_programs.random_lr_case`), one launch a frame.  The file imports
no JAX, so that it runs on a machine without it:

    PYTHONPATH=. python -m pytest --noconftest tests/test_torch_lr_card.py -m cuda
"""

import pytest
import torch

from easyav1_tpu_torch import trace
from easyav1_tpu_torch.unit_programs import random_lr_case
from easyav1_tpu_torch.video.av1.recon import lr_torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("width,height,bd", [(1920, 1080, 8),
                                             (3840, 2160, 10)])
def test_kernel_on_the_card(cuda_device, width, height, bd):
    hdr, seq, plan, planes, debl = random_lr_case(5, width, height, bd=bd,
                                                  pad=(8, 16))
    lr = lr_torch.LoopRestoration(hdr, seq, plan, bd)
    tp = [torch.from_numpy(p).to(cuda_device) for p in planes]
    td = [torch.from_numpy(d).to(cuda_device) for d in debl]
    before = trace.counters()
    got = lr.apply(tp, td)
    assert trace.counters()["launches.lr_frame_kernel"] \
        == before["launches.lr_frame_kernel"] + 1
    want = lr.apply_plain(tp, td)
    torch.cuda.synchronize()
    for p in range(3):
        bad = torch.nonzero(got[p] != want[p])
        assert not len(bad), (f"plane {p}: {len(bad)} differ, first at "
                              f"{bad[0].tolist()}")
    assert any(not torch.equal(g, t) for g, t in zip(got, tp))
