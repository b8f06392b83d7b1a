"""PyTorch and CUDA port of easyav1_tpu's device side, for NVIDIA Hopper.

`EasyAV1(source, device="cuda")` is the reference API whose AV1 video
decodes through the port; `stats` counts the frames that reached the
port's pipe and the fallbacks among them (frames it declined to the
shared C recon).  The port imports torch, never jax.
"""

from easyav1_tpu_torch.api import EasyAV1
from easyav1_tpu_torch.native import stats

__all__ = ["EasyAV1", "stats"]
