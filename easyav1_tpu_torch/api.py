"""The public API on the port: `easyav1_tpu.api.EasyAV1` whose AV1 video
track decodes through `TorchAV1Backend` on an explicit device; and the
yardsticks it is held to, the reference's native C session and its frame
hash."""

from __future__ import annotations

import os
from typing import Optional

import torch

from easyav1_tpu import api as ref_api
from easyav1_tpu.container import webm as W
from easyav1_tpu.settings import EasyAV1Settings
from easyav1_tpu.video.av1.recon.resident import frame_hash_host
from easyav1_tpu_torch.video.av1.backend import TorchAV1Backend


def resolve_device(device) -> torch.device:
    """torch.device of `device`; raises for a CUDA device without a card
    and for any device type other than cuda and cpu."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but no CUDA device is available; "
                "pass device='cpu' to run the plain torch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device={device!r}: no such CUDA device")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class EasyAV1(ref_api.EasyAV1):
    """One decode session whose AV1 video decodes on `device` ("cuda"
    runs the CUDA kernels; "cpu" runs their plain torch versions)."""

    def __init__(self, source, settings: Optional[EasyAV1Settings] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        super().__init__(source, settings)

    def _init_tracks(self) -> None:
        super()._init_tracks()
        track = self._video_track
        if track is not None and track.codec_id == W.CODEC_AV1:
            self._video_backend = TorchAV1Backend(
                track, self.device, threads=self.settings.video_threads)


def native_session(source, settings: Optional[EasyAV1Settings] = None
                   ) -> ref_api.EasyAV1:
    """A session of the reference API on its native C path.  Raises when
    EASYAV1_PIPE routes the reference anywhere else."""
    pipe = os.environ.get("EASYAV1_PIPE", "native")
    if pipe != "native":
        raise RuntimeError(f"EASYAV1_PIPE={pipe!r} routes the reference "
                           "away from its native C path")
    return ref_api.EasyAV1(source, settings)


def frame_hash(planes) -> int:
    """The reference's host frame hash (`resident.frame_hash_host`) of a
    frame's planes."""
    return frame_hash_host(list(planes))
