# Copy of easyav1_tpu/capi/bridge.py, the JAX package's counterpart.
"""Python side of the C ABI shim (easyav1_capi.c embeds the interpreter
and calls into this module).

Marshals between the easyav1_t C world (plain ints, byte buffers,
function pointers) and the port's EasyAV1.  C callback pointers are
invoked through ctypes with struct layouts mirroring capi/easyav1.h, so
callbacks fire from the playback thread exactly like the reference.

`easyav1_settings` has no device field, so a session's device and pipe
come from the environment (`session_args`):

- `EASYAV1_PIPE`, with the reference's meanings: unset or "pallas", the
  port's main device pipe; "device", the postfilter pipe (C recon, then
  deblocking, CDEF and loop restoration on the device); "native", the C
  path, on no device;
- `EASYAV1_TORCH_DEVICE`: the device of the two device pipes, "cuda" by
  default; "cpu" runs the kernels' plain torch versions.  Without a card
  a "cuda" session raises, so `easyav1_init_from_*` returns NULL: nothing
  carries on on the CPU or on the C path.

`EASYAV1_HOST_RESID=0` chooses the device residual composer, as
`api.host_residual_default` reads it.  Frames go to C as host planes
(`resident=False`): a device frame's `LazyPlanes` download on first
index, uint8 at 8 bits and uint16 above.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from easyav1_tpu_torch.api import EasyAV1
from easyav1_tpu_torch.settings import EasyAV1Settings, LogLevel

# EASYAV1_PIPE -> the port's pipe
_PIPES = {"pallas": "recon", "device": "postfilter"}


# -- ctypes mirrors of the public structs (capi/easyav1.h) -------------

class _VideoProps(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "pixel_layout", "bits_per_color", "color_space", "color_primaries",
        "transfer_characteristics", "matrix_coefficients",
        "chroma_sample_position")] + [
        ("width", ctypes.c_uint), ("height", ctypes.c_uint)]


class _VideoFrame(ctypes.Structure):
    _fields_ = [
        ("properties", _VideoProps),
        ("timestamp", ctypes.c_uint64),
        ("data", ctypes.c_void_p * 3),
        ("stride", ctypes.c_size_t * 3),
    ]


class _AudioPcm(ctypes.Union):
    _fields_ = [("deinterlaced", ctypes.POINTER(ctypes.c_void_p)),
                ("interlaced", ctypes.c_void_p)]


class _AudioFrame(ctypes.Structure):
    _fields_ = [
        ("channels", ctypes.c_uint),
        ("samples", ctypes.c_uint),
        ("timestamp", ctypes.c_uint64),
        ("bytes", ctypes.c_size_t),
        ("pcm", _AudioPcm),
    ]


_VIDEO_CB = ctypes.CFUNCTYPE(None, ctypes.POINTER(_VideoFrame),
                             ctypes.c_void_p)
_AUDIO_CB = ctypes.CFUNCTYPE(None, ctypes.POINTER(_AudioFrame),
                             ctypes.c_void_p)


class Instance:
    """One easyav1_t: wraps EasyAV1 plus C callback plumbing."""

    def __init__(self, source, settings: EasyAV1Settings):
        self._c_video_cb = None
        self._c_audio_cb = None
        self._c_userdata = None
        self._keepalive = []
        self.av = EasyAV1(source, settings, **session_args())

    # -- C callbacks ----------------------------------------------------

    def set_c_callbacks(self, video_ptr: int, audio_ptr: int,
                        userdata: int) -> None:
        self._c_userdata = ctypes.c_void_p(userdata or None)
        s = self.av.settings
        if video_ptr:
            self._c_video_cb = _VIDEO_CB(video_ptr)
            s.video_callback = self._video_trampoline
        else:
            self._c_video_cb = None
            s.video_callback = None
        if audio_ptr:
            self._c_audio_cb = _AUDIO_CB(audio_ptr)
            s.audio_callback = self._audio_trampoline
        else:
            self._c_audio_cb = None
            s.audio_callback = None

    def _video_trampoline(self, frame, userdata=None) -> None:
        cf = _VideoFrame()
        p = frame.properties
        cf.properties.pixel_layout = int(p.pixel_layout)
        cf.properties.bits_per_color = int(p.bits_per_color)
        cf.properties.color_space = int(p.color_space)
        cf.properties.color_primaries = int(p.color_primaries)
        cf.properties.transfer_characteristics = int(
            p.transfer_characteristics)
        cf.properties.matrix_coefficients = int(p.matrix_coefficients)
        cf.properties.chroma_sample_position = int(p.chroma_sample_position)
        cf.properties.width = p.width
        cf.properties.height = p.height
        cf.timestamp = frame.timestamp
        # row-strided views (contiguous rows) pass through zero-copy:
        # the C side reads data[i] with stride[i] row pitch
        planes = [d if d.strides[-1] == d.itemsize
                  else np.ascontiguousarray(d) for d in frame.data]
        self._keepalive = planes
        for i in range(3):
            if i < len(planes):
                cf.data[i] = planes[i].ctypes.data
                cf.stride[i] = planes[i].strides[0]
            else:
                cf.data[i] = None
                cf.stride[i] = 0
        self._c_video_cb(ctypes.byref(cf), self._c_userdata)

    def _audio_trampoline(self, frame, userdata=None) -> None:
        cf = _AudioFrame()
        cf.channels = frame.channels
        cf.samples = frame.samples
        cf.timestamp = frame.timestamp
        cf.bytes = frame.bytes
        if isinstance(frame.pcm, list):
            chans = [np.ascontiguousarray(c, np.float32) for c in frame.pcm]
            ptrs = (ctypes.c_void_p * len(chans))(
                *[c.ctypes.data for c in chans])
            self._keepalive = [chans, ptrs]
            cf.pcm.deinterlaced = ptrs
        else:
            pcm = np.ascontiguousarray(frame.pcm, np.float32)
            self._keepalive = [pcm]
            cf.pcm.interlaced = pcm.ctypes.data
        self._c_audio_cb(ctypes.byref(cf), self._c_userdata)


def session_args() -> dict:
    """The port's `EasyAV1` keywords for a session of the C ABI, from
    `EASYAV1_PIPE` and `EASYAV1_TORCH_DEVICE` (see the module
    docstring)."""
    pipe = os.environ.get("EASYAV1_PIPE", "pallas")
    if pipe == "native":
        return {"device": None}
    if pipe not in _PIPES:
        raise ValueError(f"EASYAV1_PIPE={pipe!r}: not one of native, "
                         f"{', '.join(_PIPES)}")
    return {"device": os.environ.get("EASYAV1_TORCH_DEVICE", "cuda"),
            "pipe": _PIPES[pipe], "resident": False}


def _settings_from_dict(d: dict) -> EasyAV1Settings:
    s = EasyAV1Settings(
        enable_video=bool(d["enable_video"]),
        enable_audio=bool(d["enable_audio"]),
        skip_unprocessed_frames=bool(d["skip_unprocessed_frames"]),
        interlace_audio=bool(d["interlace_audio"]),
        close_handle_on_destroy=bool(d["close_handle_on_destroy"]),
        video_track=d["video_track"],
        audio_track=d["audio_track"],
        use_fast_seeking=bool(d["use_fast_seeking"]),
        audio_offset_time=d["audio_offset_time"],
        log_level=LogLevel(min(max(int(d["log_level"]), 0),
                                max(LogLevel))),
    )
    return s


def create_from_filename(path: str, d: dict) -> Optional[Instance]:
    return Instance(path, _settings_from_dict(d))


def create_from_memory(data: bytes, d: dict) -> Optional[Instance]:
    return Instance(data, _settings_from_dict(d))


# -- thin call-throughs (C uses PyObject_CallMethod on these names) -----

def decode_next(i: Instance) -> int:
    return int(i.av.decode_next())


def decode_until(i: Instance, ts: int) -> int:
    return int(i.av.decode_until(ts))


def decode_for(i: Instance, ms: int) -> int:
    return int(i.av.decode_for(ms))


def play(i: Instance) -> int:
    return int(i.av.play())


def stop(i: Instance) -> None:
    i.av.stop()


def seek_to_timestamp(i: Instance, ts: int) -> int:
    return int(i.av.seek_to_timestamp(ts))


def seek_forward(i: Instance, ms: int) -> int:
    return int(i.av.seek_forward(ms))


def seek_backward(i: Instance, ms: int) -> int:
    return int(i.av.seek_backward(ms))


def get_status(i: Instance) -> int:
    return int(i.av.get_status())


def get_current_timestamp(i: Instance) -> int:
    return max(0, i.av.get_current_timestamp())


def has_video_track(i: Instance) -> int:
    return int(i.av.has_video_track())


def has_audio_track(i: Instance) -> int:
    return int(i.av.has_audio_track())


def get_total_video_tracks(i: Instance) -> int:
    return i.av.get_total_video_tracks()


def get_total_audio_tracks(i: Instance) -> int:
    return i.av.get_total_audio_tracks()


def get_video_width(i: Instance) -> int:
    return i.av.get_video_width()


def get_video_height(i: Instance) -> int:
    return i.av.get_video_height()


def get_video_fps(i: Instance) -> int:
    return int(round(i.av.get_video_fps()))


def get_audio_channels(i: Instance) -> int:
    return i.av.get_audio_channels()


def get_audio_sample_rate(i: Instance) -> int:
    return i.av.get_audio_sample_rate()


def get_duration(i: Instance) -> int:
    return i.av.get_duration()


def get_total_video_frames_processed(i: Instance) -> int:
    return i.av.get_total_video_frames_processed()


def is_finished(i: Instance) -> int:
    return int(i.av.is_finished())


def has_video_frame(i: Instance) -> int:
    return int(i.av.has_video_frame())


def is_audio_buffer_filled(i: Instance) -> int:
    return int(i.av.is_audio_buffer_filled())


def get_video_frame_raw(i: Instance):
    """Returns None or (props_tuple, ts, [plane bytes], [strides])."""
    f = i.av.get_video_frame()
    if f is None:
        return None
    p = f.properties
    props = (int(p.pixel_layout), int(p.bits_per_color),
             int(p.color_space), int(p.color_primaries),
             int(p.transfer_characteristics), int(p.matrix_coefficients),
             int(p.chroma_sample_position), p.width, p.height)
    planes = [np.ascontiguousarray(d) for d in f.data]
    return (props, f.timestamp,
            [pl.tobytes() for pl in planes],
            [pl.strides[0] for pl in planes])


def get_audio_frame_raw(i: Instance):
    """Returns None or (channels, samples, ts, nbytes, interlaced_flag,
    payload) — payload is bytes (interlaced) or list of bytes."""
    f = i.av.get_audio_frame()
    if f is None:
        return None
    if isinstance(f.pcm, list):
        payload = [np.ascontiguousarray(c, np.float32).tobytes()
                   for c in f.pcm]
        return (f.channels, f.samples, f.timestamp, f.bytes, 0, payload)
    payload = np.ascontiguousarray(f.pcm, np.float32).tobytes()
    return (f.channels, f.samples, f.timestamp, f.bytes, 1, payload)


def update_settings(i: Instance, d: dict) -> int:
    return int(i.av.update_settings(_settings_from_dict(d)))


def set_c_callbacks(i: Instance, video_ptr: int, audio_ptr: int,
                    userdata: int) -> None:
    i.set_c_callbacks(video_ptr, audio_ptr, userdata)


def destroy(i: Instance) -> None:
    i.av.close()
