# Copy of easyav1_tpu/api.py, the JAX package's counterpart.
"""The public easyav1 API surface on the port.

The reference's `EasyAV1` (mirroring reference src/easyav1.h:449-822:
init from file/memory/custom stream, decode_next/until/for, play/stop,
timestamp seeks, frame/sample pull + push callbacks, settings
live-update, status taxonomy) with an explicit `device` for its AV1
video track: "cuda" runs the port's CUDA kernels and raises without a
card, "cpu" runs their plain torch versions, and None decodes every
frame on the native C path.  With `resident=True` the frames of a device
session stay on the device (`frame.data.device_planes`) until a consumer
indexes `frame.data`.  `host_residual` chooses the residual composer of
a device session: the host C composer (True, the default) or the
device's (False); None reads the reference's setting,
`EASYAV1_HOST_RESID=0` for the device's (`host_residual_default`).
`pipe` chooses a device session's pipe: "recon", the main pipe (the
reference's `EASYAV1_PIPE=pallas`), or "postfilter", the C recon with
deblocking, CDEF and loop restoration then run on the device (its
`EASYAV1_PIPE=device`).
`native_session` is that C path, the yardstick the port is held to, and
`frame_hash` the frame hash both are compared by.

Threading model parity (easyav1.c:2271-2333, 2805-2853): a playback
thread paces decode against the wall clock; a video prefetch thread
decodes ahead of `position`.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from easyav1_tpu_torch import trace
from easyav1_tpu_torch.container import webm as W
from easyav1_tpu_torch.container.webm import Packet, TrackType, WebMDemuxer
from easyav1_tpu_torch.io.stream import Stream, open_stream
from easyav1_tpu_torch.native.pipe import PIPES
from easyav1_tpu_torch.settings import EasyAV1Settings, EasyAV1Status, default_settings
from easyav1_tpu_torch.types import AudioFrame, VideoFrame
from easyav1_tpu_torch.utils.log import Logger

# Behavioral constants (reference easyav1.c:38-47)
AUDIO_BUFFER_SIZE = 4096
VIDEO_FRAMES_TO_PREFETCH = 10
VIDEO_FRAME_QUEUE_SIZE = 11
DECODE_UNTIL_SKIP_MS = 1000


class VideoBackend:
    """Interface video codec backends implement (the dav1d role)."""

    def decode(self, chunks: List[bytes], timestamp_ms: int) -> List[VideoFrame]:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def probe_sequence_header(self, chunks: List[bytes]) -> bool:
        """True if the packet contains a valid sequence header (parity:
        dav1d_parse_sequence_header probe during seek, easyav1.c:2335)."""
        raise NotImplementedError

    @property
    def fps(self) -> float:
        return 0.0


def _make_video_backend(track: W.TrackInfo, device, threads: int = 0,
                        resident: bool = False, host_residual: bool = True,
                        pipe: str = "recon"):
    if track.codec_id == W.CODEC_AV1:
        from easyav1_tpu_torch.video.av1.backend import AV1Backend
        return AV1Backend(track, device, threads=threads, resident=resident,
                          host_residual=host_residual, pipe=pipe)
    return None


def host_residual_default() -> bool:
    """The reference's setting of the residual composer: the host C
    composer unless `EASYAV1_HOST_RESID` is "0" (`jax_exec.py:395`).
    The one place the port reads it."""
    return os.environ.get("EASYAV1_HOST_RESID", "1") != "0"


def resolve_device(device) -> Optional[torch.device]:
    """torch.device of `device` (None stays None: the native C path);
    raises for a CUDA device without a card and for any device type
    other than cuda and cpu."""
    if device is None:
        return None
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


class EasyAV1:
    """One decode session over a WebM stream (the `easyav1_t` handle),
    its AV1 video decoded on `device` (see the module docstring)."""

    def __init__(self, source, settings: Optional[EasyAV1Settings] = None,
                 close_handle_on_destroy: Optional[bool] = None,
                 device="cuda", resident: bool = False,
                 host_residual: Optional[bool] = None, pipe: str = "recon"):
        if pipe not in PIPES:
            raise ValueError(f"pipe={pipe!r}: not one of {PIPES}")
        self.pipe = pipe
        self.device = resolve_device(device)
        # the residual planes of a device session: the host C composer,
        # or the device composer (csrc/itx.cu)
        self.host_residual = (host_residual_default() if host_residual is None
                              else bool(host_residual))
        # frames stay on the device: `frame.data` downloads a frame's
        # planes when first indexed, `frame.data.device_planes` are the
        # tensors, uint8 at 8 bits and uint16 above, as `frame.data`'s
        # numpy planes are (see recon/resident.py)
        self.resident = bool(resident) and self.device is not None
        self.settings = settings.copy() if settings else default_settings()
        if close_handle_on_destroy is not None:
            self.settings.close_handle_on_destroy = close_handle_on_destroy
        self.log = Logger(self.settings.log_level)
        self._status = EasyAV1Status.OK
        self._position = 0  # ms
        self._stream: Optional[Stream] = None
        self._demux: Optional[WebMDemuxer] = None
        self._video_track: Optional[W.TrackInfo] = None
        self._audio_track: Optional[W.TrackInfo] = None
        self._video_backend: Optional[VideoBackend] = None
        self._audio_decoder = None
        self._fps = 0.0
        self._duration_ms = 0
        self._total_video_frames = 0
        self._audio_offset_ms = 0

        # packet queues (video, audio) — timestamp-ordered heads
        self._vq: List[Packet] = []
        self._aq: List[Packet] = []
        self._stream_ended = False

        # decoded video frame queue (ring of 11, easyav1.c:40-41)
        self._frame_queue: List[VideoFrame] = []
        self._frame_lock = threading.Lock()

        # video decode-ahead thread (reference video_decoder_thread,
        # easyav1.c:2271-2333): decode_next hands video packets to this
        # worker and returns; the worker decodes into the frame ring,
        # throttled to VIDEO_FRAMES_TO_PREFETCH undisplayed frames.
        # ctypes releases the GIL during the C decode, so packet fetch
        # and audio decode genuinely overlap video decode on multicore
        # hosts.
        self._vwork: List[Packet] = []
        # each video packet handed to the worker is numbered: the frame
        # its spans serve (`trace`)
        self._packet_ids = itertools.count()
        self._vwork_cv = threading.Condition()
        self._vworker_busy = False
        self._vthread_stop = False
        self._vthread: Optional[threading.Thread] = None

        # audio ring buffer
        self._audio_buf: Optional[np.ndarray] = None
        self._audio_buf_fill = 0
        self._audio_buf_ts = 0
        self._audio_consumed = True

        # playback thread state (easyav1.c:2805)
        self._playback_thread: Optional[threading.Thread] = None
        self._playback_stop = threading.Event()
        self._playback_lock = threading.Lock()
        self._seek_request: Optional[int] = None

        self._destroyed = False

        try:
            self._init_stream(source)
        except Exception as e:  # noqa: BLE001
            self._set_error(EasyAV1Status.INVALID_DATA, f"init failed: {e}")
            raise

    # ------------------------------------------------------------------
    # init

    def _init_stream(self, source) -> None:
        self._stream = open_stream(source)
        self._demux = WebMDemuxer(self._stream)
        self._duration_ms = self._demux.duration_ns // 1_000_000
        self._init_tracks()
        self._sync_packet_queues()
        if self._fps == 0.0 and len(self._vq) >= 2:
            # no DefaultDuration in the track header: estimate from the
            # first cluster's packet spacing
            dt = self._vq[1].timestamp_ns - self._vq[0].timestamp_ns
            if dt > 0:
                self._fps = round(1e9 / dt, 3)

    def _init_tracks(self) -> None:
        """Track selection + codec init (parity: init_webm_tracks
        easyav1.c:1279-1381: pick Nth track of each type, warn and continue
        on unsupported codecs)."""
        demux = self._demux
        videos = demux.tracks_of_type(TrackType.VIDEO)
        audios = demux.tracks_of_type(TrackType.AUDIO)
        s = self.settings
        if s.enable_video and s.video_track < len(videos):
            track = videos[s.video_track]
            backend = _make_video_backend(track, self.device,
                                          self.settings.video_threads,
                                          self.resident, self.host_residual,
                                          self.pipe)
            if backend is None:
                self.log.warning(
                    f"unsupported video codec {track.codec_id!r}; "
                    "continuing without video")
            else:
                self._video_track = track
                self._video_backend = backend
                if track.default_duration_ns:
                    self._fps = 1e9 / track.default_duration_ns
        if s.enable_audio and s.audio_track < len(audios):
            track = audios[s.audio_track]
            if track.codec_id != W.CODEC_VORBIS:
                self.log.warning(
                    f"unsupported audio codec {track.codec_id!r}; "
                    "continuing without audio")
            else:
                from easyav1_tpu_torch.audio.vorbis import VorbisDecoder

                try:
                    self._audio_decoder = VorbisDecoder(track.vorbis_headers())
                except Exception as e:  # noqa: BLE001
                    self.log.warning(f"vorbis init failed: {e}")
                    self._audio_decoder = None
                else:
                    self._audio_track = track
                    # settings offset + container codec delay
                    # (easyav1.c:1495-1496)
                    self._audio_offset_ms = (s.audio_offset_time
                                             + track.codec_delay_ns // 1_000_000)
                    self._reset_audio_buffer()
        if self._video_track is None and self._audio_track is None:
            raise W.WebMError("no decodable tracks")

    def _reset_audio_buffer(self) -> None:
        ch = self._audio_track.channels if self._audio_track else 1
        self._audio_buf = np.zeros((AUDIO_BUFFER_SIZE, ch), np.float32)
        self._audio_buf_fill = 0
        self._audio_buf_ts = 0
        self._audio_consumed = True

    # ------------------------------------------------------------------
    # status & metadata getters (easyav1.h:615-791)

    def get_status(self) -> EasyAV1Status:
        if self._status.is_error:
            return self._status
        return self._status

    def _set_error(self, status: EasyAV1Status, msg: str) -> None:
        self.log.error(msg)
        self._status = status

    @property
    def position(self) -> int:
        return self._position

    def get_current_timestamp(self) -> int:
        return self._position

    def has_video_track(self) -> bool:
        return self._video_track is not None

    def has_audio_track(self) -> bool:
        return self._audio_track is not None

    def get_total_video_tracks(self) -> int:
        return len(self._demux.tracks_of_type(TrackType.VIDEO))

    def get_total_audio_tracks(self) -> int:
        return len(self._demux.tracks_of_type(TrackType.AUDIO))

    def get_video_width(self) -> int:
        return self._video_track.width if self._video_track else 0

    def get_video_height(self) -> int:
        return self._video_track.height if self._video_track else 0

    def get_video_fps(self) -> float:
        return self._fps

    def get_audio_channels(self) -> int:
        return self._audio_track.channels if self._audio_track else 0

    def get_audio_sample_rate(self) -> int:
        return int(self._audio_track.sample_rate) if self._audio_track else 0

    def get_duration(self) -> int:
        return self._duration_ms

    def get_total_video_frames_processed(self) -> int:
        return self._total_video_frames

    def is_finished(self) -> bool:
        return self._status == EasyAV1Status.FINISHED

    def get_current_settings(self) -> EasyAV1Settings:
        return self.settings.copy()

    # ------------------------------------------------------------------
    # packet machinery (parity: easyav1.c:1904-2132)

    @trace.spanned("demux")
    def _prepare_new_packet(self) -> bool:
        """Pull one packet from the demuxer into the right queue.
        Returns False at end of stream."""
        demux = self._demux
        demux.save_state()
        try:
            pkt = demux.read_packet()
        except W.EBMLError as e:
            demux.restore_state()
            self._set_error(EasyAV1Status.IO_ERROR, f"demux error: {e}")
            return False
        if pkt is None:
            self._stream_ended = True
            return False
        ts_ms = pkt.timestamp_ns // 1_000_000
        if self._video_track and pkt.track == self._video_track.number:
            pkt.timestamp_ns = ts_ms * 1_000_000
            self._vq.append(pkt)
            return True
        if self._audio_track and pkt.track == self._audio_track.number:
            ts_ms += self._audio_offset_ms
            # drop audio outside [0, duration] (easyav1.c:1959-1975)
            if ts_ms < 0 or (self._duration_ms and ts_ms > self._duration_ms):
                return True
            pkt.timestamp_ns = ts_ms * 1_000_000
            self._aq.append(pkt)
            return True
        return True  # unselected track: skip

    def _sync_packet_queues(self) -> None:
        """Fill queues per prefetch policy (easyav1.c:2026-2104)."""
        want_video = self._video_track is not None
        want_audio = self._audio_track is not None
        while not self._stream_ended:
            have_video = len(self._vq) >= (VIDEO_FRAMES_TO_PREFETCH
                                           if want_video else 0)
            have_audio = len(self._aq) >= 1 if want_audio else True
            if (not want_video or have_video) and have_audio:
                break
            if want_video and not want_audio and have_video:
                break
            if not self._prepare_new_packet():
                break

    def _get_next_packet(self) -> Optional[Packet]:
        self._sync_packet_queues()
        vhead = self._vq[0] if self._vq else None
        ahead = self._aq[0] if self._aq else None
        if vhead is None and ahead is None:
            return None
        if vhead is None:
            return self._aq.pop(0)
        if ahead is None:
            return self._vq.pop(0)
        if vhead.timestamp_ns <= ahead.timestamp_ns:
            return self._vq.pop(0)
        return self._aq.pop(0)

    # ------------------------------------------------------------------
    # decode drivers (easyav1.c:2618-2792)

    # -- video decode-ahead thread -------------------------------------

    def _video_worker(self) -> None:
        # NB: the worker never stalls on a full frame queue — the
        # reference decoder thread keeps decoding and the frame ring
        # drops its oldest entry (easyav1.c:2139-2148).  Throttling
        # here would livelock _drain_video when a decode driver runs
        # without a frame consumer (prefetch is bounded on the packet
        # side instead, as in get_video_packet_to_decode).
        while True:
            with self._vwork_cv:
                while not self._vthread_stop and not self._vwork:
                    self._vwork_cv.wait(0.005)
                if self._vthread_stop:
                    return
                pkt = self._vwork.pop(0)
                self._vworker_busy = True
            try:
                with trace.span("decode", frame=pkt.seq, cause=pkt.cause):
                    self._decode_video_packet(pkt)
            finally:
                with self._vwork_cv:
                    pkt.decoded = True
                    self._vworker_busy = False
                    self._vwork_cv.notify_all()

    def _ensure_vthread(self) -> None:
        if self._vthread is None or not self._vthread.is_alive():
            self._vthread_stop = False
            self._vthread = threading.Thread(target=self._video_worker,
                                             daemon=True,
                                             name="easyav1-video-decode")
            self._vthread.start()

    def _queue_video_packet(self, pkt: Packet) -> None:
        """Hands a video packet to the worker, numbered, with the span
        that handed it (its decode span's cause)."""
        self._ensure_vthread()
        pkt.decoded = False
        pkt.seq = next(self._packet_ids)
        trace.tag(frame=pkt.seq)
        sp = trace.current()
        pkt.cause = None if sp is None else sp.id
        with self._vwork_cv:
            self._vwork.append(pkt)
            self._vwork_cv.notify_all()

    def _wait_packet_decoded(self, pkt: Packet) -> None:
        """Block until the worker finished this packet — reference
        decode_packet waits on has_frames_to_display until
        packet.decoded (easyav1.c:2567-2589), so decode_next's side
        effects (frame queue, frames-processed counter) are visible
        when it returns."""
        with trace.span("wait", frame=pkt.seq), self._vwork_cv:
            while not getattr(pkt, "decoded", True):
                self._vwork_cv.wait(0.005)

    def _drain_video(self) -> None:
        """Block until the worker is idle (seek, finish, teardown;
        reference pause_video_decoder_thread easyav1.c:2222)."""
        if self._vthread is None:
            return
        with trace.span("wait"), self._vwork_cv:
            while self._vwork or self._vworker_busy:
                self._vwork_cv.notify_all()
                self._vwork_cv.wait(0.005)

    def _stop_vthread(self) -> None:
        if self._vthread is None:
            return
        self._drain_video()
        with self._vwork_cv:
            self._vthread_stop = True
            self._vwork_cv.notify_all()
        self._vthread.join(timeout=5.0)
        self._vthread = None

    def decode_next(self) -> EasyAV1Status:
        with self._playback_lock:
            return self._decode_next_locked()

    @trace.spanned("decode_next")
    def _decode_next_locked(self,
                            fire_callbacks: bool = True) -> EasyAV1Status:
        if self._status.is_error:
            return EasyAV1Status.ERROR
        pkt = self._get_next_packet()
        if pkt is None:
            self._drain_video()
            if fire_callbacks:
                # deliver frames the worker finished after the last
                # packet advanced the position
                self._callback_video()
                while (not self.settings.skip_unprocessed_frames
                       and self.settings.video_callback is not None
                       and self.has_video_frame()):
                    self._callback_video()
                self._callback_audio()
            self._status = EasyAV1Status.FINISHED
            return EasyAV1Status.FINISHED
        ts_ms = pkt.timestamp_ns // 1_000_000
        if ts_ms > self._position:
            self._position = ts_ms
        if self._video_track and pkt.track == self._video_track.number:
            self._queue_video_packet(pkt)
            self._wait_packet_decoded(pkt)
        else:
            self._decode_packet(pkt)
        if self._status.is_error:
            return EasyAV1Status.ERROR
        if fire_callbacks:
            # push-mode delivery (reference easyav1.c:2668-2671); settle
            # the decode-ahead worker so each decode_next delivers the
            # frame its packet produced
            if self.settings.video_callback is not None:
                self._drain_video()
            self._callback_video()
            self._callback_audio()
        return EasyAV1Status.OK

    def _decode_packet(self, pkt: Packet) -> None:
        if self._video_track and pkt.track == self._video_track.number:
            self._decode_video_packet(pkt)
        elif self._audio_track and pkt.track == self._audio_track.number:
            self._decode_audio_packet(pkt)

    def decode_until(self, timestamp_ms: int) -> EasyAV1Status:
        with self._playback_lock:
            return self._decode_until_locked(timestamp_ms)

    def _decode_until_locked(self, timestamp_ms: int) -> EasyAV1Status:
        """Decode packets until position reaches timestamp (easyav1.c:2676).
        If we fall > 1s behind and a later cue point exists, force a fast
        seek to catch up (easyav1.c:2696-2713)."""
        if self._status.is_error:
            return EasyAV1Status.ERROR
        if self.settings.skip_unprocessed_frames and \
                timestamp_ms > self._position + DECODE_UNTIL_SKIP_MS:
            # catch-up fast seek only in latest-only mode
            # (easyav1.c:2696-2713)
            cue = self._demux.find_cue(timestamp_ms * 1_000_000)
            if cue is not None and cue.time_ns // 1_000_000 > self._position:
                self._do_seek(timestamp_ms, fast=True)
        st = EasyAV1Status.OK
        while self._position < timestamp_ms:
            # peek: only decode packets at or before the target timestamp
            self._sync_packet_queues()
            nxt = None
            if self._vq:
                nxt = self._vq[0].timestamp_ns
            if self._aq and (nxt is None or self._aq[0].timestamp_ns < nxt):
                nxt = self._aq[0].timestamp_ns
            if nxt is not None and nxt // 1_000_000 > timestamp_ms:
                self._position = timestamp_ms
                break
            st = self._decode_next_locked(fire_callbacks=False)
            if st != EasyAV1Status.OK:
                break
        if st != EasyAV1Status.ERROR and not self._status.is_error:
            # single end-of-drive delivery (easyav1.c:2768-2771):
            # latest-only video when skip_unprocessed_frames is on
            self._drain_video()
            self._callback_video()
            self._callback_audio()
        return st

    def decode_for(self, duration_ms: int) -> EasyAV1Status:
        return self.decode_until(self._position + duration_ms)

    # ------------------------------------------------------------------
    # video path

    def _decode_video_packet(self, pkt: Packet) -> None:
        backend = self._video_backend
        if backend is None:
            return
        ts_ms = pkt.timestamp_ns // 1_000_000
        try:
            frames = backend.decode(pkt.frames, ts_ms)
        except Exception as e:  # noqa: BLE001
            self._set_error(EasyAV1Status.DECODER_ERROR, f"video decode: {e}")
            return
        for f in frames:
            self._total_video_frames += 1
            with self._frame_lock:
                self._frame_queue.append(f)
                while len(self._frame_queue) > VIDEO_FRAME_QUEUE_SIZE:
                    self._frame_queue.pop(0)  # drop oldest (easyav1.c:2139)
        if not self.settings.skip_unprocessed_frames:
            # per-frame delivery: every decoded frame reaches the
            # callback (easyav1.c:2595-2597); in latest-only mode the
            # decode drivers deliver once at the end instead.  The
            # decode-ahead worker may run ahead of the position, so
            # drain every currently-displayable frame.
            cb = self.settings.video_callback
            while cb is not None:
                f = self.get_video_frame()
                if f is None:
                    break
                cb(f, self.settings.callback_userdata)

    def _callback_video(self) -> None:
        """Pop-based push delivery (reference callback_video,
        easyav1.c:2192-2205): hands the queue head to the callback
        only when its timestamp has been reached."""
        cb = self.settings.video_callback
        if cb is None:
            return
        f = self.get_video_frame()
        if f is not None:
            cb(f, self.settings.callback_userdata)

    def _callback_audio(self) -> None:
        """Reference callback_audio (easyav1.c:2207-2220): hands the
        ring buffer once and marks it consumed."""
        cb = self.settings.audio_callback
        if cb and self._audio_buf_fill:
            cb(self._make_audio_frame(), self.settings.callback_userdata)
            self._audio_buf_fill = 0
            self._audio_consumed = True

    def has_video_frame(self) -> bool:
        with self._frame_lock:
            if (self._frame_queue
                    and self._frame_queue[0].timestamp <= self._position):
                return True
        # a displayable frame may still be in flight on the decode-ahead
        # worker; settle it so pull-mode callers keep the synchronous
        # decode_next -> has_video_frame contract.  Not while play()
        # drives the decode: its thread keeps the worker busy for as long
        # as it is behind the clock, so a reader waiting for the worker
        # to go idle would wait while the ring drops the frames it came
        # for; the reader polls instead.
        if self._vthread is not None and not self.is_playing():
            with self._vwork_cv:
                busy = bool(self._vwork) or self._vworker_busy
            if busy:
                self._drain_video()
        with self._frame_lock:
            return bool(self._frame_queue
                        and self._frame_queue[0].timestamp <= self._position)

    @trace.spanned("get_video_frame")
    def get_video_frame(self) -> Optional[VideoFrame]:
        """Pull the next displayable frame (easyav1.c:3509-3571): head of
        queue only if its timestamp has been reached."""
        with self._frame_lock:
            if not self._frame_queue:
                return None
            if self._frame_queue[0].timestamp > self._position:
                return None
            f = self._frame_queue.pop(0)
        if self._vthread is not None:
            # un-throttle the decode-ahead worker
            with self._vwork_cv:
                self._vwork_cv.notify_all()
        return f

    # ------------------------------------------------------------------
    # audio path

    def _decode_audio_packet(self, pkt: Packet) -> None:
        dec = self._audio_decoder
        if dec is None:
            return
        ts_ms = pkt.timestamp_ns // 1_000_000
        for chunk in pkt.frames:
            try:
                pcm = dec.decode_packet_host(chunk)
            except Exception as e:  # noqa: BLE001
                self._set_error(EasyAV1Status.DECODER_ERROR, f"audio decode: {e}")
                return
            if pcm.shape[0]:
                self._push_audio(pcm, ts_ms)

    def _push_audio(self, pcm: np.ndarray, ts_ms: int) -> None:
        """Append to the ring; overflow drops oldest (easyav1.c:2501-2532)."""
        n = pcm.shape[0]
        buf = self._audio_buf
        if self._audio_consumed and self._audio_buf_fill == 0:
            self._audio_buf_ts = ts_ms
            self._audio_consumed = False
        if n >= AUDIO_BUFFER_SIZE:
            buf[:] = pcm[-AUDIO_BUFFER_SIZE:]
            self._audio_buf_fill = AUDIO_BUFFER_SIZE
        else:
            overflow = self._audio_buf_fill + n - AUDIO_BUFFER_SIZE
            if overflow > 0:
                buf[:self._audio_buf_fill - overflow] = \
                    buf[overflow:self._audio_buf_fill]
                self._audio_buf_fill -= overflow
                rate = self._audio_track.sample_rate or 48000
                self._audio_buf_ts += int(overflow * 1000 / rate)
            buf[self._audio_buf_fill:self._audio_buf_fill + n] = pcm
            self._audio_buf_fill += n

    def is_audio_buffer_filled(self) -> bool:
        return self._audio_buf_fill >= AUDIO_BUFFER_SIZE

    def _make_audio_frame(self) -> AudioFrame:
        ch = self._audio_track.channels
        n = self._audio_buf_fill
        data = self._audio_buf[:n]
        if self.settings.interlace_audio:
            pcm = data.reshape(-1).copy()
        else:
            pcm = [data[:, c].copy() for c in range(ch)]
        return AudioFrame(channels=ch, samples=n,
                          timestamp=self._audio_buf_ts, pcm=pcm)

    def get_audio_frame(self) -> Optional[AudioFrame]:
        """Hand over the buffered samples and mark consumed
        (easyav1.c:3604-3630)."""
        if self._audio_buf_fill == 0:
            return None
        frame = self._make_audio_frame()
        self._audio_buf_fill = 0
        self._audio_consumed = True
        return frame

    # ------------------------------------------------------------------
    # seeking (easyav1.c:2961-3260)

    def seek_to_timestamp(self, timestamp_ms: int) -> EasyAV1Status:
        if self._status.is_error:
            return EasyAV1Status.ERROR
        if self._playback_thread and self._playback_thread.is_alive():
            # deferred: serviced by the playback thread (easyav1.c:3208)
            self._seek_request = timestamp_ms
            return EasyAV1Status.OK
        with self._playback_lock:
            return self._do_seek(timestamp_ms,
                                 fast=self.settings.use_fast_seeking)

    def seek_forward(self, offset_ms: int) -> EasyAV1Status:
        return self.seek_to_timestamp(self._position + offset_ms)

    def seek_backward(self, offset_ms: int) -> EasyAV1Status:
        return self.seek_to_timestamp(max(0, self._position - offset_ms))

    @trace.spanned("seek")
    def _do_seek(self, timestamp_ms: int, fast: bool) -> EasyAV1Status:
        """Two-pass cue seek (easyav1.c:2961-3206):
        pass 0 scans from the cue cluster for the last keyframe <= target
        (no reconstruction); pass 1 re-seeks and decodes forward from that
        keyframe — to the keyframe only (fast) or to the exact target."""
        # pre-seek packets are obsolete: drop queued work, wait for the
        # in-flight decode (pause_video_decoder_thread parity)
        if self._vthread is not None:
            with self._vwork_cv:
                self._vwork.clear()
            self._drain_video()
        demux = self._demux
        if timestamp_ms > self._duration_ms:
            timestamp_ms = self._duration_ms
        target_ns = timestamp_ms * 1_000_000

        cue = demux.find_cue(target_ns,
                             self._video_track.number if self._video_track
                             else None)
        # flush state
        self._vq.clear()
        self._aq.clear()
        self._stream_ended = False
        with self._frame_lock:
            self._frame_queue.clear()
        if self._video_backend:
            self._video_backend.flush()
        if self._audio_decoder:
            self._audio_decoder.reset()
        self._audio_buf_fill = 0
        self._audio_consumed = True

        if cue is not None:
            demux.seek_to_cue(cue)
        else:
            demux.seek_to_start()

        if self._video_track is None:
            # audio only: decode forward discarding output until target
            self._position = 0
            self._skip_audio_until(timestamp_ms)
            self._status = EasyAV1Status.OK
            return EasyAV1Status.OK

        # pass 0: find last keyframe <= target without reconstructing;
        # when a cue window has none, back up one cue point at a time
        # (reference easyav1.c:3126-3145)
        keyframe_ts: Optional[int] = None
        first_kf: Optional[int] = None
        while True:
            keyframe_ts, first_kf = self._seek_scan_pass0(target_ns)
            if keyframe_ts is not None or cue is None:
                break
            prev = (demux.find_cue(cue.time_ns - 1,
                                   self._video_track.number)
                    if cue.time_ns > 0 else None)
            if prev is not None and prev.time_ns < cue.time_ns:
                cue = prev
                demux.seek_to_cue(cue)
            else:
                cue = None
                demux.seek_to_start()
        if keyframe_ts is None:
            if first_kf is not None:
                # target precedes the first keyframe: decode from it
                # (reference keeps last_keyframe_timestamp = 0 and
                # accepts the first keyframe in pass 1)
                keyframe_ts = first_kf
            else:
                # scanned from the stream start and found no keyframe
                # (reference easyav1.c:3126-3140)
                self._set_error(EasyAV1Status.DECODER_ERROR,
                                "seek: no keyframe found in stream")
                return EasyAV1Status.ERROR

        # pass 1: re-seek and decode forward
        if cue is not None:
            demux.seek_to_cue(cue)
        else:
            demux.seek_to_start()
        self._stream_ended = False
        found_key = False
        while True:
            pkt = self._fetch_any_packet()
            if pkt is None:
                break
            is_video = (pkt.track == self._video_track.number
                        if self._video_track else False)
            ts = pkt.timestamp_ns
            if is_video:
                if not found_key:
                    if ts == keyframe_ts:
                        found_key = True
                    else:
                        continue  # discard pre-keyframe packets
                self._decode_video_packet(pkt)
                self._position = ts // 1_000_000
                if fast:
                    break
                if ts >= target_ns:
                    break
            else:
                if found_key and not fast:
                    self._decode_audio_packet(pkt)
        # seek packets REPLACE the queue head (easyav1.c:2317-2319):
        # intermediate keyframe->target frames must not leak to the
        # consumer — only the last decoded frame survives the seek
        with self._frame_lock:
            if len(self._frame_queue) > 1:
                last = self._frame_queue[-1]
                self._frame_queue.clear()
                self._frame_queue.append(last)
        if not fast:
            self._position = timestamp_ms
        self._status = EasyAV1Status.OK
        return EasyAV1Status.OK

    def _seek_scan_pass0(self, target_ns: int):
        """One forward scan of seek pass 0: (last keyframe <= target,
        first keyframe seen).  Packets before a sequence header only
        probe for one (parity: SEEKING_FOR_SQHDR via
        dav1d_parse_sequence_header, easyav1.c:2603-2609, 2335-2351) so
        the keyframe search starts where decoding could succeed."""
        demux = self._demux
        keyframe_ts: Optional[int] = None
        first_kf: Optional[int] = None
        probe_packets = 0
        sqhdr_found = self._video_backend is None
        while True:
            demux.save_state()
            pkt = demux.read_packet()
            if pkt is None:
                break
            if pkt.track != self._video_track.number:
                continue
            if pkt.timestamp_ns > target_ns and \
                    (keyframe_ts is not None or probe_packets > 0):
                if pkt.keyframe and first_kf is None:
                    first_kf = pkt.timestamp_ns
                break
            probe_packets += 1
            if not sqhdr_found:
                sqhdr_found = self._video_backend.probe_sequence_header(
                    pkt.frames)
                if not sqhdr_found:
                    continue
            if pkt.keyframe:
                if first_kf is None:
                    first_kf = pkt.timestamp_ns
                if pkt.timestamp_ns <= target_ns:
                    keyframe_ts = pkt.timestamp_ns
        return keyframe_ts, first_kf

    def _fetch_any_packet(self) -> Optional[Packet]:
        demux = self._demux
        while True:
            pkt = demux.read_packet()
            if pkt is None:
                return None
            if self._video_track and pkt.track == self._video_track.number:
                return pkt
            if self._audio_track and pkt.track == self._audio_track.number:
                ts_ms = pkt.timestamp_ns // 1_000_000 + self._audio_offset_ms
                if ts_ms < 0:
                    continue
                pkt.timestamp_ns = ts_ms * 1_000_000
                return pkt

    def _skip_audio_until(self, timestamp_ms: int) -> None:
        """Audio-only seek: symbol-decode (track position, no synthesis)
        until the target (parity: vorbis_synthesis_trackonly,
        easyav1.c:2446-2456)."""
        while True:
            demux = self._demux
            demux.save_state()
            pkt = demux.read_packet()
            if pkt is None:
                self._stream_ended = True
                break
            if not (self._audio_track and pkt.track == self._audio_track.number):
                continue
            ts_ms = pkt.timestamp_ns // 1_000_000 + self._audio_offset_ms
            if ts_ms >= timestamp_ms:
                demux.restore_state()
                break
            # decode-free position tracking: symbols only, no
            # synthesis (parity: vorbis_synthesis_trackonly,
            # easyav1.c:2446-2456 / minivorbis.h:12854)
            for chunk in pkt.frames:
                blk = self._audio_decoder.decode_packet_symbols(chunk)
                if blk is not None:
                    self._audio_decoder.track_block(blk)
            self._position = ts_ms
        self._position = timestamp_ms

    # ------------------------------------------------------------------
    # playback (easyav1.c:2805-2922)

    def play(self) -> EasyAV1Status:
        if self._status.is_error:
            return EasyAV1Status.ERROR
        if self._playback_thread and self._playback_thread.is_alive():
            return EasyAV1Status.OK
        self._playback_stop.clear()
        self._playback_thread = threading.Thread(
            target=self._playback_loop, daemon=True, name="easyav1-playback")
        self._playback_thread.start()
        return EasyAV1Status.OK

    def stop(self) -> EasyAV1Status:
        self._playback_stop.set()
        t = self._playback_thread
        if t and t.is_alive():
            t.join(timeout=5)
        self._playback_thread = None
        return EasyAV1Status.OK

    def is_playing(self) -> bool:
        return bool(self._playback_thread and self._playback_thread.is_alive())

    def _playback_loop(self) -> None:
        last = time.monotonic()
        while not self._playback_stop.is_set():
            if self._seek_request is not None:
                ts = self._seek_request
                self._seek_request = None
                with self._playback_lock:
                    self._do_seek(ts, fast=self.settings.use_fast_seeking)
                last = time.monotonic()
            now = time.monotonic()
            elapsed_ms = int((now - last) * 1000)
            if elapsed_ms <= 0:
                time.sleep(0.001)  # 1ms idle sleep (easyav1.c:2820)
                continue
            last = now
            st = self.decode_until(self._position + elapsed_ms)
            if st != EasyAV1Status.OK:
                break

    # ------------------------------------------------------------------
    # settings live-update (easyav1.c:3854-3949)

    def update_settings(self, new: EasyAV1Settings) -> EasyAV1Status:
        if self._status.is_error:
            return EasyAV1Status.ERROR
        old = self.settings
        was_playing = self.is_playing()
        if was_playing:
            self.stop()
        needs_reinit = (
            new.enable_video != old.enable_video
            or new.enable_audio != old.enable_audio
            or new.video_track != old.video_track
            or new.audio_track != old.audio_track
        )
        self.settings = new.copy()
        self.log.level = new.log_level
        if needs_reinit:
            pos = self._position
            self._stop_vthread()
            if self._video_backend is not None:
                # drain in-flight frame-parallel recon before dropping
                # the backend: an orphaned worker would race the new
                # backend's entropy pass on the shared buffer pools
                self._video_backend.flush()
            self._video_track = None
            self._audio_track = None
            self._video_backend = None
            self._audio_decoder = None
            try:
                self._init_tracks()
            except W.WebMError as e:
                self._set_error(EasyAV1Status.UNSUPPORTED, str(e))
                return EasyAV1Status.ERROR
            # exact re-seek to rebuild decoder state (easyav1.c:3934-3946)
            with self._playback_lock:
                self._do_seek(pos, fast=False)
        else:
            self._audio_offset_ms = (new.audio_offset_time
                                     + (self._audio_track.codec_delay_ns
                                        // 1_000_000
                                        if self._audio_track else 0))
        if was_playing:
            self.play()
        return EasyAV1Status.OK

    # ------------------------------------------------------------------

    def close(self) -> None:
        """easyav1_destroy (easyav1.c:3990-4039)."""
        if self._destroyed:
            return
        self.stop()
        self._stop_vthread()
        self._vq.clear()
        self._aq.clear()
        with self._frame_lock:
            self._frame_queue.clear()
        if self._stream is not None and self.settings.close_handle_on_destroy:
            self._stream.close()
        self._destroyed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # C-style aliases -------------------------------------------------

    decode = decode_next


def native_session(source, settings: Optional[EasyAV1Settings] = None
                   ) -> EasyAV1:
    """A session on the native C path, as the reference decodes with
    EASYAV1_PIPE unset.  Raises when EASYAV1_PIPE routes the reference
    anywhere else, so that the yardstick stays the reference's native
    path."""
    pipe = os.environ.get("EASYAV1_PIPE", "native")
    if pipe != "native":
        raise RuntimeError(f"EASYAV1_PIPE={pipe!r} routes the reference "
                           "away from its native C path")
    return EasyAV1(source, settings, device=None)


# the reference's host frame hash (resident.frame_hash_host)
_FNV = 16777619
_RK = 2654435761
_CK = 40503


def frame_hash(planes) -> int:
    """A 32-bit position-weighted hash of a frame's planes, the
    reference's `resident.frame_hash_host`."""
    h = np.uint32(2166136261)
    with np.errstate(over="ignore"):
        for p in planes:
            p = np.asarray(p)
            ph, pw = p.shape
            r = np.arange(ph, dtype=np.uint32)[:, None]
            c = np.arange(pw, dtype=np.uint32)[None, :]
            wts = np.uint32(1) + r * np.uint32(_RK) + c * np.uint32(_CK)
            h = h * np.uint32(_FNV) \
                + (p.astype(np.uint32) * wts).sum(dtype=np.uint32)
    return int(h)
