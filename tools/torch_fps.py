"""Frames per second of the port on the card beside its native C session,
on the bench streams, for comparing two trees of the repository in one
call on the same card (run them in turns: A, B, B, A).

    python3 tools/torch_fps.py [--root DIR] [STREAM ...]

`--root` names the checkout whose `easyav1_tpu_torch` is imported (by
default the one holding this file). STREAM defaults to the 1080p intra,
1080p inter and 1080p loop restoration + grain streams of
tests/data/bench. A first decode of a small stream builds the libraries
and is not timed; then each stream is decoded once through
`easyav1_tpu_torch.EasyAV1(path, device="cuda")` and once through
`api.native_session`, every frame's hash compared, and both fps printed.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(HERE, "tests", "data", "bench")
STREAMS = [os.path.join(BENCH, n) for n in (
    "bench_av1_intra_1920x1080_30.webm", "bench_av1_inter_1920x1080_60.webm",
    "bench_av1_lr_grain_1920x1080_8.webm")]


def main():
    args = sys.argv[1:]
    root = HERE
    if args[:1] == ["--root"]:
        root, args = os.path.abspath(args[1]), args[2:]
    sys.path.insert(0, root)
    import easyav1_tpu_torch
    from easyav1_tpu_torch.api import frame_hash, native_session

    assert easyav1_tpu_torch.__file__.startswith(root)

    def decode(make):
        av = make()
        hashes = []
        t0 = time.perf_counter()
        try:
            while not av.is_finished() and len(hashes) < 4096:
                av.decode_next()
                while av.has_video_frame():
                    hashes.append(frame_hash(av.get_video_frame().data))
        finally:
            av.close()
        return hashes, time.perf_counter() - t0

    warm = os.path.join(HERE, "tests", "data", "smoke",
                        "inter_modes_96x96.webm")
    decode(lambda: easyav1_tpu_torch.EasyAV1(warm, device="cuda"))
    for path in args or STREAMS:
        port, port_s = decode(
            lambda: easyav1_tpu_torch.EasyAV1(path, device="cuda"))
        native, native_s = decode(lambda: native_session(path))
        if port != native:
            sys.exit(f"{path}: the port's hashes differ from native C")
        n = len(port)
        print(f"{os.path.relpath(root, HERE) or '.'} "
              f"{os.path.basename(path)}: {n} frames, port {n / port_s:.3f} "
              f"fps, native C session {n / native_s:.3f} fps", flush=True)


if __name__ == "__main__":
    main()
