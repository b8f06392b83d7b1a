"""The strip kernel's time a frame on inter frames: the kernels launched
inside the "intra" stage of frames of kind "inter"
(`spans.span_kernels`)."""

import spans


def read(run, spec):
    return spans.span_kernels(run, {"span": "intra", "frames": "inter"})
