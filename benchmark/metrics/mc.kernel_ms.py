"""MC and OBMC's kernel time a frame: the kernels launched inside the
"mc" stage (`spans.span_kernels`)."""

import spans


def read(run, spec):
    return spans.span_kernels(run, {"span": "mc"})
