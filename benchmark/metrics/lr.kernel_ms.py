"""Loop restoration's kernel time a frame: the kernels launched inside
the "lr" stage (`spans.span_kernels`)."""

import spans


def read(run, spec):
    return spans.span_kernels(run, {"span": "lr"})
