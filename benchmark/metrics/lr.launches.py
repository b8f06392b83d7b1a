"""Loop restoration's kernel launches a frame: those inside the "lr"
stage (`spans.span_kernels`)."""

import spans


def read(run, spec):
    return spans.span_kernels(run, {"span": "lr", "count": True})
