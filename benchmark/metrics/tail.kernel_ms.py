"""The tail's kernel time a frame (crop and cast, film grain): the
kernels launched inside the "tail" and "grain" stages
(`spans.span_kernels`)."""

import spans


def read(run, spec):
    return spans.span_kernels(run, {"span": ["tail", "grain"]})
