"""The reference's state, carried into the port's tensors.

A decoder has no weights.  What the JAX package hands its device is of
two kinds, and both reach the port through `from_reference`:

- constant tables: the Smooth weights, filter-intra taps, warp filter
  and OBMC masks of `tables_data.npz`, and CDEF's direction, chroma-remap, cost-weight and
  partial-sum tables (`reference_tables`), all from the port's copies
  of them (`video/av1/tables.py`, `recon/cdef_torch.py`);
- the per-frame export: unit fields, int16 residual planes, and the
  deblocking and CDEF parameter maps.

`dr_intra_derivative` and the deblocking limit LUTs are applied on the
host by the planners (`records.preprocess_units` writes dx/dy into the
unit fields, `postfilter._lf_size_maps` writes per-edge limits), so they
arrive already applied, as part of the export.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping

import numpy as np
import torch

from easyav1_tpu_torch.video.av1 import tables as T
from easyav1_tpu_torch.video.av1.recon import cdef_torch


def _partial_index() -> np.ndarray:
    """[8, 64] int64: flat index d*15 + k of the direction-search
    partial sum that pixel i*8+j of an 8x8 block feeds in direction d
    (the one-hot `_partial_indicators` as an index)."""
    ind = cdef_torch._partial_indicators().reshape(8, 15, 64)
    k = np.argmax(ind, axis=1)
    return (np.arange(8)[:, None] * 15 + k).astype(np.int64)


def reference_tables() -> Dict[str, np.ndarray]:
    """The constant tables the port's kernels read, as numpy."""
    d = T.data()
    return {
        "sm_weights": d["sm_weights"].astype(np.int32),
        "filter_intra_taps": d["filter_intra_taps"].astype(np.int32),
        "warped_filter": d["warped_filter"].astype(np.int32),
        # the OBMC masks of lengths 2, 4, 8, 16, 32, the one of length n
        # at offset n - 2
        "obmc_masks": np.concatenate(
            [d[f"obmc_mask_{n}"] for n in (2, 4, 8, 16, 32)]).astype(np.int32),
        "cdef_directions": cdef_torch.CDEF_DIRECTIONS.astype(np.int64),
        "cdef_uv_dir": cdef_torch.CDEF_UV_DIR.astype(np.int64),
        "cdef_cost_weights": cdef_torch._cost_weights().astype(np.int64),
        "cdef_partial_index": _partial_index(),
    }


def from_reference(arrays: Mapping[str, np.ndarray],
                   device) -> Dict[str, torch.Tensor]:
    """numpy arrays -> contiguous tensors of the same dtype on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


@functools.lru_cache(maxsize=None)
def tables(device: torch.device) -> Dict[str, torch.Tensor]:
    """`reference_tables()` on `device`, made once per device."""
    return from_reference(reference_tables(), device)
