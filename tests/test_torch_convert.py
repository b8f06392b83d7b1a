"""`convert.from_reference` carries the JAX package's tables and per-frame
maps into the port's tensors unchanged."""

import numpy as np
import pytest
import torch

from easyav1_tpu.video.av1 import tables as T
from easyav1_tpu.video.av1.recon import cdef_jax, jax_exec
from easyav1_tpu_torch import convert
from easyav1_tpu_torch.unit_programs import random_program

# each table against the JAX package's own source of it
REFERENCE = {
    "sm_weights": lambda: jax_exec._tables()[1],
    "filter_intra_taps": lambda: T.data()["filter_intra_taps"],
    "cdef_directions": lambda: cdef_jax.CDEF_DIRECTIONS,
    "cdef_uv_dir": lambda: cdef_jax.CDEF_UV_DIR,
    "cdef_cost_weights": cdef_jax._cost_weights,
}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_table_matches_reference(name):
    got = convert.tables(torch.device("cpu"))[name]
    want = REFERENCE[name]()
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_partial_index_matches_indicators():
    idx = convert.tables(torch.device("cpu"))["cdef_partial_index"].numpy()
    onehot = np.zeros((8, 15 * 8 * 8), np.int32)
    onehot.reshape(8, 15, 64)[np.arange(8)[:, None], idx % 15,
                              np.arange(64)[None, :]] = 1
    assert np.array_equal(idx // 15, np.repeat(np.arange(8)[:, None], 64, 1))
    assert np.array_equal(onehot.reshape(8, 15, 8, 8),
                          cdef_jax._partial_indicators())


def test_frame_export_round_trips():
    """Unit fields, int16 residual and int32 maps keep dtype and values."""
    prog = random_program(301)
    fields = jax_exec.preprocess_units(prog["units"], prog["dims"], pad=0)
    arrays = {"fields": fields[prog["plane"]], "resid": prog["resid"][0],
              "luma": prog["luma"],
              "filt": np.random.default_rng(0).integers(0, 2, (7, 9))
              .astype(np.int32)}
    got = convert.from_reference(arrays, "cpu")
    for k, a in arrays.items():
        assert got[k].is_contiguous()
        assert got[k].numpy().dtype == a.dtype
        assert np.array_equal(got[k].numpy(), a), k
