"""Port parity: K7's plain version (ops/rescore.py) against vaq_tpu's Pallas
``gather_rescore`` in interpret mode, on the same seeded numpy inputs (CPU).

At d = 96 the JAX package stores the buckets transposed and runs
``_kernel_t`` (K8); the port keeps rows row-major at every d, so its K7 at
d = 96 is held against JAX's transposed path. Tolerance: the same bf16 dot
and f32 norms, summed in another order: 1e-5 of the size of the terms
summed (``rescore_term_scale``: 2·Σ|q·x| + Σ w·x²).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import (assert_scores_close, make_rescore_inputs,
                                    rescore_term_scale, to_rows)
from vaq_tpu.ops import rescore_pallas
from vaq_tpu_torch.ops import rescore

torch.set_num_threads(2)  # six test workers share the host


def _jax(q, w, rows, wblk, gs, transposed=False):
    rows_j = jnp.asarray(rows)
    if rows.dtype != np.int8:
        rows_j = rows_j.astype(jnp.bfloat16)
    if transposed:  # one "cluster" holding every window: (d, cap)
        rows_j = rows_j.T
    return np.asarray(rescore_pallas.gather_rescore(
        jnp.asarray(q), jnp.asarray(w), rows_j, jnp.asarray(wblk), gs,
        transposed=transposed, interpret=True))


def _port(q, w, rows, wblk, gs):
    return rescore.gather_rescore(torch.as_tensor(q), torch.as_tensor(w),
                                  to_rows(rows, "cpu"),
                                  torch.as_tensor(wblk), gs).numpy()


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("nq,m,gs,d,nblk", [
    (16, 20, 16, 128, 64),     # the 1M-ish shape
    (8, 20, 64, 128, 32),      # the 10M shape class
    (5, 6, 8, 128, 16),        # nq not a tile multiple
])
def test_gather_rescore_matches_jax(dtype, nq, m, gs, d, nblk):
    q, w, rows, wblk = make_rescore_inputs(nq, m, gs, d, nblk, dtype)
    got = _port(q, w, rows, wblk, gs)
    assert got.shape == (nq, m, gs) and got.dtype == np.float32
    assert_scores_close(got, _jax(q, w, rows, wblk, gs),
                        rescore_term_scale(q, w, rows, wblk, gs))


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("nq,m,gs,d,nblk", [
    (8, 6, 64, 96, 20),        # d = 96, the K8 layout on the TPU
    (5, 5, 16, 96, 12),
    (6, 4, 8, 64, 9),
])
def test_gather_rescore_matches_jax_transposed(dtype, nq, m, gs, d, nblk):
    q, w, rows, wblk = make_rescore_inputs(nq, m, gs, d, nblk, dtype, seed=11)
    assert_scores_close(_port(q, w, rows, wblk, gs),
                        _jax(q, w, rows, wblk, gs, transposed=True),
                        rescore_term_scale(q, w, rows, wblk, gs))


def test_gather_rescore_duplicate_and_boundary_windows():
    """Duplicate window ids and ids at both ends of the range gather
    correctly (tests/test_rescore_pallas.py:77-89 on the port)."""
    q, w, rows, _ = make_rescore_inputs(9, 5, 16, 128, 10, "int8", seed=3)
    wblk = np.array([[0, 0, 9, 9, 0]] * 9, dtype=np.int32)
    got = _port(q, w, rows, wblk, 16)
    assert_scores_close(got, _jax(q, w, rows, wblk, 16),
                        rescore_term_scale(q, w, rows, wblk, 16))
    np.testing.assert_array_equal(got[:, 0], got[:, 1])
    np.testing.assert_array_equal(got[:, 2], got[:, 3])


def test_gather_rescore_out_of_range_windows_are_nan():
    q, w, rows, wblk = make_rescore_inputs(3, 4, 8, 64, 6, "bf16")
    wblk[0, 1], wblk[2, 3] = -1, 6
    got = _port(q, w, rows, wblk, 8)
    assert np.isnan(got[0, 1]).all() and np.isnan(got[2, 3]).all()
    assert np.isfinite(np.delete(got.reshape(12, 8), [1, 11], 0)).all()
