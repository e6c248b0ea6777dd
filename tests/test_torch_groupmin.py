"""Port parity: K5's plain version (ops/probe_scan.py) against vaq_tpu's
Pallas ``groupmin_window_scan`` in interpret mode, on the same seeded numpy
inputs (CPU), and the group-size rule against JAX's.

At d = 96 the JAX package stores the buckets transposed and runs
``_groupmin_kernel_t`` (K6); the port keeps rows row-major at every d, so
its K5 at d = 96 is held against JAX's transposed path. The port writes
(ncl, qcap, ng) where JAX writes (ncl, ng, qcap). Tolerance: products are
exact and only summation order differs, so results agree to 1e-5 of the
size of the terms summed (``groupmin_term_scale``: Σ|q·x| + norms at the
group's smallest row). A minimum near 0 is a difference of terms of
thousands, so 1e-5 of |dist| itself would fail on the last bits of those.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import (assert_scores_close, bf16_values,
                                    groupmin_term_scale, make_groupmin_inputs,
                                    to_rows)
from vaq_tpu.ops import probe_pallas
from vaq_tpu_torch.ops import probe_scan

torch.set_num_threads(2)  # six test workers share the host


def _jax_groupmin(qsl, rows, w, ncl, cap, gs):
    """JAX's scan on the layout JAX picks (transposed at d % 128 != 0),
    returned as (ncl, qcap, ng)."""
    d = qsl.shape[2]
    rows_j = jnp.asarray(rows)
    if rows.dtype != np.int8:
        rows_j = rows_j.astype(jnp.bfloat16)
    transposed = d % 128 != 0
    if transposed:
        rows_j = jnp.swapaxes(rows_j.reshape(ncl, cap, d), 1, 2)
        rows_j = rows_j.reshape(ncl * d, cap)
    rt = next(r for r in range(512, cap + 1, 512)
              if cap % r == 0 and r % (8 * gs) == 0)
    out = probe_pallas.groupmin_window_scan(
        jnp.asarray(qsl).astype(jnp.bfloat16), rows_j, jnp.asarray(w), ncl,
        cap, gs=gs, rt=rt, transposed=transposed, interpret=True)
    return np.asarray(out).transpose(0, 2, 1)


def _port_groupmin(qsl, rows, w, ncl, cap, gs, n_slots=None):
    return probe_scan.groupmin_window_scan(
        torch.as_tensor(qsl).to(torch.bfloat16), to_rows(rows, "cpu"),
        torch.as_tensor(w), ncl, cap, gs, n_slots).numpy()


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("gs", [8, 16, 64])
@pytest.mark.parametrize("ncl,cap,qcap,d", [
    (2, 512, 40, 128),      # one row tile, qcap < 128
    (2, 1024, 24, 128),     # two row tiles
    (3, 512, 16, 96),       # d = 96: JAX's transposed kernel (K6)
])
def test_groupmin_matches_jax(dtype, gs, ncl, cap, qcap, d):
    qsl, rows, w = make_groupmin_inputs(ncl, cap, qcap, d, dtype, seed=gs)
    ref = _jax_groupmin(qsl, rows, w, ncl, cap, gs)
    got = _port_groupmin(qsl, rows, w, ncl, cap, gs)
    assert got.shape == (ncl, qcap, cap // gs) and got.dtype == np.float32
    assert_scores_close(got, ref,
                        groupmin_term_scale(qsl, rows, w, ncl, cap, gs))


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_groupmin_padding_ranks_last(dtype):
    """A window of pure padding (int8 poison / bf16 sentinel) ranks behind
    every live window for natural queries — here rows of the bucket plus
    noise — in the port and in JAX (tests/test_probe_pallas.py:95-113; the
    poison is a ranking guard for such queries, not for any query)."""
    ncl, cap, gs, qcap, d = 2, 512, 8, 32, 128
    _, rows, w = make_groupmin_inputs(ncl, cap, qcap, d, dtype)
    dead = (probe_scan.poison_pattern(d) if dtype == "int8"
            else np.full(d, 1e15, np.float32))
    rows.reshape(ncl, cap, d)[1, 64:64 + gs] = dead
    scale = 32.0 if dtype == "int8" else 1.0    # x̂ = rows / scale
    near = rows.reshape(ncl, cap, d)[:, 200:200 + qcap].astype(np.float32)
    rng = np.random.default_rng(1)
    q = near / scale + 0.1 * rng.standard_normal(near.shape)
    qsl = bf16_values(-2.0 * q / scale)      # scale-folded, as the probe does
    for out in (_port_groupmin(qsl, rows, w, ncl, cap, gs),
                _jax_groupmin(qsl, rows, w, ncl, cap, gs)):
        pad_win = out[1, :, 64 // gs]
        live = np.delete(out[1], 64 // gs, axis=1)
        assert (pad_win > live.max(axis=1)).all()
        if dtype == "bf16":
            assert (pad_win >= 1e30).all()


def test_groupmin_empty_slots_read_inf():
    """Slots at or past n_slots[c] are not scored: +inf; the others are the
    full scan's."""
    ncl, cap, qcap, d, gs = 3, 512, 20, 64, 16
    qsl, rows, w = make_groupmin_inputs(ncl, cap, qcap, d, "int8")
    full = _port_groupmin(qsl, rows, w, ncl, cap, gs)
    n_slots = torch.tensor([0, 7, 20], dtype=torch.int32)
    part = _port_groupmin(qsl, rows, w, ncl, cap, gs, n_slots)
    assert np.isinf(part[0]).all() and np.isinf(part[1, 7:]).all()
    np.testing.assert_array_equal(part[1, :7], full[1, :7])
    np.testing.assert_array_equal(part[2], full[2])


def test_groupmin_rejects_bad_shapes():
    qsl, rows, w = make_groupmin_inputs(2, 512, 8, 64, "int8")
    args = (torch.as_tensor(qsl).to(torch.bfloat16), to_rows(rows, "cpu"),
            torch.as_tensor(w))
    with pytest.raises(ValueError, match="power of two"):
        probe_scan.groupmin_window_scan(*args, 2, 512, 12)
    with pytest.raises(ValueError, match="disagree"):
        probe_scan.groupmin_window_scan(*args, 2, 256, 8)
    with pytest.raises(ValueError, match="int8 or bf16"):
        probe_scan.groupmin_window_scan(args[0], args[1].float(), args[2],
                                        2, 512, 8)


@pytest.mark.parametrize("cap", [512, 1024, 1536, 4096, 8192, 16896, 32768,
                                 61440, 131072, 102400])
@pytest.mark.parametrize("d,itemsize", [(128, 1), (96, 1), (128, 2)])
def test_pick_gs_matches_jax(cap, d, itemsize):
    """gs decides which windows exist: the port keeps JAX's rule, including
    the back-off that Mosaic's tiling forced (cap = 512·33 cannot take
    gs ≥ 128), whatever the slot count and row width."""
    gs_j, _ = probe_pallas.pick_gs_rt(cap, 128, d, itemsize)
    assert probe_scan.pick_gs(cap) == gs_j


def test_poison_pattern_matches_jax():
    for d in (96, 128, 64):
        np.testing.assert_array_equal(probe_scan.poison_pattern(d),
                                      probe_pallas.poison_pattern(d))
