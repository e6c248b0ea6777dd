"""Port parity: the LUT build, the u8 LUT quantization and the LUT gather
scan of vaq_tpu_torch (``ops/scan_lut.py``) against vaq_tpu's
``ops/scan_jax.py``, on the same seeded inputs, on the CPU.

Tolerances: the LUT is ‖q‖² − 2·q·c + ‖c‖², a difference of terms of the
size of max|lut| that the two sides multiply and sum in other orders: rtol
1e-5 plus 1e-5·max|lut| absolute. The quantization is elementwise IEEE
arithmetic on one f32 table: bit-equal. The gather scan sums f32 entries in
another order: distances to rtol 1e-5, ids equal (random f32 entries leave
no ties at the k-th distance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaq_tpu.ops import scan_jax
from vaq_tpu_torch.ops import scan_codes, scan_lut

torch.set_num_threads(2)  # six test workers share the host


def make_lut_inputs(m=8, c=16, l=4, nq=5, seed=0):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((m, c, l)).astype(np.float32)
    cents[1, -3:] = 1e18            # padded centroid rows hold the sentinel
    qp = (3.0 * rng.standard_normal((nq, m * l))).astype(np.float32)
    return cents, qp


@pytest.mark.parametrize("geom", [(8, 16, 4), (4, 256, 8), (16, 8, 2)])
def test_build_luts_matches_jax(geom):
    cents, qp = make_lut_inputs(*geom)
    want = np.asarray(scan_jax.build_luts(jnp.asarray(qp), jnp.asarray(cents)))
    got = scan_lut.build_luts(torch.as_tensor(qp), torch.as_tensor(cents))
    assert got.dtype == torch.float32 and got.shape == want.shape
    live = np.abs(want) < 1e30
    scale = np.abs(want[live]).max()
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy()[~live], want[~live], rtol=1e-5)


def test_quantize_luts_bit_equals_jax():
    """Both quantize JAX's f32 table with the same offsets and scales; some
    entries fall below the offset and some above the 255 ceiling."""
    cents, qp = make_lut_inputs(seed=1)
    luts = np.asarray(scan_jax.build_luts(jnp.asarray(qp), jnp.asarray(cents)))
    luts = np.array(luts[:, :, :13])   # the sentinel rows stay out
    rng = np.random.default_rng(2)
    off = np.quantile(luts, 0.05, axis=(0, 2)).astype(np.float32)
    scales = (255.0 / (np.quantile(luts, 0.9, axis=(0, 2)) - off)
              * rng.uniform(0.9, 1.1, 8)).astype(np.float32)
    want = np.asarray(scan_jax.quantize_luts(
        jnp.asarray(luts), jnp.asarray(off), jnp.asarray(scales)))
    got = scan_lut.quantize_luts(torch.as_tensor(luts), torch.as_tensor(off),
                                 torch.as_tensor(scales))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any() and (want == 255).any()


@pytest.mark.parametrize("n,n_valid,block_rows,k", [
    (3000, None, 1024, 10),     # ragged last block
    (3000, 2500, 1024, 10),     # n_valid inside the last full block
    (700, 650, 32768, 7),       # one block (block_rows > n)
    (50, 8, 16, 12),            # fewer valid rows than k: −1 / +inf tail
])
def test_adc_scan_topk_matches_jax(n, n_valid, block_rows, k):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 16, (n, 6)).astype(np.uint8)
    luts = rng.random((4, 6, 16)).astype(np.float32)
    d_j, i_j = scan_jax.adc_scan_topk(
        jnp.asarray(codes), jnp.asarray(luts), k,
        n_valid=None if n_valid is None else jnp.int32(n_valid),
        block_rows=block_rows)
    d_t, i_t = scan_lut.adc_scan_topk(torch.as_tensor(codes),
                                      torch.as_tensor(luts), k,
                                      n_valid=n_valid, block_rows=block_rows)
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5)
    if n_valid is not None:
        assert i_t.max() < n_valid


def test_adc_scan_topk_ties_keep_the_lower_row():
    """Duplicated rows tie exactly; JAX's merge keeps the lower row first,
    across blocks too, and so does the port's."""
    rng = np.random.default_rng(5)
    codes = np.tile(rng.integers(0, 16, (10, 4)).astype(np.uint8), (30, 1))
    luts = rng.integers(0, 3, (3, 4, 16)).astype(np.float32)
    d_j, i_j = scan_jax.adc_scan_topk(jnp.asarray(codes), jnp.asarray(luts),
                                      25, block_rows=64)
    d_t, i_t = scan_lut.adc_scan_topk(torch.as_tensor(codes),
                                      torch.as_tensor(luts), 25, block_rows=64)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_lut_sums_and_select_lowest():
    rng = np.random.default_rng(3)
    codes = torch.as_tensor(rng.integers(0, 8, (20, 3)).astype(np.uint8))
    luts = torch.as_tensor(rng.integers(-5, 5, (2, 3, 8)).astype(np.int32))
    want = sum(luts[:, s, codes[:, s].long()] for s in range(3))
    got = scan_codes.lut_sums(codes, luts)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    vals, pos = scan_codes._select_lowest(torch.tensor([[3, 1, 2, 1, 1]]), 3)
    assert vals.tolist() == [[1, 1, 1]] and pos.tolist() == [[1, 3, 4]]
