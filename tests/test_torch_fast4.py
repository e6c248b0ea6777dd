"""Port parity: the FAST window scan (kernels K3 and K4,
``scan_codes.fast4_window_scan``) and ``fast4_scan_topk`` of vaq_tpu_torch
against vaq_tpu's Pallas ``fast4_window_scan`` / ``fast4_scan_topk`` run with
``interpret=True``, on the same seeded inputs.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernels are
held against that version by tests/test_torch_kernels_gpu.py.

Tolerances: K4 sums integers, so its scores and ids equal JAX's bit for bit.
K3 adds bf16-rounded entries in f32; JAX sums eight subspaces at a time on
the MXU, the port one at a time, so the sums differ in the last bits, and
the packed key keeps only 23 − idx_bits mantissa bits: scores agree to
1e-5 + 2^(idx_bits − 23) relative (the K1 rule), and a window's winning row
may differ only where the two rows' sums agree to that. The rescored
top-k distances are f32 sums of the same entries in another order: rtol
1e-5. On the tie-heavy input every sum is an exact integer, so ids must
equal JAX's exactly, which only a selection that puts the lower position
first among equal scores gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_scan_decoded import assert_topk_match
from vaq_tpu.ops import scan_pallas
from vaq_tpu_torch.ops import scan_codes

torch.set_num_threads(2)  # six test workers share the host

# (n, M, C, nq, block_rows): the FAST width, the 8-bit width, and n that is
# no multiple of 8·block_rows
GEOMETRIES = [(4096, 16, 16, 4, 128), (2048, 4, 256, 3, 64),
              (1000, 8, 16, 5, 64)]


def make_fast4(geom, seed=0):
    """(codes u8, f32 LUTs, u8 LUTs) as numpy, from a seed."""
    n, m, c, nq, _ = geom
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, c, (n, m)).astype(np.uint8)
    luts = (rng.random((nq, m, c)) * 4.0).astype(np.float32)
    lut8 = rng.integers(0, 256, (nq, m, c)).astype(np.uint8)
    return codes, luts, lut8


def s8(lut8):
    """The u8 LUT in K4's signed form, u8 − 128."""
    return (lut8.astype(np.int16) - 128).astype(np.int8)


def k3_rtol(block_rows):
    return 1e-5 + 2.0 ** ((block_rows - 1).bit_length() - 23)


def jax_window_scan(codes, luts, block_rows):
    """JAX's window scan on the rows zero-padded to 8·block_rows."""
    pad = (-codes.shape[0]) % (8 * block_rows)
    codes_p = np.pad(codes, ((0, pad), (0, 0)))
    s, i = scan_pallas.fast4_window_scan(
        jnp.asarray(codes_p), jnp.asarray(luts), block_rows=block_rows,
        q_tile=luts.shape[0], interpret=True)
    return np.asarray(s), np.asarray(i), codes_p


def port_window_scan(codes, luts, block_rows):
    n_win = -(-codes.shape[0] // (8 * block_rows)) * 8
    s, i = scan_codes.fast4_window_scan(torch.as_tensor(codes),
                                        torch.as_tensor(luts), block_rows,
                                        n_win)
    return s.numpy(), i.numpy()


def k3_sums64(codes, luts, q_idx, rows):
    """K3's sum in f64 for given (query, row) pairs, over bf16 entries."""
    lut_bf = torch.as_tensor(luts).to(torch.bfloat16).double().numpy()
    m = codes.shape[1]
    return lut_bf[q_idx[:, None], np.arange(m)[None, :],
                  codes[rows].astype(np.int64)].sum(1)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_k4_plain_bit_equals_jax(geom):
    codes, _, lut8 = make_fast4(geom)
    br = geom[4]
    s_j, i_j, _ = jax_window_scan(codes, s8(lut8), br)
    s_t, i_t = port_window_scan(codes, s8(lut8), br)
    assert s_t.dtype == np.int32 and i_t.dtype == np.int32
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(i_t, i_j)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_k3_plain_matches_jax(geom):
    codes, luts, _ = make_fast4(geom)
    br = geom[4]
    rtol = k3_rtol(br)
    s_j, i_j, codes_p = jax_window_scan(codes, luts, br)
    s_t, i_t = port_window_scan(codes, luts, br)
    assert s_t.dtype == np.float32
    np.testing.assert_allclose(s_t, s_j, rtol=rtol)
    q_idx, w_idx = np.nonzero(i_t != i_j)
    if len(q_idx):  # only rows whose sums agree to the tolerance may differ
        a = k3_sums64(codes_p, luts, q_idx, i_t[q_idx, w_idx])
        b = k3_sums64(codes_p, luts, q_idx, i_j[q_idx, w_idx])
        np.testing.assert_allclose(a, b, rtol=rtol)
    assert len(q_idx) <= 0.02 * i_t.size


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n_valid", [None, 3000])
def test_fast4_scan_topk_matches_jax(quantized, n_valid):
    geom = (4096, 16, 16, 4, 64)
    codes, luts, lut8 = make_fast4(geom, seed=4)
    k = 8
    d_j, i_j = scan_pallas.fast4_scan_topk(
        jnp.asarray(codes), jnp.asarray(luts), k,
        n_valid=None if n_valid is None else jnp.int32(n_valid),
        block_rows=64, q_tile=4, interpret=True,
        luts8=jnp.asarray(lut8) if quantized else None)
    d_t, i_t = scan_codes.fast4_scan_topk(
        torch.as_tensor(codes), torch.as_tensor(luts), k, block_rows=64,
        luts8=torch.as_tensor(lut8) if quantized else None, n_valid=n_valid)
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int32
    if quantized:  # integer winner selection: the same ids, in order
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)
    if n_valid is not None:
        assert i_t.max() < n_valid


def test_fast4_scan_topk_ragged_rows_and_few_windows():
    """n = 1000 pads to 1024 rows (16 windows of 64); k = 20 > 16 windows:
    the tail is −1 / +inf, as in JAX."""
    codes, luts, _ = make_fast4((1000, 8, 16, 3, 64), seed=6)
    d_j, i_j = scan_pallas.fast4_scan_topk(
        jnp.asarray(codes), jnp.asarray(luts), 20, block_rows=64, q_tile=3,
        interpret=True)
    d_t, i_t = scan_codes.fast4_scan_topk(
        torch.as_tensor(codes), torch.as_tensor(luts), 20, block_rows=64)
    assert (i_t[:, 16:] == -1).all() and torch.isinf(d_t[:, 16:]).all()
    assert (i_t[:, :16] >= 0).all() and i_t.max() < 1000
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)


def tie_heavy(seed=8):
    """16 distinct code rows repeated over 4096 rows and a coarse u8 LUT
    (entries 0-3): many windows share their minimum, and duplicated rows
    share their distance. luts holds the u8 values as f32, so every sum is
    an exact integer on both sides."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 16, (16, 8)).astype(np.uint8)
    codes = pool[rng.integers(0, 16, 4096)]
    lut8 = rng.integers(0, 4, (4, 8, 16)).astype(np.uint8)
    return codes, lut8.astype(np.float32), lut8


@pytest.mark.parametrize("quantized", [False, True])
def test_fast4_scan_topk_ties_match_jax_exactly(quantized):
    codes, luts, lut8 = tie_heavy()
    args = dict(block_rows=64)
    d_j, i_j = scan_pallas.fast4_scan_topk(
        jnp.asarray(codes), jnp.asarray(luts), 20, q_tile=4, interpret=True,
        luts8=jnp.asarray(lut8) if quantized else None, **args)
    d_t, i_t = scan_codes.fast4_scan_topk(
        torch.as_tensor(codes), torch.as_tensor(luts), 20,
        luts8=torch.as_tensor(lut8) if quantized else None, **args)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5)
    # the input is what the test says: ties inside the top 20
    assert (np.diff(np.asarray(d_j), axis=1) == 0).sum() >= 20


def test_select_lowest_is_what_torch_topk_is_not():
    """On the tie-heavy window scores, ``_select_lowest`` picks the windows
    ``jax.lax.top_k`` picks; ``torch.topk`` picks other windows, so the
    helper is what keeps the port's ids equal to JAX's."""
    codes, _, lut8 = tie_heavy()
    scores, _ = scan_codes.fast4_window_scan(
        torch.as_tensor(codes), torch.as_tensor(s8(lut8)), 64)
    _, want = jax.lax.top_k(-jnp.asarray(scores.numpy()).astype(jnp.float32),
                            20)
    _, pos = scan_codes._select_lowest(scores, 20)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))
    topk = torch.topk(scores, 20, dim=1, largest=False, sorted=True).indices
    assert any(set(topk[q].tolist()) != set(pos[q].tolist())
               for q in range(scores.shape[0]))


def test_fast4_tile_fits_the_shared_memory():
    """The query tile follows M and C: the main FAST shape, C = 256, and a
    LUT no block can hold."""
    assert scan_codes._fast4_tile(64, 16, 4, 512, 256)[0] == 16   # K3
    assert scan_codes._fast4_tile(64, 16, 1, 512, 256)[0] == 32   # K4
    assert scan_codes._fast4_tile(32, 256, 4, 128, 512)[0] == 2
    assert scan_codes._fast4_tile(32, 256, 1, 128, 512)[0] == 8
    assert scan_codes._fast4_tile(16, 256, 1, 128, 512)[0] == 16  # 8 groups
    assert scan_codes._fast4_tile(24, 256, 1, 128, 512)[0] == 8   # 10 → 8
    assert scan_codes._fast4_tile(32, 256, 1, 5, 512)[0] == 5     # nq caps it
    for args in ((64, 16, 4, 512, 256), (32, 256, 4, 128, 512),
                 (512, 16, 1, 7, 1)):
        assert scan_codes._fast4_tile(*args)[1] <= scan_codes._SMEM_LIMIT
    with pytest.raises(ValueError, match="does not fit"):
        scan_codes._fast4_tile(256, 256, 4, 8, 256)


def test_fast4_wrapper_checks_inputs_and_counts_only_launches():
    codes, luts, lut8 = make_fast4(GEOMETRIES[0])
    c, lf, l8 = (torch.as_tensor(codes), torch.as_tensor(luts),
                 torch.as_tensor(s8(lut8)))
    before = dict(scan_codes.fast4_window_scan.launches)
    scan_codes.fast4_window_scan(c, lf, 128)
    scan_codes.fast4_window_scan(c, l8, 128)
    assert scan_codes.fast4_window_scan.launches == before  # plain versions
    with pytest.raises(ValueError, match="uint8"):
        scan_codes.fast4_window_scan(c.to(torch.int32), lf, 128)
    with pytest.raises(ValueError, match="float32"):
        scan_codes.fast4_window_scan(c, lf.double(), 128)
    with pytest.raises(ValueError, match="power of 2"):
        scan_codes.fast4_window_scan(c, lf[:, :, :12].contiguous(), 128)
    with pytest.raises(ValueError, match="disagree on M"):
        scan_codes.fast4_window_scan(c[:, :5].contiguous(), lf, 128)
    with pytest.raises(ValueError, match="do not cover"):
        scan_codes.fast4_window_scan(c, lf, 128, n_win=3)
    with pytest.raises(ValueError, match="overflows"):
        wide = torch.zeros((4, 2048), dtype=torch.uint8)
        scan_codes.fast4_window_scan(wide, torch.zeros((1, 2048, 16),
                                                       dtype=torch.int8), 16384)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        scan_codes.fast4_window_scan(c.to(meta), lf.to(meta), 128)


def test_plain_k3_adds_in_subspace_order():
    """K3's plain version is the sequential f32 sum of the bf16 entries the
    kernel computes, so the two can agree bit for bit."""
    codes, luts, _ = make_fast4((512, 8, 16, 2, 512), seed=9)
    s, i = scan_codes.fast4_window_scan(torch.as_tensor(codes),
                                        torch.as_tensor(luts), 512)
    lut_bf = torch.as_tensor(luts).to(torch.bfloat16).float()
    acc = torch.zeros((2, 512))
    for s_ in range(8):
        acc = acc + lut_bf[:, s_, torch.as_tensor(codes[:, s_]).long()]
    mask = (1 << 9) - 1                   # idx_bits of 512-row windows
    keys = (acc.contiguous().view(torch.int32) & ~mask) | torch.arange(
        512, dtype=torch.int32)
    want = keys.amin(dim=1)
    np.testing.assert_array_equal(i[:, 0].numpy(), (want & mask).numpy())
    np.testing.assert_array_equal(s[:, 0].numpy(),
                                  (want & ~mask).view(torch.float32).numpy())
