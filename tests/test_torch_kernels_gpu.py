"""The port's CUDA kernels (K1 ``decode_window_scan``, K2
``decode_rescore``) against their plain PyTorch versions, on a CUDA card.

Every test here is marked ``gpu`` and skips without a card. The file
imports neither jax nor vaq_tpu, so on the machine with the card it runs
without them:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

The helpers are shared with tests/test_torch_scan_codes.py, which holds the
plain versions against vaq_tpu's Pallas kernels on the CPU. Tolerances: K1's
scores keep only 23 − idx_bits mantissa bits, so they agree to 1e-5 plus one
packed-key step, 2^(idx_bits − 23) relative, and window winners agree
except where two rows tie within that; K2 sums squares: rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from vaq_tpu_torch.ops import scan_codes

# (M, C, L, n, block_rows), tests/test_scan_pallas.py:147-148
GEOMETRIES = [(8, 16, 4, 1024, 16), (32, 256, 4, 4096, 64),
              (16, 4, 8, 1024, 16)]


def make_inputs(geom, seed=31, nq=4):
    m, c, l, n, _ = geom
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((m, c, l)).astype(np.float32)
    codes = rng.integers(0, c, (n, m)).astype(np.uint8)
    qp = rng.standard_normal((nq, m * l)).astype(np.float32)
    return cents, codes, qp


def _k1_rtol(block_rows):
    return 1e-5 + 2.0 ** ((block_rows - 1).bit_length() - 23)


def _k1_score64(cents, codes, qp, q_idx, row_ids):
    """The K1 quantity in f64 for given (query, row) pairs: bf16-rounded
    decode, bf16 query in the dot, f32 query in ‖q‖²."""
    table = scan_codes.build_decode_table(cents).double().numpy()
    m, c, l = cents.shape
    x = table.reshape(c, m, l)[codes[row_ids].astype(np.int64),
                               np.arange(m)].reshape(len(row_ids), -1)
    qb = torch.as_tensor(qp).to(torch.bfloat16).double().numpy()[q_idx]
    qn = (qp.astype(np.float64) ** 2).sum(1)[q_idx]
    return (x * x).sum(1) - 2 * (x * qb).sum(1) + qn


def assert_windows_match(cents, codes, qp, s_a, i_a, s_b, i_b, block_rows):
    """Two K1 results agree: scores to the packed-key tolerance, and where
    the winning rows differ, the two rows score the same in f64."""
    s_a, i_a, s_b, i_b = (np.asarray(t) for t in (s_a, i_a, s_b, i_b))
    rtol = _k1_rtol(block_rows)
    np.testing.assert_allclose(s_a, s_b, rtol=rtol, atol=1e-6)
    q_idx, w_idx = np.nonzero(i_a != i_b)
    if len(q_idx):  # only ties may pick different rows
        a = _k1_score64(cents, codes, qp, q_idx, i_a[q_idx, w_idx])
        b = _k1_score64(cents, codes, qp, q_idx, i_b[q_idx, w_idx])
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6)
    assert len(q_idx) <= 0.01 * i_a.size


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run python3 chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("geom", GEOMETRIES + [
    (32, 256, 4, 100_000, 128),   # windows span two 64-row tiles
    (8, 16, 4, 1000, 24),         # ragged n, windows not tile-aligned
    (512, 4, 1, 2000, 1),         # > 48 KB shared memory, one-row windows
])
def test_decode_window_scan_kernel_matches_plain(cuda, geom):
    cents, codes, qp = make_inputs(geom, nq=70)
    br = geom[4]
    table = scan_codes.build_decode_table(cents, cuda)
    c, q = torch.as_tensor(codes, device=cuda), torch.as_tensor(qp, device=cuda)
    before = scan_codes.decode_window_scan.launches
    s_k, i_k = scan_codes.decode_window_scan(c, table, q, br)
    torch.cuda.synchronize()
    assert scan_codes.decode_window_scan.launches == before + 1
    s_r, i_r = scan_codes.decode_window_scan_ref(c, table, q, br)
    assert_windows_match(cents, codes, qp, s_k.cpu(), i_k.cpu(), s_r.cpu(),
                         i_r.cpu(), br)


@pytest.mark.gpu
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_decode_rescore_kernel_matches_plain(cuda, geom):
    cents, codes, qp = make_inputs(geom, nq=9)
    rng = np.random.default_rng(1)
    cand = rng.integers(-1, geom[3], (9, 40)).astype(np.int32)
    args = (torch.as_tensor(codes, device=cuda),
            torch.as_tensor(cand, device=cuda),
            scan_codes.build_decode_rows(cents, cuda),
            torch.as_tensor(qp, device=cuda))
    got = scan_codes.decode_rescore(*args)
    torch.cuda.synchronize()
    ref = scan_codes.decode_rescore_ref(*args)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
