"""Port parity: the codes tier (kernels K1 ``decode_window_scan`` and K2
``decode_rescore``, and ``decode_scan_topk``) of vaq_tpu_torch against the
Pallas kernels of vaq_tpu run with ``interpret=True``, on the same seeded
inputs, at the three geometries of tests/test_scan_pallas.py.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
are held against those versions by tests/test_torch_kernels_gpu.py.

Tolerances: K1's scores keep only 23 − idx_bits mantissa bits (the rest hold
the row index), and the two sides sum the dot in different orders, so
scores agree to 1e-5 plus one step of the packed key, 2^(idx_bits − 23)
relative; window winners agree except where two rows tie within that.
K2 and the rescored top-k are sums of squares: rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels_gpu import (GEOMETRIES, assert_windows_match,
                                    make_inputs)
from test_torch_scan_decoded import assert_topk_match
from vaq_tpu.ops import scan_pallas
from vaq_tpu_torch import _build
from vaq_tpu_torch.ops import scan_codes

torch.set_num_threads(2)  # six test workers share the host


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_decode_window_scan_plain_matches_jax(geom):
    cents, codes, qp = make_inputs(geom)
    br = geom[4]
    table_j, _ = scan_pallas.build_decode_table(cents)
    s_j, i_j = scan_pallas.decode_window_scan(
        jnp.asarray(codes.T.copy()), table_j, jnp.asarray(qp),
        block_rows=br, q_tile=8, interpret=True)
    s_t, i_t = scan_codes.decode_window_scan(
        torch.as_tensor(codes), scan_codes.build_decode_table(cents, "cpu"),
        torch.as_tensor(qp), br)
    assert s_t.dtype == torch.float32 and i_t.dtype == torch.int32
    assert s_t.shape == (qp.shape[0], codes.shape[0] // br)
    assert_windows_match(cents, codes, qp, s_t, i_t, s_j, i_j, br)


@pytest.mark.parametrize("block_rows", [16, 32, 64, 128, 256, 512])
def test_decode_window_scan_plain_every_window_size_matches_jax(block_rows):
    """Every power of two from 16 to 512 rows, the window sizes the codes
    tier takes (the sharded tier's per-shard rule among them: 32 rows at 4
    shards of 1M, k = 100)."""
    n = 8 * max(128, block_rows)           # JAX's grid: 8 windows a cell
    geom = (8, 16, 4, n, block_rows)
    cents, codes, qp = make_inputs(geom, seed=block_rows)
    table_j, _ = scan_pallas.build_decode_table(cents)
    s_j, i_j = scan_pallas.decode_window_scan(
        jnp.asarray(codes.T.copy()), table_j, jnp.asarray(qp),
        block_rows=block_rows, q_tile=8, interpret=True)
    s_t, i_t = scan_codes.decode_window_scan(
        torch.as_tensor(codes), scan_codes.build_decode_table(cents, "cpu"),
        torch.as_tensor(qp), block_rows)
    assert s_t.shape == (qp.shape[0], n // block_rows)
    assert_windows_match(cents, codes, qp, s_t, i_t, s_j, i_j, block_rows)


def test_decode_window_scan_ragged_rows_decode_as_code_zero():
    """n not a multiple of block_rows: the last window's missing rows count
    as code 0, exactly as JAX's zero-padded codes do."""
    geom = (8, 16, 4, 1000, 64)
    cents, codes, qp = make_inputs(geom, seed=3)
    padded = np.zeros((1024, 8), np.uint8)
    padded[:1000] = codes
    table_j, _ = scan_pallas.build_decode_table(cents)
    s_j, i_j = scan_pallas.decode_window_scan(
        jnp.asarray(padded.T.copy()), table_j, jnp.asarray(qp),
        block_rows=64, q_tile=8, interpret=True)
    s_t, i_t = scan_codes.decode_window_scan(
        torch.as_tensor(codes), scan_codes.build_decode_table(cents, "cpu"),
        torch.as_tensor(qp), 64)
    assert s_t.shape == (4, 16)
    assert_windows_match(cents, padded, qp, s_t, i_t, s_j, i_j, 64)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_decode_rescore_plain_matches_jax(geom):
    """K2's fused form (codes + candidate ids + per-query rows) against the
    JAX kernel fed the gathered codes and the broadcast queries."""
    m, c, l, n, _ = geom
    cents, codes, qp = make_inputs(geom, seed=32)
    rng = np.random.default_rng(33)
    cand = rng.integers(0, n, (qp.shape[0], 25)).astype(np.int32)
    cand[:, -2:] = -1
    rows_j = scan_pallas.build_decode_rows(cents)
    flat = np.maximum(cand, 0).reshape(-1)
    q_rep = np.repeat(qp, cand.shape[1], axis=0)
    ref = np.asarray(scan_pallas.decode_rescore(
        jnp.asarray(codes[flat]), rows_j, jnp.asarray(q_rep),
        interpret=True)).reshape(cand.shape)
    got = scan_codes.decode_rescore(
        torch.as_tensor(codes), torch.as_tensor(cand),
        scan_codes.build_decode_rows(cents, "cpu"), torch.as_tensor(qp)).numpy()
    assert np.isinf(got[:, -2:]).all()
    np.testing.assert_allclose(got[:, :-2], ref[:, :-2], rtol=1e-5)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_decode_scan_topk_matches_jax(geom):
    cents, codes, qp = make_inputs(geom)
    br = geom[4]
    table_j, _ = scan_pallas.build_decode_table(cents)
    d_j, i_j = scan_pallas.decode_scan_topk(
        jnp.asarray(codes.T.copy()), table_j,
        scan_pallas.build_decode_rows(cents), jnp.asarray(qp), 10,
        block_rows=br, q_tile=8, interpret=True)
    d_t, i_t = scan_codes.decode_scan_topk(
        torch.as_tensor(codes), scan_codes.build_decode_table(cents, "cpu"),
        scan_codes.build_decode_rows(cents, "cpu"), torch.as_tensor(qp), 10,
        block_rows=br)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)
    # and the true top-1 row wins (test_scan_pallas.py:166)
    m, c, l, n, _ = geom
    xhat = cents[np.arange(m)[None, :], codes].reshape(n, m * l)
    full = ((qp[:, None, :] - xhat[None, :, :]) ** 2).sum(2)
    np.testing.assert_array_equal(i_t[:, 0].numpy(), full.argmin(1))


def test_decode_scan_topk_fewer_windows_than_k():
    """kk = min(2k, windows) < k: the tail is −1 / +inf, as in JAX."""
    geom = (8, 16, 4, 256, 64)
    cents, codes, qp = make_inputs(geom, seed=5)
    d_t, i_t = scan_codes.decode_scan_topk(
        torch.as_tensor(codes), scan_codes.build_decode_table(cents, "cpu"),
        scan_codes.build_decode_rows(cents, "cpu"), torch.as_tensor(qp), 6,
        block_rows=64)
    assert (i_t[:, 4:] == -1).all() and torch.isinf(d_t[:, 4:]).all()
    assert (i_t[:, :4] >= 0).all()


def test_decode_tables_match_jax():
    """bf16 table = the JAX packed pairs unpacked; f32 rows = the JAX rows
    (minus its 8-row padding); ≥1e30 sentinels zeroed, 1e18 kept."""
    rng = np.random.default_rng(9)
    cents = rng.standard_normal((4, 6, 2)).astype(np.float32)
    cents[1, 4] = 1e18
    cents[2, 5] = 3e31
    packed, _ = scan_pallas.build_decode_table(cents)
    u32 = np.asarray(packed).view(np.uint32)[:3]
    pairs = np.stack([u32 & 0xFFFF, u32 >> 16], axis=1).reshape(6, 8)
    want = (pairs.astype(np.uint32) << 16).view(np.float32)
    table = scan_codes.build_decode_table(cents, "cpu")
    np.testing.assert_array_equal(table.float().numpy(), want)
    rows = scan_codes.build_decode_rows(cents, "cpu")
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(scan_pallas.build_decode_rows(cents))[:6])
    assert rows[4, 2] == 1e18 and rows[5, 4] == 0.0


def test_wrappers_check_inputs_and_count_only_launches():
    cents, codes, qp = make_inputs(GEOMETRIES[0])
    table = scan_codes.build_decode_table(cents, "cpu")
    rows = scan_codes.build_decode_rows(cents, "cpu")
    c, q = torch.as_tensor(codes), torch.as_tensor(qp)
    cand = torch.zeros((4, 3), dtype=torch.int32)
    before = (scan_codes.decode_window_scan.launches,
              scan_codes.decode_rescore.launches)
    scan_codes.decode_window_scan(c, table, q, 16)
    scan_codes.decode_rescore(c, cand, rows, q)
    # the CPU runs the plain versions: no kernel launched, nothing counted
    assert (scan_codes.decode_window_scan.launches,
            scan_codes.decode_rescore.launches) == before
    with pytest.raises(ValueError, match="uint8"):
        scan_codes.decode_window_scan(c.to(torch.int32), table, q, 16)
    with pytest.raises(ValueError, match="bfloat16"):
        scan_codes.decode_window_scan(c, rows, q, 16)
    with pytest.raises(ValueError, match="contiguous"):
        scan_codes.decode_window_scan(c, table, q.T.contiguous().T, 16)
    with pytest.raises(ValueError, match="disagree"):
        scan_codes.decode_window_scan(c[:, :5].contiguous(), table, q, 16)
    with pytest.raises(ValueError, match="int32"):
        scan_codes.decode_rescore(c, cand.long(), rows, q)
    with pytest.raises(ValueError, match="nq"):
        scan_codes.decode_rescore(c, cand[:2], rows, q)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        scan_codes.decode_window_scan(c.to(meta), table.to(meta),
                                      q.to(meta), 16)


def test_k1_tile_fits_the_shared_memory():
    """K1's block geometry: as few query chunks as fit, each of equal runs
    of whole 128-query sub-tiles; the decode table in shared memory where
    that costs no extra chunk (C = 256 at 130 queries, not at 512, which
    stay one chunk and read the table from global memory); the depth sliced,
    and the table read from global memory, only where one sub-tile at the
    whole depth does not fit."""
    tile = scan_codes._k1_tile
    assert tile(512, 32, 256, 128) == (512, 128, False, 221696)
    assert tile(130, 32, 256, 128)[:3] == (256, 128, True)
    assert tile(600, 32, 256, 128)[:3] == (384, 128, False)    # 2 chunks
    assert tile(2000, 24, 256, 96)[:3] == (512, 96, True)      # 4 chunks
    assert tile(70, 6, 16, 30)[:3] == (128, 32, True)          # d → 32
    assert tile(70, 512, 4, 512)[:3] == (128, 80, False)       # sliced
    for args in ((512, 32, 256, 128), (70, 512, 4, 512), (40, 128, 16, 512),
                 (600, 24, 256, 96)):
        assert tile(*args)[3] <= scan_codes._SMEM_LIMIT


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: a clear build error, never a silent fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build._nvcc()


def test_library_path_follows_the_sources(monkeypatch, tmp_path):
    """The build is keyed by the sources: an edit names a new library."""
    for p in _build.sources():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    assert first.parent == _build.BUILD_DIR
    (tmp_path / "decode_rescore.cu").write_text("// edited\n")
    assert _build.library_path() != first
    assert {p.name for p in _build.sources()} == {
        "decode_window_scan.cu", "decode_rescore.cu",
        "groupmin_window_scan.cu", "gather_rescore.cu",
        "fast4_window_scan.cu", "hamming_scan.cu", "decoded_topk_scan.cu"}
