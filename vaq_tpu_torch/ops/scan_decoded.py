"""Decoded-database scan: ADC distances as one matmul per row block.

The counterpart of ``vaq_tpu/ops/scan_decoded.py`` (the bf16 tier :48-76,
213-293 and the int8 tier :80-210). The subspaces partition the projected
dimensions, so the ADC distance is exact in decoded form,
``Σ_s ‖q_s − C_s[code_s]‖² = ‖q − decode(x)‖²``. Rows are stored decoded, in
bf16 or (the int8 tier) as int8 with one scale per dimension, with exact f32
norms; the scan ranks by the monotone score ``2·q·x̂ − ‖x̂‖²`` with a bf16
query (for int8 rows the scales are folded into the query first),
over-fetches ``max(2k, k+16)`` candidates and rescores them exactly in f32.

No hand-written kernel sits on this path: it is a plain GEMM plus top-k, as
the JAX version leaves it to XLA. Where the JAX version takes
``approx_max_k``, this port takes an exact top-k (the JAX ``exact=True``
semantics), and it scans in row blocks with a running top-k, so the (nq, n)
f32 score matrix (2 GB at nq=512, n=1M) never exists whole. Every selection
breaks ties as ``jax.lax.top_k`` does, to the lower position: the blocked
scan through ``distances.lowest_over_blocks`` (each block's ``torch.topk``
with a margin, one tie-exact sort of what the blocks kept), the exact
rescores through ``scan_codes._select_lowest``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vaq_tpu_torch.ops.distances import lowest_over_blocks
from vaq_tpu_torch.ops.scan_codes import _select_lowest

# Rows per block of the decode and of the scan: bounds the f32 transients
# (a 65536-row block of 512 queries' scores is 128 MB).
BLOCK_ROWS = 65536


def decode_db(codes: torch.Tensor, centroids: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize decoded rows (bf16) + f32 squared norms.

    codes (n, M) ints, row-major; centroids (M, C, L) f32 on the same device.
    Returns (decoded (n, M·L) bf16, norms (n,) f32), the norms taken over the
    f32 rows before the bf16 rounding, as in the JAX version.
    """
    n, m = codes.shape
    _, _, l = centroids.shape
    sub = torch.arange(m, device=codes.device)
    dec = torch.empty((n, m * l), dtype=torch.bfloat16, device=codes.device)
    norms = torch.empty((n,), dtype=torch.float32, device=codes.device)
    for start in range(0, n, BLOCK_ROWS):
        blk = codes[start:start + BLOCK_ROWS].to(torch.int64)
        rows = centroids[sub[None, :], blk].reshape(blk.shape[0], m * l)
        norms[start:start + blk.shape[0]] = torch.sum(rows * rows, dim=1)
        dec[start:start + blk.shape[0]] = rows.to(torch.bfloat16)
    return dec, norms


def _rescore_exact(qp: torch.Tensor, decoded: torch.Tensor, idx: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 distances for the selected candidates + ascending sort."""
    rows = decoded[torch.clamp_min(idx, 0).to(torch.int64)].to(torch.float32)
    diff = qp[:, None, :] - rows
    d2 = torch.sum(diff * diff, dim=2)
    d2 = torch.where(idx >= 0, d2, torch.inf)
    top, pos = _select_lowest(d2, k)
    return torch.clamp_min(top, 0.0), torch.gather(idx, 1, pos)


def _scan_topk(rows: torch.Tensor, norms: torch.Tensor, q32: torch.Tensor,
               kk: int) -> torch.Tensor:
    """Row ids of the kk best ``2·q·x − ‖x‖²`` scores, scanned in row blocks
    (``distances.lowest_over_blocks`` of the negated scores, ``‖x‖² −
    2·q·x``: IEEE rounds a − b to −(b − a), so only the sign of a zero score
    differs), ties to the lower id; −1 where a score is −inf (a tombstoned
    row).

    rows (n, D) bf16 or int8, upcast to f32 per block; q32 (nq, D) f32 with
    bf16 values. JAX asks for f32 GEMM output (preferred_element_type); a
    bf16×bf16 torch.matmul would return bf16 and rounding the scores to 8
    mantissa bits would reorder the over-fetch. So both operands run in f32:
    products of bf16 (and int8) values are exact in f32, so only the
    summation order differs from JAX."""
    n = rows.shape[0]

    def blocks():
        for start in range(0, n, BLOCK_ROWS):
            blk = rows[start:start + BLOCK_ROWS].to(torch.float32)
            yield norms[None, start:start + blk.shape[0]] - 2.0 * (q32 @ blk.T), start

    neg, best_i = lowest_over_blocks(blocks, kk)
    # tombstoned rows carry -inf scores; never let the exact rescore
    # resurrect them
    return torch.where(torch.isfinite(neg), best_i, -1)


def decoded_scan_topk(
    decoded: torch.Tensor,
    norms: torch.Tensor,
    queries_proj: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked scan + top-k over the decoded database.

    decoded (n, D) bf16; norms (n,) f32 (+inf marks tombstoned rows);
    queries_proj (nq, D) f32. Returns (sq_dists (nq, k) f32 exact,
    labels (nq, k) int32), ascending; -1 / +inf where fewer than k rows live.
    """
    n = decoded.shape[0]
    kk = min(max(2 * k, k + 16), n)
    q32 = queries_proj.to(torch.bfloat16).to(torch.float32)
    idx = _scan_topk(decoded, norms, q32, kk)
    if kk < k:
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return _rescore_exact(queries_proj, decoded, idx, k)


def int8_dim_scales(centroids) -> torch.Tensor:
    """(D,) f32 per-dimension int8 scales ``127 / max_c |centroid|`` over the
    (M, C, L) padded codebooks, sentinel rows (|v| ≥ 1e17) left out
    (scan_decoded.py:105-107, ivf.py:209-213): ``x ≈ int8 / scale``. On the
    centroids' device when given a tensor, else on the CPU."""
    cents = torch.as_tensor(centroids, dtype=torch.float32)
    fin = torch.where(cents.abs() < 1e17, cents.abs(), 0.0)
    dim_max = torch.amax(fin, dim=1).reshape(-1)
    # tensor / tensor: ``127.0 / t`` is reciprocal-then-multiply in torch,
    # one ulp off the IEEE quotient that JAX (and numpy) return
    return torch.full_like(dim_max, 127.0) / torch.clamp_min(dim_max, 1e-30)


def quantize_int8(rows: torch.Tensor, dim_scales: torch.Tensor
                  ) -> torch.Tensor:
    """``clip(round(rows · scales), ±127)`` as int8; round-half-even, as
    ``jnp.round``."""
    q = torch.round(rows.to(torch.float32) * dim_scales[None, :])
    return torch.clamp(q, -127, 127).to(torch.int8)


def decode_db_int8(codes: torch.Tensor, centroids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 tier's rows (``scan_decoded.py:80-132``): the f32 decode
    quantized per dimension.

    codes (n, M) row-major; centroids (M, C, L) f32 on the same device.
    Returns (decoded8 (n, D) int8 row-major — the JAX (D, n) layout was a
    TPU tile workaround —, dim_scales (D,) f32 with x ≈ decoded8 / scales,
    norms (n,) f32 of the f32 decode)."""
    n, m = codes.shape
    _, _, l = centroids.shape
    scales = int8_dim_scales(centroids)
    sub = torch.arange(m, device=codes.device)
    dec = torch.empty((n, m * l), dtype=torch.int8, device=codes.device)
    norms = torch.empty((n,), dtype=torch.float32, device=codes.device)
    for start in range(0, n, BLOCK_ROWS):
        blk = codes[start:start + BLOCK_ROWS].to(torch.int64)
        rows = centroids[sub[None, :], blk].reshape(blk.shape[0], m * l)
        norms[start:start + blk.shape[0]] = torch.sum(rows * rows, dim=1)
        dec[start:start + blk.shape[0]] = quantize_int8(rows, scales)
    return dec, scales, norms


def decoded8_scan_topk(
    decoded8: torch.Tensor,
    dim_scales: torch.Tensor,
    norms: torch.Tensor,
    queries_proj: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 tier's scan (``scan_decoded.py:136-210``, ``exact=True``):
    per-dim scales folded into the query, which is rounded to bf16; an f32
    scan over the int8 rows; an exact top-2k over-fetch; exact f32 rescore
    of the winners from the dequantized int8 rows.

    decoded8 (n, D) int8; dim_scales (D,); norms (n,) f32 (+inf marks
    tombstoned rows); queries_proj (nq, D) f32. Returns (sq_dists (nq, k)
    f32, labels (nq, k) int32), ascending; -1 / +inf where fewer than k rows
    live. JAX's score-derived distances above 16M rows are not carried over:
    the rescore is always exact."""
    n = decoded8.shape[0]
    kk = min(max(2 * k, k + 16), n)
    q32 = (queries_proj / dim_scales[None, :]).to(torch.bfloat16)
    idx = _scan_topk(decoded8, norms, q32.to(torch.float32), kk)
    if kk < k:
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    rows = decoded8[torch.clamp_min(idx, 0).to(torch.int64)].to(torch.float32)
    diff = queries_proj[:, None, :] - rows / dim_scales[None, None, :]
    d2 = torch.where(idx >= 0, torch.sum(diff * diff, dim=2), torch.inf)
    top, pos = _select_lowest(d2, k)
    return torch.clamp_min(top, 0.0), torch.gather(idx, 1, pos)


def decoded_search_e2e(
    queries: torch.Tensor,
    eigvecs_td: torch.Tensor,
    decoded: torch.Tensor,
    norms: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project queries → decoded scan → top-k (the serving hot path).

    queries (nq, d) raw f32; eigvecs_td (d, total_dim) rotation slice.
    """
    qp = queries @ eigvecs_td
    return decoded_scan_topk(decoded, norms, qp, k)
