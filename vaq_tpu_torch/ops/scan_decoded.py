"""Decoded-database scan: ADC distances as one matmul per row block.

The counterpart of ``vaq_tpu/ops/scan_decoded.py:48-76, 213-293``. The
subspaces partition the projected dimensions, so the ADC distance is exact in
decoded form, ``Σ_s ‖q_s − C_s[code_s]‖² = ‖q − decode(x)‖²``. Rows are stored
decoded in bf16 with exact f32 norms; the scan ranks by the monotone score
``2·q·x̂ − ‖x̂‖²`` with a bf16 query, over-fetches ``max(2k, k+16)``
candidates and rescores them exactly in f32.

No hand-written kernel sits on this path: it is a plain GEMM plus top-k, as
the JAX version leaves it to XLA. Where the JAX version takes
``approx_max_k``, this port takes an exact ``torch.topk`` (the JAX
``exact=True`` semantics), and it scans in row blocks with a running top-k,
so the (nq, n) f32 score matrix (2 GB at nq=512, n=1M) never exists whole.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vaq_tpu_torch.ops.distances import merge_topk

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
    top, pos = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return torch.clamp_min(top, 0.0), torch.gather(idx, 1, pos)


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
    nq = queries_proj.shape[0]
    dev = decoded.device
    kk = min(max(2 * k, k + 16), n)
    # bf16 GEMM output: torch.matmul of two bf16 tensors returns bf16, and
    # rounding the scores to 8 mantissa bits would reorder the over-fetch.
    # JAX asks for f32 output (preferred_element_type). This port upcasts
    # both bf16 operands to f32 and runs the full-f32 GEMM: products of bf16
    # values are exact in f32, so only the summation order differs from JAX.
    q32 = queries_proj.to(torch.bfloat16).to(torch.float32)
    best_s = torch.full((nq, 0), -torch.inf, device=dev)
    best_i = torch.full((nq, 0), -1, dtype=torch.int32, device=dev)
    for start in range(0, n, BLOCK_ROWS):
        blk = decoded[start:start + BLOCK_ROWS].to(torch.float32)
        score = 2.0 * (q32 @ blk.T) - norms[None, start:start + blk.shape[0]]
        ids = torch.arange(start, start + blk.shape[0], dtype=torch.int32,
                           device=dev).expand(nq, -1)
        # merge_topk keeps the smallest; negate to keep the largest scores
        neg, best_i = merge_topk(-best_s, best_i, -score, ids,
                                 min(kk, best_s.shape[1] + blk.shape[0]))
        best_s = -neg
    # tombstoned rows carry -inf scores; never let the exact rescore
    # resurrect them
    idx = torch.where(torch.isfinite(best_s), best_i, -1)
    if kk < k:
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return _rescore_exact(queries_proj, decoded, idx, k)


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
