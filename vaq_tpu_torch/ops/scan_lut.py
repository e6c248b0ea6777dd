"""LUT-side search pieces: the LUT build, its u8 quantization, the LUT
gather scan and the exact refine.

The counterpart of ``vaq_tpu/ops/scan_jax.py``:

- ``build_luts`` (scan_jax.py:36-55, reference ``VAQ::CreateLUT``,
  VAQ.hpp:127-180): ``lut[q, s, c] = ‖q_s − C_{s,c}‖²`` for a query batch;
- ``quantize_luts`` (scan_jax.py:58-64, reference smallQuantize,
  utils/Math.hpp:215-224): the learned per-subspace u8 quantization;
- ``adc_scan_topk`` (scan_jax.py:79-130): the LUT gather scan with a running
  top-k merge, behind ``backend="lut_gather"``. It is no Pallas kernel in
  the JAX package either, so it stays plain PyTorch on the card;
- ``refine_topk`` (scan_jax.py:133-153, reference VAQ::refine,
  VAQ.cpp:849-876).

The running top-k merge and the refine select with
``scan_codes._select_lowest``, which breaks ties toward the lower position
as ``jax.lax.top_k(−x)`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vaq_tpu_torch.ops.scan_codes import _select_lowest, lut_sums


def build_luts(queries_proj: torch.Tensor, centroids: torch.Tensor
               ) -> torch.Tensor:
    """lut[q, s, c] = ‖q_s − C_{s,c}‖² for the whole query batch.

    queries_proj (nq, M·L) projected queries; centroids (M, C, L) padded
    codebooks on the same device (padded rows hold a large sentinel, so they
    are never competitive). Returns (nq, M, C) f32. The product runs in full
    f32: the package turns TF32 off at import.
    """
    nq = queries_proj.shape[0]
    m, c, l = centroids.shape
    q = queries_proj.reshape(nq, m, l)
    qc = torch.einsum("qml,mcl->qmc", q, centroids)
    q2 = torch.sum(q * q, dim=2)[:, :, None]
    c2 = torch.sum(centroids * centroids, dim=2)[None, :, :]
    return q2 - 2.0 * qc + c2


def quantize_luts(luts: torch.Tensor, offsets: torch.Tensor,
                  scales: torch.Tensor) -> torch.Tensor:
    """u8-quantize a LUT batch with the learned per-subspace offset and
    scale: ``floor((lut − off)·scale)`` clipped to [0, 255]."""
    q = (luts - offsets[None, :, None]) * scales[None, :, None]
    q = torch.clamp(torch.floor(q), 0.0, 255.0)
    return q.to(torch.uint8)


def adc_scan_topk(codes: torch.Tensor, luts: torch.Tensor, k: int,
                  n_valid: Optional[int] = None, block_rows: int = 32768
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan all code rows against per-query LUTs; top-k per query.

    codes (n, M) integer codes; luts (nq, M, C) f32 on the same device.
    Rows at or past ``n_valid`` get +inf. Rows go in blocks of
    ``block_rows``; each block's sums are added one subspace at a time
    into one (nq, block) buffer (JAX gathers an (M, block, nq) block
    first, 4.3 GB at M = 64, 32768 rows, 512 queries) and merged into the
    running best k by ``_select_lowest``, the running best first, so ties
    keep the lower row as JAX's merge does. Returns (sq_dists (nq, k) f32 ascending,
    labels (nq, k) int32, −1 where fewer than k rows were valid).
    """
    n = codes.shape[0]
    nq = luts.shape[0]
    dev = luts.device
    n_valid = n if n_valid is None else int(n_valid)
    block_rows = min(block_rows, n)
    best_d = torch.full((nq, k), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, n, block_rows):
        blk = codes[start:start + block_rows]
        # the ragged last block is zero-padded, as in JAX; its padded rows
        # sit past n ≥ n_valid and score +inf
        blk = torch.nn.functional.pad(blk, (0, 0, 0, block_rows - blk.shape[0]))
        d = lut_sums(blk, luts.to(torch.float32))
        ids = torch.arange(start, start + block_rows, dtype=torch.int32,
                           device=dev)
        d = torch.where(ids[None, :] < n_valid, d, torch.inf)
        best_d, pos = _select_lowest(torch.cat([best_d, d], dim=1), k)
        best_i = torch.gather(
            torch.cat([best_i, ids.expand(nq, -1)], dim=1), 1, pos)
    return best_d, best_i


def refine_topk(queries: torch.Tensor, db_candidates: torch.Tensor,
                cand_labels: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact rerank of R candidates per query: recompute exact squared L2
    in f32 and keep the k best.

    queries (nq, d) original-space; db_candidates (nq, R, d) gathered rows;
    cand_labels (nq, R) their global ids (−1 marks padding, never kept
    ahead of a real row).
    """
    diff = queries[:, None, :] - db_candidates
    d2 = torch.sum(diff * diff, dim=2)
    d2 = torch.where(cand_labels >= 0, d2, torch.inf)
    top, pos = _select_lowest(d2, k)
    return top, torch.gather(cand_labels, 1, pos)
