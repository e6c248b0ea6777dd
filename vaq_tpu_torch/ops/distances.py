"""Exact L2 distances and brute-force top-k search.

The counterpart of ``vaq_tpu/ops/distances.py:25-75``: every L2 computation is
the matmul identity ``‖q−x‖² = ‖q‖² − 2·q·xᵀ + ‖x‖²`` in full f32 (the
package's precision policy keeps TF32 off). ``exact_search`` doubles as the
groundtruth generator; it walks the database in row blocks with a running
top-k, so the (nq, n) distance matrix never exists whole (2 GB at nq=512,
n=1M in f32).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vaq_tpu_torch.device import DEFAULT, resolve

# Database rows per block of exact_search (a block of 1000 queries' f32
# distances is 512 MB).
BLOCK_ROWS = 131072


def pairwise_sq_dists(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(nq, d) × (n, d) → (nq, n) squared L2, clamped at 0."""
    qn = torch.sum(q * q, dim=1, keepdim=True)
    xn = torch.sum(x * x, dim=1)
    d2 = qn - 2.0 * (q @ x.T) + xn[None, :]
    return torch.clamp_min(d2, 0.0)


def merge_topk(best_d: torch.Tensor, best_i: torch.Tensor, d: torch.Tensor,
               ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a block's (nq, b) distances with ids into the running ascending
    (nq, k) best. Ties may come out in any order (``torch.topk`` does not
    promise the lower-index-first order of ``jax.lax.top_k``)."""
    cand_d = torch.cat([best_d, d], dim=1)
    cand_i = torch.cat([best_i, ids], dim=1)
    top_d, pos = torch.topk(cand_d, k, dim=1, largest=False, sorted=True)
    return top_d, torch.gather(cand_i, 1, pos)


def exact_search(queries: torch.Tensor, db: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 top-k: blocked f32 matmul + streaming top-k merge.

    queries (nq, d) and db (n, d) f32 on one device. Returns (sq_dists
    (nq, k) f32 ascending, labels (nq, k) int32); rows past n are absent, so
    k > n leaves +inf / -1 entries, as in the JAX version.
    """
    n = db.shape[0]
    nq = queries.shape[0]
    dev = queries.device
    qn = torch.sum(queries * queries, dim=1, keepdim=True)
    best_d = torch.full((nq, k), float("inf"), device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, n, BLOCK_ROWS):
        blk = db[start:start + BLOCK_ROWS]
        xn = torch.sum(blk * blk, dim=1)
        d2 = qn - 2.0 * (queries @ blk.T) + xn[None, :]
        ids = torch.arange(start, start + blk.shape[0], dtype=torch.int32,
                           device=dev).expand(nq, -1)
        best_d, best_i = merge_topk(best_d, best_i, d2, ids, k)
    return torch.clamp_min(best_d, 0.0), best_i


def compute_groundtruth(queries, db, k: int,
                        device: torch.device | str = DEFAULT) -> np.ndarray:
    """Brute-force groundtruth labels (host arrays in, host labels out),
    computed on ``device``."""
    dev = resolve(device)
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    x = torch.as_tensor(np.asarray(db, np.float32), device=dev)
    _, labels = exact_search(q, x, k)
    return labels.cpu().numpy()
