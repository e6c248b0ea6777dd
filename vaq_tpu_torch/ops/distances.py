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
from vaq_tpu_torch.ops.scan_codes import _ordered, _select_lowest

# Database rows per block of exact_search (a block of 1000 queries' f32
# distances is 512 MB).
BLOCK_ROWS = 131072
# Entries a block keeps past the k it may contribute (lowest_over_blocks):
# more than this many equal values at a block's k-th place send the scan to
# its tie-exact form.
TIE_SLACK = 8


def pairwise_sq_dists(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(nq, d) × (n, d) → (nq, n) squared L2, clamped at 0."""
    qn = torch.sum(q * q, dim=1, keepdim=True)
    xn = torch.sum(x * x, dim=1)
    d2 = qn - 2.0 * (q @ x.T) + xn[None, :]
    return torch.clamp_min(d2, 0.0)


def lowest_over_blocks(blocks, k: int, carry=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k lowest entries of rows that come in column blocks, ascending,
    ties to the lower id: ``jax.lax.top_k(−x)``'s set and order over the
    whole row, as the JAX package's running merge keeps them.

    ``blocks()`` yields (scores (nq, b) f32, id of its first column) for
    each block, ids rising from block to block; ``carry`` (values, int32
    ids ≥ −1) stands before the first block, as the JAX merge's initial
    best does. Each block keeps its ``k + TIE_SLACK`` lowest by one
    ``torch.topk``, which may pick any of equal values; where its k-th kept
    value is below its last kept one in every row, the block's k lowest by
    (value, id) are all kept whatever topk picked among ties, and one sort
    of the kept entries by (value in IEEE total order, id) gives the
    result. Where a tie group reaches the last kept place (read once per
    scan), the scan runs again with each block's k lowest taken tie-exact
    (``scan_codes._select_lowest``)."""
    for exact in (False, True):
        straddle = None
        vals, ids = ([carry[0]], [carry[1]]) if carry is not None else ([], [])
        for scores, first in blocks():
            width = scores.shape[1]
            if exact:
                v, pos = _select_lowest(scores, min(k, width))
            else:
                kb = min(k + TIE_SLACK, width)
                v, pos = torch.topk(scores, kb, dim=1, largest=False,
                                    sorted=True)
                if kb < width:
                    tie = torch.any(v[:, k - 1] == v[:, kb - 1])
                    straddle = tie if straddle is None else straddle | tie
            vals.append(v)
            ids.append((pos + first).to(torch.int32))
        if exact or straddle is None or not bool(straddle):
            break
    v = torch.cat(vals, dim=1)
    i = torch.cat(ids, dim=1)
    key = (_ordered(v).to(torch.int64) << 32) | (i.to(torch.int64) + 1)
    order = torch.sort(key, dim=1).indices[:, :k]
    return torch.gather(v, 1, order), torch.gather(i, 1, order)


def exact_search(queries: torch.Tensor, db: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 top-k: blocked f32 matmul, each block's lowest kept, ties to
    the lower id as in the JAX version's running merge.

    queries (nq, d) and db (n, d) f32 on one device. Returns (sq_dists
    (nq, k) f32 ascending, labels (nq, k) int32); rows past n are absent, so
    k > n leaves +inf / -1 entries, as in the JAX version.
    """
    n = db.shape[0]
    nq = queries.shape[0]
    dev = queries.device
    qn = torch.sum(queries * queries, dim=1, keepdim=True)

    def blocks():
        for start in range(0, n, BLOCK_ROWS):
            blk = db[start:start + BLOCK_ROWS]
            xn = torch.sum(blk * blk, dim=1)
            yield qn - 2.0 * (queries @ blk.T) + xn[None, :], start

    best_d, best_i = lowest_over_blocks(blocks, k, (
        torch.full((nq, k), float("inf"), device=dev),
        torch.full((nq, k), -1, dtype=torch.int32, device=dev)))
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
