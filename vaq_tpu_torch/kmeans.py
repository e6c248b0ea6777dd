"""K-means — batched Lloyd iterations on the device.

The counterpart of ``vaq_tpu/kmeans.py:33-190`` (reference
``bitvecengine/KMeans.hpp`` and the ``arma::kmeans`` calls in VAQ.cpp:526-661).
One Lloyd iteration is

    assignment:  argmin_c ( ‖x‖² − 2·x·Cᵀ + ‖c‖² )   — one batched f32 matmul
    update:      C ← (onehot(assign)ᵀ · X) / count_c  — batched f32 matmuls

run for a fixed iteration count (the reference uses 25). JAX's ``vmap`` over
subspaces is the leading batch dimension G here. Empty clusters keep their
previous centroid (arma behaviour). Inits are k distinct rows drawn by numpy
from the seed, exactly as the JAX version draws them, so both packages start
from the same centroids.

The update is JAX's one-hot product (``vaq_tpu/kmeans.py:57-85``), taken in
the same row chunks as the assignment so that the (G, rows, k) one-hot stays
within ``_BLOCK_ELEMS``; the chunks' partial sums are added in row order.
Every step is a matmul, a scatter of ones or an integer count, none of which
adds floats in a varying order, so one seed gives one state on the card from
run to run. Results still drift from the JAX version's in the last bits: the
matmuls sum in another order. Near-equidistant points can then change
cluster, and the tests compare training through statistics.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Bound on the elements of one (G, rows, k) distance block (256 MB in f32).
_BLOCK_ELEMS = 1 << 26


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(..., n, d) × (..., k, d) → (..., n, k) squared L2 via the matmul
    identity, summed as ``(‖x‖² − 2·x·c) + ‖c‖²`` like the JAX version."""
    xn = torch.sum(x * x, dim=-1, keepdim=True)
    cn = torch.sum(c * c, dim=-1)
    return xn - 2.0 * (x @ c.transpose(-1, -2)) + cn[..., None, :]


def _assign_many(xs: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(G, n, d) × (G, k, d) → (G, n) int64 nearest-centroid ids, in row
    blocks so the (G, block, k) matrix stays bounded."""
    g, n, _ = xs.shape
    k = c.shape[1]
    rows = max(256, _BLOCK_ELEMS // max(g * k, 1))
    return torch.cat([
        torch.argmin(_pairwise_sq_dists(xs[:, s:s + rows], c), dim=2)
        for s in range(0, n, rows)
    ], dim=1)


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(n, d) × (k, d) → (n,) int64 nearest-centroid ids, in row blocks
    (``vaq_tpu/kmeans.py:40``); argmin ties go to the lower centroid."""
    return _assign_many(x[None], centroids[None])[0]


def _lloyd_step_many(xs: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    g, n, d = xs.shape
    k = c.shape[1]
    rows = max(256, _BLOCK_ELEMS // max(g * k, 1))
    sums = torch.zeros((g, k, d), dtype=torch.float32, device=xs.device)
    counts = torch.zeros((g, k), dtype=torch.int64, device=xs.device)
    for s in range(0, n, rows):
        xb = xs[:, s:s + rows]
        assign = torch.argmin(_pairwise_sq_dists(xb, c), dim=2)
        # per-cluster sums as onehot(assign)ᵀ · x: a matmul, whose order of
        # addition is fixed, where a scatter-add would use atomics
        onehot = torch.zeros((g, xb.shape[1], k), dtype=torch.float32,
                             device=xs.device)
        onehot.scatter_(2, assign[:, :, None], 1.0)
        sums += torch.bmm(onehot.transpose(1, 2), xb)
        flat = (assign + k * torch.arange(g, device=xs.device)[:, None]).reshape(-1)
        counts += torch.bincount(flat, minlength=g * k).view(g, k)
    cnt = counts.to(torch.float32)[:, :, None]
    new_c = sums / torch.clamp_min(cnt, 1.0)
    # Empty clusters keep the previous centroid.
    return torch.where(cnt > 0, new_c, c)


def lloyd_many(xs: torch.Tensor, c0: torch.Tensor, iters: int = 25
               ) -> torch.Tensor:
    """``iters`` Lloyd iterations of G independent problems:
    xs (G, n, d), c0 (G, k, d) → (G, k, d)."""
    c = c0
    for _ in range(iters):
        c = _lloyd_step_many(xs, c)
    return c


def lloyd(x: torch.Tensor, init_centroids: torch.Tensor, iters: int = 25
          ) -> torch.Tensor:
    """Run ``iters`` Lloyd iterations from the given initial centroids."""
    return lloyd_many(x[None], init_centroids[None], iters)[0]


def _init_indices(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """k distinct random rows (arma static_subset), with replacement when
    n < k — the JAX version's draw, call for call."""
    if n >= k:
        return rng.choice(n, size=k, replace=False)
    return rng.choice(n, size=k, replace=True)


def fit_many(xs: torch.Tensor, k: int, iters: int = 25,
             seed: int = 13517106) -> torch.Tensor:
    """Fit G independent k-means problems of identical shape at once:
    xs (G, n, d) f32 → centroids (G, k, d) on xs's device.

    The batched trainer for per-subspace codebooks (VAQ trains one k-means
    per subspace, VAQ.cpp:526-661)."""
    xs = xs.to(torch.float32)
    g, n, _ = xs.shape
    rng = np.random.default_rng(seed)
    init_idx = np.stack([_init_indices(rng, n, k) for _ in range(g)])
    idx = torch.as_tensor(init_idx, dtype=torch.int64, device=xs.device)
    c0 = torch.gather(xs, 1, idx[:, :, None].expand(-1, -1, xs.shape[2]))
    return lloyd_many(xs, c0, iters)


def fit(x: torch.Tensor, k: int, iters: int = 25, seed: int = 13517106
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train one k-means from a subset init; returns (centroids (k, d) f32,
    assignments (n,) int64) on x's device."""
    x = x.to(torch.float32)
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(_init_indices(rng, x.shape[0], k),
                          dtype=torch.int64, device=x.device)
    centroids = lloyd(x, x[idx], iters)
    return centroids, assign_clusters(x, centroids)
