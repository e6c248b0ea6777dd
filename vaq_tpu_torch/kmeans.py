"""K-means — batched Lloyd iterations on the device.

The counterpart of ``vaq_tpu/kmeans.py`` (reference ``bitvecengine/KMeans.hpp``
and the ``arma::kmeans`` calls in VAQ.cpp:526-661). One Lloyd iteration is

    assignment:  argmin_c ( ‖x‖² − 2·x·Cᵀ + ‖c‖² )   — one batched f32 matmul
    update:      C ← (onehot(assign)ᵀ · X) / count_c  — batched f32 matmuls

run for a fixed iteration count (the reference uses 25). JAX's ``vmap`` over
subspaces is the leading batch dimension G here. Empty clusters keep their
previous centroid (arma behaviour). Inits are drawn by numpy from the seed,
exactly as the JAX version draws them, so both packages start from the same
centroids: k distinct rows (``"subset"``, arma's ``static_subset``) or D²
sampling (``"kmeans++"``, KMeans.hpp:303-328, on the host as in JAX).

The update is JAX's one-hot product (``vaq_tpu/kmeans.py:57-85``), taken in
the same row chunks as the assignment so that the (G, rows, k) one-hot stays
within ``_BLOCK_ELEMS``; the chunks' partial sums are added in row order.
Every step is a matmul, a scatter of ones or an integer count, none of which
adds floats in a varying order, so one seed gives one state on the card from
run to run. Results still drift from the JAX version's in the last bits: the
matmuls sum in another order. Near-equidistant points can then change
cluster, and the tests compare training through statistics.

The codebooks above 8 bits (``vaq_tpu/kmeans.py:149-284``, reference
VAQ.cpp:546-607 and 1311-1371) are here too: the mini-batch fit
(``fit_minibatch``, the reference's fastFit), the two-level
``hierarchical_fit`` and the recursive ``binary_split_fit``. The JAX
hierarchical fit runs its 2^coarse_bits sub-fits one after another, each
resampled to one shape; here the sub-fits of the general branch run as one
``lloyd_many`` over the stacked (G, s_fit, L) members, each from the init
``fit(members, k_sub, seed=seed + i + 1)`` would draw. The batched form
equals the sequential one up to the order of addition inside the batched
matmul.
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


def _cluster_sums(xs: torch.Tensor, c: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's nearest centroid, then per-cluster (sums (G, k, d) f32,
    counts (G, k) int64) of G independent problems xs (G, n, d), c (G, k, d):
    the part of a Lloyd step that ``parallel.dist_kmeans`` runs per shard."""
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
    return sums, counts


def _lloyd_update(sums: torch.Tensor, counts: torch.Tensor, c: torch.Tensor
                  ) -> torch.Tensor:
    """New centroids from per-cluster sums and counts."""
    cnt = counts.to(torch.float32)[..., None]
    new_c = sums / torch.clamp_min(cnt, 1.0)
    # Empty clusters keep the previous centroid.
    return torch.where(cnt > 0, new_c, c)


def _lloyd_step_many(xs: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return _lloyd_update(*_cluster_sums(xs, c), c)


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


def init_subset(x: np.ndarray, k: int, seed: int) -> np.ndarray:
    """k distinct random rows (arma static_subset), the rows of
    ``vaq_tpu/kmeans.py:149``'s draw."""
    idx = _init_indices(np.random.default_rng(seed), x.shape[0], k)
    return np.asarray(x)[idx].astype(np.float32)


def init_kmeanspp(x: np.ndarray, k: int, seed: int) -> np.ndarray:
    """k-means++ D² seeding (reference KMeans.hpp:303-328); copied from
    ``vaq_tpu/kmeans.py:160``, numpy on the host."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    centroids = np.empty((k, x.shape[1]), dtype=np.float32)
    centroids[0] = x[rng.integers(n)]
    d2 = np.sum((x - centroids[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-30)
        centroids[i] = x[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((x - centroids[i]) ** 2, axis=1))
    return centroids


def fit(x: torch.Tensor, k: int, iters: int = 25, init: str = "subset",
        seed: int = 13517106) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train one k-means; returns (centroids (k, d) f32, assignments (n,)
    int64) on x's device. ``init`` is "kmeans++" (D² seeding on the host)
    or anything else for the subset init, as in JAX."""
    x = x.to(torch.float32)
    if init == "kmeans++":
        c0 = torch.as_tensor(init_kmeanspp(x.cpu().numpy(), k, seed),
                             device=x.device)
    else:
        rng = np.random.default_rng(seed)
        c0 = x[torch.as_tensor(_init_indices(rng, x.shape[0], k),
                               dtype=torch.int64, device=x.device)]
    centroids = lloyd(x, c0, iters)
    return centroids, assign_clusters(x, centroids)


def fit_minibatch(x: torch.Tensor, k: int, iters: int = 25,
                  batch_size: int = 4096, seed: int = 13517106
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mini-batch k-means (reference fastFit/staticFastFit, KMeans.hpp:194/654;
    ``vaq_tpu/kmeans.py:189``): per batch, assign then move centroids toward
    batch means with a per-center learning rate 1/count. The subset init and
    the batch draws are JAX's, call for call (two generators from one
    seed); the batch sums are a one-hot product, as there."""
    x = x.to(torch.float32)
    n = x.shape[0]
    dev = x.device
    rng = np.random.default_rng(seed)
    c = x[torch.as_tensor(_init_indices(np.random.default_rng(seed), n, k),
                          dtype=torch.int64, device=dev)]
    counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    for _ in range(iters):
        idx = rng.integers(0, n, size=batch_size)
        batch = x[torch.as_tensor(idx, dtype=torch.int64, device=dev)]
        assign = torch.argmin(_pairwise_sq_dists(batch, c), dim=1)
        onehot = torch.zeros((batch_size, k), dtype=torch.float32, device=dev)
        onehot.scatter_(1, assign[:, None], 1.0)
        bcounts = torch.sum(onehot, dim=0)
        counts = counts + bcounts
        lr = torch.where(counts > 0, 1.0 / torch.clamp_min(counts, 1.0), 0.0)
        bmean = (onehot.T @ batch) / torch.clamp_min(bcounts[:, None], 1.0)
        c = c + ((bmean - c) * (bcounts[:, None] > 0) * lr[:, None]
                 * bcounts[:, None])
    return c, assign_clusters(x, c)


def _resize_rows(rows: torch.Tensor, k: int) -> torch.Tensor:
    """``np.resize(rows, (k, d))`` of a non-empty (m, d) block: its rows
    repeated cyclically to k."""
    return rows[torch.arange(k, device=rows.device) % rows.shape[0]]


def hierarchical_fit(x: torch.Tensor, bits: int, iters: int = 25,
                     seed: int = 13517106, coarse_bits: int = 7
                     ) -> torch.Tensor:
    """Two-level k-means for >8-bit codebooks (reference VAQ.cpp:546-607;
    ``vaq_tpu/kmeans.py:221``): 2^coarse_bits coarse clusters, then a
    sub-k-means of 2^(bits−coarse_bits) centroids inside each coarse member
    set. Returns (2^bits, d) f32 centroids on x's device.

    JAX's branches per coarse cluster, in its order and with its draws: an
    empty cluster repeats its coarse centroid; one of at most k_sub members
    repeats its members cyclically; otherwise the members are sampled
    without repetition down to, or with repetition up to, exactly
    s_fit = min(n, 256·k_sub) rows. The sub-fits of that last branch all
    have one shape, so they run as one batched Lloyd (see the module
    docstring)."""
    x = x.to(torch.float32)
    n, dim = x.shape
    dev = x.device
    k_coarse = 1 << coarse_bits
    k_sub = 1 << (bits - coarse_bits)
    coarse, assign = fit(x, k_coarse, iters=iters, seed=seed)
    assign = assign.cpu().numpy()
    out = torch.empty((k_coarse, k_sub, dim), dtype=torch.float32, device=dev)
    s_fit = int(min(n, 256 * k_sub))
    rng = np.random.default_rng(seed)
    # members of cluster i in row order, as x[assign == i] lists them
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=k_coarse)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots, rows, inits = [], [], []
    for i in range(k_coarse):
        members = order[starts[i]:starts[i] + counts[i]]
        if members.shape[0] == 0:
            out[i] = coarse[i]
            continue
        if members.shape[0] <= k_sub:
            out[i] = _resize_rows(x[torch.as_tensor(members, device=dev)],
                                  k_sub)
            continue
        if members.shape[0] > s_fit:
            members = members[rng.choice(members.shape[0], s_fit,
                                         replace=False)]
        elif members.shape[0] < s_fit:
            members = members[rng.integers(0, members.shape[0], s_fit)]
        slots.append(i)
        rows.append(members)
        inits.append(_init_indices(np.random.default_rng(seed + i + 1),
                                   s_fit, k_sub))
    if slots:
        xs = x[torch.as_tensor(np.stack(rows), dtype=torch.int64, device=dev)]
        idx = torch.as_tensor(np.stack(inits), dtype=torch.int64, device=dev)
        c0 = torch.gather(xs, 1, idx[:, :, None].expand(-1, -1, dim))
        out[torch.as_tensor(slots, device=dev)] = lloyd_many(xs, c0, iters)
    return out.view(k_coarse * k_sub, dim)


def binary_split_fit(x: torch.Tensor, bits: int, iters: int = 25,
                     seed: int = 13517106) -> torch.Tensor:
    """Recursive 2-way splits to depth = bits, with flat-k-means fallback when
    a side is too small (reference hierarchicalBinKmeans, VAQ.cpp:1311-1371;
    ``vaq_tpu/kmeans.py:266``, ported as written: one 2-means per node).
    Returns (2^bits, d) f32 centroids on x's device."""
    x = x.to(torch.float32)

    def rec(data, depth_left, seed):
        k_total = 1 << depth_left
        if depth_left == 0:
            return data.mean(dim=0, keepdim=True)
        if data.shape[0] < max(2, k_total // 2):
            return _resize_rows(data, k_total)
        _, assign = fit(data, 2, iters=iters, seed=seed)
        left = data[assign == 0]
        right = data[assign == 1]
        if left.shape[0] < (k_total // 2) // 2 + 1 or \
                right.shape[0] < (k_total // 2) // 2 + 1:
            c, _ = fit(data, k_total, iters=iters, seed=seed)
            return c
        return torch.cat([rec(left, depth_left - 1, seed * 2 + 1),
                          rec(right, depth_left - 1, seed * 2 + 2)])

    return rec(x, bits, seed)
