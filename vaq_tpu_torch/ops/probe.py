"""Cluster-probe dispatch for the TI/IVF path.

The counterpart of ``vaq_tpu/ops/probe.py`` (``cluster_sq_dists`` :37,
``dynamic_probe`` :46, ``dispatch_table`` :69, ``pick_qcap`` :139). The
reference visits clusters per query in a data-dependent loop
(``searchTriangleInequality`` VAQ.cpp:1540-1692); here, as in JAX, it is a
static-shape batched dispatch:

1. ``dynamic_probe``: each query's ``p_max`` nearest clusters, of which the
   nearest ``max(p_visit, smallest prefix holding ≥ k members)`` are active
   (the reference's visit-until-≥k rule, VAQ.cpp:1548-1551);
2. ``dispatch_table``: the active (query, cluster) pairs ranked within each
   cluster by query id and placed in a static ``(ncl, qcap)`` table of query
   ids; entries ranked ``≥ qcap`` are dropped (callers size qcap with slack).

The JAX version builds the (nq, ncl) membership mask from an
(nq, p_max, ncl + 1) one-hot and the table from a per-cluster sort; here the
mask is one scatter and the table another (each entry knows its cluster and
rank), with the same results. ``gather_merge_topk`` and
``blocked_cluster_topk`` serve only the binary engine and come with it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cluster_sq_dists(qseg: torch.Tensor, centroids: torch.Tensor
                     ) -> torch.Tensor:
    """(nq, s) × (ncl, s) → (nq, ncl) squared L2, summed as
    ``(‖q‖² − 2·q·c) + ‖c‖²`` like the JAX version."""
    qn = torch.sum(qseg * qseg, dim=1, keepdim=True)
    cn = torch.sum(centroids * centroids, dim=1)
    return qn - 2.0 * (qseg @ centroids.T) + cn[None, :]


def dynamic_probe(cd: torch.Tensor, sizes: torch.Tensor, k: int,
                  p_visit: int, p_max: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's probe list and activity mask.

    cd (nq, ncl) query→cluster distances; sizes (ncl,) live member counts.
    Returns (probe (nq, p_max) int32 cluster ids by ascending distance, ties
    to the lower id as ``jax.lax.top_k`` orders them; active (nq, p_max)
    bool)."""
    probe = torch.sort(cd, dim=1, stable=True).indices[:, :p_max]
    cum = torch.cumsum(sizes.to(torch.int64)[probe], dim=1)
    need = 1 + torch.sum(cum < k, dim=1)                   # prefix with ≥ k
    p_q = torch.clamp(torch.clamp_min(need, p_visit), 1, p_max)
    slot = torch.arange(p_max, device=cd.device)
    return probe.to(torch.int32), slot[None, :] < p_q[:, None]


def dispatch_table(probe: torch.Tensor, active: torch.Tensor, ncl: int,
                   qcap: int) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """The (ncl, qcap) table of query ids per cluster.

    Returns (table (ncl, qcap) int32, ``nq`` in empty slots; ok (nq·p_max,)
    bool, entry dispatched; ent_c (nq·p_max,) int32, entry's cluster (0 when
    not dispatched); ent_r (nq·p_max,) int32, entry's rank within its
    cluster (0 when not dispatched)) — JAX's four results."""
    nq, p_max = probe.shape
    dev = probe.device
    probe_l = probe.to(torch.int64)
    # membership (nq, ncl): inactive entries land in a dropped column ncl
    mask = torch.zeros((nq, ncl + 1), dtype=torch.int32, device=dev)
    mask.scatter_(1, torch.where(active, probe_l, ncl), 1)
    mask = mask[:, :ncl]
    rank_excl = torch.cumsum(mask, dim=0) - mask
    ent_r = torch.gather(rank_excl, 1, probe_l)             # (nq, p_max)
    ok = active & (ent_r < qcap)
    table = torch.full((ncl * qcap,), nq, dtype=torch.int32, device=dev)
    qid = torch.arange(nq, dtype=torch.int32, device=dev)[:, None]
    table[(probe_l * qcap + ent_r)[ok]] = qid.expand(nq, p_max)[ok]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (table.reshape(ncl, qcap), ok.reshape(-1),
            torch.where(ok, probe, zero).reshape(-1),
            torch.where(ok, ent_r.to(torch.int32), zero).reshape(-1))


def pick_qcap(nq: int, p_max: int, ncl: int, slack: float = 2.0) -> int:
    """Static per-cluster query capacity: ~slack× the mean demand, rounded
    to a multiple of 8, capped at nq (no drops possible there) — the JAX
    rule unchanged, since qcap decides which entries drop."""
    mean = nq * p_max / max(ncl, 1)
    cap = int(-(-slack * mean // 8)) * 8 + 8
    return max(8, min(nq, cap))
