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
rank), with the same results.

The binary engine's cluster-pruned Hamming probe (``binary.py``) also takes
``gather_merge_topk`` (:104) and ``blocked_cluster_topk`` (:147): scores
where larger is better, each selection ``jax.lax.top_k``'s, ties to the
lower position in the candidate list (``scan_codes._select_lowest`` on the
negated scores), always exact (the JAX ``exact=True``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from vaq_tpu_torch.ops.scan_codes import _select_lowest


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


def _top_scores(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(scores, k)`` along dim 1: the k largest, descending,
    ties to the lower position (positions int64)."""
    neg, pos = _select_lowest(-scores, k)
    return -neg, pos


def gather_merge_topk(vals: torch.Tensor, ids: torch.Tensor, ok: torch.Tensor,
                      ent_c: torch.Tensor, ent_r: torch.Tensor, nq: int,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query merge (JAX probe.py:104-136): gather each dispatched
    entry's per-(cluster, slot) candidates, then the top-k by score.

    vals (ncl, qcap, kk) f32 scores, larger better; ids (ncl, qcap, kk)
    int32 row ids; ok/ent_c/ent_r from :func:`dispatch_table`. An entry
    that was not dispatched contributes (−inf, −1). A query's candidates
    stand in its probe-slot order, each slot's kk in rank order, and ties
    go to the lower of those positions. Returns (scores (nq, k) descending,
    ids (nq, k) int32), padded with (−inf, −1) past the candidates."""
    ncl, qcap, kk = vals.shape
    flat = (ent_c.to(torch.int64) * qcap + ent_r.to(torch.int64))
    okc = ok[:, None]
    cand_v = torch.where(okc, vals.reshape(ncl * qcap, kk)[flat], -torch.inf)
    cand_i = torch.where(okc, ids.reshape(ncl * qcap, kk)[flat], -1)
    cand_v = cand_v.reshape(nq, -1)
    cand_i = cand_i.reshape(nq, -1)
    kk_out = min(k, cand_v.shape[1])
    top_v, pos = _top_scores(cand_v, kk_out)
    top_i = torch.gather(cand_i, 1, pos)
    if kk_out < k:
        top_v = torch.nn.functional.pad(top_v, (0, k - kk_out),
                                        value=-torch.inf)
        top_i = torch.nn.functional.pad(top_i, (0, k - kk_out), value=-1)
    return top_v, top_i


def blocked_cluster_topk(score_fn, n_blocks: int, kk: int, exact: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``score_fn(block_index) -> (CB, qcap, cap) scores`` (larger
    better) over ``n_blocks`` cluster blocks and keep each (cluster, slot)'s
    top-kk as it goes (JAX probe.py:147-175). Returns (vals (ncl, qcap, kk),
    pos (ncl, qcap, kk) int64), short rows padded with (−inf, position 0)
    as in JAX. The last block may hold fewer clusters. ``exact`` is kept
    for JAX's signature: the port's selection is always exact."""
    vals, poss = [], []
    for b in range(n_blocks):
        s = score_fn(b)
        cb, qcap, cap = s.shape
        kkk = min(kk, cap)
        v, p = _top_scores(s.reshape(cb * qcap, cap), kkk)
        if kkk < kk:
            v = torch.nn.functional.pad(v, (0, kk - kkk), value=-torch.inf)
            p = torch.nn.functional.pad(p, (0, kk - kkk), value=0)
        vals.append(v.reshape(cb, qcap, kk))
        poss.append(p.reshape(cb, qcap, kk))
    return torch.cat(vals), torch.cat(poss)
