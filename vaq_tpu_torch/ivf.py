"""IVF-style cluster probe — the triangle-inequality method, batched.

The counterpart of ``vaq_tpu/ivf.py`` (``IVFState`` :54, ``resolve_seg_num``
:89, ``build_ivf`` :100-263, ``_fill_capacity`` :266, ``_bucket_slots``
:295, ``_round_cap`` :309, ``probe_scan`` :602-770, ``IVFSearcher``
:773-836, ``attach_ivf`` :948). The reference's TI path (``VAQ::clusterTI``
VAQ.cpp:878-999 + ``searchTriangleInequality`` VAQ.cpp:1540-1692) clusters
the reconstructed rows over the first ``ti_segment_num`` subspaces and at
query time visits the nearest clusters: at least the ``visit`` fraction, and
at least until ≥ k members were seen (VAQ.cpp:1548-1551). As in JAX, the
per-row break becomes not scanning unprobed clusters at all, and one batch
runs as

  cluster distances → visit-until-≥k probe masks → per-cluster query table
  (``ops/probe.py``) → group-min scan of every probed (cluster × its
  queries) pair (K5, ``ops/probe_scan.py``) → per-query top-m windows →
  gather-rescore of those windows' rows (K7, ``ops/rescore.py``) → top-k,
  then, when the decoded tier is resident, an exact second-stage rescore of
  the top 2k against it. Every selection breaks ties toward the lower
  position, as ``jax.lax.top_k`` does (``scan_codes._select_lowest``).

The buckets are int8 by default (the decoded8 tier's per-dim scales, folded
into the query) or bf16, row-major ``(ncl, cap, D)`` at every D: the JAX
package's transposed ``(ncl, D, cap)`` layout at D % 128 ≠ 0 was a TPU
lane-padding workaround. Tombstones present when the buckets are built
become dead slots there; rows deleted afterwards are poisoned in place by
:func:`poison_deleted`, which ``VAQIndex.delete`` calls. Left for later: the
streamed 100M build (``build_ivf_streamed``) and ``ShardedIVF``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from vaq_tpu_torch import kmeans
from vaq_tpu_torch.errors import ConfigError
from vaq_tpu_torch.ops import probe as probe_ops
from vaq_tpu_torch.ops.probe_scan import (groupmin_window_scan, pick_gs,
                                          poison_pattern)
from vaq_tpu_torch.ops.rescore import gather_rescore
from vaq_tpu_torch.ops.scan_codes import _select_lowest
from vaq_tpu_torch.ops.scan_decoded import int8_dim_scales, quantize_int8

# Rows per block of the top-S cluster candidates (bounds its (rows, ncl)
# f32 distances: 256 MB at 1000 clusters) and slots per block of the bucket
# fill.
_BLOCK_ROWS = 1 << 16
# The bf16 rows of padding and dead slots (their distances, ~1e32, lose
# every group-min).
BF16_SENTINEL = 1e15


@dataclasses.dataclass
class IVFState:
    """The decoded database grouped by cluster into padded buckets."""

    centroids: np.ndarray        # (ncl, seg_dims) f32 cluster centroids
    seg_dims: int                # prefix dims of the cluster distances
    cap: int                     # rows per bucket (padded)
    bucket_rows: torch.Tensor    # (ncl, cap, D) int8 (x̂ ≈ rows / dim_scales)
    #                              or bf16; dead slots hold poison/sentinels
    bucket_ids: torch.Tensor     # (ncl, cap) int32, −1 for dead slots
    sizes: torch.Tensor          # (ncl,) int32 live member counts
    dim_scales: Optional[torch.Tensor] = None  # (D,) f32 for int8 rows

    @property
    def ncl(self) -> int:
        return self.centroids.shape[0]

    @property
    def d_full(self) -> int:
        return self.bucket_rows.shape[2]


def resolve_seg_num(cfg, cum_var_per_subs, highest_subs: int) -> int:
    """ti_variance < 1 → #subspaces with cumvar ≤ ti_variance (min 1);
    ti_segment_num == -1 → all kept subspaces (VAQ.cpp:879-893)."""
    if cfg.ti_variance < 1.0:
        seg = int(np.sum(np.asarray(cum_var_per_subs) <= cfg.ti_variance))
        return max(seg, 1)
    if cfg.ti_segment_num == -1:
        return highest_subs
    return int(cfg.ti_segment_num)


def build_ivf(index, verbose: bool = False,
              balance_cap_factor: float = 1.5,
              ti_cluster_num: Optional[int] = None,
              ti_segment_num: Optional[int] = None,
              rows_dtype: str = "int8") -> IVFState:
    """Cluster the decoded database and group its rows into padded buckets
    on the index's device (JAX ``build_ivf``, ivf.py:100-263).

    k-means runs on the f32 prefix of the bf16 decode, from ``ncl`` rows
    drawn by numpy from the config's seed; clusters holding more than
    ``balance_cap_factor ×`` the mean are capacity-bounded (overflow rows go
    to their next-nearest cluster with room, among their 8 nearest), and the
    capacity is rounded up to a multiple of 512 (4096 above 32768), as in
    JAX. int8 rows quantize the bf16 decode with the decoded8 tier's scales,
    round-half-even, clipped to ±127. Rows tombstoned before the build
    (+inf decoded norms) and padding get id −1 and poison rows.
    ``ti_cluster_num``/``ti_segment_num`` override the config's TI fields
    without changing it."""
    if rows_dtype not in ("int8", "bf16"):
        raise ConfigError(f"rows_dtype must be int8|bf16, got {rows_dtype}")
    cfg = index.config
    if ti_cluster_num is not None or ti_segment_num is not None:
        cfg = dataclasses.replace(
            cfg,
            ti_cluster_num=(cfg.ti_cluster_num if ti_cluster_num is None
                            else ti_cluster_num),
            ti_segment_num=(cfg.ti_segment_num if ti_segment_num is None
                            else ti_segment_num))
    ncl = int(cfg.ti_cluster_num)
    if ncl <= 0:
        raise ConfigError("ti_cluster_num must be set for the TI/IVF method")
    index._ensure_decoded()
    dec = index.decoded                          # (n, D) bf16
    norms = index.decoded_norms
    n, d_full = dec.shape
    dev = dec.device
    seg_subs = resolve_seg_num(cfg, index.cum_var_per_subs,
                               index.highest_subs)
    seg_dims = min(seg_subs, index.highest_subs) * index.subs_len

    prefix = dec[:, :seg_dims].to(torch.float32)
    rng = np.random.default_rng(cfg.seed)
    init_idx = (rng.choice(n, size=ncl, replace=False) if n >= ncl
                else rng.choice(n, size=ncl, replace=True))
    c0 = prefix[torch.as_tensor(init_idx, device=dev)]
    cents = kmeans.lloyd(prefix, c0, iters=cfg.kmeans_iters)
    assign = kmeans.assign_clusters(prefix, cents).cpu().numpy()

    cap = max(1, int(math.ceil(balance_cap_factor * n / ncl)))
    if np.bincount(assign, minlength=ncl).max() > cap:
        # top-S candidate clusters per row, in row blocks so the (n, ncl)
        # distance matrix never exists whole
        s_cand = min(8, ncl)
        cand = np.concatenate([
            _select_lowest(probe_ops.cluster_sq_dists(
                prefix[s:s + _BLOCK_ROWS], cents), s_cand)[1].cpu().numpy()
            for s in range(0, n, _BLOCK_ROWS)])
        assign = _fill_capacity(cand, ncl, cap)
    del prefix
    sizes = np.bincount(assign, minlength=ncl)
    cap = _round_cap(int(max(cap, sizes.max())))
    if verbose:
        print(f"== ivf: {ncl} clusters, seg_dims={seg_dims}, cap={cap}, "
              f"sizes min/mean/max = {sizes.min()}/{sizes.mean():.0f}/"
              f"{sizes.max()}")

    bids, _ = _bucket_slots(assign, ncl, cap)
    bids = torch.as_tensor(bids, device=dev)
    safe = torch.clamp_min(bids, 0).reshape(-1).to(torch.int64)
    # rows deleted before the build carry +inf decoded norms: dead slots,
    # like padding
    live = (bids >= 0) & torch.isfinite(norms[safe].reshape(ncl, cap))
    live_flat = live.reshape(-1)
    dim_scales = None
    if rows_dtype == "int8":
        dim_scales = int8_dim_scales(index.centroids).to(dev)[:d_full]
        dead_row = torch.as_tensor(poison_pattern(d_full), device=dev)
        rows = torch.empty((ncl * cap, d_full), dtype=torch.int8, device=dev)
    else:
        dead_row = torch.full((d_full,), BF16_SENTINEL, dtype=torch.bfloat16,
                              device=dev)
        rows = torch.empty((ncl * cap, d_full), dtype=torch.bfloat16,
                           device=dev)
    for s in range(0, ncl * cap, _BLOCK_ROWS):
        blk = dec[safe[s:s + _BLOCK_ROWS]]
        if dim_scales is not None:
            blk = quantize_int8(blk, dim_scales)
        rows[s:s + _BLOCK_ROWS] = torch.where(
            live_flat[s:s + _BLOCK_ROWS, None], blk, dead_row)
    return IVFState(
        centroids=cents.cpu().numpy(),
        seg_dims=seg_dims,
        cap=cap,
        bucket_rows=rows.view(ncl, cap, d_full),
        bucket_ids=torch.where(live, bids, -1),
        sizes=live.sum(dim=1).to(torch.int32),
        dim_scales=dim_scales,
    )


def poison_deleted(state: IVFState, ids: torch.Tensor) -> None:
    """Kill the bucket slots of deleted rows in place (the IVF part of JAX's
    ``VAQIndex.delete``, vaq_tpu/vaq.py:886-911).

    ``ids`` (on the state's device) are row ids, each in [0, n). Their slots
    get id −1, which the rescore masks, so the probe never returns them;
    their rows get the int8 poison pattern or the bf16 sentinel, because the
    group-min scan ranks by row values and a dead row left in place would
    keep promoting its window; ``sizes`` lose them per cluster. The slots
    are found on the device (``torch.isin`` over ``bucket_ids``), with no
    copy of the id table to the host. ``IVFSearcher.params`` reads ``sizes``
    back for every batch, so it sees the decrement; a later cache of the
    sorted cumulative sizes must be dropped here."""
    dead = torch.isin(state.bucket_ids, ids.to(state.bucket_ids.dtype))
    if state.bucket_rows.dtype == torch.int8:
        poison = torch.as_tensor(poison_pattern(state.d_full),
                                 device=state.bucket_rows.device)
    else:
        poison = torch.full((state.d_full,), BF16_SENTINEL,
                            dtype=state.bucket_rows.dtype,
                            device=state.bucket_rows.device)
    state.bucket_ids[dead] = -1
    state.bucket_rows[dead] = poison
    state.sizes -= torch.sum(dead, dim=1, dtype=torch.int32)


def _fill_capacity(cand: np.ndarray, ncl: int, cap: int) -> np.ndarray:
    """Round-based greedy capacity fill: in round j, unplaced rows claim
    their j-th nearest cluster; each cluster admits claimants up to its
    remaining space in row order. Returns assign (n,) with every row placed
    (pathological leftovers go to any cluster with space)."""
    n, s_cand = cand.shape
    fill = np.zeros(ncl, dtype=np.int64)
    assign = np.full(n, -1, dtype=np.int64)
    for j in range(s_cand):
        un = np.flatnonzero(assign < 0)
        if un.size == 0:
            break
        choice = cand[un, j].astype(np.int64)
        order = np.argsort(choice, kind="stable")
        sorted_choice = choice[order]
        seg_start = np.searchsorted(sorted_choice, sorted_choice,
                                    side="left")
        rank = np.arange(un.size) - seg_start
        take = rank < (cap - fill)[sorted_choice]
        assign[un[order[take]]] = sorted_choice[take]
        fill += np.bincount(sorted_choice[take], minlength=ncl)
    spill = np.flatnonzero(assign < 0)
    if spill.size:  # extremely skewed data: fill remaining space
        space = np.maximum(cap - fill, 0)
        slots = np.repeat(np.arange(ncl), space)
        assign[spill] = slots[: spill.size]
    return assign


def _bucket_slots(assign: np.ndarray, ncl: int, cap: int):
    """(bids (ncl, cap) row-id table, dest (n,) flat slot per row)."""
    n = assign.shape[0]
    bids = np.full((ncl, cap), -1, dtype=np.int32)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    seg_start = np.searchsorted(sorted_assign, sorted_assign, side="left")
    rank = np.arange(n) - seg_start
    bids[sorted_assign, rank] = order.astype(np.int32)
    dest = np.empty(n, dtype=np.int64)
    dest[order] = sorted_assign * cap + rank
    return bids, dest


def _round_cap(cap: int) -> int:
    """The bucket capacity rounded up to a multiple of 512 (4096 above
    32768): JAX's tile rule, kept because the capacity decides gs and with
    it which windows exist."""
    q = 512 if cap <= 32768 else 4096
    return -(-cap // q) * q


def probe_scan(
    qp: torch.Tensor,
    centroids: torch.Tensor,
    bucket_rows: torch.Tensor,
    bucket_ids: torch.Tensor,
    sizes: torch.Tensor,
    k: int,
    p_visit: int,
    p_max: int,
    qcap: int,
    gs: int,
    dim_scales: Optional[torch.Tensor] = None,
    rescore_rows: Optional[torch.Tensor] = None,
    rescore_norms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One probe batch (JAX ``probe_scan``, ivf.py:602-770, ``exact=True``).

    qp (nq, D) f32 projected queries; centroids (ncl, seg_dims) f32;
    bucket_rows (ncl, cap, D) int8 (with dim_scales) or bf16; bucket_ids
    (ncl, cap) int32, −1 dead; sizes (ncl,) live counts. ``rescore_rows``/
    ``rescore_norms``: the flat decoded tier (n, D) bf16 and its norms, for
    the exact second stage over the top 2k. Returns (sq_dists (nq, k) f32
    ascending, labels (nq, k) int32); +inf / −1 where fewer than k live rows
    were reached.

    Window-rescore correctness (JAX's argument): a gs-row group holding a
    true top-k row has group-min ≤ d_k, and at most k groups can, so the
    top m = 2k windows hold every group with a top-k row.

    The stages run inside profiler ranges ``ivf.probe``, ``ivf.groupmin``
    (K5), ``ivf.merge``, ``ivf.rescore`` (K7) and ``ivf.second_stage``,
    which ``torch.profiler`` reads as the probe's time split."""
    nq, d_full = qp.shape
    ncl, cap = bucket_ids.shape
    ng = cap // gs
    qcap = min(qcap, nq)
    if (bucket_rows.dtype == torch.int8) != (dim_scales is not None):
        raise ValueError("int8 bucket rows require dim_scales (and only "
                         "they do)")
    dev = qp.device
    with record_function("ivf.probe"):
        cd = probe_ops.cluster_sq_dists(qp[:, : centroids.shape[1]],
                                        centroids)
        probe, active = probe_ops.dynamic_probe(cd, sizes, k, p_visit, p_max)
        table, ok, ent_c, ent_r = probe_ops.dispatch_table(probe, active,
                                                           ncl, qcap)
        # fold the int8 per-dim scales into the query: (q/s)·rows_i8 = q·x̂
        q_eff = qp if dim_scales is None else qp / dim_scales[None, :]
        qp_pad = torch.cat([q_eff, torch.zeros((1, d_full), device=dev)])
        qsl = (-2.0 * qp_pad)[table.to(torch.int64)].to(torch.bfloat16)
        dim_w = (torch.ones((d_full,), device=dev) if dim_scales is None
                 else 1.0 / (dim_scales * dim_scales))
        n_slots = torch.sum(table < nq, dim=1, dtype=torch.int32)
    rows_flat = bucket_rows.view(ncl * cap, d_full)
    with record_function("ivf.groupmin"):
        mins = groupmin_window_scan(qsl, rows_flat, dim_w, ncl, cap, gs,
                                    n_slots)               # (ncl, qcap, ng)

    with record_function("ivf.merge"):
        # per-query merge: each dispatched entry's group minima, top-m
        # windows
        flat = mins.view(ncl * qcap, ng)
        ent = (ent_c * qcap + ent_r).to(torch.int64)
        cand = torch.where(ok[:, None], flat[ent], torch.inf)
        cand = cand.view(nq, p_max * ng)
        m = min(max(2 * k, 16), p_max * ng)
        wd, pos = _select_lowest(cand, m)
        w_ok = torch.isfinite(wd)                          # dispatched + live
        clus = torch.gather(probe, 1, (pos // ng).to(torch.int64))
        wblk = (clus * ng + (pos % ng)).to(torch.int32)    # (nq, m) windows

    with record_function("ivf.rescore"):
        blk_ids = bucket_ids.view(ncl * ng, gs)[wblk.to(torch.int64)]
        raw = gather_rescore(q_eff.contiguous(), dim_w, rows_flat, wblk, gs)
        score = torch.where(w_ok[:, :, None] & (blk_ids >= 0), raw,
                            -torch.inf)
        score = score.view(nq, m * gs)
        rows = blk_ids.view(nq, m * gs)
        kk = min(k if rescore_rows is None else 2 * k, m * gs)
        # the largest scores, ties to the lower position: JAX's top_k
        neg, post = _select_lowest(-score, kk)
        top_s = -neg
        top_i = torch.gather(rows, 1, post)
    qn = torch.sum(qp * qp, dim=1)
    if rescore_rows is not None:
        with record_function("ivf.second_stage"):
            # exact second stage against the flat bf16 decoded rows: the
            # stage-1 selection is in the int8 reconstruction's metric
            safe = torch.clamp_min(top_i, 0).to(torch.int64)
            rr = rescore_rows[safe].to(torch.float32)      # (nq, kk, D)
            qb = qp.to(torch.bfloat16).to(torch.float32)
            inner2 = torch.bmm(rr, qb[:, :, None])[:, :, 0]
            score2 = 2.0 * inner2 - rescore_norms[safe]
            kk2 = min(k, kk)
            neg, post2 = _select_lowest(
                torch.where(torch.isfinite(top_s) & (top_i >= 0), -score2,
                            torch.inf), kk2)
            top_s = -neg
            top_i = torch.gather(top_i, 1, post2)
            kk = kk2
    if kk < k:
        top_s = torch.nn.functional.pad(top_s, (0, k - kk), value=-torch.inf)
        top_i = torch.nn.functional.pad(top_i, (0, k - kk), value=-1)
    fin = torch.isfinite(top_s)
    d2 = torch.clamp_min(qn[:, None] - top_s, 0.0)
    return torch.where(fin, d2, torch.inf), torch.where(fin, top_i, -1)


class IVFSearcher:
    """Gives ``VAQIndex.search`` its TI/IVF path (``index.ivf``)."""

    def __init__(self, state: IVFState, visit: float):
        self.state = state
        self.visit = float(visit)

    def params(self, k: int, nq: int) -> Tuple[int, int, int, int]:
        """(p_visit, p_max, qcap, gs) for this (k, nq), JAX's rules
        (ivf.py:783-810): a probe floor that reaches k members even through
        the smallest clusters; strict capacity (qcap = nq, nothing can drop)
        up to 256 queries, else ``pick_qcap``'s 2× mean-demand slack; gs from
        the bucket capacity."""
        st = self.state
        ncl = st.ncl
        p_visit = max(1, int(np.ceil(self.visit * ncl)))
        cum = np.cumsum(np.sort(st.sizes.cpu().numpy()))
        p_floor = int(np.searchsorted(cum, k) + 1)
        p_max = min(ncl, max(p_visit, p_floor))
        qcap = nq if nq <= 256 else probe_ops.pick_qcap(nq, p_max, ncl)
        return p_visit, p_max, qcap, pick_gs(st.cap)

    def search(self, index, qp: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One batch of projected queries on the state's device. The exact
        second stage runs for int8 buckets when ``index`` holds its decoded
        tier already; it is never built for it (at 100M it cannot exist)."""
        st = self.state
        p_visit, p_max, qcap, gs = self.params(k, qp.shape[0])
        r_rows = r_norms = None
        if st.dim_scales is not None and index is not None and \
                index.decoded is not None:
            r_rows, r_norms = index.decoded, index.decoded_norms
        cents = torch.as_tensor(st.centroids, device=qp.device)
        return probe_scan(qp, cents, st.bucket_rows, st.bucket_ids, st.sizes,
                          k, p_visit, p_max, qcap, gs,
                          dim_scales=st.dim_scales, rescore_rows=r_rows,
                          rescore_norms=r_norms)


def attach_ivf(index, verbose: bool = False,
               ti_cluster_num: Optional[int] = None,
               ti_segment_num: Optional[int] = None,
               visit: Optional[float] = None,
               rows_dtype: str = "int8"):
    """Build and attach the cluster-probe state (the clusterTI call site,
    demo_vaq.cpp:127); the overrides leave ``index.config`` unchanged."""
    state = build_ivf(index, verbose=verbose, ti_cluster_num=ti_cluster_num,
                      ti_segment_num=ti_segment_num, rows_dtype=rows_dtype)
    index.ivf = IVFSearcher(
        state, index.config.visit if visit is None else visit)
    return index
