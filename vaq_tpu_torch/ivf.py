"""IVF-style cluster probe — the triangle-inequality method, batched.

The counterpart of ``vaq_tpu/ivf.py`` (``IVFState`` :54, ``resolve_seg_num``
:89, ``build_ivf`` :100-263, ``_fill_capacity`` :266, ``_bucket_slots``
:295, ``_round_cap`` :309, ``build_ivf_streamed`` :318-508,
``_upload_ivf_state`` :510-600, ``probe_scan`` :602-770, ``IVFSearcher``
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
:func:`poison_deleted`, which ``VAQIndex.delete`` calls.

:func:`build_ivf_streamed` builds the same int8 buckets from the resident
codes, chunk by chunk, for a database whose decode cannot exist whole (19.2
GB of bf16 at 100M × 96). JAX staged them in a host buffer and uploaded it
in pieces, answers to the TPU's 16 GB and its transfer pool; here they are
filled in place on the index's device, and the capacity fill and the slot
table run there too.

:class:`ShardedIVF` (JAX ivf.py:839-939) splits the buckets by whole
clusters over a mesh's "db" axis and probes every shard
(``parallel.sharded_ivf_search``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
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
from vaq_tpu_torch.ops.scan_decoded import (decode_db, int8_dim_scales,
                                            quantize_int8)

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
    # what build_ivf_streamed measured: its passes' wall seconds, cap, the
    # live sizes' range and the spilled rows
    build_stats: Optional[dict] = None

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
    cfg, ncl = _ti_config(index.config, ti_cluster_num, ti_segment_num)
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
    assign = kmeans.assign_clusters(prefix, cents)

    cap = max(1, int(math.ceil(balance_cap_factor * n / ncl)))
    if int(torch.bincount(assign, minlength=ncl).max()) > cap:
        # top-S candidate clusters per row, in row blocks so the (n, ncl)
        # distance matrix never exists whole
        s_cand = min(8, ncl)
        cand = torch.cat([
            _select_lowest(probe_ops.cluster_sq_dists(
                prefix[s:s + _BLOCK_ROWS], cents), s_cand)[1]
            for s in range(0, n, _BLOCK_ROWS)])
        assign = _fill_capacity(cand, ncl, cap)
    del prefix
    sizes = torch.bincount(assign, minlength=ncl)
    cap = _round_cap(max(cap, int(sizes.max())))
    if verbose:
        print(f"== ivf: {ncl} clusters, seg_dims={seg_dims}, cap={cap}, "
              f"sizes min/mean/max = {int(sizes.min())}/"
              f"{float(sizes.double().mean()):.0f}/{int(sizes.max())}")

    bids, _ = _bucket_slots(assign, ncl, cap)
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


def _ti_config(cfg, ti_cluster_num: Optional[int],
               ti_segment_num: Optional[int]):
    """(the config with the given TI overrides, its cluster count); raises
    ConfigError when no cluster count is set."""
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
    return cfg, ncl


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


def _fill_capacity(cand: torch.Tensor, ncl: int, cap: int) -> torch.Tensor:
    """Round-based greedy capacity fill (JAX ivf.py:266, on the candidates'
    device): in round j, unplaced rows claim their j-th nearest cluster;
    each cluster admits claimants up to its remaining space in row order
    (stable sorts). Returns assign (n,) int64 with every row placed
    (pathological leftovers go to any cluster with space)."""
    n, s_cand = cand.shape
    dev = cand.device
    fill = torch.zeros(ncl, dtype=torch.int64, device=dev)
    assign = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for j in range(s_cand):
        un = torch.nonzero(assign < 0)[:, 0]
        if un.numel() == 0:
            break
        sorted_choice, order = torch.sort(cand[un, j].to(torch.int64),
                                          stable=True)
        seg_start = torch.searchsorted(sorted_choice, sorted_choice)
        rank = torch.arange(un.numel(), device=dev) - seg_start
        take = rank < (cap - fill)[sorted_choice]
        assign[un[order[take]]] = sorted_choice[take]
        fill += torch.bincount(sorted_choice[take], minlength=ncl)
    spill = torch.nonzero(assign < 0)[:, 0]
    if spill.numel():  # extremely skewed data: fill remaining space
        slots = torch.repeat_interleave(torch.arange(ncl, device=dev),
                                        torch.clamp_min(cap - fill, 0))
        assign[spill] = slots[: spill.numel()]
    return assign


def _bucket_slots(assign: torch.Tensor, ncl: int, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bids (ncl, cap) int32 row-id table, dest (n,) int64 flat slot per
    row), on the assignment's device (JAX ivf.py:295)."""
    n = assign.shape[0]
    dev = assign.device
    sorted_assign, order = torch.sort(assign, stable=True)
    seg_start = torch.searchsorted(sorted_assign, sorted_assign)
    slot = sorted_assign * cap + (torch.arange(n, device=dev) - seg_start)
    bids = torch.full((ncl * cap,), -1, dtype=torch.int32, device=dev)
    bids[slot] = order.to(torch.int32)
    dest = torch.empty(n, dtype=torch.int64, device=dev)
    dest[order] = slot
    return bids.view(ncl, cap), dest


def _round_cap(cap: int) -> int:
    """The bucket capacity rounded up to a multiple of 512 (4096 above
    32768): JAX's tile rule, kept because the capacity decides gs and with
    it which windows exist."""
    q = 512 if cap <= 32768 else 4096
    return -(-cap // q) * q


def build_ivf_streamed(index, n_chunks_fn=None, verbose: bool = False,
                       balance_cap_factor: float = 1.05,
                       ti_cluster_num: Optional[int] = None,
                       ti_segment_num: Optional[int] = None,
                       sample_n: int = 2_000_000,
                       chunk_rows: int = 2_000_000,
                       free_codes_before_upload: bool = False,
                       stage_cache: Optional[str] = None) -> IVFState:
    """int8 probe buckets built from the resident codes, ``chunk_rows`` rows
    at a time (JAX ``build_ivf_streamed``, ivf.py:318-508), so device
    transients stay O(chunk) next to the (ncl·cap, D) buckets.

    1. k-means (``kmeans.lloyd`` from ``ncl`` sample rows drawn by numpy
       from the config's seed) on the f32 prefix of the bf16 decode of the
       first ``sample_n // n_chunks`` rows of every chunk;
    2. each row's min(4, ncl) nearest clusters (``probe.cluster_sq_dists``,
       ties to the lower id), then the capacity fill into ``cap =
       _round_cap(ceil(balance_cap_factor · n / ncl))`` slots a cluster and
       the slot table, both on the device (:func:`_fill_capacity`,
       :func:`_bucket_slots`, equal to JAX's numpy steps);
       tombstoned ids in [0, n) get id −1 and leave ``sizes``;
    3. every chunk decoded again, quantized to int8 with the decoded8
       tier's scales (round half to even, ±127) and scattered into the
       poison-filled buckets by its rows' slots.

    JAX staged the buckets in a host buffer and uploaded them in pieces
    (the TPU's 16 GB, its transfer pool); here they are filled in place on
    the index's device. ``stage_cache`` keeps JAX's npz format (``buf``
    row-major (ncl·cap, D) int8, ``bids``, ``sizes``, ``cents``, ``cap``,
    ``seg_dims``, ``dim_scales``): a cache written by either package loads
    in the other, and a loaded cache needs no codes.
    ``free_codes_before_upload`` drops the codes at the end, after which
    the index serves only the probe. ``n_chunks_fn`` is unused, as in JAX.
    A built state's ``build_stats`` holds the wall seconds of k-means
    (``centroids_s``), of the nearest clusters (``candidates_s``), of the
    capacity fill and slot table (``assign_s``) and of the int8 fill
    (``fill_s``), ``cap``, the live sizes' min and max and ``spilled``: the
    rows the fill placed outside their nearest clusters (ROADMAP fault
    9)."""
    cfg, ncl = _ti_config(index.config, ti_cluster_num, ti_segment_num)
    d_full = index.total_dim
    if stage_cache and os.path.exists(stage_cache):
        z = np.load(stage_cache)
        if verbose:
            print(f"== ivf-streamed: staging loaded from {stage_cache}")
        return _upload_ivf_state(index, z["buf"], z["bids"], z["sizes"],
                                 z["cents"], int(z["cap"][0]),
                                 int(z["seg_dims"][0]), z["dim_scales"],
                                 ncl, d_full, free_codes_before_upload,
                                 verbose)

    dev = index.device
    n = index.codes.shape[0]
    dim_scales = int8_dim_scales(index.centroids).to(dev)[:d_full]
    stats: dict = {}
    seg_dims, cl_cents, cand = _streamed_candidates(index, cfg, ncl,
                                                    chunk_rows, sample_n,
                                                    stats)
    t0 = time.perf_counter()
    cap = _round_cap(max(1, int(math.ceil(balance_cap_factor * n / ncl))))
    assign = _fill_capacity(cand, ncl, cap)
    stats["spilled"] = int(torch.sum(~torch.any(cand == assign[:, None],
                                                dim=1)))
    del cand
    bids, dest = _bucket_slots(assign, ncl, cap)
    sizes = torch.bincount(assign, minlength=ncl).to(torch.int32)
    # tombstones: rows deleted before the build are dead slots (id −1) and
    # leave the live counts the visit rule uses; ids outside [0, n) name no
    # row (ROADMAP fault 15)
    dd = None
    if index.deleted_ids is not None and len(index.deleted_ids):
        dd = torch.as_tensor(index.deleted_ids, dtype=torch.int64,
                             device=dev)
        dd = dd[(dd >= 0) & (dd < n)]
        bids.view(-1)[dest[dd]] = -1
        sizes -= torch.bincount(assign[dd], minlength=ncl).to(torch.int32)
    del assign
    _sync(dev)
    stats["assign_s"] = time.perf_counter() - t0
    stats.update(cap=cap, sizes_min=int(sizes.min()),
                 sizes_max=int(sizes.max()))
    if verbose:
        print(f"== ivf-streamed: assignment {stats['assign_s']:.1f}s "
              f"(cap={cap}, sizes min/max={stats['sizes_min']}/"
              f"{stats['sizes_max']}, spilled={stats['spilled']})")

    # ---- pass 3: int8 rows scattered into the poisoned buckets ----
    t0 = time.perf_counter()
    cents_dev = torch.as_tensor(index.centroids, device=dev)
    poison = torch.as_tensor(poison_pattern(d_full), device=dev)
    buf = poison.expand(ncl * cap, d_full).contiguous()
    for start in range(0, n, chunk_rows):
        rows = min(chunk_rows, n - start)
        buf[dest[start:start + rows]] = quantize_int8(
            decode_db(index.codes[start:start + rows], cents_dev)[0],
            dim_scales)
    if dd is not None:
        buf[dest[dd]] = poison
    del dest
    _sync(dev)
    stats["fill_s"] = time.perf_counter() - t0
    if verbose:
        print(f"== ivf-streamed: centroids {stats['centroids_s']:.1f}s, "
              f"candidates {stats['candidates_s']:.1f}s, "
              f"fill {stats['fill_s']:.1f}s")

    cents_np = cl_cents.cpu().numpy()
    if stage_cache:
        np.savez(stage_cache, buf=buf.cpu().numpy(), bids=bids.cpu().numpy(),
                 sizes=sizes.cpu().numpy(), cents=cents_np,
                 cap=np.array([cap]), seg_dims=np.array([seg_dims]),
                 dim_scales=dim_scales.cpu().numpy())
        if verbose:
            print(f"== ivf-streamed: staging cached to {stage_cache}")
    state = _upload_ivf_state(index, buf, bids, sizes, cents_np, cap,
                              seg_dims, dim_scales, ncl, d_full,
                              free_codes_before_upload, verbose)
    state.build_stats = stats
    return state


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _streamed_candidates(index, cfg, ncl: int, chunk_rows: int,
                         sample_n: int, stats: dict):
    """Passes 1 and 2 of :func:`build_ivf_streamed` (JAX ivf.py:433-461):
    (seg_dims, the k-means centroids (ncl, seg_dims) f32, each row's
    min(4, ncl) nearest of them (n, S) int32, ties to the lower id), on
    the index's device, from the f32 prefix of the bf16 decode of its
    codes."""
    dev = index.device
    codes = index.codes                                  # (n, M) row-major
    n = codes.shape[0]
    seg_subs = resolve_seg_num(cfg, index.cum_var_per_subs,
                               index.highest_subs)
    seg_dims = min(seg_subs, index.highest_subs) * index.subs_len
    cents_dev = torch.as_tensor(index.centroids, device=dev)
    n_chunks = -(-n // chunk_rows)

    def prefix(start: int, rows: int) -> torch.Tensor:
        dec = decode_db(codes[start:start + rows], cents_dev)[0]
        return dec[:, :seg_dims].to(torch.float32)

    # ---- pass 1: sampled prefix → k-means centroids ----
    t0 = time.perf_counter()
    spc = max(1, min(sample_n // n_chunks, chunk_rows))
    sample = torch.cat([prefix(s, min(spc, n - s))
                        for s in range(0, n, chunk_rows)])
    ns = sample.shape[0]
    init_idx = np.random.default_rng(cfg.seed).choice(
        ns, size=min(ncl, ns), replace=ncl > ns)
    cl_cents = kmeans.lloyd(sample, sample[torch.as_tensor(init_idx,
                                                           device=dev)],
                            iters=cfg.kmeans_iters)
    del sample
    _sync(dev)
    stats["centroids_s"] = time.perf_counter() - t0

    # ---- pass 2: each row's nearest clusters ----
    t0 = time.perf_counter()
    s_cand = min(4, ncl)
    cand = torch.empty((n, s_cand), dtype=torch.int32, device=dev)
    for start in range(0, n, chunk_rows):
        pre = prefix(start, min(chunk_rows, n - start))
        for s in range(0, pre.shape[0], _BLOCK_ROWS):
            top = _select_lowest(probe_ops.cluster_sq_dists(
                pre[s:s + _BLOCK_ROWS], cl_cents), s_cand)[1]
            cand[start + s:start + s + top.shape[0]] = top
    _sync(dev)
    stats["candidates_s"] = time.perf_counter() - t0
    return seg_dims, cl_cents, cand


def _upload_ivf_state(index, buf, bids, sizes, cents_np, cap: int,
                      seg_dims: int, dim_scales, ncl: int, d_full: int,
                      free_codes: bool, verbose: bool) -> IVFState:
    """The staged arrays, on the host or already on the index's device, as
    an ``IVFState`` there (JAX ivf.py:510-600, whose chunked, lazily retired
    upload answered the TPU's transfer pool and has nothing to do here).
    ``free_codes`` drops the index's codes first."""
    if free_codes:
        index.codes = None
    dev = index.device

    def put(a, dtype):
        return torch.as_tensor(a, device=dev).to(dtype)

    state = IVFState(
        centroids=np.asarray(cents_np, dtype=np.float32),
        seg_dims=int(seg_dims),
        cap=int(cap),
        bucket_rows=put(buf, torch.int8).view(ncl, cap, d_full),
        bucket_ids=put(bids, torch.int32).view(ncl, cap),
        sizes=put(sizes, torch.int32),
        dim_scales=put(dim_scales, torch.float32))
    if verbose:
        print(f"== ivf-streamed: {ncl} clusters × {cap} slots × {d_full} "
              f"int8 on {dev} ({state.bucket_rows.numel() / 1e9:.2f} GB)")
    return state


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

    def probes(self, k: int) -> int:
        """Static probe count, ``params(k, 1)``'s p_max (JAX's legacy
        accessor, vaq_tpu/ivf.py:812-814)."""
        return self.params(k, 1)[1]

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


class ShardedIVF:
    """Mesh-sharded probe state + search (JAX ivf.py:839-939).

    Shards the buckets over the CLUSTER axis of a mesh's "db" axis: each
    shard owns ``ncl_local`` whole clusters, as the reference's
    disk-resident cluster chunks do (BitVecEngine.cpp:1024-1139), held as an
    :class:`IVFState` of its own (``shards[r][j]``, row r of the mesh's
    grid, ids global). The cluster count is padded to a multiple of the
    shard count with far centroids (1e9, ranked last), zero sizes, poison
    rows (``poison_pattern`` for int8, 1e15 for bf16) and ids of −1.
    Queries go through ``parallel.sharded_ivf_search``: each shard probes
    its local clusters with the same visit fraction (``probe_scan``, K5/K7
    on the card), the merge takes the global k. ``rescore_rows``/
    ``rescore_norms`` (the ROW-sharded decoded tier, ``VAQIndex``'s
    ``_sharded_decoded``/``_sharded_norms``) enable the exact second stage
    for int8 buckets, assembled across shards."""

    def __init__(self, state: IVFState, visit: float, mesh, q_axis=None,
                 rescore_rows=None, rescore_norms=None):
        from vaq_tpu_torch.parallel.sharded import split_rows

        self.rescore_rows = rescore_rows
        self.rescore_norms = rescore_norms
        self.visit = float(visit)
        self.mesh = mesh
        self.q_axis = q_axis
        self.cap = state.cap
        self.seg_dims = state.seg_dims
        self.d_full = state.d_full
        self.dim_scales = state.dim_scales
        nshards = mesh.shape["db"]
        ncl = state.ncl
        ncl_pad = -(-ncl // nshards) * nshards
        padc = ncl_pad - ncl
        self.ncl_local = ncl_pad // nshards
        dev = state.bucket_rows.device
        cents = np.pad(state.centroids, ((0, padc), (0, 0)),
                       constant_values=1e9)          # far: ranked last
        if state.bucket_rows.dtype == torch.int8:
            dead_row = torch.as_tensor(poison_pattern(self.d_full),
                                       device=dev)
        else:
            dead_row = torch.full((self.d_full,), BF16_SENTINEL,
                                  dtype=state.bucket_rows.dtype, device=dev)
        rows = state.bucket_rows
        if padc:
            rows = torch.cat([rows, dead_row.expand(padc, self.cap,
                                                    self.d_full)])
        ids = split_rows(state.bucket_ids, mesh, fill=-1)
        sizes = split_rows(state.sizes, mesh)
        rows = split_rows(rows, mesh)
        grid = mesh.rows("db")
        self.shards = []
        for r in range(grid.shape[0]):
            row = []
            for j in range(grid.shape[1]):
                g = mesh.offset("db") + j
                row.append(IVFState(
                    centroids=cents[g * self.ncl_local:
                                    (g + 1) * self.ncl_local],
                    seg_dims=self.seg_dims, cap=self.cap,
                    bucket_rows=rows.parts[r][j],
                    bucket_ids=ids.parts[r][j], sizes=sizes.parts[r][j],
                    dim_scales=(None if self.dim_scales is None
                                else self.dim_scales.to(grid[r, j]))))
            self.shards.append(row)

    def params(self, k: int, nq: int) -> Tuple[int, int, int, int]:
        """Per-shard (p_visit, p_max, qcap, gs): IVFSearcher.params's rules,
        the worst shard (over every rank) setting the ≥ k probe floor."""
        ncl_l = self.ncl_local
        p_visit = max(1, int(np.ceil(self.visit * ncl_l)))
        local = torch.stack([st.sizes.to(self.shards[0][0].sizes.device)
                             for st in self.shards[0]]).cpu().numpy()
        p_floor = 1
        for srt in np.sort(local, axis=1):
            p_floor = max(p_floor,
                          int(np.searchsorted(np.cumsum(srt), k) + 1))
        mesh = self.mesh
        if mesh.group is not None and mesh.group_axis == "db":
            from vaq_tpu_torch.parallel.sharded import _gather_ranks
            p_floor = int(_gather_ranks(torch.tensor([p_floor]), mesh.group,
                                        0).max())
        p_max = min(ncl_l, max(p_visit, p_floor))
        qcap = nq if nq <= 256 else probe_ops.pick_qcap(nq, p_max, ncl_l)
        return p_visit, p_max, qcap, pick_gs(self.cap)

    def poison(self, ids: torch.Tensor) -> None:
        """``poison_deleted`` on every shard's buckets (global row ids)."""
        for row in self.shards:
            for st in row:
                poison_deleted(st, ids.to(st.bucket_ids.device))

    def search(self, qp: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        from vaq_tpu_torch.parallel.sharded import sharded_ivf_search

        p_visit, p_max, qcap, gs = self.params(k, qp.shape[0])
        # the exact second stage only pays for int8 buckets (bf16 buckets
        # already ARE the decoded rows)
        r_rows = r_norms = None
        if self.dim_scales is not None and self.rescore_rows is not None:
            r_rows, r_norms = self.rescore_rows, self.rescore_norms
        return sharded_ivf_search(
            self.shards, qp, k, self.mesh, p_visit, p_max, qcap, gs,
            q_axis=self.q_axis, rescore_rows=r_rows, rescore_norms=r_norms)


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
