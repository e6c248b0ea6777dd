"""Sharded search: per-shard top-k → gather → global top-k.

The counterpart of ``vaq_tpu/parallel/sharded.py``, the re-design of the
reference's disk-resident chunked scan (``BitVecEngine.cpp:1441-1624``):
there, file chunks are scanned with per-chunk top-k and merged by
concatenate + sort + resize (cpp:1599-1611), ids offset by the chunk base
(cpp:1488). Here the chunks are the shards of a :class:`Mesh`'s "db" axis.
Each shard runs the port's single-device scan on its own rows, with the
valid row count clipped to it as JAX's ``local`` bodies do; its ids become
global (``base + i``; dead entries ``(inf, -1)``); the k rows of every shard
are gathered to the lead device, shard-major, and the global k selected by
``scan_codes._select_lowest``: lowest distance first, ties to the lower
gathered position (shard, then rank), exactly ``lax.top_k(-gat_d, k)``.

Sharded data is a :class:`ShardedRows`: every array here is split by rows
(the port keeps the int8 tier and the codes row-major, so what JAX shards by
the columns of its transposed layouts, the port shards by rows). With a
process group on the "db" axis every rank passes the whole array and keeps
its own shards; the merge then gathers every rank's shard rows, in rank
order. Queries may be split over the "q" axis; results come back in query
order, on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from vaq_tpu_torch.errors import ShapeError
from vaq_tpu_torch.ops import distances, scan_codes, scan_decoded, scan_lut
from vaq_tpu_torch.ops.scan_codes import _select_lowest
from vaq_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class ShardedRows:
    """An array's rows split over a mesh axis, padded to a multiple of the
    axis size. ``parts[r][j]`` holds global shard ``first + j`` on device
    (r, j) of the local grid (``Mesh.rows``); shards on one device are views
    of one tensor, so an in-place update reaches every row of the grid."""

    parts: List[List[torch.Tensor]]
    shard_rows: int
    first: int

    def fill_rows(self, ids: np.ndarray, value) -> None:
        """Set the global rows ``ids`` (those in this rank's shards) to
        ``value`` in place, in every copy."""
        ids = np.asarray(ids, dtype=np.int64)
        for row in self.parts:
            for j, part in enumerate(row):
                base = (self.first + j) * self.shard_rows
                sel = ids[(ids >= base) & (ids < base + self.shard_rows)]
                if sel.size:
                    part[torch.as_tensor(sel - base, device=part.device)] = \
                        value


def split_rows(x: torch.Tensor, mesh: Mesh, axis: str = "db",
               fill=0) -> ShardedRows:
    """Pad ``x`` (a tensor or a host array) along dim 0 with ``fill`` to a
    multiple of the axis size and place this rank's shards on their
    devices."""
    x = torch.as_tensor(x)
    nshards = mesh.shape[axis]
    n = x.shape[0]
    pad = (-n) % nshards
    if pad:
        x = torch.cat([x, torch.full((pad, *x.shape[1:]), fill,
                                     dtype=x.dtype, device=x.device)])
    sr = (n + pad) // nshards
    first = mesh.offset(axis)
    grid = mesh.rows(axis)
    parts = [[x[(first + j) * sr:(first + j + 1) * sr].to(grid[r, j])
              for j in range(grid.shape[1])] for r in range(grid.shape[0])]
    return ShardedRows(parts, sr, first)


def shard_codes(codes: torch.Tensor, mesh: Mesh, axis: str = "db"
                ) -> ShardedRows:
    """Place code rows row-sharded over the mesh's db axis (zero-pads to a
    multiple of the axis size)."""
    return split_rows(codes, mesh, axis)


def _gather_ranks(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along ``dim`` in rank
    order (through the host when the group's backend is gloo)."""
    import torch.distributed as dist
    dev = t.device
    if dist.get_backend(group) == "gloo":
        t = t.cpu()
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.cat(out, dim=dim).to(dev)


def _sum_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``."""
    import torch.distributed as dist
    dev = t.device
    if dist.get_backend(group) == "gloo":
        t = t.cpu()
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t.to(dev)


def _local_topk_merge(gat_d: torch.Tensor, gat_i: torch.Tensor, k: int,
                      mesh: Mesh, db_axis: str = "db"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce the gathered shard rows (this rank's, shard-major, on one
    device) to the global top-k: the other ranks' rows joined in rank order
    first when the group spans ``db_axis``; ties to the lower position."""
    if mesh.group is not None and mesh.group_axis == db_axis:
        gat_d = _gather_ranks(gat_d, mesh.group, 1)
        gat_i = _gather_ranks(gat_i, mesh.group, 1)
    top, pos = _select_lowest(gat_d, min(k, gat_d.shape[1]))
    return top, torch.gather(gat_i, 1, pos)


def _dead(nq: int, k: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((nq, k), torch.inf, device=dev),
            torch.full((nq, k), -1, dtype=torch.int32, device=dev))


def _globalize(d: torch.Tensor, i: torch.Tensor, base: int, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard-local (d, i) → k columns of global ids, (inf, −1) where dead."""
    live = i >= 0
    d = torch.where(live, d, torch.inf)
    gi = torch.where(live, i + base, -1).to(torch.int32)
    if d.shape[1] < k:
        d = torch.nn.functional.pad(d, (0, k - d.shape[1]), value=torch.inf)
        gi = torch.nn.functional.pad(gi, (0, k - gi.shape[1]), value=-1)
    return d, gi


def _query_blocks(queries: torch.Tensor, mesh: Mesh, q_axis: Optional[str]
                  ) -> List[torch.Tensor]:
    """This rank's query block for each row of its grid (all queries on row
    0 without a q axis)."""
    if q_axis is None:
        return [queries]
    nq = queries.shape[0]
    nblk = mesh.shape[q_axis]
    if nq % nblk:
        raise ShapeError(f"{nq} queries do not split over the {nblk} "
                         f"entries of the {q_axis!r} axis")
    per = nq // nblk
    off = mesh.offset(q_axis)
    nrows = mesh.devices.shape[mesh.axis_names.index(q_axis)]
    return [queries[(off + r) * per:(off + r + 1) * per]
            for r in range(nrows)]


def _run_sharded(mesh: Mesh, queries: torch.Tensor, k: int,
                 local: Callable, q_axis: Optional[str], db_axis: str,
                 merge: Optional[Callable] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``local(r, j, qb)`` — shard j's (d, global ids), k columns, for
    the query block qb on device (r, j) — over this rank's grid, merge each
    row's shards (``merge(r, qb, gat_d, gat_i)``, the top-k merge by
    default), and return the results in query order on the first device."""
    grid = mesh.rows(db_axis)
    outs = []
    for r, qb in enumerate(_query_blocks(queries, mesh, q_axis)):
        lead = grid[r, 0]
        ds, ids = [], []
        for j in range(grid.shape[1]):
            d, i = local(r, j, qb.to(grid[r, j]))
            ds.append(d.to(lead))
            ids.append(i.to(lead))
        gat_d, gat_i = torch.cat(ds, dim=1), torch.cat(ids, dim=1)
        if merge is None:
            outs.append(_local_topk_merge(gat_d, gat_i, k, mesh, db_axis))
        else:
            outs.append(merge(r, qb.to(lead), gat_d, gat_i))
    first = grid[0, 0]
    d = torch.cat([o[0].to(first) for o in outs])
    i = torch.cat([o[1].to(first) for o in outs])
    if q_axis is not None and mesh.group is not None and \
            mesh.group_axis == q_axis:
        d = _gather_ranks(d, mesh.group, 0)
        i = _gather_ranks(i, mesh.group, 0)
    return d, i


def _shard_span(rows: ShardedRows, j: int, n_total: int) -> Tuple[int, int]:
    """(global id of shard j's first row, its valid rows)."""
    base = (rows.first + j) * rows.shard_rows
    return base, int(np.clip(int(n_total) - base, 0, rows.shard_rows))


def sharded_adc_search(
    codes: ShardedRows,
    luts: torch.Tensor,
    k: int,
    n_total: int,
    mesh: Mesh,
    block_rows: int = 32768,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC scan (``scan_lut.adc_scan_topk``) over row-sharded codes with
    replicated (or q-split) LUTs (nq, M, C). Returns (sq_dists, labels) of
    shape (nq, k), global ids."""
    def local(r, j, luts_l):
        base, nv = _shard_span(codes, j, n_total)
        d, i = scan_lut.adc_scan_topk(
            codes.parts[r][j], luts_l, k, n_valid=nv,
            block_rows=min(block_rows, codes.shard_rows))
        return _globalize(d, i, base, k)

    return _run_sharded(mesh, luts, k, local, q_axis, db_axis)


def sharded_decoded_search(
    decoded: ShardedRows,
    norms: ShardedRows,
    luts_or_qp: torch.Tensor,
    k: int,
    n_total: int,
    mesh: Mesh,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoded bf16 tier row-sharded: each shard's
    ``scan_decoded.decoded_scan_topk`` (exact, as the port's single-device
    scan is; JAX's ``exact``/``recall_target`` have no counterpart), then
    the merge. ``luts_or_qp``: (nq, D) projected queries (named for API
    symmetry with ``sharded_adc_search``)."""
    def local(r, j, qp_l):
        base, nv = _shard_span(decoded, j, n_total)
        if nv == 0:
            return _dead(qp_l.shape[0], k, qp_l.device)
        d, i = scan_decoded.decoded_scan_topk(
            decoded.parts[r][j][:nv], norms.parts[r][j][:nv], qp_l, k)
        return _globalize(d, i, base, k)

    return _run_sharded(mesh, luts_or_qp, k, local, q_axis, db_axis)


def sharded_decoded8_search(
    decoded8: ShardedRows,
    dim_scales: torch.Tensor,
    norms: ShardedRows,
    qp: torch.Tensor,
    k: int,
    n_total: int,
    mesh: Mesh,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 capacity tier sharded: the (n, D) int8 rows are row-sharded
    (JAX shards the columns of its (D, n) layout), the per-dim scales and the
    queries replicated (or q-split); each shard's
    ``scan_decoded.decoded8_scan_topk``, then the merge."""
    def local(r, j, qp_l):
        base, nv = _shard_span(decoded8, j, n_total)
        if nv == 0:
            return _dead(qp_l.shape[0], k, qp_l.device)
        d, i = scan_decoded.decoded8_scan_topk(
            decoded8.parts[r][j][:nv], dim_scales.to(qp_l.device),
            norms.parts[r][j][:nv], qp_l, k)
        return _globalize(d, i, base, k)

    return _run_sharded(mesh, qp, k, local, q_axis, db_axis)


def sharded_codes_search(
    codes: ShardedRows,
    dec_table: torch.Tensor,
    rows_f32: torch.Tensor,
    qp: torch.Tensor,
    k: int,
    n_total: int,
    mesh: Mesh,
    block_rows: int = 512,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codes-resident tier sharded: the (n, M) u8 codes row-sharded, the
    decode table and rows replicated (C rows of d); each shard's
    ``scan_codes.decode_scan_topk`` (kernels K1/K2 on the card) over its
    valid rows, then the merge."""
    def local(r, j, qp_l):
        base, nv = _shard_span(codes, j, n_total)
        if nv == 0:
            return _dead(qp_l.shape[0], k, qp_l.device)
        dev = qp_l.device
        d, i = scan_codes.decode_scan_topk(
            codes.parts[r][j][:nv], dec_table.to(dev), rows_f32.to(dev),
            qp_l, k, block_rows)
        return _globalize(d, i, base, k)

    return _run_sharded(mesh, qp, k, local, q_axis, db_axis)


def sharded_ivf_search(
    shards,
    qp: torch.Tensor,
    k: int,
    mesh: Mesh,
    p_visit: int,
    p_max: int,
    qcap: int,
    gs: int,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
    rescore_rows: Optional[ShardedRows] = None,
    rescore_norms: Optional[ShardedRows] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded IVF/TI cluster probe (JAX sharded.py:272-379): whole clusters
    sharded over "db" (``shards[r][j]``, an ``ivf.IVFState`` of shard j's
    clusters, ids global), each shard running ``ivf.probe_scan`` (K5/K7 on
    the card) with the per-shard visit budget, then the merge. Bucket ids
    are global, so no offset is needed.

    With ``rescore_rows``/``rescore_norms`` (the ROW-sharded bf16 decoded
    tier and its +inf-masked norms), each shard returns its stage-1 top-2k,
    the merge selects the global 2k candidates, and the exact distances are
    assembled across shards: each shard scores the candidates whose rows it
    owns (``2·q·x − ‖x‖²``, both operands in f32 where JAX takes a bf16
    einsum with f32 output, −inf for tombstones), the others give 0, and the
    sum over shards (then over ranks) is exact, since one shard is non-zero
    per entry."""
    from vaq_tpu_torch import ivf

    with_rescore = rescore_rows is not None
    if with_rescore and rescore_norms is None:
        raise ValueError("rescore_rows requires rescore_norms")
    k1 = 2 * k if with_rescore else k

    def local(r, j, qp_l):
        st = shards[r][j]
        cents = torch.as_tensor(st.centroids, device=qp_l.device)
        return ivf.probe_scan(qp_l, cents, st.bucket_rows, st.bucket_ids,
                              st.sizes, k1, p_visit, p_max, qcap, gs,
                              dim_scales=st.dim_scales)

    def rescore(r, qp_l, gat_d, gat_i):
        d, cand = _local_topk_merge(gat_d, gat_i, k1, mesh, db_axis)
        sr = rescore_rows.shard_rows
        qb = qp_l.to(torch.bfloat16).to(torch.float32)
        score2 = torch.zeros(cand.shape, device=qp_l.device)
        for j, rows_l in enumerate(rescore_rows.parts[r]):
            dev = rows_l.device
            lid = cand.to(dev).to(torch.int64) - (rescore_rows.first + j) * sr
            owned = (lid >= 0) & (lid < sr)
            safe = torch.clamp(lid, 0, sr - 1)
            inner = torch.bmm(rows_l[safe].to(torch.float32),
                              qb.to(dev)[:, :, None])[:, :, 0]
            contrib = torch.where(
                owned, 2.0 * inner - rescore_norms.parts[r][j][safe], 0.0)
            score2 = score2 + contrib.to(qp_l.device)
        if mesh.group is not None and mesh.group_axis == db_axis:
            score2 = _sum_ranks(score2, mesh.group)
        score2 = torch.where((cand >= 0) & torch.isfinite(d), score2,
                             -torch.inf)
        neg, pos = _select_lowest(-score2, min(k, score2.shape[1]))
        top_s = -neg
        top_i = torch.gather(cand, 1, pos)
        qn = torch.sum(qp_l * qp_l, dim=1)
        d2 = torch.clamp_min(qn[:, None] - top_s, 0.0)
        fin = torch.isfinite(top_s)
        return torch.where(fin, d2, torch.inf), torch.where(fin, top_i, -1)

    return _run_sharded(mesh, qp, k, local, q_axis, db_axis,
                        merge=rescore if with_rescore else None)


def sharded_exact_search(
    db: ShardedRows,
    queries: torch.Tensor,
    k: int,
    n_total: int,
    mesh: Mesh,
    block_rows: int = 131072,
    q_axis: Optional[str] = None,
    db_axis: str = "db",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force L2 top-k over row-sharded original vectors — the sharded
    groundtruth generator / rerank backend (reference queryNaiveParallel
    with the disk-resident merge, BitVecEngine.cpp:1441-1624): each shard's
    ``distances.exact_search`` over its valid rows, then the merge.
    ``block_rows`` is JAX's argument, unused there as here: the scan blocks
    by ``distances.BLOCK_ROWS``."""
    def local(r, j, q_l):
        base, nv = _shard_span(db, j, n_total)
        if nv == 0:
            return _dead(q_l.shape[0], k, q_l.device)
        d, i = distances.exact_search(q_l, db.parts[r][j][:nv], k)
        return _globalize(d, i, base, k)

    return _run_sharded(mesh, queries, k, local, q_axis, db_axis)
