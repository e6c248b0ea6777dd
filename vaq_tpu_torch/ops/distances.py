"""Exact L2 distances and brute-force top-k search.

The counterpart of ``vaq_tpu/ops/distances.py:25-75`` and :162-236: every L2
computation is the matmul identity ``‖q−x‖² = ‖q‖² − 2·q·xᵀ + ‖x‖²`` in full
f32 (the package's precision policy keeps TF32 off). ``exact_search``
doubles as the groundtruth generator; it walks the database in row blocks
with a running top-k, so the (nq, n) distance matrix never exists whole (2 GB
at nq=512, n=1M in f32). ``exact_search_chunked`` and
``exact_rescore_chunked`` do the same over a source that hands out row
chunks (``data.DeviceChunkSource``, a memmap), for databases that never
exist whole on any device: groundtruth and refine at 100M rows.

The binary engine's distances come here too (JAX distances.py:78-159):
``jaccard_dists``/``jaccard_topk`` over packed bit-vectors through kernel H1
(``ops/hamming.py``), and ``manhattan_dists``/``manhattan_topk``, L1 by
``torch.cdist`` a block at a time (JAX computes it in XLA, outside any
Pallas kernel). Their running merges keep, as JAX's do, the k lowest by
(value, id) (:func:`running_lowest`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vaq_tpu_torch.device import DEFAULT, resolve
from vaq_tpu_torch.ops import hamming
from vaq_tpu_torch.ops.scan_codes import _ordered, _select_lowest

# Database rows per block of exact_search (a block of 1000 queries' f32
# distances is 512 MB).
BLOCK_ROWS = 131072
# Entries a block keeps past the k it may contribute (lowest_over_blocks):
# more than this many equal values at a block's k-th place send the scan to
# its tie-exact form.
TIE_SLACK = 8
# Kept entries per row past which lowest_over_blocks folds them to their k
# lowest: bounds its transients (without it, 512 queries × 1,526 blocks of
# 1,008 entries held ~25 GB at 100M rows, refine 500).
FOLD_WIDTH = 1 << 14
# Rows per block of the Jaccard and Manhattan scans: JAX's defaults
# (distances.py:97, 134).
JACCARD_BLOCK_ROWS = 65536
MANHATTAN_BLOCK_ROWS = 8192


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
    (``scan_codes._select_lowest``). Once the kept entries pass
    ``FOLD_WIDTH`` a row, they are folded to their k lowest by that same
    key: ids are distinct, so the k lowest of the whole are the k lowest
    of the folded part and the rest."""
    for exact in (False, True):
        straddle = None
        vals, ids = ([carry[0]], [carry[1]]) if carry is not None else ([], [])
        width_kept = sum(v.shape[1] for v in vals)
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
            width_kept += v.shape[1]
            if width_kept > FOLD_WIDTH:
                v, i = _lowest_by_key(vals, ids, k)
                vals, ids, width_kept = [v], [i], v.shape[1]
        if exact or straddle is None or not bool(straddle):
            break
    return _lowest_by_key(vals, ids, k)


def _lowest_by_key(vals, ids, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k lowest of the concatenated (values, int32 ids ≥ −1) by (value
    in IEEE total order, id), ascending."""
    v = torch.cat(vals, dim=1)
    i = torch.cat(ids, dim=1)
    key = (_ordered(v).to(torch.int64) << 32) | (i.to(torch.int64) + 1)
    order = torch.sort(key, dim=1).indices[:, :k]
    return torch.gather(v, 1, order), torch.gather(i, 1, order)


def running_lowest(blocks, k: int, fill) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's running top-k merge over row blocks (``lax.scan`` with a
    ``top_k`` of the carry and the block): the k lowest by (value, id),
    ascending, with (``fill``, −1) entries where fewer than k rows exist.

    ``blocks()`` yields (values (nq, b) of the block's real rows, id of its
    first row), ids rising; ``fill`` is the carry's initial value (+inf, or
    2^30 for JAX's integer scans), which the dtype of the values decides.
    Each step selects from the carry followed by the block by
    ``scan_codes._select_lowest`` (ties to the lower position): the carry's
    ids are below the block's and ascend among equal values, so position
    order is id order, as JAX's."""
    best_v = best_i = None
    for vals, first in blocks():
        nq = vals.shape[0]
        if best_v is None:
            best_v = torch.full((nq, k), fill, dtype=vals.dtype,
                                device=vals.device)
            best_i = torch.full((nq, k), -1, dtype=torch.int32,
                                device=vals.device)
        best_v, pos = _select_lowest(torch.cat([best_v, vals], dim=1), k)
        best_i = torch.where(pos < k,
                             torch.gather(best_i, 1, pos.clamp(max=k - 1)),
                             (pos - k + first).to(torch.int32))
    return best_v, best_i


def jaccard_dists(q_packed: torch.Tensor, db_packed: torch.Tensor
                  ) -> torch.Tensor:
    """Jaccard distance between packed bit-vectors (reference
    ``jaccardDist``, DistanceFunctions.hpp:218-230): ``1 − popcount(a & b)
    / popcount(a | b)``, 0 when the union is empty.

    q_packed (nq, W), db_packed (n, W) int32 words on one device → (nq, n)
    f32, bit-equal to JAX's."""
    return hamming.popcount_dists(q_packed[None].contiguous(),
                                  db_packed[None].contiguous(),
                                  "jaccard")[0]


def jaccard_topk(db_packed: torch.Tensor, q_packed: torch.Tensor, k: int,
                 block_rows: int = JACCARD_BLOCK_ROWS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked Jaccard top-k over packed bit-vectors, ascending, ties to
    the lower id (JAX distances.py:95-122): (dists (nq, k) f32, ids (nq, k)
    int32), (+inf, −1) past n."""
    n = db_packed.shape[0]
    block_rows = min(block_rows, max(n, 1))

    def blocks():
        for start in range(0, n, block_rows):
            yield jaccard_dists(q_packed, db_packed[start:start + block_rows]), \
                start

    return running_lowest(blocks, k, float("inf"))


def manhattan_dists(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(nq, d) × (n, d) → (nq, n) L1 distances (reference ``manhattanDist``,
    DistanceFunctions.hpp:254-263), f32 sums in ``torch.cdist``'s order
    (JAX's differ in the last bits)."""
    return torch.cdist(q, x, p=1.0)


def manhattan_topk(queries: torch.Tensor, db: torch.Tensor, k: int,
                   block_rows: int = MANHATTAN_BLOCK_ROWS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked L1 top-k (JAX distances.py:132-159), ascending, ties to the
    lower id: (dists (nq, k) f32, ids (nq, k) int32), (+inf, −1) past n."""
    n = db.shape[0]
    block_rows = min(block_rows, max(n, 1))

    def blocks():
        for start in range(0, n, block_rows):
            yield manhattan_dists(queries, db[start:start + block_rows]), start

    return running_lowest(blocks, k, float("inf"))


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


def _stable_lowest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k lowest of (nq, w) distances, ties to the lower
    position: numpy's and JAX's stable argsort, where −0 equals +0 (it is
    made +0 first) and NaN sorts last."""
    return torch.sort(d + 0.0, dim=1, stable=True).indices[:, :k]


def exact_search_chunked(queries, chunk_fn, n: int, chunk_rows: int, k: int,
                         device: torch.device | str = DEFAULT
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k over a chunk source, merged chunk by chunk (JAX
    ``exact_search_chunked``, distances.py:162-186).

    ``queries`` and ``chunk_fn(i)``, chunk ``i`` (rows ``i·chunk_rows`` on)
    as (rows_i, d) f32, may be host arrays or tensors: a memmap slice, a
    ``data.DeviceChunkSource`` chunk. Each chunk's top-min(k, rows_i) comes
    from :func:`exact_search`; the carried best and the chunk's, its ids
    offset by the chunk's start, are merged on the device by one stable sort
    of the distances, the carry first: JAX's host merge, in the same
    (value, position) order. Device memory stays O(chunk). Returns host
    (sq_dists (nq, k) f32 ascending, labels (nq, k) int32)."""
    dev = resolve(device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    nq = q.shape[0]
    best_d = torch.full((nq, k), float("inf"), device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    for i, start in enumerate(range(0, n, chunk_rows)):
        chunk = torch.as_tensor(chunk_fn(i), dtype=torch.float32, device=dev)
        d, lab = exact_search(q, chunk, min(k, chunk.shape[0]))
        cd = torch.cat([best_d, d], dim=1)
        ci = torch.cat([best_i, lab + start], dim=1)
        order = _stable_lowest(cd, k)
        best_d = torch.gather(cd, 1, order)
        best_i = torch.gather(ci, 1, order)
    return best_d.cpu().numpy(), best_i.cpu().numpy()


def exact_search_host_stream(queries, base_np: np.ndarray, k: int,
                             chunk_rows: int = 4_000_000,
                             device: torch.device | str = DEFAULT
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k streaming host chunks of ``base_np`` to the device (JAX
    distances.py:189-204), for a database whose f32 form does not fit next
    to an index. Device memory stays O(chunk)."""

    def chunk_fn(i):
        return np.asarray(base_np[i * chunk_rows:(i + 1) * chunk_rows],
                          np.float32)

    return exact_search_chunked(queries, chunk_fn, base_np.shape[0],
                                chunk_rows, k, device=device)


def _rescore_chunk(queries: torch.Tensor, rows: torch.Tensor,
                   cand: torch.Tensor, start: int, prev: torch.Tensor
                   ) -> torch.Tensor:
    """Exact sq-dists of the candidates that fall inside [start,
    start + rows): their rows gathered, ‖q − x‖² against each candidate's
    own query; ``prev`` kept for every other id, −1 included (JAX
    distances.py:207-218)."""
    nq, r = cand.shape
    local = cand.to(torch.int64) - start
    valid = (local >= 0) & (local < rows.shape[0])
    safe = torch.clamp(local, 0, rows.shape[0] - 1).reshape(-1)
    g = rows[safe].reshape(nq, r, -1)
    d2 = torch.sum((queries[:, None, :] - g) ** 2, dim=2)
    return torch.where(valid, d2, prev)


def exact_rescore_chunked(queries, cand, chunk_fn, n: int, chunk_rows: int,
                          k: int, device: torch.device | str = DEFAULT
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact rerank of candidate ids against a chunk source (JAX
    distances.py:221-236): each chunk is generated or read again, the
    candidates that live in it are gathered and rescored; ``cand`` (nq, r)
    ids may be a host array or a tensor. Ids that land in
    no chunk (−1, ≥ n) keep +inf. Returns host (sq_dists (nq, k) f32,
    labels (nq, k) int32), ascending, ties to the lower candidate
    position."""
    dev = resolve(device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    cand_d = torch.as_tensor(cand, device=dev).to(torch.int32)
    d2 = torch.full(cand_d.shape, float("inf"), device=dev)
    for i, start in enumerate(range(0, n, chunk_rows)):
        rows = torch.as_tensor(chunk_fn(i), dtype=torch.float32, device=dev)
        d2 = _rescore_chunk(q, rows, cand_d, start, d2)
    order = _stable_lowest(d2, k)
    return (torch.gather(d2, 1, order).cpu().numpy(),
            torch.gather(cand_d, 1, order).cpu().numpy())
