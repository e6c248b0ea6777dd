"""Decoded-database scan: ADC distances as one product per row block.

The counterpart of ``vaq_tpu/ops/scan_decoded.py`` (the bf16 tier :48-76,
213-293 and the int8 tier :80-210). The subspaces partition the projected
dimensions, so the ADC distance is exact in decoded form,
``Σ_s ‖q_s − C_s[code_s]‖² = ‖q − decode(x)‖²``. Rows are stored decoded, in
bf16 or (the int8 tier) as int8 with one scale per dimension, with exact f32
norms; the scan ranks by the monotone score ``2·q·x̂ − ‖x̂‖²`` with a bf16
query (for int8 rows the scales are folded into the query first),
over-fetches ``max(2k, k+16)`` candidates and rescores them exactly in f32.

The JAX version leaves the scan to XLA, a GEMM plus ``approx_max_k``. Where
it takes ``approx_max_k``, this port takes an exact top-k (the JAX
``exact=True`` semantics): the kk lowest of ``‖x‖² − 2·q·x`` by (score in
IEEE total order, row), ties to the lower row, as ``jax.lax.top_k`` orders
them. On a CUDA card the bf16 tier runs kernel **D1**
``decoded_topk_scan`` (``csrc/decoded_topk_scan.cu``): the product on the
tensor cores and, in the same kernel, each row split's kk lowest keys, so
the (nq, n) score matrix never exists; one sort of the splits' keys
(:func:`_lowest_split_keys`) finishes the selection. It serves kk ≤
``D1_MAX_KK`` at depths ≤ ``D1_MAX_DEPTH``, a rule on those two shapes
alone; a larger kk or depth, every CPU tensor and the int8 tier take the
plain blocked scan (:func:`_scan_topk`): an f32 GEMM a 65,536-row block
and ``distances.lowest_over_blocks`` (each block's ``torch.topk`` with a
margin, one tie-exact sort of what the blocks kept). The exact rescores go
through ``scan_codes._select_lowest``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vaq_tpu_torch import _build, profiling
from vaq_tpu_torch.ops.distances import lowest_over_blocks
from vaq_tpu_torch.ops.scan_codes import (_SMEM_LIMIT, _check, _ordered,
                                          _select_lowest)

# Rows per block of the decode and of the scan: bounds the f32 transients
# (a 65536-row block of 512 queries' scores is 128 MB).
BLOCK_ROWS = 65536
# D1's geometry (csrc/decoded_topk_scan.cu): rows a tile, bf16 of padding
# after each staged row, the most warps and ring stages a block takes, the
# keys a query stages between drains, the shared memory before the ring (its
# mbarriers), and the largest kk and depth D1 takes.
_D1_ROWS = 64
_D1_PAD = 8
_D1_MAX_WARPS = 8
_D1_MAX_STAGES = 4
_D1_SLOTS = 16
_D1_HEAD = 128
D1_MAX_KK = 512
D1_MAX_DEPTH = 960
# A split's key where it kept fewer than kk rows; it sorts after every key
# and decodes as a NaN score, so it comes back as row −1.
_EMPTY_KEY = 2**63 - 1
# The SMs the CPU version splits the rows for: an H100 SXM's, so that it
# splits them as D1 does on that card.
_D1_CPU_SMS = 132


def decode_db(codes: torch.Tensor, centroids: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize decoded rows (bf16) + f32 squared norms.

    codes (n, M) ints, row-major; centroids (M, C, L) f32 on the same device.
    Returns (decoded (n, M·L) bf16, norms (n,) f32), the norms taken over the
    f32 rows before the bf16 rounding, as in the JAX version.
    """
    n, m = codes.shape
    _, _, l = centroids.shape
    sub = torch.arange(m, device=codes.device)
    dec = torch.empty((n, m * l), dtype=torch.bfloat16, device=codes.device)
    norms = torch.empty((n,), dtype=torch.float32, device=codes.device)
    for start in range(0, n, BLOCK_ROWS):
        blk = codes[start:start + BLOCK_ROWS].to(torch.int64)
        rows = centroids[sub[None, :], blk].reshape(blk.shape[0], m * l)
        norms[start:start + blk.shape[0]] = torch.sum(rows * rows, dim=1)
        dec[start:start + blk.shape[0]] = rows.to(torch.bfloat16)
    return dec, norms


def _rescore_exact(qp: torch.Tensor, decoded: torch.Tensor, idx: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 distances for the selected candidates + ascending sort."""
    rows = decoded[torch.clamp_min(idx, 0).to(torch.int64)].to(torch.float32)
    diff = qp[:, None, :] - rows
    d2 = torch.sum(diff * diff, dim=2)
    d2 = torch.where(idx >= 0, d2, torch.inf)
    top, pos = _select_lowest(d2, k)
    return torch.clamp_min(top, 0.0), torch.gather(idx, 1, pos)


def _block_scores(rows: torch.Tensor, norms: torch.Tensor,
                  q32: torch.Tensor, start: int) -> torch.Tensor:
    """``‖x‖² − 2·q·x`` of the row block at ``start`` (``BLOCK_ROWS`` rows),
    (nq, rows) f32, rows upcast to f32 (see :func:`_scan_topk`)."""
    blk = rows[start:start + BLOCK_ROWS].to(torch.float32)
    return norms[None, start:start + blk.shape[0]] - 2.0 * (q32 @ blk.T)


def _scan_topk(rows: torch.Tensor, norms: torch.Tensor, q32: torch.Tensor,
               kk: int) -> torch.Tensor:
    """Row ids of the kk best ``2·q·x − ‖x‖²`` scores, scanned in row blocks
    (``distances.lowest_over_blocks`` of the negated scores, ``‖x‖² −
    2·q·x``: IEEE rounds a − b to −(b − a), so only the sign of a zero score
    differs), ties to the lower id; −1 where a score is −inf (a tombstoned
    row).

    rows (n, D) bf16 or int8, upcast to f32 per block; q32 (nq, D) f32 with
    bf16 values. JAX asks for f32 GEMM output (preferred_element_type); a
    bf16×bf16 torch.matmul would return bf16 and rounding the scores to 8
    mantissa bits would reorder the over-fetch. So both operands run in f32:
    products of bf16 (and int8) values are exact in f32, so only the
    summation order differs from JAX. Each block's scores are made in a
    ``decoded.scores`` span, and its selection runs outside it."""
    n = rows.shape[0]

    def blocks():
        for start in range(0, n, BLOCK_ROWS):
            with profiling.span("decoded.scores"):
                scores = _block_scores(rows, norms, q32, start)
            yield scores, start

    neg, best_i = lowest_over_blocks(blocks, kk)
    # tombstoned rows carry -inf scores; never let the exact rescore
    # resurrect them
    return torch.where(torch.isfinite(neg), best_i, -1)


class D1Geometry(NamedTuple):
    """D1's launch: ``mt`` query tiles of 16 a warp, ``warps`` warps and
    ``stages`` ring stages a block, ``groups`` query groups × ``splits``
    row splits of blocks, ``smem`` bytes a block."""
    mt: int
    warps: int
    stages: int
    groups: int
    splits: int
    smem: int


def _d1_geometry(nq: int, n: int, d: int, kk: int, n_sm: int) -> D1Geometry:
    """D1's launch for nq queries, n rows of depth d and kk keys a query on
    a card of ``n_sm`` SMs. A block holds its warps' queries (the depth
    rounded up to 16, plus 8 bf16 of padding a row), one max-heap of kk
    int64 keys, 16 staged keys and their count a query, and a ring of 64-row
    tiles of the same row stride. Of the layouts that fit ``_SMEM_LIMIT``,
    it takes the one whose blocks hold the most queries up to the batch (the
    fewest query groups: each group reads every row), then the fewest
    queries a block, then 32-query warps, with as many stages as fit up to
    ``_D1_MAX_STAGES``. The kernel's source lays the buffer out; its C
    entry refuses a ``smem`` below that layout. The row splits fill the card once: ``n_sm`` over
    the query groups, at most one a tile. At kk = 26, d = 128 and 1024
    queries: 8 warps of 32 queries, 4 stages, 4 groups × 33 splits."""
    row = 2 * (-(-d // 16) * 16 + _D1_PAD)
    best = None
    for mt in (2, 1):
        qw = 16 * mt
        per_warp = qw * (row + 8 * kk + 8 * _D1_SLOTS + 4)
        for warps in range(min(_D1_MAX_WARPS, -(-max(nq, 1) // qw)), 0, -1):
            room = _SMEM_LIMIT - _D1_HEAD - warps * per_warp
            stages = min(_D1_MAX_STAGES, room // (_D1_ROWS * row))
            if stages >= 1:
                qb = warps * qw
                rank = (-(-max(nq, 1) // qb), qb, -mt)
                smem = _D1_HEAD + stages * _D1_ROWS * row + warps * per_warp
                if best is None or rank < best[0]:
                    best = (rank, mt, warps, stages, smem)
                break
    if best is None:
        raise ValueError(f"D1: kk = {kk} at depth {d} does not fit one "
                         "block's shared memory")
    _, mt, warps, stages, smem = best
    groups = -(-max(nq, 1) // (warps * 16 * mt))
    n_tiles = -(-n // _D1_ROWS)
    splits = max(1, min(n_tiles, n_sm // groups))
    return D1Geometry(mt, warps, stages, groups, splits, smem)


def _keys(scores: torch.Tensor, first: int) -> torch.Tensor:
    """(nq, b) f32 scores of rows ``first`` on → int64 keys ordering as
    (score in IEEE total order, row)."""
    rows = torch.arange(first, first + scores.shape[1], dtype=torch.int64,
                        device=scores.device)
    return (_ordered(scores).to(torch.int64) << 32) | rows[None, :]


def _lowest_split_keys(keys: torch.Tensor, kk: int) -> torch.Tensor:
    """The row ids of the kk lowest of each query's (nq, splits·kk) keys,
    ascending, as (nq, kk) int32: −1 where the score is not finite (a
    tombstoned row, or a split's empty key), as :func:`_scan_topk` returns
    them."""
    top = torch.sort(keys, dim=1).values[:, :kk]
    hi = (top >> 32).to(torch.int32)
    score = (hi ^ ((hi >> 31) & 0x7FFFFFFF)).view(torch.float32)
    ids = (top & 0xFFFFFFFF).to(torch.int32)
    return torch.where(torch.isfinite(score), ids, -1)


def _check_d1_args(rows, norms, q, kk):
    dev = rows.device
    _check(rows, "rows", torch.bfloat16, 2, dev)
    _check(norms, "norms", torch.float32, 1, dev)
    _check(q, "q", torch.bfloat16, 2, dev)
    n, d = rows.shape
    if norms.shape[0] != n or q.shape[1] != d:
        raise ValueError(f"rows {tuple(rows.shape)}, norms "
                         f"{tuple(norms.shape)} and q {tuple(q.shape)} "
                         "disagree (need norms (n,), q (nq, d))")
    if not 1 <= kk <= min(n, D1_MAX_KK):
        raise ValueError(f"D1 takes 1 ≤ kk ≤ min(n, {D1_MAX_KK}); got "
                         f"kk = {kk} with n = {n}")
    if d > D1_MAX_DEPTH:
        raise ValueError(f"D1 takes depths up to {D1_MAX_DEPTH}, got {d}")
    return n, d


def decoded_topk_scan_ref(rows: torch.Tensor, norms: torch.Tensor,
                          q: torch.Tensor, kk: int, splits: int
                          ) -> torch.Tensor:
    """Plain PyTorch version of D1's partition: the rows split as D1 splits
    them (64-row tile t to split t mod ``splits``), each split's kk lowest
    keys, ascending, ``_EMPTY_KEY`` past its rows; (nq, splits·kk) int64.
    The scores are :func:`_scan_topk`'s, block for block."""
    _check_d1_args(rows, norms, q, kk)
    n = rows.shape[0]
    nq = q.shape[0]
    q32 = q.to(torch.float32)
    split_of = (torch.arange(n, device=rows.device) // _D1_ROWS) % splits
    kept = [torch.empty((nq, 0), dtype=torch.int64, device=rows.device)
            for _ in range(splits)]
    for start in range(0, n, BLOCK_ROWS):
        keys = _keys(_block_scores(rows, norms, q32, start), start)
        part = split_of[start:start + keys.shape[1]]
        for s in torch.unique(part).tolist():
            both = torch.cat([kept[s], keys[:, part == s]], dim=1)
            kept[s] = torch.sort(both, dim=1).values[:, :kk]
    out = torch.full((nq, splits, kk), _EMPTY_KEY, dtype=torch.int64,
                     device=rows.device)
    for s, v in enumerate(kept):
        out[:, s, :v.shape[1]] = v
    return out.reshape(nq, splits * kk)


def decoded_topk_scan(rows: torch.Tensor, norms: torch.Tensor,
                      q: torch.Tensor, kk: int) -> torch.Tensor:
    """D1: each row split's kk lowest keys of ``‖x‖² − 2·q·x``.

    rows (n, d) bf16; norms (n,) f32 (+inf marks tombstoned rows); q (nq,
    d) bf16; 1 ≤ kk ≤ min(n, ``D1_MAX_KK``), d ≤ ``D1_MAX_DEPTH``, all
    contiguous on one device. Returns (nq, splits·kk) int64 keys, (score in
    IEEE total order) << 32 | row, each split's in any order,
    ``_EMPTY_KEY`` where a split has fewer rows; :func:`_lowest_split_keys`
    merges them. A CPU tensor takes :func:`decoded_topk_scan_ref`, split for
    an H100's 132 SMs. Counts its launches in ``decoded_topk_scan.launches``
    and, while a profiler records, the keys its heaps took in the counter
    ``decoded.kept``."""
    n, d = _check_d1_args(rows, norms, q, kk)
    dev = rows.device
    nq = q.shape[0]
    if dev.type == "cpu":
        return decoded_topk_scan_ref(
            rows, norms, q, kk, _d1_geometry(nq, n, d, kk, _D1_CPU_SMS).splits)
    if dev.type != "cuda":
        raise ValueError(f"decoded_topk_scan runs on cpu or cuda, not {dev}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = _d1_geometry(nq, n, d, kk, n_sm)
    cand = torch.empty((nq, geo.splits * kk), dtype=torch.int64, device=dev)
    if nq == 0:
        return cand
    # each query's lowest published kk-th key, then each split's lowest key
    bound = torch.full((nq * (1 + geo.splits),), _EMPTY_KEY,
                       dtype=torch.int64, device=dev)
    # D1's inserts a block, counted only while a profiler records
    recording = profiling.recording()
    kept = (torch.zeros((geo.groups * geo.splits,), dtype=torch.int64,
                        device=dev) if recording else None)
    with torch.cuda.device(dev):
        lib = _build.library()
        err = lib.vaq_decoded_topk_scan(
            rows.data_ptr(), n, d, norms.data_ptr(), q.data_ptr(), nq, kk,
            geo.mt, geo.warps, geo.stages, geo.splits, geo.smem,
            cand.data_ptr(), bound.data_ptr(),
            kept.data_ptr() if recording else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "decoded_topk_scan")
    decoded_topk_scan.launches += 1
    if recording:
        profiling.count("decoded.kept", kept.sum())
    return cand


decoded_topk_scan.launches = 0


def _d1_takes(rows: torch.Tensor, kk: int) -> bool:
    """Whether the bf16 tier's scan runs D1: on a CUDA card, for 1 ≤ kk ≤
    ``D1_MAX_KK`` at depths ≤ ``D1_MAX_DEPTH`` (shapes alone)."""
    return (rows.device.type == "cuda" and 1 <= kk <= D1_MAX_KK
            and rows.shape[1] <= D1_MAX_DEPTH)


def decoded_scan_topk(
    decoded: torch.Tensor,
    norms: torch.Tensor,
    queries_proj: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan + top-k over the decoded database.

    decoded (n, D) bf16; norms (n,) f32 (+inf marks tombstoned rows);
    queries_proj (nq, D) f32. Returns (sq_dists (nq, k) f32 exact,
    labels (nq, k) int32), ascending; -1 / +inf where fewer than k rows live.
    Runs in a ``decoded.scan`` span. On a card (:func:`_d1_takes`) D1 runs
    in a ``decoded.scores`` span inside it, and the merge of its splits'
    keys and the exact rescore outside that; on the plain path each block's
    scores are a ``decoded.scores`` span.
    """
    with profiling.span("decoded.scan"):
        n = decoded.shape[0]
        kk = min(max(2 * k, k + 16), n)
        q_bf = queries_proj.to(torch.bfloat16)
        if _d1_takes(decoded, kk):
            with profiling.span("decoded.scores"):
                keys = decoded_topk_scan(decoded, norms, q_bf.contiguous(),
                                         kk)
            idx = _lowest_split_keys(keys, kk)
        else:
            idx = _scan_topk(decoded, norms, q_bf.to(torch.float32), kk)
        if kk < k:
            idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
        return _rescore_exact(queries_proj, decoded, idx, k)


def int8_dim_scales(centroids) -> torch.Tensor:
    """(D,) f32 per-dimension int8 scales ``127 / max_c |centroid|`` over the
    (M, C, L) padded codebooks, sentinel rows (|v| ≥ 1e17) left out
    (scan_decoded.py:105-107, ivf.py:209-213): ``x ≈ int8 / scale``. On the
    centroids' device when given a tensor, else on the CPU."""
    cents = torch.as_tensor(centroids, dtype=torch.float32)
    fin = torch.where(cents.abs() < 1e17, cents.abs(), 0.0)
    dim_max = torch.amax(fin, dim=1).reshape(-1)
    # tensor / tensor: ``127.0 / t`` is reciprocal-then-multiply in torch,
    # one ulp off the IEEE quotient that JAX (and numpy) return
    return torch.full_like(dim_max, 127.0) / torch.clamp_min(dim_max, 1e-30)


def quantize_int8(rows: torch.Tensor, dim_scales: torch.Tensor
                  ) -> torch.Tensor:
    """``clip(round(rows · scales), ±127)`` as int8; round-half-even, as
    ``jnp.round``."""
    q = torch.round(rows.to(torch.float32) * dim_scales[None, :])
    return torch.clamp(q, -127, 127).to(torch.int8)


def decode_db_int8(codes: torch.Tensor, centroids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 tier's rows (``scan_decoded.py:80-132``): the f32 decode
    quantized per dimension.

    codes (n, M) row-major; centroids (M, C, L) f32 on the same device.
    Returns (decoded8 (n, D) int8 row-major — the JAX (D, n) layout was a
    TPU tile workaround —, dim_scales (D,) f32 with x ≈ decoded8 / scales,
    norms (n,) f32 of the f32 decode)."""
    n, m = codes.shape
    _, _, l = centroids.shape
    scales = int8_dim_scales(centroids)
    sub = torch.arange(m, device=codes.device)
    dec = torch.empty((n, m * l), dtype=torch.int8, device=codes.device)
    norms = torch.empty((n,), dtype=torch.float32, device=codes.device)
    for start in range(0, n, BLOCK_ROWS):
        blk = codes[start:start + BLOCK_ROWS].to(torch.int64)
        rows = centroids[sub[None, :], blk].reshape(blk.shape[0], m * l)
        norms[start:start + blk.shape[0]] = torch.sum(rows * rows, dim=1)
        dec[start:start + blk.shape[0]] = quantize_int8(rows, scales)
    return dec, scales, norms


def decoded8_scan_topk(
    decoded8: torch.Tensor,
    dim_scales: torch.Tensor,
    norms: torch.Tensor,
    queries_proj: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 tier's scan (``scan_decoded.py:136-210``, ``exact=True``):
    per-dim scales folded into the query, which is rounded to bf16; an f32
    scan over the int8 rows; an exact top-2k over-fetch; exact f32 rescore
    of the winners from the dequantized int8 rows.

    decoded8 (n, D) int8; dim_scales (D,); norms (n,) f32 (+inf marks
    tombstoned rows); queries_proj (nq, D) f32. Returns (sq_dists (nq, k)
    f32, labels (nq, k) int32), ascending; -1 / +inf where fewer than k rows
    live. JAX's score-derived distances above 16M rows are not carried over:
    the rescore is always exact."""
    n = decoded8.shape[0]
    kk = min(max(2 * k, k + 16), n)
    q32 = (queries_proj / dim_scales[None, :]).to(torch.bfloat16)
    idx = _scan_topk(decoded8, norms, q32.to(torch.float32), kk)
    if kk < k:
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    rows = decoded8[torch.clamp_min(idx, 0).to(torch.int64)].to(torch.float32)
    diff = queries_proj[:, None, :] - rows / dim_scales[None, None, :]
    d2 = torch.where(idx >= 0, torch.sum(diff * diff, dim=2), torch.inf)
    top, pos = _select_lowest(d2, k)
    return torch.clamp_min(top, 0.0), torch.gather(idx, 1, pos)


def decoded_search_e2e(
    queries: torch.Tensor,
    eigvecs_td: torch.Tensor,
    decoded: torch.Tensor,
    norms: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project queries → decoded scan → top-k (the serving hot path).

    queries (nq, d) raw f32; eigvecs_td (d, total_dim) rotation slice.
    """
    qp = queries @ eigvecs_td
    return decoded_scan_topk(decoded, norms, qp, k)
