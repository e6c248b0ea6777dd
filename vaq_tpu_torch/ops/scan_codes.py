"""Codes-resident search over the raw u8 codes: decode-then-dot, and the
FAST window scan over per-query LUTs.

The counterpart of ``vaq_tpu/ops/scan_pallas.py``: the decode path
(``decode_window_scan``, ``decode_rescore``, ``decode_scan_topk`` and the two
table builders) and the FAST path (``fast4_window_scan``,
``fast4_scan_topk``, scan_pallas.py:190-280, 636-701). Device memory holds
only the codes, M bytes per row, stored row-major (n, M) u8; the TPU's
transposed (M, n) layout existed only for its u8 tile. The decode search is

1. **K1** ``decode_window_scan`` (``csrc/decode_window_scan.cu``): for each
   (query, window of ``block_rows`` rows) the best row by
   ``‖x̂‖² − 2·q·x̂ + ‖q‖²`` over the bf16-rounded decode, as one packed key;
2. an exact top-2k of the windows by :func:`_select_lowest` (the JAX
   version's ``approx_max_k`` on the TPU, exact ``top_k`` in its interpret
   mode), ties to the lower window;
3. **K2** ``decode_rescore`` (``csrc/decode_rescore.cu``): exact f32
   ``‖q − x̂‖²`` of the winners from the f32 decode rows;
4. a top-k of those, by the same helper.

The FAST search (``backend="fast4"``) is

1. **K3/K4** ``fast4_window_scan`` (``csrc/fast4_window_scan.cu``): for each
   (query, window) the best row by the LUT sum ``Σ_s lut[q, s, code_s]``,
   over the bf16-rounded f32 LUT (K3) or over the u8-quantized LUT shifted
   to s8 (K4, the reference's FAST winner semantics); where the query
   tile's LUT fits in shared memory (``_fast4_form``) as the one-hot ×
   LUT product on the tensor cores, else as a shared-memory gather;
2. the top-k windows by :func:`_select_lowest`, which breaks ties toward
   the lower window as ``jax.lax.top_k`` does (K4's integer sums tie often);
3. the f32 LUT sum of each winner, and a top-k of those, by the same helper.

Each kernel wrapper takes its plain PyTorch version (``*_ref`` below) only
for tensors on the CPU; for a CUDA tensor it launches the kernel or raises.
Each counts its kernel launches in a plain int attribute, ``launches``
(``fast4_window_scan``, which launches K3 or K4, in a dict of two).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from vaq_tpu_torch import _build
from vaq_tpu_torch.device import DEFAULT, resolve

_INT32_MAX = 2**31 - 1
# Rows per chunk of the plain K1/K3/K4 versions (bounds their (nq, rows)
# scores).
_REF_CHUNK_ROWS = 65536
# fast4_scan_topk pads the rows to a multiple of W_PER_CELL·block_rows, as
# JAX's grid cells do (scan_pallas.py:76, 661): the padded window count sets
# kk and so which windows can win.
W_PER_CELL = 8
# The geometry of K3/K4's gather form (csrc/fast4_window_scan.cu): rows per
# block, one per thread; the shared memory a block gives its query tile's
# LUT and the queries a tile holds at most (the best of a sweep on an H100,
# scripts/fast4_tile_sweep.py: two blocks fit an SM); the queries a thread
# sums at once; the shared memory a block may have on an H100.
_FAST4_ROWS = 256
_FAST4_LUT_BYTES = 64 * 1024
_FAST4_MAX_Q_TILE = 32
_FAST4_QJ = 8
_SMEM_LIMIT = 232448
# K3/K4's tensor-core form (the same file): queries a tile (the wgmma N) and
# columns of K a step for K3 (bf16) and K4 (s8), steps built and issued at
# once, warpgroups a block, code tiles in each warp's ring, and the table
# width the one-hot steps need at least (narrower tables are zero-padded).
_MMA_N = {False: 64, True: 128}
_MMA_KSTEP = {False: 16, True: 32}
_MMA_GROUP = 4
_MMA_WGS = {False: 4, True: 3}
_MMA_RING = 4
_MMA_MIN_C = 16
# K1 geometry (csrc/decode_window_scan.cu): rows per tile, queries per
# sub-tile (a block stages a chunk of whole sub-tiles), bf16 of padding after
# each staged row, and the most queries a chunk holds.
_K1_ROWS = 128
_K1_Q_TILE = 128
_K1_PAD = 8
_K1_MAX_Q_CHUNK = 512
# _select_lowest sorts rows up to this width whole; wider rows take one
# torch.topk of (score, position) keys. On an H100 (chip_smoke.py, 512 rows)
# the sort wins at 1600 and 3912 columns (0.062-0.067 / 0.077-0.078 ms
# against 0.115-0.116 / 0.225-0.470), the keys at 7813, 19,200 and 32,868
# (0.298 / 0.641 / 0.924 against 0.380 / 0.820 / 1.420), and at 200 the two
# trade places from run to run (0.05-0.08 ms). The crossover lies between
# 3912 and 7813; no selection of the port falls in between.
_SORT_WIDTH = 4096
# Centroid magnitudes at or above this are sentinels, zeroed in the tables
# (scan_pallas.py:461,555). vaq.PAD_SENTINEL (1e18) stays below it, as in the
# JAX tables; codes never address padded rows either way.
_SENTINEL_ABS = 1e30


def _centroid_rows(centroids) -> torch.Tensor:
    """(M, C, L) padded centroids → (C, M·L) f32 rows, row c holding every
    subspace's centroid c (lane s·L + j ↔ centroids[s, c, j])."""
    cents = torch.as_tensor(np.asarray(centroids, dtype=np.float32))
    m, c, l = cents.shape
    cents = torch.where(cents.abs() < _SENTINEL_ABS, cents, 0.0)
    return cents.permute(1, 0, 2).reshape(c, m * l).contiguous()


def build_decode_table(centroids, device: torch.device | str = DEFAULT
                       ) -> torch.Tensor:
    """(C, M·L) bf16 decode table for K1 on ``device``: the centroid rows
    rounded to bf16 (round-to-nearest-even, as the JAX table's ml_dtypes
    cast)."""
    return _centroid_rows(centroids).to(torch.bfloat16).to(resolve(device))


def build_decode_rows(centroids, device: torch.device | str = DEFAULT
                      ) -> torch.Tensor:
    """(C, M·L) f32 decode rows for K2 on ``device``."""
    return _centroid_rows(centroids).to(resolve(device))


def _idx_bits(block_rows: int) -> int:
    return max(1, (block_rows - 1).bit_length())


def _unpack(keys: torch.Tensor, block_rows: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nq, n_win) packed int32 keys → (scores f32, global row ids int32)."""
    mask = (1 << _idx_bits(block_rows)) - 1
    ids_local = keys & mask
    scores = (keys & ~mask).view(torch.float32)
    base = torch.arange(keys.shape[1], dtype=torch.int32,
                        device=keys.device) * block_rows
    return scores, ids_local + base[None, :]


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: need a {ndim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_geometry(codes, table, qp):
    n, m = codes.shape
    c, d = table.shape
    if d % m or qp.shape[1] != d:
        raise ValueError(f"codes (n, {m}), table ({c}, {d}) and queries "
                         f"{tuple(qp.shape)} disagree (need d = M·L)")
    return n, m, d


def decode_window_scan_ref(codes: torch.Tensor, table: torch.Tensor,
                           qp: torch.Tensor, block_rows: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, same arguments and result."""
    n, m, d = _check_geometry(codes, table, qp)
    c = table.shape[0]
    l = d // m
    nq = qp.shape[0]
    dev = codes.device
    n_win = -(-n // block_rows)
    mask = (1 << _idx_bits(block_rows)) - 1
    q_bf = qp.to(torch.bfloat16).to(torch.float32)
    qn = torch.sum(qp * qp, dim=1)
    tbl = table.to(torch.float32).reshape(c, m, l)
    sub = torch.arange(m, device=dev)
    keys = torch.empty((nq, n_win), dtype=torch.int32, device=dev)
    wins = max(1, _REF_CHUNK_ROWS // block_rows)
    for w_start in range(0, n_win, wins):
        w_end = min(n_win, w_start + wins)
        rs, re = w_start * block_rows, w_end * block_rows
        blk = codes[rs:min(re, n)].to(torch.int64)
        # rows past n decode as code 0, like the JAX caller's zero padding
        blk = torch.nn.functional.pad(blk, (0, 0, 0, re - rs - blk.shape[0]))
        xhat = tbl[blk, sub[None, :]].reshape(re - rs, d)
        norms = torch.sum(xhat * xhat, dim=1)
        dist = (norms[None, :] - 2.0 * (q_bf @ xhat.T)) + qn[:, None]
        dist = torch.where(dist > 0, dist, 0.0).contiguous()
        local = torch.arange(re - rs, dtype=torch.int32, device=dev) % block_rows
        k = (dist.view(torch.int32) & ~mask) | local[None, :]
        keys[:, w_start:w_end] = k.reshape(nq, w_end - w_start,
                                           block_rows).amin(dim=2)
    return _unpack(keys, block_rows)


def _k1_tile(nq: int, m: int, c: int, d: int) -> Tuple[int, int, bool, int]:
    """(queries a K1 block stages, the depth it stages at once, whether the
    decode table sits in shared memory, the block's dynamic shared memory in
    bytes). A block holds two decoded 128-row tiles (one being filled while
    the other is multiplied), two tiles' codes, the tiles' row norms, the
    query chunk as bf16 rows of that depth plus 8 of padding with its ‖q‖²,
    and the decode table where that costs no extra chunk (each chunk decodes
    every tile again). The chunk is whole 128-query sub-tiles, as many as
    fit up to ``_K1_MAX_Q_CHUNK``, the batch split into equal chunks: 512
    queries at C = 256, d = 128 are one chunk, the 64 KB table then read
    from global memory, which an H100 ran faster than two chunks beside the
    table. Where not even one sub-tile fits at the
    whole depth (d = 512 at M = 512), the chunk is one sub-tile, the table
    is read from global memory, the depth goes in the largest slices of 16
    that fit, and the query slices are double-buffered too."""
    dpad = -(-d // 16) * 16
    # norms, the row-warp pairs' window minima, two tiles' codes
    small = 12 * _K1_ROWS + 1024 + 2 * _K1_ROWS * m
    per_q = 2 * (dpad + _K1_PAD) + 4         # one staged query and its ‖q‖²
    table = 2 * (-(-c * d // 8) * 8)
    want = -(-max(nq, 1) // _K1_Q_TILE)
    cap = _K1_MAX_Q_CHUNK // _K1_Q_TILE
    best = None
    for in_smem in (True, False):
        fixed = small + 4 * _K1_ROWS * (dpad + _K1_PAD) + \
            (table if in_smem else 0)
        fits = min((_SMEM_LIMIT - fixed) // (_K1_Q_TILE * per_q), cap)
        if fits >= 1:
            chunks = -(-want // fits)
            q_chunk = _K1_Q_TILE * -(-want // chunks)      # equal chunks
            if best is None or chunks < best[0]:
                best = (chunks, (q_chunk, dpad, in_smem,
                                 fixed + q_chunk * per_q))
    if best is not None:
        return best[1]
    rows = 2 * (_K1_ROWS + _K1_Q_TILE)
    fixed = small + 4 * _K1_Q_TILE
    kc = ((_SMEM_LIMIT - fixed) // (2 * rows) - _K1_PAD) // 16 * 16
    if kc < 16:
        raise ValueError(f"K1: M = {m}, d = {d} do not fit one block's "
                         "shared memory")
    return _K1_Q_TILE, kc, False, fixed + rows * 2 * (kc + _K1_PAD)


def decode_window_scan(codes: torch.Tensor, table: torch.Tensor,
                       qp: torch.Tensor, block_rows: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: per-(query, window) best row of the decode-then-dot scan.

    codes (n, M) u8 row-major, every code < C; table (C, d) bf16 from
    :func:`build_decode_table`; qp (nq, d) f32 projected queries. Windows are
    consecutive runs of ``block_rows`` rows; rows past n count as code 0.
    Returns (scores (nq, n_win) f32 with the low index bits zeroed, row ids
    (nq, n_win) int32 global), as the JAX ``decode_window_scan`` returns them.
    """
    dev = codes.device
    _check(codes, "codes", torch.uint8, 2, dev)
    _check(table, "table", torch.bfloat16, 2, dev)
    _check(qp, "qp", torch.float32, 2, dev)
    n, m, d = _check_geometry(codes, table, qp)
    if dev.type == "cpu":
        return decode_window_scan_ref(codes, table, qp, block_rows)
    if dev.type != "cuda":
        raise ValueError(f"decode_window_scan runs on cpu or cuda, not {dev}")
    nq = qp.shape[0]
    n_win = -(-n // block_rows)
    q_chunk, kc, table_smem, smem = _k1_tile(nq, m, table.shape[0], d)
    q_bf = qp.to(torch.bfloat16).contiguous()
    qn = torch.sum(qp * qp, dim=1).contiguous()
    keys = torch.full((nq, n_win), _INT32_MAX, dtype=torch.int32, device=dev)
    if nq and n_win:
        with torch.cuda.device(dev):
            lib = _build.library()
            err = lib.vaq_decode_window_scan(
                codes.data_ptr(), n, m, table.shape[0], table.data_ptr(),
                q_bf.data_ptr(), qn.data_ptr(), nq, d, block_rows,
                _idx_bits(block_rows), n_win, q_chunk, kc, int(table_smem),
                smem, keys.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(err, "decode_window_scan")
        decode_window_scan.launches += 1
    return _unpack(keys, block_rows)


decode_window_scan.launches = 0


def decode_rescore_ref(codes: torch.Tensor, cand: torch.Tensor,
                       rows: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2, same arguments and result."""
    n, m, d = _check_geometry(codes, rows, qp)
    c = rows.shape[0]
    l = d // m
    ids = cand.to(torch.int64)
    valid = (ids >= 0) & (ids < n)
    cod = codes[ids.clamp(0, max(n - 1, 0))].to(torch.int64)  # (nq, kk, M)
    sub = torch.arange(m, device=codes.device)
    xhat = rows.reshape(c, m, l)[cod, sub].reshape(*ids.shape, d)
    diff = xhat - qp[:, None, :]
    return torch.where(valid, torch.sum(diff * diff, dim=2), torch.inf)


def decode_rescore(codes: torch.Tensor, cand: torch.Tensor,
                   rows: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """K2: exact f32 ``‖q_i − x̂‖²`` for each query's candidate rows.

    codes (n, M) u8, every code < C; cand (nq, kk) int32 row ids, −1 for
    none; rows (C, d) f32 from :func:`build_decode_rows`; qp (nq, d) f32.
    Returns (nq, kk) f32, +inf where the id is −1 (or outside [0, n)).
    """
    dev = codes.device
    _check(codes, "codes", torch.uint8, 2, dev)
    _check(cand, "cand", torch.int32, 2, dev)
    _check(rows, "rows", torch.float32, 2, dev)
    _check(qp, "qp", torch.float32, 2, dev)
    n, m, d = _check_geometry(codes, rows, qp)
    if cand.shape[0] != qp.shape[0]:
        raise ValueError(f"cand {tuple(cand.shape)} and qp "
                         f"{tuple(qp.shape)} disagree on nq")
    if dev.type == "cpu":
        return decode_rescore_ref(codes, cand, rows, qp)
    if dev.type != "cuda":
        raise ValueError(f"decode_rescore runs on cpu or cuda, not {dev}")
    nq, kk = cand.shape
    out = torch.empty((nq, kk), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _build.library()
        err = lib.vaq_decode_rescore(
            codes.data_ptr(), n, m, cand.data_ptr(), nq, kk, rows.data_ptr(),
            qp.data_ptr(), d, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "decode_rescore")
    decode_rescore.launches += 1
    return out


decode_rescore.launches = 0


def decode_scan_topk(codes: torch.Tensor, table: torch.Tensor,
                     rows: torch.Tensor, qp: torch.Tensor, k: int,
                     block_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes-resident search: window scan (K1) → top-2k windows → exact f32
    rescore of their winners (K2) → top-k.

    Returns (sq_dists (nq, k) f32 ascending, labels (nq, k) int32); distances
    are exact ADC sums for the returned ids; −1 / +inf fill missing entries.
    """
    n = codes.shape[0]
    scores, ids = decode_window_scan(codes, table, qp, block_rows)
    invalid = ids >= n          # the window's best row was padding
    scores = torch.where(invalid, torch.inf, scores)
    kk = min(2 * k, scores.shape[1])
    _, pos = _select_lowest(scores, kk)
    top_ids = torch.where(torch.gather(invalid, 1, pos), -1,
                          torch.gather(ids, 1, pos))
    d2 = decode_rescore(codes, top_ids.contiguous(), rows, qp)
    if kk < k:
        d2 = torch.nn.functional.pad(d2, (0, k - kk), value=torch.inf)
        top_ids = torch.nn.functional.pad(top_ids, (0, k - kk), value=-1)
    top, pos2 = _select_lowest(d2, k)
    out_ids = torch.gather(top_ids, 1, pos2)
    return top, torch.where(torch.isfinite(top), out_ids, -1)


def _select_lowest(scores: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries along dim 1, ascending, ties to the lower
    position: (values, positions int64), the order ``jax.lax.top_k(−x)``
    gives; ``torch.topk`` picks another set among equal scores. Every
    selection of the port goes through here, the running merges of the
    decoded tier and of ``exact_search`` where a cheaper ``torch.topk``
    could not be shown to keep JAX's set (``distances.lowest_over_blocks``).

    f32 scores are compared as JAX compares them, in IEEE total order (−0
    below +0): their bits, negative floats flipped, as int32. Up to
    ``_SORT_WIDTH`` columns (or for another dtype than f32 and int32) a
    stable sort of those does it; wider, one ``torch.topk`` of int64 keys
    that order as (score, position)."""
    bits = _ordered(scores)
    if scores.shape[1] <= _SORT_WIDTH or bits.dtype != torch.int32:
        pos = _lowest_sorted(bits, k)
    else:
        pos = _lowest_keyed(bits, k)
    return torch.gather(scores, 1, pos), pos


def _ordered(scores: torch.Tensor) -> torch.Tensor:
    """``scores`` as values whose order is JAX's: f32 as int32 bits with
    negative floats flipped (IEEE total order, −0 below +0), other dtypes
    as they are."""
    if scores.dtype != torch.float32:
        return scores
    bits = scores.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _lowest_sorted(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k lowest, ties to the lower position: the first k
    of a stable sort of the whole row, copied out of it, so that a caller
    who keeps them does not keep the whole (rows, width) sort alive."""
    return torch.sort(bits, dim=1, stable=True).indices[:, :k].contiguous()


def _lowest_keyed(bits: torch.Tensor, k: int) -> torch.Tensor:
    """The same, by one ``torch.topk`` of int64 keys that order as (value,
    position), so that no two keys tie (``bits`` int32)."""
    cols = torch.arange(bits.shape[1], dtype=torch.int64, device=bits.device)
    keys = (bits.to(torch.int64) << 32) | cols
    return torch.topk(keys, k, dim=1, largest=False, sorted=True).indices


def lut_sums(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """(nq, rows) ``Σ_s luts[q, s, codes[row, s]]`` in ``luts``' dtype,
    added one subspace at a time, s = 0 … M−1, into one (nq, rows) buffer
    (the order K3 adds in)."""
    codes = codes.to(torch.int64)
    acc = torch.zeros((luts.shape[0], codes.shape[0]), dtype=luts.dtype,
                      device=luts.device)
    for s in range(codes.shape[1]):
        acc += torch.index_select(luts[:, s, :], 1, codes[:, s])
    return acc


def _unpack_fast4(keys: torch.Tensor, block_rows: int, int8: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3/K4 keys → (scores, global row ids int32): f32 scores with the
    index bits zeroed for K3, the int32 sums ``key >> idx_bits`` for K4."""
    if not int8:
        return _unpack(keys, block_rows)
    idx_bits = _idx_bits(block_rows)
    base = torch.arange(keys.shape[1], dtype=torch.int32,
                        device=keys.device) * block_rows
    return keys >> idx_bits, (keys & ((1 << idx_bits) - 1)) + base[None, :]


def _check_fast4(codes, luts, block_rows, n_win):
    """Shape and dtype checks shared by K3/K4 and their plain version;
    returns (n_win, int8)."""
    dev = codes.device
    int8 = luts.dtype == torch.int8
    _check(codes, "codes", torch.uint8, 2, dev)
    _check(luts, "luts", torch.int8 if int8 else torch.float32, 3, dev)
    n, m = codes.shape
    c = luts.shape[2]
    if luts.shape[1] != m:
        raise ValueError(f"codes (n, {m}) and luts {tuple(luts.shape)} "
                         "disagree on M")
    if c & (c - 1) or c > 256:
        raise ValueError(f"LUT width {c} must be a power of 2 <= 256")
    n_win = -(-n // block_rows) if n_win is None else n_win
    if n_win * block_rows < n:
        raise ValueError(f"{n_win} windows of {block_rows} rows do not "
                         f"cover {n} rows")
    if int8 and m << _idx_bits(block_rows) > 1 << 24:
        raise ValueError(f"M = {m} at {block_rows}-row windows overflows "
                         "K4's packed int32 key (M·2^idx_bits ≤ 2^24)")
    return n_win, int8


def _fast4_tile(m: int, c: int, lut_bytes: int, nq: int, block_rows: int
                ) -> Tuple[int, int]:
    """(queries per block, dynamic shared memory bytes) of K3/K4: the
    block's codes (256 rows, ceil(M/4) words each padded to an odd count),
    its window minima and its query tile's LUT; the tile is as large as
    ``_FAST4_LUT_BYTES`` allows, at least one query, and whole groups of the
    kernel's 8 accumulators once it holds 8."""
    per_q = m * c * lut_bytes
    q_tile = max(1, min(_FAST4_MAX_Q_TILE, _FAST4_LUT_BYTES // per_q, nq))
    if q_tile >= _FAST4_QJ:
        q_tile -= q_tile % _FAST4_QJ
    words = ((m + 3) // 4) | 1
    win_per_tile = min(_FAST4_ROWS, (_FAST4_ROWS - 1) // block_rows + 2)
    smem = 4 * (_FAST4_ROWS * words + q_tile * win_per_tile) + q_tile * per_q
    if smem > _SMEM_LIMIT:
        raise ValueError(f"K3/K4: one query's LUT ({per_q} B at M = {m}, "
                         f"C = {c}) does not fit a block's shared memory")
    return q_tile, smem


class Fast4Form(NamedTuple):
    """How K3/K4 run at one shape: ``"mma"`` (the tensor-core form) with
    ``q_tile`` queries a tile, the table zero-padded to width ``c`` and depth
    ``kpad``; or ``"gather"`` with ``_fast4_tile``'s query tile (``c`` and
    ``kpad`` then unused). ``smem`` is the block's dynamic shared memory."""
    kind: str
    q_tile: int
    smem: int
    c: int = 0
    kpad: int = 0


def _fast4_form(m: int, c: int, int8: bool, nq: int, block_rows: int
                ) -> Fast4Form:
    """The one rule that picks K3/K4's form: the tensor-core form where the
    query tile's LUT (64 queries of bf16 for K3, 128 of s8 for K4, the width
    padded to at least 16 and the depth M·C to whole groups of k steps), the
    warps' code rings and the window minima fit a block's shared memory;
    the gather form otherwise (a wide table: M = 32, C = 256 takes 1 MB a
    tile). It is a rule on the shape, not a fallback."""
    n = _MMA_N[int8]
    cp = max(c, _MMA_MIN_C)
    step = _MMA_KSTEP[int8] * _MMA_GROUP
    kpad = -(-(m * cp) // step) * step
    ms = (-(-m // 16) * 16) | 16          # a ring row: an odd count of 16 bytes
    wgs = _MMA_WGS[int8]
    smem = (n * kpad * (1 if int8 else 2) + wgs * 4 * _MMA_RING * 16 * ms
            + wgs * 2 * 4 * n * 4)
    if smem <= _SMEM_LIMIT:
        return Fast4Form("mma", n, smem, cp, kpad)
    q_tile, smem = _fast4_tile(m, c, 1 if int8 else 4, nq, block_rows)
    return Fast4Form("gather", q_tile, smem)


def _fast4_lut_tiles(luts: torch.Tensor, form: Fast4Form) -> torch.Tensor:
    """The tensor-core form's B operand: ``luts`` (nq, M, C) as bf16 (K3, the
    entries rounded as K3 sums them) or s8 (K4), zero-padded to width
    ``form.c``, depth ``form.kpad`` and a whole number of ``form.q_tile``-query
    tiles, in K-major core-matrix order: element (q, k) at byte
    (q // 8)·8·kpad·e + (k·e // 16)·128 + (q % 8)·16 + k·e % 16, e its size
    in bytes, so that each query tile is one contiguous block the kernel
    copies as it is. Returns the flat bytes (uint8)."""
    nq, m, c = luts.shape
    int8 = luts.dtype == torch.int8
    t = luts if int8 else luts.to(torch.bfloat16)
    t = torch.nn.functional.pad(t, (0, form.c - c)).reshape(nq, m * form.c)
    nq_pad = -(-nq // form.q_tile) * form.q_tile
    t = torch.nn.functional.pad(t, (0, form.kpad - m * form.c, 0, nq_pad - nq))
    per16 = 16 if int8 else 8                 # elements in 16 bytes
    t = t.view(nq_pad // 8, 8, form.kpad // per16, per16).permute(0, 2, 1, 3)
    return t.contiguous().view(torch.uint8).reshape(-1)


def fast4_window_scan_ref(codes: torch.Tensor, luts: torch.Tensor,
                          block_rows: int, n_win: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3/K4, same arguments and result. K3 adds
    the bf16-rounded entries in f32 in subspace order, rounding each
    addition to nearest, as the kernel's gather form does, so the two give
    the same keys bit for bit; the tensor-core form adds in the same order
    with the tensor cores' rounding (``k3_accumulation_rounding``). K4 sums
    in int32, exactly as both forms do."""
    n_win, int8 = _check_fast4(codes, luts, block_rows, n_win)
    n = codes.shape[0]
    nq = luts.shape[0]
    dev = codes.device
    idx_bits = _idx_bits(block_rows)
    mask = (1 << idx_bits) - 1
    tbl = (luts.to(torch.int32) if int8
           else luts.to(torch.bfloat16).to(torch.float32))
    keys = torch.empty((nq, n_win), dtype=torch.int32, device=dev)
    wins = max(1, _REF_CHUNK_ROWS // block_rows)
    for w_start in range(0, n_win, wins):
        w_end = min(n_win, w_start + wins)
        rs, re = w_start * block_rows, w_end * block_rows
        blk = codes[rs:min(re, n)].to(torch.int64)
        # rows past n count as code 0, like JAX's zero-padded codes
        blk = torch.nn.functional.pad(blk, (0, 0, 0, re - rs - blk.shape[0]))
        acc = lut_sums(blk, tbl)
        local = torch.arange(re - rs, dtype=torch.int32, device=dev) % block_rows
        if int8:
            k = acc * (1 << idx_bits) | local[None, :]
        else:
            acc = torch.where(acc > 0, acc, 0.0).contiguous()
            k = (acc.view(torch.int32) & ~mask) | local[None, :]
        keys[:, w_start:w_end] = k.reshape(nq, w_end - w_start,
                                           block_rows).amin(dim=2)
    return _unpack_fast4(keys, block_rows, int8)


def fast4_window_scan(codes: torch.Tensor, luts: torch.Tensor,
                      block_rows: int, n_win: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 (f32 ``luts``) or K4 (int8 ``luts``): per-(query, window) best row
    of the LUT-sum scan.

    codes (n, M) u8 row-major, every code < C; luts (nq, M, C), C a power
    of 2 ≤ 256: f32 for K3, which sums the bf16-rounded entries in f32 and
    clamps at 0, or int8 (the u8 LUT − 128) for K4, which sums in int32.
    Windows are consecutive runs of ``block_rows`` rows, ``n_win`` of them
    (enough to cover n by default); rows past n count as code 0. Returns
    (scores (nq, n_win), row ids (nq, n_win) int32 global), as the JAX
    ``fast4_window_scan`` does: f32 window minima with the low index bits
    zeroed for K3, int32 sums for K4; ties go to the lower row.
    """
    n_win, int8 = _check_fast4(codes, luts, block_rows, n_win)
    dev = codes.device
    if dev.type == "cpu":
        return fast4_window_scan_ref(codes, luts, block_rows, n_win)
    if dev.type != "cuda":
        raise ValueError(f"fast4_window_scan runs on cpu or cuda, not {dev}")
    n, m = codes.shape
    nq, _, c = luts.shape
    form = _fast4_form(m, c, int8, nq, block_rows)
    keys = torch.full((nq, n_win), _INT32_MAX, dtype=torch.int32, device=dev)
    if nq and n_win:
        with torch.cuda.device(dev):
            tiles = (_fast4_lut_tiles(luts, form) if form.kind == "mma"
                     else None)
            lib = _build.library()
            err = lib.vaq_fast4_window_scan(
                codes.data_ptr(), n, m, luts.data_ptr(), int(int8), nq,
                form.c or c, block_rows, _idx_bits(block_rows), n_win,
                form.q_tile, form.smem,
                None if tiles is None else tiles.data_ptr(), form.kpad,
                keys.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(err, "fast4_window_scan")
        fast4_window_scan.launches["K4" if int8 else "K3"] += 1
    return _unpack_fast4(keys, block_rows, int8)


# one wrapper, two kernels: a count for each
fast4_window_scan.launches = {"K3": 0, "K4": 0}


def k3_accumulation_rounding(device) -> str:
    """How K3's tensor-core form adds a k step's product to its f32
    accumulator, read through K3 itself on ``device`` (a CUDA device): two
    queries over five subspaces whose first four entries sum exactly to
    2 − 2⁻²³ and whose fifth adds 0.75·2⁻²³ (query 0) or 0.25·2⁻²³ (query
    1), in one 64-row window of rows all code 0. To nearest the sums are 2
    and 2 − 2⁻²³; toward zero 2 − 2⁻²³ twice; upward 2 twice (the packed
    key's index bits lie below the last place either way). Returns
    "nearest", "toward zero", "upward" or "other [...]". Its launch counts
    as one of K3's."""
    u = 2.0 ** -23
    head = [1.0, 255 / 256, 255 * 2.0 ** -16, 127 * u]
    luts = torch.zeros((2, 5, 16))
    luts[0, :, 0] = torch.tensor(head + [0.75 * u])
    luts[1, :, 0] = torch.tensor(head + [0.25 * u])
    codes = torch.zeros((64, 5), dtype=torch.uint8, device=device)
    assert _fast4_form(5, 16, False, 2, 64).kind == "mma"
    s, _ = fast4_window_scan(codes, luts.to(device), 64)
    got = tuple(float(v) == 2.0 for v in s[:, 0].cpu())
    return {(True, False): "nearest", (False, False): "toward zero",
            (True, True): "upward"}.get(got, f"other {s[:, 0].tolist()}")


def fast4_scan_topk(codes: torch.Tensor, luts: torch.Tensor, k: int,
                    block_rows: int = 512,
                    luts8: Optional[torch.Tensor] = None,
                    n_valid: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FAST-path search: window scan (K3, or K4 when ``luts8`` is given) →
    top-k windows → the f32 ``luts`` sum of each window's winner → top-k.

    codes (n, M) u8; luts (nq, M, C) f32; luts8 (nq, M, C) u8, the
    quantized tables whose sums pick the winners (the reference's FAST
    semantics, VAQ.cpp:1778-1836); rows at or past ``n_valid`` (default n)
    never return. The rows are padded to a multiple of 8·``block_rows`` as
    JAX pads them (scan_pallas.py:636-701): padded rows count as code 0 and
    a window whose best row is padding carries no candidate. Both selections
    break ties toward the lower position, as JAX's ``top_k`` does. The
    stages run in profiler ranges ``fast.scan``, ``fast.select``,
    ``fast.rescore`` and ``fast.topk``. Returns
    (sq_dists (nq, k) f32 ascending, labels (nq, k) int32); −1 / +inf fill
    missing entries.
    """
    n = codes.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    n_win = (n + (-n) % (W_PER_CELL * block_rows)) // block_rows
    with record_function("fast.scan"):
        scan_luts = luts if luts8 is None else \
            (luts8.to(torch.int16) - 128).to(torch.int8)
        scores, ids = fast4_window_scan(codes, scan_luts, block_rows, n_win)
    with record_function("fast.select"):
        invalid = ids >= n_valid
        big = _INT32_MAX if scores.dtype == torch.int32 else torch.inf
        scores = torch.where(invalid, big, scores)
        kk = min(k, n_win)
        _, pos = _select_lowest(scores, kk)
        top_ids = torch.where(torch.gather(invalid, 1, pos), -1,
                              torch.gather(ids, 1, pos))
    with record_function("fast.rescore"):
        rows = top_ids.clamp(0, max(n - 1, 0)).to(torch.int64)
        cand = codes[rows].to(torch.int64).transpose(1, 2)     # (nq, M, kk)
        d2 = torch.gather(luts, 2, cand).sum(dim=1)
        d2 = torch.where((top_ids >= 0) & (top_ids < n_valid), d2, torch.inf)
    with record_function("fast.topk"):
        if kk < k:
            d2 = torch.nn.functional.pad(d2, (0, k - kk), value=torch.inf)
            top_ids = torch.nn.functional.pad(top_ids, (0, k - kk), value=-1)
        top, pos2 = _select_lowest(d2, k)
        out_ids = torch.gather(top_ids, 1, pos2)
        return top, torch.where(torch.isfinite(top), out_ids, -1)
