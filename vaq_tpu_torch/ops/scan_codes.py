"""Codes-resident search: decode-then-dot over the raw u8 codes.

The counterpart of the decode path of ``vaq_tpu/ops/scan_pallas.py``
(``decode_window_scan``, ``decode_rescore``, ``decode_scan_topk`` and the two
table builders). Device memory holds only the codes, M bytes per row, stored
row-major (n, M) u8; the TPU's transposed (M, n) layout existed only for its
u8 tile. The search is

1. **K1** ``decode_window_scan`` (``csrc/decode_window_scan.cu``): for each
   (query, window of ``block_rows`` rows) the best row by
   ``‖x̂‖² − 2·q·x̂ + ‖q‖²`` over the bf16-rounded decode, as one packed key;
2. an exact ``torch.topk`` over the windows (the JAX version's
   ``approx_max_k`` on the TPU, exact ``top_k`` in its interpret mode), with
   a 2k over-fetch;
3. **K2** ``decode_rescore`` (``csrc/decode_rescore.cu``): exact f32
   ``‖q − x̂‖²`` of the winners from the f32 decode rows;
4. a top-k of those.

Each kernel wrapper takes its plain PyTorch version (``*_ref`` below) only
for tensors on the CPU; for a CUDA tensor it launches the kernel or raises.
Each counts its kernel launches in a plain int attribute, ``launches``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vaq_tpu_torch import _build

_INT32_MAX = 2**31 - 1
# Rows per chunk of the plain K1 version (bounds its (nq, rows) f32 scores).
_REF_CHUNK_ROWS = 65536
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


def build_decode_table(centroids, device: torch.device | str = "cpu"
                       ) -> torch.Tensor:
    """(C, M·L) bf16 decode table for K1: the centroid rows rounded to bf16
    (round-to-nearest-even, as the JAX table's ml_dtypes cast)."""
    return _centroid_rows(centroids).to(torch.bfloat16).to(device)


def build_decode_rows(centroids, device: torch.device | str = "cpu"
                      ) -> torch.Tensor:
    """(C, M·L) f32 decode rows for K2."""
    return _centroid_rows(centroids).to(device)


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
    q_bf = qp.to(torch.bfloat16).contiguous()
    qn = torch.sum(qp * qp, dim=1).contiguous()
    keys = torch.full((nq, n_win), _INT32_MAX, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        lib = _build.library()
        err = lib.vaq_decode_window_scan(
            codes.data_ptr(), n, m, table.data_ptr(), q_bf.data_ptr(),
            qn.data_ptr(), nq, d, block_rows, _idx_bits(block_rows), n_win,
            keys.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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
    _, pos = torch.topk(scores, kk, dim=1, largest=False, sorted=False)
    top_ids = torch.where(torch.gather(invalid, 1, pos), -1,
                          torch.gather(ids, 1, pos))
    d2 = decode_rescore(codes, top_ids.contiguous(), rows, qp)
    if kk < k:
        d2 = torch.nn.functional.pad(d2, (0, k - kk), value=torch.inf)
        top_ids = torch.nn.functional.pad(top_ids, (0, k - kk), value=-1)
    top, pos2 = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    out_ids = torch.gather(top_ids, 1, pos2)
    return top, torch.where(torch.isfinite(top), out_ids, -1)
