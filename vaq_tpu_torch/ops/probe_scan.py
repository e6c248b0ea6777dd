"""Group-min scoring of the TI/IVF cluster probe (kernel K5).

The counterpart of ``vaq_tpu/ops/probe_pallas.py``: ``poison_pattern`` (:80),
the group-size half of ``pick_gs_rt`` (:140-155) and
``groupmin_window_scan`` (:249) with both of its Pallas bodies,
``_groupmin_kernel`` (:158, K5) and ``_groupmin_kernel_t`` (:205, K6).

Every probed (cluster × its dispatched queries) pair is scored and each
``gs``-row group (window) of the cluster's bucket is reduced to one f32, the
group's smallest

    dist = ((−2q)·x̂ + Σ_d w_d·x̂_d²) + qn,   qn = 0.25·‖−2q‖²,

where ``−2q`` is the cluster's bf16 query slab (for int8 rows with the
per-dimension scales folded in, so ``qn`` is ‖q/s‖², not ‖q‖²) and
``w = 1/scales²`` (ones for bf16 rows). The minima stay f32: a bf16 min
collapsed recall on the TPU (probe_pallas.py:195-200).

K6 was the same computation over a transposed (ncl·d, cap) layout that the
TPU needed at d % 128 ≠ 0 (int8 rows lane-pad d = 96 to 128 there). A GPU
stores (cap, 96) int8 rows unpadded, so the port keeps one row-major layout
and K5 takes any d that is a multiple of 16; K6 is K5 at d = 96.

The wrapper takes the plain PyTorch version (``groupmin_window_scan_ref``)
only for CPU tensors; for a CUDA tensor it launches
``csrc/groupmin_window_scan.cu`` or raises. It counts its launches in
``groupmin_window_scan.launches``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vaq_tpu_torch import _build
from vaq_tpu_torch.ops.scan_codes import _check

# Bound on the elements of one (clusters, qcap, cap) f32 block of the plain
# version (256 MB).
_REF_BLOCK_ELEMS = 1 << 26
# Caps must be multiples of this: the CUDA kernel's 128-row tiles end in
# half a tile where cap is not a multiple of 128.
KERNEL_TILE_ROWS = 64


def poison_pattern(d: int) -> np.ndarray:
    """The int8 row of padding and dead bucket slots: alternating ±127.

    Its reconstruction has the largest possible norm and, for natural
    queries, a small dot product, so its distance ranks at or above every
    live row's and a window of padding never wins a group-min. A ranking
    guard only: the rescore masks dead slots by ``bucket_ids == -1``."""
    pat = np.full((d,), 127, dtype=np.int8)
    pat[1::2] = -127
    return pat


def pick_gs(cap: int, target_ng: int = 240, gs_max: int = 256) -> int:
    """The group size for a bucket capacity, by JAX's whole rule
    (``pick_gs_rt``, probe_pallas.py:140-155): grow gs while the bucket
    keeps more than ``target_ng`` windows, then back off while no row tile
    rt (a multiple of 512 dividing cap) has rt % (8·gs) == 0. That back-off
    was forced by Mosaic's tiling, not by anything on a GPU, but gs decides
    which windows exist and so which rows survive to the rescore: it is
    kept so that the port's results match the JAX package's."""
    gs = 8
    while gs < gs_max and cap // gs > target_ng:
        gs *= 2
    while gs > 8:
        if any(cap % rt == 0 and rt % (8 * gs) == 0
               for rt in range(512, cap + 1, 512)):
            return gs
        gs //= 2
    return 8


def _check_args(qsl, rows, dim_w, ncl, cap, gs, n_slots):
    dev = qsl.device
    _check(qsl, "qsl", torch.bfloat16, 3, dev)
    if rows.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"rows must be int8 or bf16, got {rows.dtype}")
    _check(rows, "rows", rows.dtype, 2, dev)
    _check(dim_w, "dim_w", torch.float32, 1, dev)
    if n_slots is not None:
        _check(n_slots, "n_slots", torch.int32, 1, dev)
        if n_slots.shape[0] != ncl:
            raise ValueError(f"n_slots has {n_slots.shape[0]} entries, "
                             f"expected ncl = {ncl}")
    d = qsl.shape[2]
    if qsl.shape[0] != ncl or rows.shape != (ncl * cap, d) or \
            dim_w.shape[0] != d:
        raise ValueError(f"qsl {tuple(qsl.shape)}, rows {tuple(rows.shape)} "
                         f"and dim_w {tuple(dim_w.shape)} disagree with "
                         f"ncl = {ncl}, cap = {cap}")
    if d % 16:
        raise ValueError(f"d = {d} must be a multiple of 16")
    if gs < 8 or gs & (gs - 1):
        raise ValueError(f"gs = {gs} must be a power of two ≥ 8")
    if cap % max(gs, KERNEL_TILE_ROWS):
        raise ValueError(f"cap = {cap} must be a multiple of "
                         f"max(gs, {KERNEL_TILE_ROWS})")


def groupmin_window_scan_ref(qsl: torch.Tensor, rows: torch.Tensor,
                             dim_w: torch.Tensor, ncl: int, cap: int, gs: int,
                             n_slots: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of K5, same arguments and result."""
    _, qcap, d = qsl.shape
    ng = cap // gs
    qf = qsl.to(torch.float32)
    qn = 0.25 * torch.sum(qf * qf, dim=2)                   # (ncl, qcap)
    rows3 = rows.view(ncl, cap, d)
    out = torch.empty((ncl, qcap, ng), dtype=torch.float32, device=qsl.device)
    step = max(1, _REF_BLOCK_ELEMS // max(qcap * cap, 1))
    for c0 in range(0, ncl, step):
        r = rows3[c0:c0 + step].to(torch.float32)            # (cb, cap, d)
        dot = torch.bmm(qf[c0:c0 + step], r.transpose(1, 2))  # (cb, qcap, cap)
        xn = torch.sum(r * r * dim_w, dim=2)                 # (cb, cap)
        dist = (dot + xn[:, None, :]) + qn[c0:c0 + step, :, None]
        out[c0:c0 + step] = dist.view(r.shape[0], qcap, ng, gs).amin(dim=3)
    if n_slots is not None:
        slot = torch.arange(qcap, device=qsl.device)
        empty = slot[None, :] >= n_slots[:, None].to(torch.int64)
        out = torch.where(empty[:, :, None], torch.inf, out)
    return out


def groupmin_window_scan(qsl: torch.Tensor, rows: torch.Tensor,
                         dim_w: torch.Tensor, ncl: int, cap: int, gs: int,
                         n_slots: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """K5: per (cluster, query slot, gs-row group) min squared distance.

    qsl (ncl, qcap, d) bf16 query slabs, −2-scaled (and scale-folded for
    int8 rows); rows (ncl·cap, d) int8 or bf16, the buckets row-major, any
    d that is a multiple of 16; dim_w (d,) f32 norm weights; n_slots
    optional (ncl,) int32 count of occupied slots per cluster (the dispatch
    fills slots in order), slots at or past it are not scored and read
    +inf. Returns (ncl, qcap, cap // gs) f32 — JAX's (ncl, ng, qcap) with
    the last two axes swapped, so the per-query merge gathers rows without
    a transpose."""
    _check_args(qsl, rows, dim_w, ncl, cap, gs, n_slots)
    dev = qsl.device
    if dev.type == "cpu":
        return groupmin_window_scan_ref(qsl, rows, dim_w, ncl, cap, gs,
                                        n_slots)
    if dev.type != "cuda":
        raise ValueError(f"groupmin_window_scan runs on cpu or cuda, not {dev}")
    _, qcap, d = qsl.shape
    out = torch.empty((ncl, qcap, cap // gs), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _build.library()
        err = lib.vaq_groupmin_window_scan(
            qsl.data_ptr(), rows.data_ptr(), int(rows.dtype == torch.int8),
            dim_w.data_ptr(), None if n_slots is None else n_slots.data_ptr(),
            ncl, cap, qcap, d, gs, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "groupmin_window_scan")
    groupmin_window_scan.launches += 1
    return out


groupmin_window_scan.launches = 0
