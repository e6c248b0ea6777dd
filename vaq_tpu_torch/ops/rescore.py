"""Gather-rescore of the TI/IVF probe's winner windows (kernel K7).

The counterpart of ``vaq_tpu/ops/rescore_pallas.py``: ``gather_rescore``
(:175) with its Pallas bodies ``_kernel`` (:105, K7) and ``_kernel_t``
(:39, K8, the transposed bucket layout of d % 128 ≠ 0; the port stores every
d row-major, so K8 is K7 at d = 96). For each query and each of its m winner
windows (a window is gs consecutive bucket rows, ``wblk`` its id) it scores
every row x of the window as

    2·(q_bf16 · x) − Σ_d w_d·x_d²      (f32, the norm in full f32),

the monotone score ‖q‖² − ‖q − x̂‖² for x̂ = x / scales with ``q`` the
scale-folded query and ``w = 1/scales²`` (ones for bf16 rows). Masking dead
slots (``bucket_ids == −1``) stays with the caller, as in JAX.

The plain version (``gather_rescore_ref``) is the XLA formulation that the
JAX package itself runs off the TPU (ivf.py:722-734). The wrapper takes it
only for CPU tensors; for a CUDA tensor it launches
``csrc/gather_rescore.cu`` or raises. It counts its launches in
``gather_rescore.launches``.
"""

from __future__ import annotations

import torch

from vaq_tpu_torch import _build
from vaq_tpu_torch.ops.scan_codes import _check


def _check_args(q_eff, dim_w, rows, wblk, gs):
    dev = q_eff.device
    _check(q_eff, "q_eff", torch.float32, 2, dev)
    _check(dim_w, "dim_w", torch.float32, 1, dev)
    if rows.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"rows must be int8 or bf16, got {rows.dtype}")
    _check(rows, "rows", rows.dtype, 2, dev)
    _check(wblk, "wblk", torch.int32, 2, dev)
    d = q_eff.shape[1]
    if rows.shape[1] != d or dim_w.shape[0] != d or \
            wblk.shape[0] != q_eff.shape[0]:
        raise ValueError(f"q_eff {tuple(q_eff.shape)}, dim_w "
                         f"{tuple(dim_w.shape)}, rows {tuple(rows.shape)} and "
                         f"wblk {tuple(wblk.shape)} disagree")
    if d % 16:
        raise ValueError(f"d = {d} must be a multiple of 16")
    if gs < 1 or rows.shape[0] % gs:
        raise ValueError(f"rows ({rows.shape[0]}) must be whole windows of "
                         f"gs = {gs} rows")


def gather_rescore_ref(q_eff: torch.Tensor, dim_w: torch.Tensor,
                       rows: torch.Tensor, wblk: torch.Tensor, gs: int
                       ) -> torch.Tensor:
    """Plain PyTorch version of K7, same arguments and result."""
    nq, d = q_eff.shape
    n_blk = rows.shape[0] // gs
    ids = wblk.to(torch.int64)
    bad = (ids < 0) | (ids >= n_blk)
    blk = rows.view(n_blk, gs, d)[ids.clamp(0, max(n_blk - 1, 0))]
    blk = blk.to(torch.float32)                            # (nq, m, gs, d)
    qb = q_eff.to(torch.bfloat16).to(torch.float32)
    inner = torch.einsum("qd,qmgd->qmg", qb, blk)
    norms = torch.einsum("qmgd,d->qmg", blk * blk, dim_w)
    return torch.where(bad[:, :, None], torch.nan, 2.0 * inner - norms)


def gather_rescore(q_eff: torch.Tensor, dim_w: torch.Tensor,
                   rows: torch.Tensor, wblk: torch.Tensor, gs: int
                   ) -> torch.Tensor:
    """K7: scores of every row of each query's winner windows.

    q_eff (nq, d) f32 scale-folded queries (rounded to bf16 inside, as in
    JAX); dim_w (d,) f32; rows (ncl·cap, d) int8 or bf16, the buckets
    row-major, any d that is a multiple of 16; wblk (nq, m) int32 window
    ids, window w being rows [w·gs, (w+1)·gs). Returns (nq, m, gs) f32
    ``2·q·x − Σ w·x²``; NaN for a window id outside [0, rows/gs)."""
    _check_args(q_eff, dim_w, rows, wblk, gs)
    dev = q_eff.device
    if dev.type == "cpu":
        return gather_rescore_ref(q_eff, dim_w, rows, wblk, gs)
    if dev.type != "cuda":
        raise ValueError(f"gather_rescore runs on cpu or cuda, not {dev}")
    if rows.data_ptr() % 16:  # the kernel reads rows in aligned words
        raise ValueError("rows must start on a 16-byte boundary")
    nq, d = q_eff.shape
    m = wblk.shape[1]
    q_bf = q_eff.to(torch.bfloat16).contiguous()
    out = torch.empty((nq, m, gs), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _build.library()
        err = lib.vaq_gather_rescore(
            q_bf.data_ptr(), dim_w.data_ptr(), rows.data_ptr(),
            int(rows.dtype == torch.int8), rows.shape[0] // gs,
            wblk.data_ptr(), nq, m, gs, d, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "gather_rescore")
    gather_rescore.launches += 1
    return out


gather_rescore.launches = 0
