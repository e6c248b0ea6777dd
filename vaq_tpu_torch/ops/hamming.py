"""Popcount distances between packed bit-vectors (kernel H1).

The binary engine's scan. JAX writes it inline in XLA as XOR (or AND/OR) +
``jax.lax.population_count`` + a word sum: the flat Hamming scan
(``vaq_tpu/binary.py:121-122``), the progressive filters (:352-353,
:401-402), the cluster probe's block scoring (:738-739) and the Jaccard
distance (``vaq_tpu/ops/distances.py:86-91``). It has no Pallas kernel;
here one function, :func:`popcount_dists`, serves all of them:

- ``op="xor"``: the Hamming distance, int32;
- ``op="jaccard"``: ``1 − inter / max(union, 1)`` in f32, 0 where the union
  is empty, JAX's expression in JAX's order (bit-equal values);
- ``B = 1`` is the flat scan, ``B = cb`` the probe's cluster blocks;
- a word range ``[lo, hi)`` serves the filters' sub-vector stages.

Words are the JAX package's uint32 held as int32 (the same bits, viewed):
XOR, AND, OR and popcount do not care about the sign. The plain version
(:func:`popcount_dists_ref`) widens each word to int64 and masks it to its
32 bits before any shift, so no sign extension leaks into the count. The
wrapper takes it only for tensors on the CPU; for a CUDA tensor it launches
``csrc/hamming_scan.cu`` or raises. It counts its launches in
``popcount_dists.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from vaq_tpu_torch import _build
from vaq_tpu_torch.ops.scan_codes import _check

WORD = 32
OPS = ("xor", "jaccard")
# Bound on the (B, nq, rows, words) int64 temporaries of the plain version.
_REF_ELEMS = 1 << 23


def _popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 or int64 holding one), as int64:
    the SWAR count on the word masked to 32 bits."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101 & 0xFFFFFFFF) >> 24


def jaccard_from_counts(inter: torch.Tensor, union: torch.Tensor
                        ) -> torch.Tensor:
    """``1 − inter / max(union, 1)`` in f32, 0 where the union is empty —
    JAX's expression (distances.py:90-92), in its order."""
    frac = inter.to(torch.float32) / torch.clamp_min(
        union.to(torch.float32), 1.0)
    return torch.where(union == 0, 0.0, 1.0 - frac)


def _check_args(q_words, x_words, op, lo, hi):
    dev = q_words.device
    _check(q_words, "q_words", torch.int32, 3, dev)
    _check(x_words, "x_words", torch.int32, 3, dev)
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    b, _, w = q_words.shape
    if x_words.shape[0] != b or x_words.shape[2] != w:
        raise ValueError(f"q_words {tuple(q_words.shape)} and x_words "
                         f"{tuple(x_words.shape)} disagree on B or W")
    hi = w if hi is None else hi
    if not 0 <= lo < hi <= w:
        raise ValueError(f"word range [{lo}, {hi}) outside [0, {w})")
    return hi


def popcount_dists_ref(q_words: torch.Tensor, x_words: torch.Tensor,
                       op: str = "xor", lo: int = 0,
                       hi: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of H1, same arguments and result."""
    hi = _check_args(q_words, x_words, op, lo, hi)
    b, nq, _ = q_words.shape
    n = x_words.shape[1]
    q = q_words[:, :, lo:hi]
    x = x_words[:, :, lo:hi]
    out = torch.empty((b, nq, n),
                      dtype=torch.int32 if op == "xor" else torch.float32,
                      device=q_words.device)
    step = max(1, _REF_ELEMS // max(b * nq * (hi - lo), 1))
    for r0 in range(0, n, step):
        xs = x[:, None, r0:r0 + step, :]
        qs = q[:, :, None, :]
        if op == "xor":
            out[:, :, r0:r0 + step] = _popcount(qs ^ xs).sum(3)
        else:
            inter = _popcount(qs & xs).sum(3)
            union = _popcount(qs | xs).sum(3)
            out[:, :, r0:r0 + step] = jaccard_from_counts(inter, union)
    return out


def popcount_dists(q_words: torch.Tensor, x_words: torch.Tensor,
                   op: str = "xor", lo: int = 0,
                   hi: Optional[int] = None) -> torch.Tensor:
    """H1: popcount distances of every (query, row) pair of each batch.

    q_words (B, nq, W) and x_words (B, n, W) int32 (packed uint32 words, as
    their bits); only words ``[lo, hi)`` (default all) count. Returns
    (B, nq, n): the Hamming distance as int32 for ``op="xor"``, the Jaccard
    distance as f32 for ``op="jaccard"``."""
    hi = _check_args(q_words, x_words, op, lo, hi)
    dev = q_words.device
    if dev.type == "cpu":
        return popcount_dists_ref(q_words, x_words, op, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"popcount_dists runs on cpu or cuda, not {dev}")
    b, nq, w = q_words.shape
    n = x_words.shape[1]
    out = torch.empty((b, nq, n),
                      dtype=torch.int32 if op == "xor" else torch.float32,
                      device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            lib = _build.library()
            err = lib.vaq_popcount_dists(
                q_words.data_ptr(), x_words.data_ptr(), b, nq, n, w, lo,
                hi - lo, int(op == "jaccard"), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(err, "popcount_dists")
        popcount_dists.launches += 1
    return out


popcount_dists.launches = 0
