"""On-card kernel parity gate: every hand-written CUDA kernel against its
plain PyTorch version, on the same CUDA tensors.

The counterpart of ``vaq_tpu/ops/kernel_check.py``, which runs each Pallas
kernel twice on the same device inputs, compiled through Mosaic and through
the interpreter. The port has no interpreter for its kernels: it calls each
kernel's wrapper (``scan_codes.decode_window_scan`` and so on), which
launches the kernel on a CUDA tensor, beside the wrapper's plain version
(``*_ref``) on the same tensors. :func:`kernel_parity_fields` checks, on a
live index and at JAX's shapes:

- K1 ``decode_window_scan`` on the index's first ``n_rows`` codes and
  ``nq`` projected queries at 64-row windows, as JAX does, and at 32- and
  16-row windows: below 64 rows the port's K1 meets its window minima in
  global memory by ``atomicMin``, a second epilogue JAX's kernel lacks;
- K2 ``decode_rescore`` on those codes (JAX's gate leaves it out);
- K3 ``fast4_window_scan`` on those codes with the index's f32 LUTs, in the
  form ``scan_codes._fast4_form`` picks for the index (the gather form at
  C = 256, the tensor-core form at C = 16), and K4 with its u8 LUTs where
  ``learn_quantization`` has run;
- K5 ``groupmin_window_scan`` at JAX's four group-min shapes; the d = 96
  one is JAX's transposed K6, which the port runs row-major, as its K6 is;
- K7 ``gather_rescore`` at JAX's three gather-rescore shapes; the d = 96
  one is the port's K8;
- H1 ``popcount_dists``, xor and Jaccard, on seeded packed words (JAX has
  no kernel there: its popcount is plain XLA);
- D1 ``decoded_topk_scan`` on those codes decoded to bf16 rows, at the
  over-fetch of k = 10 and of k = 100 (JAX leaves the tier to XLA).

Tolerances. Where they differ from JAX's, the reason is the port's kernels,
not a looser gate:

- K1: JAX gates at 1e-4 relative to the score. The port's K1 keeps only
  23 − idx_bits mantissa bits of each score (the low bits carry the row)
  and its tensor cores sum the dot in another order than the plain version
  (ROADMAP fault 1), so the scores agree to ``k1_rtol`` = 1e-5 +
  2^(idx_bits − 23) of the size of the terms summed, ‖x̂‖² + 2·Σ|q·x̂| +
  ‖q‖² (:func:`k1_terms`). Not of the score: on a live index a query's near
  rows score far below their norms, and a few last-bit differences of the
  terms are a large part of a small score. Window winners may differ only
  where the two rows' f64 scores tie within that, on at most 1% of windows.
- K2: f32 sums of squares in another order, rtol 1e-5.
- K3/K4: JAX gates its one-hot kernel bit for bit. K4 (int32 sums) and K3's
  gather form add the same entries in the same order as the plain version,
  so their keys are equal bit for bit, and so are K3's on the tensor cores
  where those add to nearest. An H100's ``wgmma`` truncates K3's f32 sums
  (``scan_codes.k3_accumulation_rounding`` reads "toward zero"), so there
  K3 is held as K1 is, relative to the score, with winners that differ only
  on ties, on at most 2% of windows.
- K5: JAX's limit, 4× the f64 reassociation envelope of
  :func:`groupmin_ref64_and_bound`, for the kernel and for the plain
  version; and the two within 1e-5 of the size of the terms summed
  (:func:`groupmin_term_scale`).
- K7: JAX's 2e-4 relative to max(|plain|, 1); and the two within 1e-5 of
  the terms summed (:func:`rescore_term_scale`).
- H1: bit-equal (integer counts, and one IEEE division for Jaccard).
- D1: its scores are the plain version's up to the order of the f32 sums
  of exact bf16 products, so its kk candidates are the plain version's
  except where rows tie within 1e-5 of the size of the terms summed,
  ‖x‖² + 2·Σ|q·x| (:func:`d1_check`).

``tests/test_torch_kernels_gpu.py`` holds the kernels to the same rules
through these functions. A kernel that does not build or launch raises
here: no failure is caught. A kernel off its tolerance sets
``kernel_parity_ok`` to false, with its detail, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from vaq_tpu_torch import pca
from vaq_tpu_torch.ops import (hamming, probe_scan, rescore, scan_codes,
                               scan_decoded, scan_lut)

# The comparison's absolute floor: scores below it are equal.
ATOL = 1e-6
# K5/K7 against their plain versions: f32 sums of exact products in
# another order.
TERMS_RTOL = 1e-5
# JAX's group-min shapes, kernel_check.py:117-122: (ncl, cap, gs, qcap, d,
# rows dtype); JAX's row tile ``rt`` and the transposed layout have no
# counterpart here.
GROUPMIN_SHAPES = {
    "1tile_int8": (8, 1536, 8, 128, 128, "int8"),
    "ntile_bf16": (4, 1024, 16, 128, 128, "bf16"),
    "gs128_int8": (4, 2048, 128, 128, 128, "int8"),
    "t96_int8": (4, 2048, 16, 128, 96, "int8"),
}
# JAX's gather-rescore shapes, kernel_check.py:174-178: (nq, m, gs, d,
# windows, rows dtype).
RESCORE_SHAPES = {
    "gs16_int8": (16, 20, 16, 128, 64, "int8"),
    "gs64_bf16": (8, 20, 64, 128, 32, "bf16"),
    "t96_int8": (8, 6, 128, 96, 12, "int8"),
}
# D1's over-fetches: the kk of k = 10 and of k = 100.
D1_KKS = (26, 200)
# H1's shapes: (batches, queries, rows, words): the flat scan of a 256-bit
# code over 65,536 rows, and a probe's four cluster blocks.
POPCOUNT_SHAPES = {"flat": (1, 128, 65536, 8), "blocks": (4, 64, 4000, 8)}

Check = Tuple[bool, dict]


def _t(x, device=None) -> torch.Tensor:
    """``x`` (a tensor, or a host array, copied) as a tensor, on ``device``
    if given."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    return t if device is None else t.to(device)


# ---------------------------------------------------------------------------
# The tolerance rules
# ---------------------------------------------------------------------------

def scores_within(got, ref, scale=None, rtol: float = TERMS_RTOL) -> Check:
    """Same shape and finite pattern, the non-finite entries equal (NaN to
    NaN), and |got − ref| ≤ rtol·scale on the rest; ``scale`` is the size
    of the terms each score sums, max(|ref|, 1) if not given."""
    got, ref = _t(got).float(), _t(ref).float()
    if got.shape != ref.shape:
        return False, {"shape": [list(got.shape), list(ref.shape)]}
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(got), fin):
        return False, {"finite_pattern_mismatches":
                       int((torch.isfinite(got) != fin).sum())}
    g, r = got[~fin], ref[~fin]
    if not bool(((g == r) | (torch.isnan(g) & torch.isnan(r))).all()):
        return False, {"non_finite_mismatch": True}
    scale = (ref.abs().clamp_min(1.0) if scale is None
             else _t(scale, ref.device).double().expand(ref.shape))
    if not bool(fin.any()):
        return True, {"max_err_over_tol": 0.0}
    ratio = float(((got[fin] - ref[fin]).double().abs()
                   / (rtol * scale[fin])).max())
    return ratio <= 1.0, {"max_err_over_tol": ratio}


def k1_rtol(block_rows: int) -> float:
    """K1's (and K3's) tolerance at ``block_rows``-row windows: 1e-5 plus
    one step of the packed key, 2^(idx_bits − 23) relative."""
    return 1e-5 + 2.0 ** ((block_rows - 1).bit_length() - 23)


def _decoded_rows(codes, table, rows) -> torch.Tensor:
    """The f64 decodes of ``rows`` (rows at or past n decode as code 0, as
    K1 pads them)."""
    n, m = codes.shape
    c, d = table.shape
    tbl = table.double().reshape(c, m, d // m)
    rows = rows.long()
    cod = codes[rows.clamp_max(n - 1)].long()
    cod = torch.where((rows >= n)[..., None], 0, cod)
    return tbl[cod, torch.arange(m, device=codes.device)].reshape(
        *rows.shape, d)


def k1_scores64(codes, table, qp, q_idx, rows) -> torch.Tensor:
    """K1's quantity in f64 for (query, row) pairs: bf16-rounded decode
    (``table``), the bf16 query in the dot, the f32 query in ‖q‖²."""
    codes, table, qp = _t(codes), _t(table), _t(qp)
    q_idx, rows = _t(q_idx).long(), _t(rows)
    x = _decoded_rows(codes, table, rows)
    qb = qp.to(torch.bfloat16).double()[q_idx]
    qn = (qp.double() ** 2).sum(1)[q_idx]
    return (x * x).sum(1) - 2 * (x * qb).sum(1) + qn


def k1_terms(codes, table, qp, ids, q_block: int = 8) -> torch.Tensor:
    """Per (query, window): ‖x̂‖² + 2·Σ_d|q_d·x̂_d| + ‖q‖² in f64 at the
    window's row ``ids`` (the query rounded to bf16 in the dot, rows past n
    code 0) — the size of the terms K1 sums, from per-subspace tables."""
    codes, table, qp, ids = _t(codes), _t(table), _t(qp), _t(ids)
    n, m = codes.shape
    c, d = table.shape
    nq = qp.shape[0]
    dev = codes.device
    t = table.double().view(c, m, d // m)
    sub_norm = (t * t).sum(2).T.contiguous()                       # (M, C)
    q_abs = qp.to(torch.bfloat16).double().abs().view(nq, m, d // m)
    dots = torch.einsum("qml,cml->qmc", q_abs, t.abs())           # (nq, M, C)
    qn = (qp.double() ** 2).sum(1)
    sub = torch.arange(m, device=dev)
    out = torch.empty(ids.shape, dtype=torch.float64, device=dev)
    for q0 in range(0, nq, q_block):
        blk = ids[q0:q0 + q_block].long()
        cod = codes[blk.clamp_max(n - 1)].long()
        cod = torch.where((blk >= n)[..., None], 0, cod)          # (qb, nw, M)
        qi = torch.arange(q0, q0 + blk.shape[0], device=dev)[:, None, None]
        out[q0:q0 + q_block] = (sub_norm[sub, cod].sum(2)
                                + 2.0 * dots[qi, sub, cod].sum(2)
                                + qn[q0:q0 + q_block, None])
    return out


def _windows_agree(got, want, rtol: float, pair_scores, size=None,
                   max_tie_frac: float = 0.01) -> Check:
    """Two window scans (scores, ids) agree: scores within ``rtol`` of
    ``size`` (of ``want``'s score if None) plus ``ATOL``; where the winners
    differ, ``pair_scores(q_idx, rows)`` (f64) of the two rows agree to
    that too (of ``size`` there, or of ``want``'s row's f64 score), on at
    most ``max_tie_frac`` of the windows."""
    (s_a, i_a), (s_b, i_b) = got, want
    if s_a.shape != s_b.shape or i_a.shape != i_b.shape:
        return False, {"shape": [list(s_a.shape), list(s_b.shape)]}
    err = (s_a.double() - s_b.double()).abs()
    scale = s_b.double().abs() if size is None else size
    ratio = float((err / (ATOL + rtol * scale)).max()) if err.numel() else 0.0
    q_idx, w_idx = torch.nonzero(i_a != i_b, as_tuple=True)
    ties_ok = True
    if len(q_idx):
        a = pair_scores(q_idx, i_a[q_idx, w_idx])
        b = pair_scores(q_idx, i_b[q_idx, w_idx])
        tie = b.abs() if size is None else size[q_idx, w_idx]
        ties_ok = bool(((a - b).abs() <= ATOL + rtol * tie).all())
    frac = len(q_idx) / max(i_a.numel(), 1)
    detail = {"max_err_over_tol": ratio, "id_mismatches": len(q_idx),
              "id_mismatch_frac": frac, "ties_ok": ties_ok}
    return (ratio <= 1.0 and ties_ok and frac <= max_tie_frac), detail


def k1_check(codes, table, qp, got, want, block_rows: int,
             of_terms: bool = True) -> Check:
    """K1's rule for two window scans ``got`` and ``want`` (scores, ids) of
    the same inputs: scores within ``k1_rtol`` of the size of the terms
    (``of_terms``, :func:`k1_terms`) or of the score itself, plus
    ``ATOL``; where the winners differ, the two rows' f64 scores
    (:func:`k1_scores64`) agree to that too, on at most 1% of the
    windows."""
    codes, table, qp = _t(codes), _t(table), _t(qp)
    dev = codes.device
    got, want = ((_t(s, dev), _t(i, dev)) for s, i in (got, want))
    size = None
    if of_terms and got[1].shape == want[1].shape:
        size = k1_terms(codes, table, qp, want[1])
    return _windows_agree(
        got, want, k1_rtol(block_rows),
        lambda q, rows: k1_scores64(codes, table, qp, q, rows), size)


def d1_scores64(rows, norms, q, ids, q_block: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f64 ``‖x‖² − 2·q·x`` of each query's rows ``ids`` (nq, kk) and the
    size of the terms it sums, ``‖x‖² + 2·Σ|q·x|``; +inf and 0 at id −1
    and at a tombstoned row (+inf norm).
    rows (n, d) bf16, norms (n,) f32, q (nq, d) bf16."""
    ids = _t(ids, rows.device).to(torch.int64)
    score = torch.empty(ids.shape, dtype=torch.float64, device=rows.device)
    terms = torch.empty_like(score)
    for a in range(0, ids.shape[0], q_block):
        sel = ids[a:a + q_block]
        safe = sel.clamp_min(0)
        prod = q[a:a + q_block, None, :].double() * rows[safe].double()
        nrm = norms[safe].double()
        live = (sel >= 0) & torch.isfinite(nrm)
        score[a:a + q_block] = torch.where(live, nrm - 2.0 * prod.sum(2),
                                           torch.inf)
        terms[a:a + q_block] = torch.where(
            live, nrm.abs() + 2.0 * prod.abs().sum(2), 0.0)
    return score, terms


def d1_check(rows, norms, q, got, want) -> Check:
    """D1's merged candidates ``got`` against the plain version's ``want``
    (each (nq, kk) row ids, −1 for none): the same ids where the sets
    agree; elsewhere every row only one side holds scores, in f64, within
    1e-5 of the terms (plus ``ATOL``) of the other side's kk-th, so only
    rows that tie at the boundary trade places, and −1 (a tombstone or too
    few rows) as often on both sides."""
    got, want = _t(got, rows.device), _t(want, rows.device)
    if got.shape != want.shape:
        return False, {"shape": [list(got.shape), list(want.shape)]}
    same = torch.equal(got, want)
    differ = ~(torch.sort(got, dim=1).values
               == torch.sort(want, dim=1).values).all(dim=1)
    detail = {"queries_differing": int(differ.sum()), "same_order": same}
    if not bool(differ.any()):
        return True, detail
    g, w = got[differ], want[differ]
    sg, tg = d1_scores64(rows, norms, q[differ], g)
    sw, tw = d1_scores64(rows, norms, q[differ], w)
    worst = 0.0
    for sa, ta, a, sb, tb, b in ((sg, tg, g, sw, tw, w),
                                 (sw, tw, w, sg, tg, g)):
        # the rows of `a` that `b` lacks, against b's kk-th
        last, at = torch.where(b >= 0, sb, -torch.inf).max(dim=1)
        t_last = tb.gather(1, at[:, None])
        only = ~(a[:, :, None] == b[:, None, :]).any(dim=2)
        excess = torch.nan_to_num(
            (sa - last[:, None]) / (TERMS_RTOL * (ta + t_last) + ATOL),
            nan=torch.inf)
        if bool(only.any()):
            worst = max(worst, float(excess[only].max()))
    detail["max_excess_over_tol"] = worst
    dead = bool(((g < 0).sum(1) == (w < 0).sum(1)).all())
    if not dead:
        detail["dead_count_mismatch"] = True
    return worst <= 1.0 and dead, detail


def k3_sums64(codes, luts, q_idx, rows) -> torch.Tensor:
    """K3's sum in f64 for (query, row) pairs, over the bf16 entries."""
    lut_bf = luts.to(torch.bfloat16).double()
    sub = torch.arange(codes.shape[1], device=codes.device)
    return lut_bf[q_idx[:, None], sub[None, :], codes[rows.long()].long()].sum(1)


def k3_check(codes, luts, block_rows: int, got, want) -> Check:
    """K3's rule where the tensor cores do not add to nearest: scores within
    ``k1_rtol`` of the score plus ``ATOL``, winners that differ only where
    the two rows' f64 sums (:func:`k3_sums64`) agree to that, on at most 2%
    of the windows."""
    return _windows_agree(
        got, want, k1_rtol(block_rows),
        lambda q, rows: k3_sums64(codes, luts, q, rows), max_tie_frac=0.02)


def groupmin_term_scale(qsl, rows, w, ncl: int, cap: int, gs: int,
                        chunk: Optional[int] = None) -> torch.Tensor:
    """Per (cluster, slot, group): Σ_d|qsl_d·x_d| + Σ w·x² + qn at the
    group's smallest row, in f64 on the inputs' device, ``chunk`` clusters
    at a time — the size of the terms K5 sums. Returns (ncl, qcap, cap //
    gs), K5's layout."""
    qsl, rows, w = _t(qsl), _t(rows), _t(w)
    qcap, d = qsl.shape[1:]
    chunk = chunk or max(1, min(100, (1 << 26) // max(qcap * cap, 1)))
    out = torch.empty((ncl, qcap, cap // gs), dtype=torch.float64,
                      device=qsl.device)
    wd = w.double()
    for c0 in range(0, ncl, chunk):
        qf = qsl[c0:c0 + chunk].double()
        r = rows.reshape(ncl, cap, d)[c0:c0 + chunk].double()
        xn = (r * r * wd).sum(2)[:, None, :]
        qn = 0.25 * (qf * qf).sum(2)[:, :, None]
        dist = torch.bmm(qf, r.transpose(1, 2)) + xn + qn
        size = torch.bmm(qf.abs(), r.abs().transpose(1, 2)) + xn + qn
        at = dist.view(qf.shape[0], qcap, -1, gs).argmin(3, keepdim=True)
        out[c0:c0 + chunk] = size.view(qf.shape[0], qcap, -1, gs).gather(
            3, at)[..., 0]
    return out


def rescore_term_scale(q, w, rows, wblk, gs: int, chunk: int = 64
                       ) -> torch.Tensor:
    """Per score: 2·Σ_d|q_d·x_d| + Σ w·x², q rounded to bf16, in f64 on the
    inputs' device, ``chunk`` queries at a time — the size of the terms K7
    sums. Window ids outside the rows are clamped to them."""
    q, w, rows, wblk = _t(q), _t(w), _t(rows), _t(wblk)
    qb = q.to(torch.bfloat16).double()
    d = rows.shape[1]
    n_blk = rows.shape[0] // gs
    out = torch.empty(wblk.shape + (gs,), dtype=torch.float64, device=q.device)
    for q0 in range(0, q.shape[0], chunk):
        ids = wblk[q0:q0 + chunk].long().clamp(0, n_blk - 1)
        blk = rows.reshape(n_blk, gs, d)[ids].double()
        out[q0:q0 + chunk] = (
            2 * torch.einsum("qd,qmgd->qmg", qb[q0:q0 + chunk].abs(), blk.abs())
            + torch.einsum("qmgd,d->qmg", blk * blk, w.double()))
    return out


def groupmin_ref64_and_bound(qsl, rows_np, dim_w, ncl, cap, gs):
    """Float64 reference for the group-min kernel plus a per-output
    reassociation-error BOUND derived from the data (copied from
    ``vaq_tpu/ops/kernel_check.py``: the gate's tolerance is anchored, not
    widened post hoc).

    The kernel computes, per (cluster, row, slot),
    ``dist = Σ_d (q̃·r̃) + Σ_d r̃²·w + 0.25·Σ_d q̃²`` with q̃, r̃ the bf16-cast
    inputs (bf16 products are exact in f32; only the f32 ACCUMULATION order
    is implementation-defined), then a min over each gs-row group. Any
    reassociation of an n-term f32 sum differs from the exact sum by at
    most ``(n−1)·u·Σ|terms|`` (u = 2⁻²⁴), and a min over values each
    perturbed by ≤ e moves by ≤ e. So
    ``bound[c,g,s] = u·(d−1)·(max_{row∈g}(Σ|q̃r̃| + Σr̃²w) + 0.25Σq̃²)``
    is a sound envelope for BOTH the kernel's and the plain version's
    outputs around the f64 reference — no measured-on-chip constant
    involved.

    rows_np: the bf16-cast row values as float64 (int8 values are exact in
    bf16, so callers pass the raw integers cast to f64).
    Returns (ref64 (ncl, ng, qcap), bound (ncl, ng, qcap)) as float64.
    """
    d = rows_np.shape[1]
    q = np.asarray(qsl, dtype=np.float64)                     # (ncl,qcap,d)
    r = rows_np.reshape(ncl, cap, d)
    w = np.asarray(dim_w, dtype=np.float64)
    dot = np.einsum("cqd,crd->crq", q, r)                     # exact-ish f64
    xn = np.sum(r * r * w[None, None, :], axis=2)             # (ncl, cap)
    qn = 0.25 * np.sum(q * q, axis=2)                         # (ncl, qcap)
    dist = dot + xn[:, :, None] + qn[:, None, :]
    ref = dist.reshape(ncl, cap // gs, gs, -1).min(axis=2)
    mag = (np.einsum("cqd,crd->crq", np.abs(q), np.abs(r))
           + xn[:, :, None] + qn[:, None, :])
    u = 2.0 ** -24
    bound = u * (d - 1) * mag.reshape(ncl, cap // gs, gs, -1).max(axis=2)
    return ref, bound


# ---------------------------------------------------------------------------
# One kernel against its plain version
# ---------------------------------------------------------------------------

def _parity_k1(codes, table, qp, block_rows: int,
               kernel: Callable = scan_codes.decode_window_scan) -> Check:
    """K1 (``kernel``) against its plain version at ``block_rows``-row
    windows, by :func:`k1_check` relative to the terms."""
    got = kernel(codes, table, qp, block_rows)
    want = scan_codes.decode_window_scan_ref(codes, table, qp, block_rows)
    return k1_check(codes, table, qp, got, want, block_rows)


def _parity_k2(codes, cand, rows, qp,
               kernel: Callable = scan_codes.decode_rescore) -> Check:
    """K2 against its plain version: +inf at the same places (ids −1 or
    past n), the rest within rtol 1e-5 plus ``ATOL``."""
    got = kernel(codes, cand, rows, qp)
    want = scan_codes.decode_rescore_ref(codes, cand, rows, qp)
    return scores_within(got, want, want.double().abs() + ATOL / TERMS_RTOL)


def _parity_fast4(codes, luts, block_rows: int, rounding: str,
                  kernel: Callable = scan_codes.fast4_window_scan) -> Check:
    """K3 (f32 ``luts``) or K4 (int8) against its plain version: equal keys
    where the form adds as the plain version does (K4, K3's gather form,
    K3's tensor-core form when ``rounding`` is "nearest"), else
    :func:`k3_check`."""
    int8 = luts.dtype == torch.int8
    nq, m, c = luts.shape
    form = scan_codes._fast4_form(m, c, int8, nq, block_rows).kind
    got = kernel(codes, luts, block_rows)
    want = scan_codes.fast4_window_scan_ref(codes, luts, block_rows)
    if int8 or form == "gather" or rounding == "nearest":
        same = [torch.equal(a, b) for a, b in zip(got, want)]
        bad = sum(int((a != b).sum()) for a, b in zip(got, want)
                  if a.shape == b.shape)
        return all(same), {"form": form, "mismatches": bad}
    ok, detail = k3_check(codes, luts, block_rows, got, want)
    return ok, {"form": form, "rounding": rounding, **detail}


def _groupmin_inputs(rng, ncl, cap, qcap, d, dtype, device):
    """JAX's group-min inputs (kernel_check.py:124-136) as the port takes
    them: rows (ncl·cap, d) row-major, their f64 values, dim_w, qsl bf16."""
    rows = rng.standard_normal((ncl * cap, d)).astype(np.float32)
    if dtype == "int8":
        rows = np.clip(np.round(rows * 32.0), -127, 127).astype(np.int8)
        rows_t = torch.as_tensor(rows, device=device)
        w = torch.full((d,), 1.0 / (32.0 * 32.0), device=device)
    else:
        rows_t = torch.as_tensor(rows, device=device).to(torch.bfloat16)
        w = torch.ones((d,), device=device)
    qsl = torch.as_tensor((-2.0 * rng.standard_normal((ncl, qcap, d))
                           ).astype(np.float32), device=device).to(torch.bfloat16)
    return qsl, rows_t, w


def _parity_groupmin(device, kernel: Callable = probe_scan.groupmin_window_scan,
                     shapes: Optional[dict] = None) -> Check:
    """K5 (``kernel``) at JAX's group-min shapes on seeded data: the kernel
    and the plain version each within JAX's limit around the f64 reference,
    and within ``TERMS_RTOL`` of the terms of each other."""
    detail = {}
    ok_all = True
    rng = np.random.default_rng(0)
    for tag, (ncl, cap, gs, qcap, d, dtype) in (shapes or GROUPMIN_SHAPES).items():
        qsl, rows, w = _groupmin_inputs(rng, ncl, cap, qcap, d, dtype, device)
        ref, bound = groupmin_ref64_and_bound(
            qsl.double().cpu().numpy(), rows.double().cpu().numpy(),
            w.cpu().numpy(), ncl, cap, gs)
        limit = 4.0 * np.maximum(bound, 1e-12)
        args = (qsl, rows, w, ncl, cap, gs)
        outs = {"kernel": kernel(*args),
                "plain": probe_scan.groupmin_window_scan_ref(*args)}
        for mode, out in outs.items():
            if tuple(out.shape) != (ncl, qcap, cap // gs):
                ok_all = False
                detail[f"{tag}_{mode}"] = {"shape": list(out.shape)}
                continue
            err = np.abs(out.transpose(1, 2).double().cpu().numpy() - ref)
            if not bool(np.all(err <= limit)):
                ok_all = False
                detail[f"{tag}_{mode}"] = {
                    "max_err_over_limit": float((err / limit).max()),
                    "max_abs_err": float(err.max())}
        if f"{tag}_kernel" not in detail:
            ok, d_terms = scores_within(
                outs["kernel"], outs["plain"],
                groupmin_term_scale(qsl, rows, w, ncl, cap, gs))
            if not ok:
                ok_all = False
                detail[f"{tag}_terms"] = d_terms
    return ok_all, detail


def _parity_gather_rescore(device, kernel: Callable = rescore.gather_rescore,
                           rtol: float = 2e-4,
                           shapes: Optional[dict] = None) -> Check:
    """K7 (``kernel``) at JAX's gather-rescore shapes on seeded data: within
    ``rtol`` of max(|plain|, 1), JAX's rule, and within ``TERMS_RTOL`` of
    the terms."""
    detail = {}
    ok_all = True
    rng = np.random.default_rng(1)
    for tag, (nq, m, gs, d, nblk, dtype) in (shapes or RESCORE_SHAPES).items():
        rows = rng.standard_normal((nblk * gs, d)).astype(np.float32)
        if dtype == "int8":
            rows = torch.as_tensor(np.clip(np.round(rows * 32.0), -127, 127)
                                   .astype(np.int8), device=device)
            w = torch.full((d,), 1.0 / (32.0 * 32.0), device=device)
        else:
            rows = torch.as_tensor(rows, device=device).to(torch.bfloat16)
            w = torch.ones((d,), device=device)
        q = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32),
                            device=device)
        wblk = torch.as_tensor(rng.integers(0, nblk, size=(nq, m))
                               .astype(np.int32), device=device)
        args = (q, w, rows, wblk, gs)
        got = kernel(*args)
        want = rescore.gather_rescore_ref(*args)
        ok_j, d_j = scores_within(got, want, rtol=rtol)
        ok_t, d_t = scores_within(got, want, rescore_term_scale(*args))
        if not (ok_j and ok_t):
            ok_all = False
            detail[tag] = {"jax_rule": d_j, "terms": d_t}
    return ok_all, detail


def _parity_popcount(device, kernel: Callable = hamming.popcount_dists,
                     shapes: Optional[dict] = None) -> Check:
    """H1 (``kernel``), xor and Jaccard, on seeded packed words: bit-equal
    to its plain version."""
    detail = {}
    rng = np.random.default_rng(2)
    for tag, (b, nq, n, w) in (shapes or POPCOUNT_SHAPES).items():
        words = rng.integers(0, 2 ** 32, (b, nq + n, w), dtype=np.uint32)
        q, x = (torch.as_tensor(np.ascontiguousarray(w_.view(np.int32)),
                                device=device)
                for w_ in (words[:, :nq], words[:, nq:]))
        for op in hamming.OPS:
            got = kernel(q, x, op)
            want = hamming.popcount_dists_ref(q, x, op)
            if not torch.equal(got, want):
                detail[f"{tag}_{op}"] = {
                    "mismatches": int((got != want).sum())
                    if got.shape == want.shape else list(got.shape)}
    return not detail, detail


def _parity_d1(rows, norms, qp, kks=D1_KKS,
               kernel: Callable = scan_decoded.decoded_topk_scan) -> Check:
    """D1 (``kernel``) at each of ``kks``, its splits merged, against the
    plain blocked scan (``scan_decoded._scan_topk``) on the same rows and
    bf16 queries, by :func:`d1_check`."""
    q = qp.to(torch.bfloat16).contiguous()
    ok_all, detail = True, {}
    for kk in kks:
        kk = min(kk, rows.shape[0])
        got = scan_decoded._lowest_split_keys(kernel(rows, norms, q, kk), kk)
        want = scan_decoded._scan_topk(rows, norms, q.float(), kk)
        ok, d = d1_check(rows, norms, q, got, want)
        ok_all &= ok
        detail[f"kk{kk}"] = d
    return ok_all, detail


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

def _checks(idx, queries: np.ndarray, n_rows: int, nq: int) -> dict:
    """Every kernel's check on the index's device, in order: name →
    (ok, detail). On a CPU index both sides are the plain version."""
    dev = idx.device
    idx._require_codes_bits()
    n_rows = min(n_rows, idx.n_rows)
    if n_rows >= 4096:
        n_rows -= n_rows % 4096           # JAX's slice: whole 4096-row tiles
    codes = idx.codes[:n_rows]
    table, dec_rows = idx._codes_tier()
    q = torch.as_tensor(np.asarray(queries[:nq], np.float32), device=dev)
    qp = pca.project(q, idx._eigvecs_device())
    checks = {}
    for br in (64, 32, 16):
        checks[f"decode_br{br}"] = _parity_k1(codes, table, qp, br)
    rng = np.random.default_rng(3)
    cand = torch.as_tensor(rng.integers(0, n_rows, (qp.shape[0], 200))
                           .astype(np.int32), device=dev)
    cand[:, -2:] = torch.tensor([-1, n_rows], dtype=torch.int32,
                                device=dev)            # ids that score +inf
    checks["decode_rescore"] = _parity_k2(codes, cand, dec_rows, qp)

    luts = scan_lut.build_luts(qp, torch.as_tensor(idx.centroids, device=dev))
    m, c = luts.shape[1:]
    rounding = "nearest"
    if scan_codes._fast4_form(m, c, False, qp.shape[0], 64).kind == "mma":
        rounding = scan_codes.k3_accumulation_rounding(dev)
    checks["fast4"] = _parity_fast4(codes, luts, 64, rounding)
    if idx.lut_offsets is not None:
        lut8 = scan_lut.quantize_luts(
            luts, torch.as_tensor(idx.lut_offsets, dtype=torch.float32,
                                  device=dev),
            torch.as_tensor(idx.lut_scales, dtype=torch.float32, device=dev))
        checks["fast4_int8"] = _parity_fast4(
            codes, (lut8.to(torch.int16) - 128).to(torch.int8), 64, rounding)
    checks["groupmin"] = _parity_groupmin(dev)
    checks["rescore"] = _parity_gather_rescore(dev)
    checks["popcount"] = _parity_popcount(dev)
    dec, norms = scan_decoded.decode_db(
        codes, torch.as_tensor(idx.centroids, device=dev))
    checks["decoded_topk"] = _parity_d1(dec, norms, qp)
    return checks


def kernel_parity_fields(idx, queries: np.ndarray, n_rows: int = 65536,
                         nq: int = 128) -> dict:
    """Every kernel against its plain version on the index's card: K1 at
    64-, 32- and 16-row windows, K2 and K3 on the index's first ``n_rows``
    codes and ``nq`` projected queries, K4 there too where the index has
    learned its LUT quantization, K5, K7 and H1 at their seeded shapes, D1
    on those codes' bf16 rows at kk = 26 and 200.

    Returns bench-JSON fields: ``kernel_parity_ok`` (bool),
    ``kernel_parity_checked`` (the checks run, in order) and a
    ``kernel_parity_<check>_detail`` for each check off its tolerance.
    On a CPU index no kernel runs and both sides would be the plain
    version: ``kernel_parity_ok`` is None, with a note, as JAX's gate
    reports its CPU backend. Codes of more than 8 bits raise ConfigError,
    as the codes tier does.
    """
    if idx.device.type != "cuda":
        return {"kernel_parity_ok": None,
                "kernel_parity_note": "cpu index: the kernels do not run, "
                                      "both paths would be the plain version"}
    checks = _checks(idx, queries, n_rows, nq)
    fields = {"kernel_parity_ok": all(ok for ok, _ in checks.values()),
              "kernel_parity_checked": list(checks)}
    for name, (ok, detail) in checks.items():
        if not ok:
            fields[f"kernel_parity_{name}_detail"] = detail
    return fields
