#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``vaq_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

from the root of the repository. It builds the port's CUDA kernels from
``vaq_tpu_torch/csrc`` with ``nvcc`` (into ``build/vaq_tpu_torch/``, one
``nvcc`` per source, all at once) and runs seven phases, printing progress
as it goes:

1. environment: the card's name and power limit, torch, CUDA and nvcc
   versions;
2. build of the kernels, timed;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, timed with CUDA events after a warm-up, beside its bound
   (bytes over 3.35 TB/s or operations over the peak rate of their type,
   the larger) and one PyTorch call doing its dominant product where there
   is one: K1 at n = 1M codes and 512 queries, at M = 32, C = 256, d = 128
   with 128-row and with 64-row windows and at the FAST "auto" shape
   (M = 64, C = 16, L = 2), with its TFLOP/s and share of the bound; the
   tie-exact top-k helper and its forms beside ``torch.topk`` on K1's
   window scores at the port's selection widths; the decoded tier's
   selection of one batch (16 blocks of 512 × 65,536, kk = 200) as
   ``lowest_over_blocks``, tie-exact, and as the parent's running merge; K2 at the same codes, the rescore at 512 × 200 candidates; K5
   over the 1M probe buckets (1000 clusters of 1536 rows, 112 query slots,
   gs = 8) with int8 rows, at d = 96 (the shape of JAX's transposed K6),
   with bf16 rows, with about 51 of the 112 slots occupied (visit 0.1) and
   at qcap = 512 (visit 1.0); K7 at 512 queries × 200 windows of 8 rows, int8 and bf16, d = 128
   and 96 (K8); K3 (f32 LUT) and K4 (s8 LUT) at the FAST path's shape
   (M = 64, C = 16, 1M rows padded to 1,001,472, 512 queries, 256-row
   windows; the tensor-core form) and at M = 32, C = 256, 262,144 rows, 128
   queries, 512-row windows (the gather form), beside a tensor-core product
   of the codes' one-hot by the LUT (bf16 ``matmul`` / ``_int_mm``): K4's
   keys bit-equal to the plain version's, K3's too where the form adds to
   nearest, else within K3's packed-key tolerance with winners differing
   only on tied rows; before them, a probe of how the tensor cores round
   K3's f32 accumulation;
4. the codes path at SIFT1M shape, 1M × 128-d,
   ``VAQ256m32min7max8var1,HEAP`` on seeded synthetic data: train, encode,
   search on the decoded and on the codes tier (k = 100), then search 200
   and refine to 100, with times, QPS, peak device memory and recall against
   exact groundtruth, and a ``torch.profiler`` split of one 512-query codes
   batch by kernel, its busy share taken against the batch's unprofiled
   wall; K1/K2's launch counters are zeroed just before it and must have
   moved just after; then a codes search at k = 200 (64-row windows) with
   K1's counter zeroed just before it;
5. the TI/IVF path on the same index: ``attach_ivf`` with 1000 clusters
   over 16 subspaces (``bench.py:642-643``), searches at visit 0.25, 0.10,
   0.05 (the reference's Fig. 11 sweep) and 1.0, k = 100, and one search on
   the int8 ``decoded8`` tier, with the same numbers, a ``torch.profiler``
   split of one visit-0.1 batch by stage, and K5/K7's counters zeroed just
   before and read just after; at visit 1.0 the probe must reach the
   decoded tier's recall within 0.03;
6. the FAST/LUT path on the same data, ``VAQ256m64min1max4var1,FAST``
   (``bench.py:603``'s FAST config at d = 128): train and encode twice
   (the two rotations, codebooks and codes must be bit-equal),
   ``search(backend="fast4")`` (K3), ``learn_quantization``, the same search
   again (K4), ``"lut_gather"``, ``"auto"`` (which the route sends to the
   codes tier: K1 must launch, K3/K4 must not), and a fast4 search of 200
   refined to 100, with a ``torch.profiler`` split of one fast4 batch with
   each LUT by stage (``fast.lut``, ``fast.scan``, ``fast.select``,
   ``fast.rescore``, ``fast.topk``) and its busy share of the unprofiled
   wall; K3's, K4's and K1's counters are zeroed before their steps and must
   have moved after them;
7. one index state searched on the card and through the port's CPU plain
   versions at n = 20k (the decoded and codes tiers, refine, an IVF state
   built on the card and copied to the CPU at d = 128 and d = 96, and a FAST
   state through fast4 with and without its LUT quantizers and through
   ``"lut_gather"``); the answers must agree.

Any failure ends the run with a non-zero exit and no result line. The last
two lines are a JSON object of per-kernel numbers and the card's
``nvidia-smi`` name and power limit; the very last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 42
N_MAIN, D_MAIN, NQ_MAIN = 1_000_000, 128, 1000
METHOD = "VAQ256m32min7max8var1,HEAP"
# Kernel check at the main path's shapes.
KC_N, KC_M, KC_C, KC_L, KC_NQ, KC_BR, KC_KK = 1_000_000, 32, 256, 4, 512, 128, 200
RTOL_KERNEL = 1e-5   # f32 sums in another order: last-bit differences
# K1 at the codes path's shape, at the FAST "auto" shape (M = 64, C = 16,
# L = 2) and at 64-row windows (the codes tier at k = 200), each as
# (n, M, C, L, nq, block_rows). Its scores keep only the high 23 − idx_bits
# mantissa bits (the low ones hold the row index), so two last-bit-different
# sums can land one step of 2^(idx_bits − 23), relative, apart: 1.5e-5 at
# 128-row windows.
K1_SHAPES = ((KC_N, KC_M, KC_C, KC_L, KC_NQ, KC_BR),
             (KC_N, 64, 16, 2, KC_NQ, KC_BR),
             (KC_N, KC_M, KC_C, KC_L, KC_NQ, 64))
# (width, k) of the port's selections at 1M rows, 512 queries: the rescored
# top-k of 2k candidates (codes, decoded, FAST, IVF second stage), the IVF
# row pick (200 windows of 8), FAST's window pick (3912 windows), the codes
# tier's (7813), the IVF merge (100 clusters × 192 groups) and the LUT
# gather scan's (k + 32,768)
SELECT_WIDTHS = ((200, 100), (1600, 200), (3912, 100), (7813, 200),
                 (19200, 200), (32868, 100))
N_CMP, NQ_CMP, K_CMP = 20_000, 200, 10
DEVICE = "cuda"
# The probe buckets of the 1M index (attach_ivf at 1000 clusters: capacity
# ceil(1.5·1M/1000) rounded to 512) and the slots pick_qcap(512, 100, 1000)
# gives at visit 0.1; K7 at 512 queries × m = 200 windows of gs = 8 rows.
KC_NCL, KC_CAP, KC_QCAP, KC_GS, KC_WIN = 1000, 1536, 112, 8, 200
# K5's other two checks: about 51 of the 112 slots occupied per cluster (the
# dispatch's fill at visit 0.1), and qcap = 512 (visit 1.0)
KC_SLOTS_MEAN, KC_QCAP_FULL = 51, 512
TI_CLUSTERS, TI_SEGMENTS = 1000, 16       # bench.py:642-643
VISITS = (0.25, 0.10, 0.05, 1.0)          # Fig. 11 (ExperimentsParameters.txt:114-124), then all
# K3/K4 at the FAST path's shape (M = 64, C = 16, 256-row windows, 512
# queries; n pads to 1,001,472 rows) and at one C = 256 shape.
KF_SHAPES = ((1_000_000, 64, 16, 512, 256), (262_144, 32, 256, 128, 512))
FAST_METHOD = "VAQ256m64min1max4var1,FAST"   # bench.py:603's FAST config at d = 128
# Published H100 SXM peaks (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_environment() -> str:
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    from vaq_tpu_torch import _build
    nvcc = _run([_build._nvcc(), "--version"]).splitlines()[-1]
    log(f"[env] nvidia-smi: {smi}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    log(f"[env] nvcc: {nvcc}")
    return smi


def _clocks() -> str:
    return _run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                 "temperature.gpu", "--format=csv,noheader"]).splitlines()[0]


def phase_build() -> float:
    from vaq_tpu_torch import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    log(f"[build] {path.name} in {dt:.2f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
            log(f"[build] {line.strip()}")
    return dt


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _entry(name, source, replaces, err, ms, plain_ms, bound, library_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms}


def _assert_within_terms(got, ref, scale, what, rtol=RTOL_KERNEL):
    """Same finite pattern, and |got − ref| ≤ rtol · scale elementwise,
    ``scale`` being the size of the terms each result sums (f64)."""
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin), f"{what}: finite pattern"
    err = ((got[fin] - ref[fin]).double().abs() / scale[fin]).max()
    assert float(err) <= rtol, f"{what}: {float(err):.3g} of the terms"
    return float((got[fin] - ref[fin]).abs().max())


def _groupmin_scale(qsl, rows, w, ncl, cap, gs, chunk=100):
    """Per (cluster, slot, group): Σ_d|qsl_d·x_d| + Σ w·x² + qn at the
    group's smallest row, in f64 — the size of the terms K5 sums."""
    qcap, d = qsl.shape[1:]
    out = torch.empty((ncl, qcap, cap // gs), dtype=torch.float64,
                      device=qsl.device)
    wd = w.double()
    for c0 in range(0, ncl, chunk):
        qf = qsl[c0:c0 + chunk].double()
        r = rows.view(ncl, cap, d)[c0:c0 + chunk].double()
        xn = (r * r * wd).sum(2)[:, None, :]
        qn = 0.25 * (qf * qf).sum(2)[:, :, None]
        dist = torch.bmm(qf, r.transpose(1, 2)) + xn + qn
        size = torch.bmm(qf.abs(), r.abs().transpose(1, 2)) + xn + qn
        at = dist.view(qf.shape[0], qcap, -1, gs).argmin(3, keepdim=True)
        out[c0:c0 + chunk] = size.view(qf.shape[0], qcap, -1, gs).gather(
            3, at)[..., 0]
    return out


def _rescore_scale(q, w, rows, wblk, gs, chunk=64):
    """Per score: 2·Σ_d|q_d·x_d| + Σ w·x², q rounded to bf16, in f64 — the
    size of the terms K7 sums."""
    qb = q.to(torch.bfloat16).double()
    d = rows.shape[1]
    out = torch.empty(wblk.shape + (gs,), dtype=torch.float64, device=q.device)
    for q0 in range(0, q.shape[0], chunk):
        blk = rows.view(-1, gs, d)[wblk[q0:q0 + chunk].long()].double()
        out[q0:q0 + chunk] = (2 * torch.einsum("qd,qmgd->qmg", qb[q0:q0 + chunk].abs(),
                                               blk.abs())
                              + torch.einsum("qmgd,d->qmg", blk * blk, w.double()))
    return out


def _probe_rows(gen, d, dtype):
    """The 1M probe buckets' shape filled with seeded rows: int8 of scale 32
    (w = 1/32²) or their bf16 values (w = 1); the last 3 slots of each bucket
    hold padding (the int8 poison pattern / the 1e15 bf16 sentinel)."""
    from vaq_tpu_torch.ops import probe_scan
    dev = torch.device(DEVICE)
    x = torch.randn((KC_NCL, KC_CAP, d), generator=gen, device=dev) * 32.0
    x = torch.clamp(torch.round(x), -127, 127)
    if dtype == "int8":
        x = x.to(torch.int8)
        x[:, -3:] = torch.as_tensor(probe_scan.poison_pattern(d), device=dev)
        w = torch.full((d,), 1.0 / 1024.0, device=dev)
    else:
        x = x.to(torch.bfloat16)
        x[:, -3:] = 1e15
        w = torch.ones((d,), device=dev)
    return x.view(KC_NCL * KC_CAP, d), w


def _check_groupmin(gen, d: int, dtype: str, qcap: int = KC_QCAP,
                    slots_mean: int | None = None) -> dict:
    """K5 against its plain version over the 1M probe buckets, all ``qcap``
    slots occupied or, with ``slots_mean``, n_slots drawn around it per
    cluster (as the dispatch fills them); tolerance 1e-5 of the terms summed
    (bf16 × int8/bf16 products are exact in f32; only the order of the sums
    differs). The bound counts what these inputs need: the rows, the live
    slots' slab, the minima, and the products of live slots only."""
    from vaq_tpu_torch.ops import probe_scan
    dev = torch.device(DEVICE)
    rows, w = _probe_rows(gen, d, dtype)
    qsl = (-2.0 * torch.randn((KC_NCL, qcap, d), generator=gen,
                              device=dev)).to(torch.bfloat16)
    n_slots = None
    live = KC_NCL * qcap
    if slots_mean is not None:
        n_slots = torch.clamp(torch.round(
            slots_mean + 12.0 * torch.randn((KC_NCL,), generator=gen, device=dev)),
            0, qcap).to(torch.int32)
        live = int(n_slots.sum())
    args = (qsl, rows, w, KC_NCL, KC_CAP, KC_GS, n_slots)
    got = probe_scan.groupmin_window_scan(*args)
    ref = probe_scan.groupmin_window_scan_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (KC_NCL, qcap, KC_CAP // KC_GS)
    err = _assert_within_terms(got, ref, _groupmin_scale(*args[:6]),
                               f"K5 d={d} {dtype} qcap={qcap}")
    ms = _time_ms(lambda: probe_scan.groupmin_window_scan(*args), 10)
    plain = _time_ms(lambda: probe_scan.groupmin_window_scan_ref(*args), 3)
    rows_bf = rows.view(KC_NCL, KC_CAP, d).to(torch.bfloat16).transpose(1, 2)
    library = _time_ms(lambda: torch.bmm(qsl, rows_bf), 10)
    del rows_bf
    ng = KC_CAP // KC_GS
    nbytes = (rows.numel() * rows.element_size() + live * d * 2 + d * 4
              + KC_NCL * qcap * ng * 4)
    ops = 2.0 * live * KC_CAP * d + 3.0 * KC_NCL * KC_CAP * d
    bound = _bound(nbytes, ops, "bf16")
    what = (f"d={d} {dtype} rows, qcap={qcap}"
            + ("" if n_slots is None else f", {live / KC_NCL:.1f} live slots a cluster"))
    log(f"[kernels] K5 groupmin_window_scan {what}: max|Δ| {err:.3g}, kernel "
        f"{ms:.3f} ms ({100 * bound[0] / ms:.1f}% of the bound), plain "
        f"{plain:.3f} ms, bf16 bmm {library:.3f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]})")
    k6 = d % 128 != 0
    name = ("groupmin_window_scan" + (f"_d{d}" if k6 else "")
            + ("" if dtype == "int8" else "_bf16")
            + ("" if qcap == KC_QCAP else f"_q{qcap}")
            + ("" if slots_mean is None else f"_slots{slots_mean}"))
    return _entry(name, "vaq_tpu_torch/csrc/groupmin_window_scan.cu",
                  "vaq_tpu/ops/probe_pallas.py:" + ("205" if k6 else "158"),
                  err, ms, plain, bound, library)


def _check_rescore(gen, d: int, dtype: str) -> dict:
    """K7 against its plain version: 512 queries × 200 windows of 8 rows
    drawn from the 1M probe buckets; tolerance 1e-5 of the terms summed."""
    from vaq_tpu_torch.ops import rescore
    dev = torch.device(DEVICE)
    rows, w = _probe_rows(gen, d, dtype)
    n_blk = rows.shape[0] // KC_GS
    q = torch.randn((KC_NQ, d), generator=gen, device=dev)
    wblk = torch.randint(0, n_blk, (KC_NQ, KC_WIN), generator=gen, device=dev,
                         dtype=torch.int32)
    args = (q, w, rows, wblk, KC_GS)
    got = rescore.gather_rescore(*args)
    ref = rescore.gather_rescore_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (KC_NQ, KC_WIN, KC_GS)
    err = _assert_within_terms(got, ref, _rescore_scale(*args),
                               f"K7 d={d} {dtype}")
    ms = _time_ms(lambda: rescore.gather_rescore(*args), 20)
    plain = _time_ms(lambda: rescore.gather_rescore_ref(*args), 5)
    gathered = KC_NQ * KC_WIN * KC_GS * d
    nbytes = (gathered * rows.element_size() + q.numel() * 4 + d * 4
              + wblk.numel() * 4 + got.numel() * 4)
    bound = _bound(nbytes, 4.0 * gathered, "bf16")
    log(f"[kernels] K7 gather_rescore d={d} {dtype} rows: max|Δ| {err:.3g}, "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]})")
    k8 = d % 128 != 0
    return _entry("gather_rescore" + (f"_d{d}" if k8 else "")
                  + ("" if dtype == "int8" else "_bf16"),
                  "vaq_tpu_torch/csrc/gather_rescore.cu",
                  "vaq_tpu/ops/rescore_pallas.py:" + ("39" if k8 else "105"),
                  err, ms, plain, bound, None)


def _k3_winners_tie(codes, luts, q_idx, ids_a, ids_b, rtol) -> bool:
    """Whether rows ``ids_a`` and ``ids_b`` of queries ``q_idx`` have K3
    sums (bf16 entries, in f64) that agree to ``rtol``."""
    lut_bf = luts.to(torch.bfloat16).double()
    sub = torch.arange(codes.shape[1], device=codes.device)

    def sums(ids):
        return lut_bf[q_idx[:, None], sub[None, :], codes[ids.long()].long()].sum(1)

    a, b = sums(ids_a), sums(ids_b)
    return bool(torch.all((a - b).abs() <= rtol * b.abs() + 1e-6))


def _check_fast4(rng, shape, int8: bool, rounding: str) -> dict:
    """K3 (f32 LUT) or K4 (s8 LUT) against its plain version, in the form
    the wrapper's shape rule picks (``scan_codes._fast4_form``). K4's keys,
    and K3's in the gather form or where the tensor cores add to nearest
    (``rounding``), must equal the plain version's bit for bit; otherwise
    K3's scores agree to 1e-5 + 2^(idx_bits − 23) relative and a window's
    winner differs only where the two rows' sums agree to that in f64. The
    library yardstick multiplies a one-hot of the codes (built outside the
    timing) by the LUT on the tensor cores: bf16 ``matmul`` for K3,
    ``_int_mm`` for K4. The bound counts that one-hot form (2·nq·n·M·C
    operations) against the bytes of codes, LUT and keys."""
    from vaq_tpu_torch.ops import scan_codes
    dev = torch.device(DEVICE)
    n, m, c, nq, br = shape
    n_pad = n + (-n) % (scan_codes.W_PER_CELL * br)
    n_win = n_pad // br
    codes = torch.as_tensor(rng.integers(0, c, (n, m), dtype=np.uint8), device=dev)
    if int8:
        luts = torch.as_tensor(rng.integers(-128, 128, (nq, m, c), dtype=np.int8),
                               device=dev)
    else:
        luts = torch.as_tensor((rng.random((nq, m, c)) * 4.0).astype(np.float32),
                               device=dev)
    form = scan_codes._fast4_form(m, c, int8, nq, br).kind
    s_k, i_k = scan_codes.fast4_window_scan(codes, luts, br, n_win)
    s_r, i_r = scan_codes.fast4_window_scan_ref(codes, luts, br, n_win)
    torch.cuda.synchronize()
    name = "K4" if int8 else "K3"
    assert s_k.shape == (nq, n_win), (name, s_k.shape)
    if int8 or form == "gather" or rounding == "nearest":
        assert torch.equal(s_k, s_r) and torch.equal(i_k, i_r), \
            f"{name} keys differ from the plain version at {shape}"
        check = "keys equal"
    else:
        rtol = RTOL_KERNEL + 2.0 ** ((br - 1).bit_length() - 23)
        torch.testing.assert_close(s_k, s_r, rtol=rtol, atol=1e-6)
        q_idx, w_idx = torch.nonzero(i_k != i_r, as_tuple=True)
        ties = len(q_idx)
        if ties:
            assert _k3_winners_tie(codes, luts, q_idx, i_k[q_idx, w_idx],
                                   i_r[q_idx, w_idx], rtol), \
                f"K3 winners differ beyond a tie at {shape}"
        check = (f"scores within {rtol:.3g}, {ties} id ties of {i_k.numel()}, "
                 f"max|Δscore| {float((s_k - s_r).abs().max()):.3g}")
    err = float((s_k.double() - s_r.double()).abs().max())
    ms = _time_ms(lambda: scan_codes.fast4_window_scan(codes, luts, br, n_win), 10)
    plain = _time_ms(lambda: scan_codes.fast4_window_scan_ref(codes, luts, br, n_win), 3)
    # the one-hot of the codes, (n_pad, M·C), padded rows all zero
    hot = torch.zeros((n_pad, m * c), dtype=torch.int8 if int8 else torch.bfloat16,
                      device=dev)
    hot[:n].scatter_(1, codes.long() + torch.arange(m, device=dev) * c, 1)
    lut_t = luts.reshape(nq, m * c).T      # (M·C, nq), column-major
    if int8:
        library = _time_ms(lambda: torch._int_mm(hot, lut_t), 10)
    else:
        lut_bf = lut_t.to(torch.bfloat16).contiguous()
        library = _time_ms(lambda: torch.matmul(hot, lut_bf), 10)
    del hot
    ops = 2.0 * nq * n_pad * m * c
    nbytes = n_pad * m + luts.numel() * luts.element_size() + nq * n_win * 4
    bound = _bound(nbytes, ops, "int8" if int8 else "bf16")
    log(f"[kernels] {name} fast4_window_scan n={n} M={m} C={c} nq={nq} br={br}, "
        f"{form} form: {check}, kernel {ms:.3f} ms ({ops / ms / 1e9:.1f} "
        f"{'TOP' if int8 else 'TFLOP'}/s, {100 * bound[0] / ms:.1f}% of the bound), "
        f"plain {plain:.3f} ms, {'_int_mm' if int8 else 'bf16 matmul'} of the "
        f"one-hot {library:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    entry = _entry("fast4_window_scan" + ("_int8" if int8 else "")
                   + ("" if c == 16 else f"_c{c}"),
                   "vaq_tpu_torch/csrc/fast4_window_scan.cu",
                   "vaq_tpu/ops/scan_pallas.py:" + ("155" if int8 else "123"),
                   err, ms, plain, bound, library)
    entry["form"] = form
    return entry


def _k1_winners_tie(codes, table, qp, q_idx, ids_a, ids_b, rtol) -> bool:
    """Whether rows ``ids_a`` and ``ids_b`` of queries ``q_idx`` score the
    same to ``rtol`` in f64 by K1's own formula (bf16 decode, bf16 query in
    the dot, f32 query in ‖q‖²)."""
    c, d = table.shape
    m = codes.shape[1]
    q64 = qp.to(torch.bfloat16).double()[q_idx]
    qn = (qp * qp).sum(1).double()[q_idx]
    tbl = table.double().reshape(c, m, d // m)
    sub = torch.arange(m, device=codes.device)

    def score(ids):
        x = tbl[codes[ids.long()].long(), sub].reshape(-1, d)
        return (x * x).sum(1) - 2 * (x * q64).sum(1) + qn

    a, b = score(ids_a), score(ids_b)
    return bool(torch.all((a - b).abs() <= rtol * b.abs() + 1e-5))


def _check_k1(rng, shape) -> tuple[dict, torch.Tensor]:
    """K1 against its plain version at one 1M shape (n, M, C, L, nq,
    block_rows): scores within 1e-5 + 2^(idx_bits − 23) relative, and ids
    differing only where the two rows tie to that in f64 (the tensor cores
    sum the dot in another order, and the key keeps 23 − idx_bits mantissa
    bits). The library yardstick is one bf16 GEMM of the queries against
    the decoded rows (decoded outside the timing). Returns the entry and
    the window scores."""
    from vaq_tpu_torch.ops import scan_codes
    dev = torch.device(DEVICE)
    n, m, c, l, nq, br = shape
    d = m * l
    cents = rng.standard_normal((m, c, l)).astype(np.float32)
    codes = torch.as_tensor(rng.integers(0, c, (n, m), dtype=np.uint8), device=dev)
    qp = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32), device=dev)
    table = scan_codes.build_decode_table(cents, dev)
    rtol = RTOL_KERNEL + 2.0 ** ((br - 1).bit_length() - 23)
    s_k, i_k = scan_codes.decode_window_scan(codes, table, qp, br)
    s_r, i_r = scan_codes.decode_window_scan_ref(codes, table, qp, br)
    torch.cuda.synchronize()
    assert s_k.shape == (nq, -(-n // br)) and torch.isfinite(s_k).all(), shape
    torch.testing.assert_close(s_k, s_r, rtol=rtol, atol=1e-5)
    diff = (i_k != i_r).nonzero()
    if len(diff):
        assert _k1_winners_tie(codes, table, qp, diff[:, 0],
                               i_k[diff[:, 0], diff[:, 1]],
                               i_r[diff[:, 0], diff[:, 1]], rtol), \
            f"K1 winners differ beyond a tie at {shape}"
    err = float((s_k - s_r).abs().max())
    ms = _time_ms(lambda: scan_codes.decode_window_scan(codes, table, qp, br), 20)
    plain = _time_ms(lambda: scan_codes.decode_window_scan_ref(codes, table, qp, br), 3)
    dec = table.view(c, m, l)[codes.long(), torch.arange(m, device=dev)]
    dec_t = dec.reshape(n, d).T
    q_bf = qp.to(torch.bfloat16)
    library = _time_ms(lambda: torch.matmul(q_bf, dec_t), 10)
    del dec, dec_t
    ops = 2.0 * nq * n * d
    bound = _bound(n * m + table.numel() * 2 + qp.numel() * 4 + s_k.numel() * 4,
                   ops, "bf16")
    log(f"[kernels] K1 decode_window_scan n={n} M={m} C={c} L={l} nq={nq} br={br}: "
        f"max|Δscore| {err:.3g}, {len(diff)} id ties of {i_k.numel()}, kernel "
        f"{ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s, {100 * bound[0] / ms:.1f}% "
        f"of the bound), plain {plain:.3f} ms, bf16 matmul {library:.3f} ms, "
        f"bound {bound[0]:.4f} ms ({bound[1]})")
    name = "decode_window_scan" + ("" if c == KC_C else f"_c{c}") + \
        ("" if br == KC_BR else f"_br{br}")
    return _entry(name, "vaq_tpu_torch/csrc/decode_window_scan.cu",
                  "vaq_tpu/ops/scan_pallas.py:283", err, ms, plain, bound,
                  library), s_k


def _time_selection(scores: torch.Tensor, k: int) -> None:
    """The tie-exact selection (``scan_codes._select_lowest``) and each of
    its forms beside ``torch.topk`` on one (nq, width) score matrix; all
    must give the helper's positions."""
    from vaq_tpu_torch.ops import scan_codes
    bits = scan_codes._ordered(scores)
    want = scan_codes._select_lowest(scores, k)[1]
    times = {"helper": _time_ms(lambda: scan_codes._select_lowest(scores, k), 20)}
    for form, fn in (("stable sort", scan_codes._lowest_sorted),
                     ("topk of (score, position)", scan_codes._lowest_keyed)):
        assert torch.equal(fn(bits, k), want), f"{form} differs"
        times[form] = _time_ms(lambda: fn(bits, k), 20)
    times["torch.topk"] = _time_ms(
        lambda: torch.topk(scores, k, dim=1, largest=False, sorted=True), 20)
    log(f"[kernels] select lowest {k} of {tuple(scores.shape)}: "
        + ", ".join(f"{f} {t:.4f} ms" for f, t in times.items()))


def _time_block_selection(gen, nq: int = KC_NQ, kk: int = 200,
                          block: int = 65536, n_blocks: int = 16) -> None:
    """The decoded tier's selection of one 512-query batch at 1M rows (16
    blocks of 65,536 columns, kk = 200) three ways: ``lowest_over_blocks``
    (each block's ``torch.topk`` of kk + TIE_SLACK, the check, one final
    sort), its tie-exact form (each block through ``_select_lowest``, as it
    runs where a tie group outruns the margin), and the parent's running
    merge (``torch.topk`` of the carried best and each block, not
    tie-exact). The first two must agree."""
    from vaq_tpu_torch.ops import distances, scan_codes
    dev = torch.device(DEVICE)
    scores = torch.randn((n_blocks, nq, block), generator=gen, device=dev)

    def blocks():
        return ((scores[i], i * block) for i in range(n_blocks))

    def exact():
        vals, ids = zip(*(scan_codes._select_lowest(scores[i], kk) for i in range(n_blocks)))
        v = torch.cat(vals, 1)
        i = torch.cat([p.to(torch.int32) + n * block for n, p in enumerate(ids)], 1)
        key = (scan_codes._ordered(v).to(torch.int64) << 32) | (i.to(torch.int64) + 1)
        order = torch.sort(key, dim=1).indices[:, :kk]
        return torch.gather(v, 1, order), torch.gather(i, 1, order)

    def running_merge():
        best_d = torch.empty((nq, 0), device=dev)
        best_i = torch.empty((nq, 0), dtype=torch.int32, device=dev)
        for n in range(n_blocks):
            cand_d = torch.cat([best_d, scores[n]], 1)
            cand_i = torch.cat([best_i, torch.arange(n * block, (n + 1) * block, dtype=torch.int32,
                                                     device=dev).expand(nq, -1)], 1)
            best_d, pos = torch.topk(cand_d, kk, dim=1, largest=False, sorted=True)
            best_i = torch.gather(cand_i, 1, pos)
        return best_d, best_i

    got = distances.lowest_over_blocks(blocks, kk)
    want = exact()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    times = {"lowest_over_blocks": _time_ms(lambda: distances.lowest_over_blocks(blocks, kk), 10),
             "tie-exact blocks": _time_ms(exact, 10),
             "running torch.topk merge (parent)": _time_ms(running_merge, 10)}
    del scores
    log(f"[kernels] decoded-tier selection, {n_blocks} blocks of {nq} × {block}, kk = {kk}: "
        + ", ".join(f"{f} {t:.4f} ms" for f, t in times.items()))


def phase_kernels() -> list[dict]:
    """Every kernel against its plain version on the card."""
    from vaq_tpu_torch.ops import scan_codes
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    kernels = []
    for shape in K1_SHAPES:
        entry, scores = _check_k1(rng, shape)
        kernels.append(entry)
        if shape == K1_SHAPES[0]:
            # on K1's window scores, at the widths the port selects from
            wide = torch.cat([scores] * 5, dim=1)
            for width, k in SELECT_WIDTHS:
                _time_selection(wide[:, :width].contiguous(), k)
            del wide
        del scores
        torch.cuda.empty_cache()
    d = KC_M * KC_L
    cents = rng.standard_normal((KC_M, KC_C, KC_L)).astype(np.float32)
    codes = torch.as_tensor(rng.integers(0, KC_C, (KC_N, KC_M), dtype=np.uint8),
                            device=dev)
    qp = torch.as_tensor(rng.standard_normal((KC_NQ, d)).astype(np.float32),
                         device=dev)
    rows = scan_codes.build_decode_rows(cents, dev)

    # K2
    cand = torch.as_tensor(rng.integers(0, KC_N, (KC_NQ, KC_KK), dtype=np.int32),
                           device=dev)
    cand[:, -3:] = -1
    o_k = scan_codes.decode_rescore(codes, cand, rows, qp)
    o_r = scan_codes.decode_rescore_ref(codes, cand, rows, qp)
    torch.cuda.synchronize()
    assert torch.isinf(o_k[:, -3:]).all() and torch.isfinite(o_k[:, :-3]).all()
    torch.testing.assert_close(o_k, o_r, rtol=RTOL_KERNEL, atol=1e-5)
    k2_err = float((o_k[:, :-3] - o_r[:, :-3]).abs().max())
    k2_ms = _time_ms(lambda: scan_codes.decode_rescore(codes, cand, rows, qp), 20)
    k2_plain = _time_ms(lambda: scan_codes.decode_rescore_ref(codes, cand, rows, qp), 5)
    n_cand = KC_NQ * KC_KK
    k2_bound = _bound(n_cand * (KC_M + 4 + 4) + rows.numel() * 4 + qp.numel() * 4,
                      3.0 * n_cand * d, "f32")
    log(f"[kernels] K2 decode_rescore: max|Δ| {k2_err:.3g}, kernel {k2_ms:.3f} ms, "
        f"plain {k2_plain:.3f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]})")
    del codes, cand
    kernels.append(
        _entry("decode_rescore", "vaq_tpu_torch/csrc/decode_rescore.cu",
               "vaq_tpu/ops/scan_pallas.py:477", k2_err, k2_ms, k2_plain,
               k2_bound, None))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    _time_block_selection(gen)
    for d_k, dtype in ((D_MAIN, "int8"), (96, "int8"), (D_MAIN, "bf16")):
        kernels.append(_check_groupmin(gen, d_k, dtype))
        torch.cuda.empty_cache()
    # partly filled slots, as the dispatch leaves them at visit 0.1, and the
    # qcap of visit 1.0 (pick_qcap gives nq = 512 there)
    for qcap, mean in ((KC_QCAP, KC_SLOTS_MEAN), (KC_QCAP_FULL, None)):
        kernels.append(_check_groupmin(gen, D_MAIN, "int8", qcap, mean))
        torch.cuda.empty_cache()
    for d_k, dtype in ((D_MAIN, "int8"), (96, "int8"), (D_MAIN, "bf16")):
        kernels.append(_check_rescore(gen, d_k, dtype))
        torch.cuda.empty_cache()
    rounding = scan_codes.k3_accumulation_rounding(dev)
    log(f"[kernels] K3's tensor-core form: wgmma adds each k step to its f32 "
        f"accumulator rounding {rounding}")
    for shape in KF_SHAPES:
        for int8 in (False, True):
            kernels.append(_check_fast4(rng, shape, int8, rounding))
            torch.cuda.empty_cache()
    return kernels


def _step(name: str, fn, nq: int | None = None, tag: str = "main"):
    """Run one path step; log its time, QPS and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() / 2**20
    qps = f", {nq / dt:.0f} QPS" if nq else ""
    log(f"[{tag}] {name}: {dt:.3f} s{qps}, peak {mem:.0f} MiB")
    return out


def _batch_wall_ms(fn, reps: int = 9) -> float:
    """Median host milliseconds of one unprofiled call of ``fn`` ended by a
    device synchronize, over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def phase_main_path() -> tuple[dict, dict]:
    """The codes path; returns K1/K2's launches and what the IVF path
    reuses (the index, its data, the groundtruth, the decoded recall)."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import data, metrics
    from vaq_tpu_torch.ops import distances, scan_codes
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    base, queries = data.make_anisotropic_gaussian(N_MAIN, D_MAIN, NQ_MAIN,
                                                   seed=SEED)
    log(f"[main] data {base.shape} + {queries.shape[0]} queries: "
        f"{time.perf_counter() - t0:.1f} s (host)")
    gt_d, gt = _step("groundtruth@100 (exact_search)", lambda: distances.exact_search(
        torch.as_tensor(queries, device=dev), torch.as_tensor(base, device=dev), 100),
        NQ_MAIN)
    gt = gt.cpu().numpy()

    idx = vt.VAQIndex(vt.parse_method_string(METHOD), device=dev)
    _step("train", lambda: idx.train(base, verbose=True))
    log(f"[main] bits {idx.bits.tolist()}")
    _step("encode", lambda: idx.encode(base))
    scan_codes.decode_window_scan.launches = 0
    scan_codes.decode_rescore.launches = 0
    _step("search decoded k=100 (first call builds the decoded db)",
          lambda: idx.search(queries, 100, backend="decoded"), NQ_MAIN)
    _, l_dec = _step("search decoded k=100",
                     lambda: idx.search(queries, 100, backend="decoded"), NQ_MAIN)
    _step("search codes k=100 (first call)",
          lambda: idx.search(queries, 100, backend="codes"), NQ_MAIN)
    d_cod, l_cod = _step("search codes k=100",
                         lambda: idx.search(queries, 100, backend="codes"), NQ_MAIN)
    _, cand = _step("search k=200", lambda: idx.search(queries, 200), NQ_MAIN)
    d_ref, l_ref = _step("refine 200->100",
                         lambda: idx.refine(queries, cand, base, 100), NQ_MAIN)
    launches = {"decode_window_scan": scan_codes.decode_window_scan.launches,
                "decode_rescore": scan_codes.decode_rescore.launches}
    log(f"[main] kernel launches during the main path: {launches}")
    _profile_split("main", "codes", lambda: idx.search(queries[:512], 100,
                                                     backend="codes"), ())
    # the codes tier at k = 200 takes 64-row windows: K1's third checked shape
    assert idx._codes_block_rows(200) == K1_SHAPES[2][5]
    scan_codes.decode_window_scan.launches = 0
    _step("search codes k=200 (64-row windows)",
          lambda: idx.search(queries, 200, backend="codes"), NQ_MAIN)
    launches["decode_window_scan_br64"] = scan_codes.decode_window_scan.launches
    log(f"[main] codes k=200: K1 launches {launches['decode_window_scan_br64']}")

    r_dec = metrics.avg_recall(l_dec, gt, 100)
    r_cod = metrics.avg_recall(l_cod, gt, 100)
    r_ref = metrics.avg_recall(l_ref, gt, 100)
    top1 = float((l_dec[:, 0] == l_cod[:, 0]).mean())
    log(f"[main] avg_recall@100 decoded {r_dec:.4f}, codes {r_cod:.4f}, "
        f"refined {r_ref:.4f}; recall@100 (true NN in top 100) refined "
        f"{metrics.recall_at_r(l_ref, gt, 100):.4f}; codes/decoded top-1 "
        f"agreement {top1:.4f} (block_rows {idx._codes_block_rows(100)})")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    assert l_cod.shape == (NQ_MAIN, 100) and np.isfinite(d_cod).all()
    assert np.isfinite(d_ref).all() and (l_ref >= 0).all()
    assert top1 >= 0.9, top1
    assert r_ref >= r_dec, (r_ref, r_dec)
    return launches, {"idx": idx, "base": base, "queries": queries, "gt": gt,
                      "r_dec": r_dec}


def _device_split(prof, names) -> tuple[dict, float]:
    """(device ms of the kernels and copies inside each profiler range, as
    the ranges' spans on the device timeline place them, plus "other" for
    the rest; the device's busy ms). The ranges' own device spans include
    the gaps between their kernels, so they are not summed themselves."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(ev.name, ev.time_range.start, ev.time_range.end)
             for ev in prof.events() if ev.device_type == cuda and ev.name in names]
    out = {n: 0.0 for n in (*names, "other")}
    for ev in prof.events():
        if ev.device_type != cuda or ev.name in names:
            continue
        stage = next((n for n, t0, t1 in spans
                      if t0 <= ev.time_range.start < t1), "other")
        out[stage] += ev.time_range.elapsed_us() / 1e3
    return out, sum(out.values())


def _profile_split(tag: str, what: str, fn, stages) -> None:
    """One call of ``fn`` (a 512-query search) under ``torch.profiler``:
    the device ms inside each of the profiler ranges ``stages`` and the
    rest, the device's busy time and its share of the unprofiled batch wall
    (the profiler slows the host), and the device time by kernel."""
    wall = _batch_wall_ms(fn)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    split, busy = _device_split(prof, stages)
    log(f"[{tag}] {what}, one 512-query batch: wall {wall:.3f} ms unprofiled "
        f"({prof_wall:.3f} ms under the profiler), device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}% of the unprofiled wall); device ms by stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    log(f"[{tag}] top device ops:\n" + prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=12))


def _dispatch_counts(idx, queries, k: int) -> tuple[int, int]:
    """(active, dispatched) (query, cluster) entries of one probe batch: the
    static qcap drops the difference (vaq_tpu/ops/probe.py:139-144)."""
    from vaq_tpu_torch import pca
    from vaq_tpu_torch.ops import probe
    st = idx.ivf.state
    p_visit, p_max, qcap, _ = idx.ivf.params(k, len(queries))
    qp = pca.project(torch.as_tensor(queries, device=DEVICE), idx._eigvecs_device())
    cents = torch.as_tensor(st.centroids, device=DEVICE)
    cd = probe.cluster_sq_dists(qp[:, :st.seg_dims], cents)
    pr, active = probe.dynamic_probe(cd, st.sizes, k, p_visit, p_max)
    _, ok, _, _ = probe.dispatch_table(pr, active, st.ncl, min(qcap, len(queries)))
    return int(active.sum()), int(ok.sum())


def phase_ivf_path(ctx: dict) -> dict:
    """The TI/IVF path on the 1M index; returns K5/K7's launches."""
    from vaq_tpu_torch import ivf, metrics
    from vaq_tpu_torch.ops import probe_scan, rescore
    idx, queries, gt = ctx["idx"], ctx["queries"], ctx["gt"]
    probe_scan.groupmin_window_scan.launches = 0
    rescore.gather_rescore.launches = 0
    _step(f"attach_ivf ({TI_CLUSTERS} clusters over {TI_SEGMENTS} subspaces)",
          lambda: ivf.attach_ivf(idx, verbose=True, ti_cluster_num=TI_CLUSTERS,
                                 ti_segment_num=TI_SEGMENTS))
    assert idx.config.ti_cluster_num == -1  # the overrides leave it as it was
    recalls = {}
    for visit in VISITS:
        idx.ivf.visit = visit
        p = idx.ivf.params(100, 512)
        _step(f"search ivf visit={visit} k=100 (first call)",
              lambda: idx.search(queries, 100, backend="ivf"), NQ_MAIN)
        d_ivf, l_ivf = _step(f"search ivf visit={visit} k=100 "
                             f"(p_visit, p_max, qcap, gs) = {p}",
                             lambda: idx.search(queries, 100, backend="ivf"),
                             NQ_MAIN)
        assert (l_ivf >= 0).all() and np.isfinite(d_ivf).all(), visit
        recalls[visit] = metrics.avg_recall(l_ivf, gt, 100)
        active, dispatched = _dispatch_counts(idx, queries[:512], 100)
        log(f"[ivf] visit={visit}: avg_recall@100 {recalls[visit]:.4f}; first "
            f"batch: {dispatched} of {active} (query, cluster) entries "
            f"dispatched, {active - dispatched} dropped by qcap = {p[2]}")
    launches = {"groupmin_window_scan": probe_scan.groupmin_window_scan.launches,
                "gather_rescore": rescore.gather_rescore.launches}
    log(f"[ivf] kernel launches during the IVF path: {launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the IVF path"
    gap = abs(recalls[1.0] - ctx["r_dec"])
    log(f"[ivf] visit 1.0 vs decoded avg_recall@100: {recalls[1.0]:.4f} vs "
        f"{ctx['r_dec']:.4f} (|Δ| {gap:.4f})")
    assert gap < 0.03, (recalls[1.0], ctx["r_dec"])

    # the stage split of one 512-query batch at visit 0.1
    idx.ivf.visit = 0.10
    qb = queries[:512]
    _profile_split("ivf", "visit 0.1", lambda: idx.search(qb, 100, backend="ivf"),
                   ("ivf.probe", "ivf.groupmin", "ivf.merge", "ivf.rescore",
                    "ivf.second_stage"))

    d8, l8 = _step("search decoded8 k=100 (first call builds the int8 db)",
                   lambda: idx.search(queries, 100, backend="decoded8"), NQ_MAIN)
    d8, l8 = _step("search decoded8 k=100",
                   lambda: idx.search(queries, 100, backend="decoded8"), NQ_MAIN)
    r8 = metrics.avg_recall(l8, gt, 100)
    log(f"[ivf] decoded8 avg_recall@100 {r8:.4f}")
    assert np.isfinite(d8).all() and (l8 >= 0).all()
    assert abs(r8 - ctx["r_dec"]) < 0.03, (r8, ctx["r_dec"])
    return launches


def _fast_search(idx, queries, gt, what: str, k: int = 100, **kw):
    """One timed FAST-path search (after a first call that is not timed
    apart); logs avg_recall@100 and returns the result."""
    from vaq_tpu_torch import metrics
    d, l = _step(f"search {what}", lambda: idx.search(queries, k, **kw),
                 NQ_MAIN, "fast")
    assert l.shape == (NQ_MAIN, k) and (l >= 0).all() and np.isfinite(d).all(), what
    log(f"[fast] {what}: avg_recall@100 "
        f"{metrics.avg_recall(l[:, :100], gt, 100):.4f}")
    return d, l


def phase_fast_path(ctx: dict) -> dict:
    """The FAST/LUT path at 1M × 128 on FAST_METHOD: K3 before the LUT
    quantization is learned, K4 after it, the LUT gather scan, "auto" (the
    codes tier, K1/K2, by the route JAX takes on an accelerator) and refine
    from a fast4 search; returns K3's and K4's launches and K1's under
    "auto"."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import metrics
    from vaq_tpu_torch.ops import scan_codes
    base, queries, gt = ctx["base"], ctx["queries"], ctx["gt"]
    counts = scan_codes.fast4_window_scan.launches
    dev = torch.device(DEVICE)
    idx = vt.VAQIndex(vt.parse_method_string(FAST_METHOD), device=dev)
    _step("train", lambda: idx.train(base), tag="fast")
    log(f"[fast] bits {idx.bits.tolist()}")
    _step("encode", lambda: idx.encode(base), tag="fast")
    # training is deterministic on the card: a second index from the same
    # config, data and seed has the same centroids and codes, bit for bit
    twin = vt.VAQIndex(vt.parse_method_string(FAST_METHOD), device=dev)
    _step("train again (same config, data and seed)", lambda: twin.train(base),
          tag="fast")
    _step("encode again", lambda: twin.encode(base), tag="fast")
    same = (np.array_equal(twin.eigvecs, idx.eigvecs)
            and np.array_equal(twin.centroids, idx.centroids)
            and torch.equal(twin.codes, idx.codes))
    log(f"[fast] two trainings: rotation, centroids and codes bit-equal: {same}")
    assert same, "two trainings of one config, data and seed differ"
    del twin
    fast_stages = ("fast.lut", "fast.scan", "fast.select", "fast.rescore",
                   "fast.topk")

    counts.update(K3=0, K4=0)
    _step("search fast4, f32 LUT (K3), first call",
          lambda: idx.search(queries, 100, backend="fast4"), NQ_MAIN, "fast")
    _fast_search(idx, queries, gt, "fast4, f32 LUT (K3)", backend="fast4")
    k3 = counts["K3"]
    assert k3 > 0 and counts["K4"] == 0, counts
    _profile_split("fast", "fast4, f32 LUT (K3)",
                   lambda: idx.search(queries[:512], 100, backend="fast4"), fast_stages)

    _step("learn_quantization(base, 0.1)",
          lambda: idx.learn_quantization(base, 0.1), tag="fast")
    counts.update(K3=0, K4=0)
    _step("search fast4, u8 LUT (K4), first call",
          lambda: idx.search(queries, 100, backend="fast4"), NQ_MAIN, "fast")
    _fast_search(idx, queries, gt, "fast4, u8 LUT (K4)", backend="fast4")
    _fast_search(idx, queries, gt, "lut_gather, dequantized LUT",
                 backend="lut_gather")
    k4 = counts["K4"]
    assert k4 > 0 and counts["K3"] == 0, counts
    _profile_split("fast", "fast4, u8 LUT (K4)",
                   lambda: idx.search(queries[:512], 100, backend="fast4"), fast_stages)

    # "auto" on a quantized FAST index: "lut", which JAX's accelerator rule
    # serves from the codes tier when enough windows form
    counts.update(K3=0, K4=0)
    scan_codes.decode_window_scan.launches = 0
    _step("search auto, first call", lambda: idx.search(queries, 100),
          NQ_MAIN, "fast")
    _fast_search(idx, queries, gt, "auto (codes tier)")
    k1 = scan_codes.decode_window_scan.launches
    log(f"[fast] auto: K1 launches {k1}, K3/K4 {counts}")
    assert k1 > 0, "auto did not run K1"
    assert counts == {"K3": 0, "K4": 0}, counts
    # K1's second checked shape (C = 16, 128-row windows)
    assert (idx._codes_block_rows(100), int(idx.bits.max())) == \
        (K1_SHAPES[1][5], K1_SHAPES[1][2].bit_length() - 1)
    _profile_split("fast", "auto (codes tier)",
                   lambda: idx.search(queries[:512], 100), ())

    counts.update(K3=0, K4=0)
    _, cand = _fast_search(idx, queries, gt, "fast4 k=200 (K4)", k=200,
                           backend="fast4")
    d_ref, l_ref = _step("refine 200->100",
                         lambda: idx.refine(queries, cand, base, 100), NQ_MAIN,
                         "fast")
    k4 += counts["K4"]
    assert counts["K4"] > 0 and counts["K3"] == 0, counts
    assert np.isfinite(d_ref).all() and (l_ref >= 0).all()
    log(f"[fast] refined 200->100 avg_recall@100 "
        f"{metrics.avg_recall(l_ref, gt, 100):.4f}")
    launches = {"fast4_window_scan": k3, "fast4_window_scan_int8": k4,
                "decode_window_scan_c16": k1}
    log(f"[fast] kernel launches during the FAST path: {launches}")
    return launches


def _ivf_card_vs_cpu(gpu, cpu, queries, ti_segments: int) -> None:
    """One IVF state built on the card, copied to the CPU, searched on both
    with the decoded tier resident (nq ≤ 256: qcap = nq, nothing drops)."""
    import dataclasses

    from vaq_tpu_torch import ivf
    ivf.attach_ivf(gpu, ti_cluster_num=64, ti_segment_num=ti_segments,
                   visit=0.25)
    st = gpu.ivf.state
    st_cpu = dataclasses.replace(
        st, bucket_rows=st.bucket_rows.cpu(), bucket_ids=st.bucket_ids.cpu(),
        sizes=st.sizes.cpu(), dim_scales=st.dim_scales.cpu())
    cpu.ivf = ivf.IVFSearcher(st_cpu, 0.25)
    for idx in (gpu, cpu):
        idx._ensure_decoded()
    dg, ig = gpu.search(queries, K_CMP, backend="ivf")
    dc, ic = cpu.search(queries, K_CMP, backend="ivf")
    agree = float(np.mean([len(set(ig[q]) & set(ic[q])) / K_CMP
                           for q in range(len(queries))]))
    # The probe returns ‖q‖² − score (JAX's formula), a difference of terms
    # of the size of ‖q‖² that cancels: hold it to 1e-4 of those terms.
    qp = queries @ cpu.eigvecs[:, :cpu.total_dim]
    terms = np.abs(dc) + (qp * qp).sum(axis=1)[:, None]
    rel = float(np.max(np.abs(dg - dc) / terms))
    log(f"[cmp] ivf d={st.d_full}: top-{K_CMP} id agreement card vs cpu "
        f"{agree:.4f}, max |Δdist| {float(np.max(np.abs(dg - dc))):.3g} = "
        f"{rel:.3g} of the terms (max rel Δdist "
        f"{float(np.max(np.abs(dg - dc) / dc)):.3g})")
    assert (ig >= 0).all() and agree >= 0.99, agree
    assert rel <= 1e-4, rel


def _fast_card_vs_cpu() -> None:
    """A 20k FAST state, its LUT quantizers learned on the card, searched on
    the card and on the CPU through fast4 (K3 without the quantizers, K4
    with them) and the LUT gather scan."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import data
    from vaq_tpu_torch.convert import index_from_numpy
    base, queries = data.make_anisotropic_gaussian(N_CMP, D_MAIN, NQ_CMP,
                                                   seed=SEED + 3)
    trained = vt.VAQIndex(vt.parse_method_string(FAST_METHOD),
                          device=DEVICE).build(base)
    trained.learn_quantization(base, 0.1)
    arrays, meta = trained.state()
    plain = {k: v for k, v in arrays.items() if not k.startswith("lut_")}
    for what, state, backend in (("fast4 K3", plain, "fast4"),
                                 ("fast4 K4", arrays, "fast4"),
                                 ("lut_gather", arrays, "lut_gather")):
        gpu = index_from_numpy(state, meta, DEVICE)
        cpu = index_from_numpy(state, meta, "cpu")
        dg, ig = gpu.search(queries, K_CMP, backend=backend)
        dc, ic = cpu.search(queries, K_CMP, backend=backend)
        agree = float(np.mean([len(set(ig[q]) & set(ic[q])) / K_CMP
                               for q in range(NQ_CMP)]))
        log(f"[cmp] FAST {what}: top-{K_CMP} id agreement card vs cpu "
            f"{agree:.4f}, ids equal on {float((ig == ic).mean()):.4f} of "
            f"entries, max rel Δdist {float(np.max(np.abs(dg - dc) / dc)):.3g}")
        assert (ig >= 0).all() and agree >= 0.99, (what, agree)
        np.testing.assert_allclose(dg, dc, rtol=1e-4)


def phase_card_vs_cpu() -> None:
    """One converted state searched on the card and on the CPU."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import data
    from vaq_tpu_torch.convert import index_from_numpy
    base, queries = data.make_anisotropic_gaussian(N_CMP, D_MAIN, NQ_CMP,
                                                   seed=SEED + 1)
    trained = vt.VAQIndex(vt.parse_method_string(METHOD), device=DEVICE).train(base)
    trained.encode(base)
    arrays, meta = trained.state()
    gpu = index_from_numpy(arrays, meta, DEVICE)
    cpu = index_from_numpy(arrays, meta, "cpu")
    for backend in ("decoded", "codes"):
        dg, ig = gpu.search(queries, K_CMP, backend=backend)
        dc, ic = cpu.search(queries, K_CMP, backend=backend)
        agree = float(np.mean([len(set(ig[q]) & set(ic[q])) / K_CMP
                               for q in range(NQ_CMP)]))
        log(f"[cmp] {backend}: top-{K_CMP} id agreement card vs cpu {agree:.4f}, "
            f"max rel Δdist {float(np.max(np.abs(dg - dc) / dc)):.3g}")
        assert agree >= 0.99, (backend, agree)
        np.testing.assert_allclose(dg, dc, rtol=1e-4)
    _, cand = cpu.search(queries, 2 * K_CMP)
    dg, ig = gpu.refine(queries, cand, base, K_CMP)
    dc, ic = cpu.refine(queries, cand, base, K_CMP)
    np.testing.assert_allclose(dg, dc, rtol=1e-4)
    log(f"[cmp] refine: ids equal on {float((ig == ic).mean()):.4f} of entries")
    _ivf_card_vs_cpu(gpu, cpu, queries, 16)
    # d = 96, the shape JAX stored transposed for its K6/K8
    base96, queries96 = data.make_anisotropic_gaussian(N_CMP, 96, NQ_CMP,
                                                       seed=SEED + 2)
    m96 = "VAQ192m24min7max8var1,HEAP"
    trained = vt.VAQIndex(vt.parse_method_string(m96), device=DEVICE).build(base96)
    arrays, meta = trained.state()
    _ivf_card_vs_cpu(index_from_numpy(arrays, meta, DEVICE),
                     index_from_numpy(arrays, meta, "cpu"), queries96, 24)
    _fast_card_vs_cpu()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        return 2
    smi = phase_environment()
    phase_build()
    log(f"[kernels] clocks.sm, clocks.max.sm, power.draw, temperature: {_clocks()}")
    kernels = phase_kernels()
    log(f"[kernels] clocks.sm, clocks.max.sm, power.draw, temperature: {_clocks()}")
    launches, ctx = phase_main_path()
    launches.update(phase_ivf_path(ctx))
    ctx["idx"] = None
    torch.cuda.empty_cache()
    launches.update(phase_fast_path(ctx))
    del ctx
    torch.cuda.empty_cache()
    phase_card_vs_cpu()
    for kern in kernels:
        # a d = 96, bf16 or C = 256 check is the same kernel as the main
        # path's: the longest counter name that prefixes the check's
        name = max((n for n in launches if kern["name"].startswith(n)), key=len)
        kern["launches"] = launches[name]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
