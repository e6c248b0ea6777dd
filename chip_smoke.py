#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``vaq_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

from the root of the repository. It builds the port's CUDA kernels from
``vaq_tpu_torch/csrc`` with ``nvcc`` (into ``build/vaq_tpu_torch/``) and runs
five phases, printing progress as it goes:

1. environment: the card's name and power limit, torch, CUDA and nvcc
   versions;
2. build of the kernels, timed;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (n = 1M codes, M = 32, C = 256, d = 128, 512 queries,
   128-row windows; the rescore at 512 × 200 candidates), timed with CUDA
   events after a warm-up;
4. the main path at SIFT1M shape, 1M × 128-d, ``VAQ256m32min7max8var1,HEAP``
   on seeded synthetic data: train, encode, search on the decoded and on the
   codes tier (k = 100), then search 200 and refine to 100, with times, QPS,
   peak device memory and recall against exact groundtruth; the kernel launch
   counters must move during this phase;
5. one index state searched on the card and through the port's CPU plain
   versions at n = 20k; the answers must agree.

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
# K1's scores keep only the high 23 − idx_bits mantissa bits (the low ones
# hold the row index), so two last-bit-different sums can land one step of
# 2^(idx_bits − 23), relative, apart: 1.5e-5 at 128-row windows.
RTOL_K1_SCORES = RTOL_KERNEL + 2.0 ** ((KC_BR - 1).bit_length() - 23)
N_CMP, NQ_CMP, K_CMP = 20_000, 200, 10
DEVICE = "cuda"


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


def phase_build() -> float:
    from vaq_tpu_torch import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    log(f"[build] {path.name} in {dt:.2f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
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


def phase_kernels() -> list[dict]:
    """K1 and K2 against their plain versions on the card."""
    from vaq_tpu_torch.ops import scan_codes
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    d = KC_M * KC_L
    cents = rng.standard_normal((KC_M, KC_C, KC_L)).astype(np.float32)
    codes = torch.as_tensor(rng.integers(0, KC_C, (KC_N, KC_M), dtype=np.uint8),
                            device=dev)
    qp = torch.as_tensor(rng.standard_normal((KC_NQ, d)).astype(np.float32),
                         device=dev)
    table = scan_codes.build_decode_table(cents, dev)
    rows = scan_codes.build_decode_rows(cents, dev)

    # K1
    s_k, i_k = scan_codes.decode_window_scan(codes, table, qp, KC_BR)
    s_r, i_r = scan_codes.decode_window_scan_ref(codes, table, qp, KC_BR)
    torch.cuda.synchronize()
    assert s_k.shape == (KC_NQ, -(-KC_N // KC_BR)) and torch.isfinite(s_k).all()
    torch.testing.assert_close(s_k, s_r, rtol=RTOL_K1_SCORES, atol=1e-5)
    diff = (i_k != i_r).nonzero()
    if len(diff):
        # ids may differ only where the two rows tie to within RTOL_KERNEL
        # (the kernel and the plain version sum in different orders): score
        # both rows in f64 with the kernel's own formula
        q64 = qp.to(torch.bfloat16).double()
        qn = (qp * qp).sum(1).double()
        tbl = table.double().reshape(KC_C, KC_M, KC_L)
        sub = torch.arange(KC_M, device=dev)

        def score(ids):
            x = tbl[codes[ids[:, 1].long()].long(), sub].reshape(-1, d)
            return (x * x).sum(1) - 2 * (x * q64[ids[:, 0]]).sum(1) + qn[ids[:, 0]]

        a = score(torch.stack([diff[:, 0], i_k[diff[:, 0], diff[:, 1]]], 1))
        b = score(torch.stack([diff[:, 0], i_r[diff[:, 0], diff[:, 1]]], 1))
        assert torch.all((a - b).abs() <= RTOL_KERNEL * b.abs() + 1e-5), \
            "K1 winners differ beyond a tie"
    k1_err = float((s_k - s_r).abs().max())
    k1_ms = _time_ms(lambda: scan_codes.decode_window_scan(codes, table, qp, KC_BR), 10)
    k1_plain = _time_ms(
        lambda: scan_codes.decode_window_scan_ref(codes, table, qp, KC_BR), 3)
    log(f"[kernels] K1 decode_window_scan: max|Δscore| {k1_err:.3g}, "
        f"{len(diff)} id ties of {i_k.numel()}, kernel {k1_ms:.3f} ms, "
        f"plain {k1_plain:.3f} ms")

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
    log(f"[kernels] K2 decode_rescore: max|Δ| {k2_err:.3g}, kernel {k2_ms:.3f} ms, "
        f"plain {k2_plain:.3f} ms")
    return [
        {"name": "decode_window_scan", "route": "cuda",
         "source": "vaq_tpu_torch/csrc/decode_window_scan.cu",
         "replaces": "vaq_tpu/ops/scan_pallas.py:283",
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "decode_rescore", "route": "cuda",
         "source": "vaq_tpu_torch/csrc/decode_rescore.cu",
         "replaces": "vaq_tpu/ops/scan_pallas.py:477",
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]


def _step(name: str, fn, nq: int | None = None):
    """Run one main-path step; log its time, QPS and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() / 2**20
    qps = f", {nq / dt:.0f} QPS" if nq else ""
    log(f"[main] {name}: {dt:.3f} s{qps}, peak {mem:.0f} MiB")
    return out


def phase_main_path() -> dict:
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

    scan_codes.decode_window_scan.launches = 0
    scan_codes.decode_rescore.launches = 0
    idx = vt.VAQIndex(vt.parse_method_string(METHOD), device=dev)
    _step("train", lambda: idx.train(base, verbose=True))
    log(f"[main] bits {idx.bits.tolist()}")
    _step("encode", lambda: idx.encode(base))
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
    return launches


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        return 2
    smi = phase_environment()
    phase_build()
    kernels = phase_kernels()
    launches = phase_main_path()
    phase_card_vs_cpu()
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
