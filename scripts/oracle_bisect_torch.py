#!/usr/bin/env python
"""The engine-vs-oracle recall gap of the PyTorch port, stage by stage.

    python3 scripts/oracle_bisect_torch.py [--n 100000] [--d 128]
        [--queries 1024] [--k 10] [--config VAQ256m32min7max8var1,HEAP]
        [--no-oracle] [--device cuda]
        [--out scripts/oracle_bisect_torch_<device type>.json]

The counterpart of ``scripts/oracle_bisect.py``, with its stages and field
names, on the same rows and config as ``bench_torch.oracle_fields``:

  A. the engine's default search (``search``, the decoded tier for HEAP);
  B. the exact top-k over the bf16 scores (``search_device`` over the same
     512-query batches). The port has no approximate top-k, so A and B run
     the same exact search and ``share_approx`` is 0 by construction;
  C. the exact f32 ADC scan (``search(backend="lut_gather")``)  → bf16 share;
  D. the engine's codes scored by the oracle's scan: the port's
     ``build_luts`` on the engine's projection, summed over
     ``codes_rowmajor()`` in f64 on the host                  → scan share;
  E. the numpy oracle end to end (``tests/oracle_ref.OracleVAQ``, a
     transliteration of the reference's VAQ.cpp)             → training share

plus the bit allocations and each side's quantization MSE on the training
rows. E runs on the host at about 9 ms a row (15 minutes at 100k);
``--no-oracle`` leaves it out (its fields are then null).

With ``--d 128`` the rows are the first ``--n`` of
``make_anisotropic_gaussian(1_000_000, 128, 1024, seed=42)`` (as JAX slices
its bench cache; ``bench_torch.py``'s cache is reused), at any other d
``make_anisotropic_gaussian(n, d, queries, seed=42)``; the groundtruth is
``exact_search`` at f32 on the device. The record (with the card's
``nvidia-smi`` name and power limit) is printed and written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_torch  # noqa: E402
import vaq_tpu_torch as vt  # noqa: E402
from vaq_tpu_torch import metrics  # noqa: E402
from vaq_tpu_torch.data import make_anisotropic_gaussian  # noqa: E402
from vaq_tpu_torch.device import resolve  # noqa: E402
from vaq_tpu_torch.io import pad_dims  # noqa: E402
from vaq_tpu_torch.ops import distances, scan_lut  # noqa: E402

METHOD = "VAQ256m32min7max8var1,HEAP"
QUERY_BATCH = 512        # VAQIndex.search's default batch
APPROX_NOTE = ("the port has no approximate top-k: A and B run the same "
               "exact decoded-tier search, so share_approx is 0 by "
               "construction")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def quant_mse(x_proj, centroids, codes_rm, subs_len, highest) -> float:
    """Σ over the kept subspaces of the mean squared quantization error of
    the projected rows (JAX's ``quant_mse``)."""
    err = 0.0
    for s in range(highest):
        sl = x_proj[:, s * subs_len:(s + 1) * subs_len]
        rec = centroids[s][codes_rm[:, s]]
        err += float(np.mean(np.sum((sl - rec) ** 2, axis=1)))
    return err


def oracle_scan(eng, codes_rm: np.ndarray, q_p: np.ndarray, k: int
                ) -> np.ndarray:
    """Stage D: the engine's codes ``codes_rm`` (n, M') scored in f64 on the
    host against LUTs built by the port's ``build_luts`` from the engine's
    projection and centroids; the top-k by a stable sort. Returns (nq, k)
    ids."""
    qp_eng = q_p @ eng.eigvecs[:, :eng.total_dim]
    luts = scan_lut.build_luts(
        torch.as_tensor(qp_eng, device=eng.device),
        torch.as_tensor(eng.centroids, device=eng.device)).cpu().numpy()
    dists = np.zeros((q_p.shape[0], codes_rm.shape[0]), dtype=np.float64)
    for s in range(codes_rm.shape[1]):
        dists += luts[:, s, :][:, codes_rm[:, s]]
    return np.argsort(dists, axis=1, kind="stable")[:, :k]


def bisect(eng, base: np.ndarray, queries: np.ndarray, gt: np.ndarray,
           k: int, oracle: bool = True) -> dict:
    """Stages A-E and their shares on the trained, encoded index ``eng``
    (``base`` its rows, ``gt`` the exact top-k of ``queries``), with JAX's
    field names; E and the fields that need it are None without
    ``oracle``."""
    cfg = eng.config
    base_p = pad_dims(np.asarray(base, np.float32), cfg.subspace_num)
    q_p = pad_dims(np.asarray(queries, np.float32), cfg.subspace_num)
    codes_rm = eng.codes_rowmajor().astype(np.int64)        # (n, M')
    out = {"n": eng.n_rows, "k": k}

    _, lab = eng.search(queries, k)
    out["A_engine_default"] = round(metrics.avg_recall(lab, gt, k), 4)
    l_b = np.concatenate([
        eng.search_device(torch.as_tensor(q_p[s:s + QUERY_BATCH],
                                          device=eng.device), k)[1]
        .cpu().numpy() for s in range(0, len(q_p), QUERY_BATCH)])
    out["B_engine_exact_topk"] = round(metrics.avg_recall(l_b, gt, k), 4)
    _, l_c = eng.search(queries, k, backend="lut_gather")
    out["C_engine_f32_adc"] = round(metrics.avg_recall(l_c, gt, k), 4)

    o = None
    out["E_oracle_e2e"] = None
    if oracle:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from oracle_ref import OracleVAQ
        t0 = time.perf_counter()
        o = OracleVAQ(cfg.bit_budget, cfg.subspace_num, cfg.min_bits,
                      cfg.max_bits, var=cfg.percent_var_explained,
                      seed=cfg.seed)
        o.train(base_p).encode(base_p)
        _, olab = o.search(q_p, k)
        out["E_oracle_e2e"] = round(metrics.avg_recall(olab, gt, k), 4)
        out["oracle_s"] = round(time.perf_counter() - t0, 1)
        log(f"oracle pipeline: {out['oracle_s']:.0f}s")

    out["D_oracle_scan_engine_codes"] = round(
        metrics.avg_recall(oracle_scan(eng, codes_rm, q_p, k), gt, k), 4)

    out["share_approx"] = round(
        out["B_engine_exact_topk"] - out["A_engine_default"], 4)
    out["share_approx_note"] = APPROX_NOTE
    out["share_bf16_scan"] = round(
        out["C_engine_f32_adc"] - out["B_engine_exact_topk"], 4)
    out["share_scan_formulation"] = round(
        out["D_oracle_scan_engine_codes"] - out["C_engine_f32_adc"], 4)
    out["share_training"] = out["delta_total"] = None
    if o is not None:
        out["share_training"] = round(
            out["E_oracle_e2e"] - out["D_oracle_scan_engine_codes"], 4)
        out["delta_total"] = round(
            out["E_oracle_e2e"] - out["A_engine_default"], 4)

    out["engine_bits"] = np.asarray(eng.bits).tolist()
    out["oracle_bits"] = None if o is None else np.asarray(o.bits).tolist()
    xp_eng = base_p @ eng.eigvecs[:, :eng.total_dim]
    out["engine_train_mse"] = round(
        quant_mse(xp_eng, eng.centroids, codes_rm, eng.subs_len,
                  eng.highest_subs), 4)
    out["oracle_train_mse"] = None
    if o is not None:
        xp_o = base_p @ o.eigvecs[:, :o.total_dim]
        out["oracle_train_mse"] = round(
            quant_mse(xp_o, o.centroids, np.asarray(o.codes, np.int64),
                      o.subs_len, o.highest_subs), 4)
    return out


def run(base: np.ndarray, queries: np.ndarray, k: int = 10,
        config: str = METHOD, oracle: bool = True,
        device: torch.device | str = "cuda") -> dict:
    """Groundtruth, engine build and :func:`bisect` on ``device``."""
    dev = resolve(device)
    _, gt = distances.exact_search(torch.as_tensor(queries, device=dev),
                                   torch.as_tensor(base, device=dev), k)
    gt = gt.cpu().numpy()
    t0 = time.perf_counter()
    eng = vt.VAQIndex(vt.parse_method_string(config), device=dev)
    eng.train(base).encode(base)
    bench_torch._sync(dev)
    build_s = time.perf_counter() - t0
    log(f"engine build: {build_s:.1f}s")
    out = bisect(eng, base, queries, gt, k, oracle)
    return {**out, "config": config, "platform": dev.type,
            "engine_build_s": round(build_s, 1)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--config", default=METHOD)
    p.add_argument("--no-oracle", action="store_true",
                   help="leave out stage E (the host numpy oracle)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None,
                   help="default scripts/oracle_bisect_torch_<device "
                        "type>.json")
    args = p.parse_args(argv)
    dev = resolve(args.device)
    env = bench_torch.environment(dev)
    log(f"device: {env['device_name']}; nvidia-smi: {env['nvidia_smi']}")
    if args.d == 128:
        base, queries = bench_torch.bench_data(
            os.path.join(ROOT, ".bench_cache", "torch"), 1_000_000, 128,
            1024)
        base, queries = base[:args.n], queries[:args.queries]
    else:
        base, queries = make_anisotropic_gaussian(args.n, args.d,
                                                  args.queries, seed=42)
    out = run(base, queries, args.k, args.config, not args.no_oracle, dev)
    out = {**out, "device": env["device_name"],
           "nvidia_smi": env["nvidia_smi"]}
    path = args.out or os.path.join(HERE,
                                    f"oracle_bisect_torch_{dev.type}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
