#!/usr/bin/env python
"""The paper's wide-bits configuration at 1M rows on the PyTorch port.

    python3 scripts/widebits_1m_torch.py [--n 1000000] [--queries 1024]
        [--k 10] [--iters 16] [--config VAQ256m32min2max13var1,HEAP]
        [--device cuda] [--out scripts/widebits_1m_torch.json]

The counterpart of ``scripts/widebits_1m.py``: the SIFT1M Fig. 5
configuration, ``VAQ256m32min2max13var1`` with the hierarchical k-means
(the reference's --kmeans-ver 1, VAQ.cpp:546-607) and codes above 8 bits
(VAQ.cpp:663-726), built on ``--n`` rows. It records the build time, the
bits, the decoded tier's QPS (``bench_torch.measure_qps``: the marginal
cost of a ``--queries`` batch, host wall between two synchronisations),
recall@k and @100 and the refined recall (100 → k), and gates the wide
encode: on the first 131,072 rows and 128 queries the exact f32 LUT-gather
scan over the codes (``ops/scan_lut.adc_scan_topk``) must find the decoded
tier's top-k (``ops/scan_decoded.decoded_scan_topk``; the same ADC
quantity, scanned another way): ``u16_gate_overlap`` is their mean top-k
overlap.

The card keeps the codes as int32; ``codes_dtype`` is the dtype the host
copy takes (``codes_rowmajor()``), uint16 as in JAX's record. The rows are
the first ``--n`` of ``make_anisotropic_gaussian(1_000_000, 128, 1024,
seed=42)`` (``bench_torch.py``'s cache is reused), the groundtruth
``exact_search`` at f32 on the device. The record (JAX's fields, plus the
card's ``nvidia-smi`` name and power limit) is printed and written to
``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_torch  # noqa: E402
import vaq_tpu_torch as vt  # noqa: E402
from vaq_tpu_torch import io, metrics, pca  # noqa: E402
from vaq_tpu_torch.device import resolve  # noqa: E402
from vaq_tpu_torch.ops import distances, scan_decoded, scan_lut  # noqa: E402

METHOD = "VAQ256m32min2max13var1,HEAP"
GATE_ROWS, GATE_QUERIES = 131_072, 128
OUT = os.path.join(HERE, "widebits_1m_torch.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def u16_gate(idx, queries: np.ndarray, k: int, n_rows: int = GATE_ROWS,
             n_queries: int = GATE_QUERIES):
    """The wide-codes gate of JAX's script (widebits_1m.py:93-112) on the
    first ``n_rows`` rows and ``n_queries`` queries of ``idx``: the exact
    f32 LUT-gather top-k over the codes against the decoded tier's exact
    top-k. Returns (mean top-k overlap, the gather scan's ids, the decoded
    tier's ids), ids (n_queries, k) host arrays."""
    dev = idx.device
    ns = min(n_rows, idx.n_rows)
    q = torch.as_tensor(io.pad_dims(np.asarray(queries[:n_queries],
                                               np.float32),
                                    idx.config.subspace_num), device=dev)
    qp = pca.project(q, idx._eigvecs_device())
    luts = scan_lut.build_luts(qp, torch.as_tensor(idx.centroids,
                                                   device=dev))
    _, l_l = scan_lut.adc_scan_topk(idx.codes[:ns], luts, k)
    del luts
    idx._ensure_decoded()
    _, l_d = scan_decoded.decoded_scan_topk(
        idx.decoded[:ns], idx.decoded_norms[:ns], qp, k)
    l_l, l_d = l_l.cpu().numpy(), l_d.cpu().numpy()
    agree = np.mean([len(set(l_l[i]) & set(l_d[i])) / k
                     for i in range(l_l.shape[0])])
    return float(agree), l_l, l_d


def run(base: np.ndarray, queries: np.ndarray, gt: np.ndarray, k: int = 10,
        iters: int = 16, config: str = METHOD,
        device: torch.device | str = "cuda"):
    """Build the hierarchical wide-bits index on ``base``, search, refine,
    time the decoded tier and run :func:`u16_gate`; ``gt`` is the exact
    top-100 of ``queries``. Returns (JAX's record fields, the index)."""
    dev = resolve(device)
    cfg = dataclasses.replace(vt.parse_method_string(config),
                              hierarchical_kmeans=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        idx = vt.VAQIndex(cfg, device=dev).build(base, verbose=True)
    bench_torch._sync(dev)
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.0f}s  bits={np.asarray(idx.bits).tolist()}")
    assert int(idx.bits.max()) > 8, "config must exercise the wide codes"
    codes_dtype = idx.codes_rowmajor().dtype
    assert codes_dtype == np.uint16, codes_dtype

    _, lab = idx.search(queries, 100)
    rec10 = metrics.avg_recall(lab[:, :k], gt, k)
    rec100 = metrics.avg_recall(lab, gt, 100)
    _, refined = idx.refine(queries, lab, base, k)
    rec_ref = metrics.avg_recall(refined, gt, k)
    log(f"recall@{k}={rec10:.4f} recall@100={rec100:.4f} "
        f"refined(100->{k})={rec_ref:.4f}")

    qb = torch.as_tensor(io.pad_dims(queries, cfg.subspace_num), device=dev)
    qps, ms = bench_torch.measure_qps(lambda q: idx.search_device(q, k), qb,
                                      qb.shape[0], iters)
    log(f"decoded QPS={qps:.1f} ({ms:.3f} ms/batch)")

    t0 = time.perf_counter()
    agree, _, _ = u16_gate(idx, queries, k)
    log(f"u16 gate: LUT-gather vs decoded top-{k} overlap = {agree:.4f} "
        f"({time.perf_counter() - t0:.1f} s)")

    n = idx.n_rows
    out = {"metric": f"wide-bits (min2max13/u16) decoded QPS at {n}",
           "value": round(qps, 1), "unit": "qps", "vs_baseline": 1.0,
           "config": config, "hierarchical_kmeans": True,
           "n": n, "build_s": round(build_s, 1),
           "bits_max": int(idx.bits.max()),
           "bits": np.asarray(idx.bits).tolist(),
           "codes_dtype": str(codes_dtype),
           "widebits_qps": round(qps, 1),
           "batch_ms": round(ms, 3),
           "widebits_recall_at_k": round(rec10, 4),
           "recall_at_100": round(rec100, 4),
           "recall_at_10_refined": round(rec_ref, 4),
           "u16_gate_overlap": round(agree, 4),
           "u16_gate_rows": min(GATE_ROWS, n),
           "u16_gate_queries": min(GATE_QUERIES, len(queries))}
    return out, idx


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--config", default=METHOD)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    dev = resolve(args.device)
    env = bench_torch.environment(dev)
    log(f"device: {env['device_name']}; nvidia-smi: {env['nvidia_smi']}")
    base, queries = bench_torch.bench_data(
        os.path.join(os.path.dirname(HERE), ".bench_cache", "torch"),
        1_000_000, 128, 1024)
    base, queries = base[:args.n], queries[:args.queries]
    _, gt = distances.exact_search(torch.as_tensor(queries, device=dev),
                                   torch.as_tensor(base, device=dev), 100)
    out, _ = run(base, queries, gt.cpu().numpy(), args.k, args.iters,
                 args.config, dev)
    out = {**out, "device": env["device_name"],
           "nvidia_smi": env["nvidia_smi"]}
    line = json.dumps(out)
    print(line)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
