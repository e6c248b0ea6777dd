#!/usr/bin/env python3
"""DEEP-100M on one CUDA card with the PyTorch port, every tier resident.

    python3 scripts/capacity_100m_torch.py [--n 100000000] [--d 96]
        [--queries 1024] [--k 10] [--batch 1024] [--chunk 2000000]
        [--config VAQ256m32min5max8var1,HEAP] [--train-sample 262144]
        [--seed 42] [--out build/capacity_100m_torch.json]

The port's run of the reference's Fig. 11a deployment (DEEP-100M,
``VAQ256m32min5max8var1``, d = 96, 1000 clusters over 16 subspaces, visit
25/10/5 %, refine 100-500; ExperimentsParameters.txt:114-124), the flow of
the JAX package's ``scripts/capacity_100m.py``, importing only
``vaq_tpu_torch``:

1. rows generated chunk by chunk on the card (``data.DeviceChunkSource``);
   the 38 GB dataset never exists whole;
2. ``train`` on a host sample, ``encode_chunks`` into the resident u8 codes
   (32 B a row, 3.2 GB);
3. exact groundtruth@100 streamed over the chunks
   (``distances.exact_search_chunked``);
4. the codes tier (``search_device(backend="codes")``, kernels K1/K2);
5. the bf16 tier (192 B a row + f32 norms, 19.6 GB) through the public
   ``search(backend="auto")``, host arrays in and out (kernel D1), then D1
   alone held against the plain scan of that tier on the first batch
   (``kernel_check.d1_check``; the candidates whose row starts 2^31 bytes
   or more into the tier counted) and, on a card, timed by CUDA events
   beside the plain scan; the tier is then released, so the probe's
   second stage does not run (it runs only while the tier is resident);
6. the int8 tier (``decoded8``, 96 B a row + f32 norms, 10 GB), then its
   candidates refined exactly, 100 and 500 → k, against the regenerated
   chunks (``distances.exact_rescore_chunked``);
7. ``ivf.build_ivf_streamed`` (1000 clusters, capacity factor 1.0: 102,400
   slots a cluster, 9.8 GB of int8 rows) with the codes and the int8 tier
   left resident, then the visit sweep through ``ivf.IVFSearcher``
   (kernels K5/K7).

Per stage it reports the wall time, for each tier the QPS (the batch over
the median of ``--reps`` timed batches after a warm-up, each ended by a
device synchronize), ``avg_recall@k`` against the groundtruth and the peak
device memory; for the probe build its passes' times, the bucket capacity,
the live sizes' range and the rows the capacity fill spilled outside their
four nearest clusters (ROADMAP fault 9). The top-k is exact everywhere
(JAX's 100M run used ``exact=False``). Unlike the JAX script no section
catches a failure: any error ends the run. It prints one JSON line and
writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import vaq_tpu_torch as vt  # noqa: E402
from vaq_tpu_torch import io, ivf, metrics, pca  # noqa: E402
from vaq_tpu_torch.data import DeviceChunkSource  # noqa: E402
from vaq_tpu_torch.device import resolve  # noqa: E402
from vaq_tpu_torch.ops import (distances, kernel_check,  # noqa: E402
                               probe_scan, rescore, scan_codes, scan_decoded)

GT_DEPTH = 100


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(n: int = 100_000_000, d: int = 96, queries: int = 1024, k: int = 10,
        batch: int = 1024, chunk: int = 2_000_000,
        config: str = "VAQ256m32min5max8var1,HEAP",
        train_sample: int = 262_144, seed: int = 42, clusters: int = 1000,
        segments: int = 16, visits=(0.25, 0.10, 0.05), refines=(100, 500),
        reps: int = 5, device: torch.device | str = "cuda"):
    """The whole flow on ``device``. Returns (the report, the index with
    its codes and int8 tier, the probe state, the projected queries (nq,
    d) f32), every structure still resident."""
    dev = resolve(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    stages: dict = {}

    def stage(name: str, fn):
        """Run ``fn`` as one stage: its wall seconds and peak memory."""
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        sync()
        rec = {"wall_s": time.perf_counter() - t0}
        if cuda:
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        stages[name] = rec
        log(f"[100m] {name}: {rec['wall_s']:.2f} s"
            + (f", peak {rec['peak_bytes'] / 2**30:.2f} GiB" if cuda else ""))
        return out

    def tier(name: str, search, q_batches, gt):
        """QPS over the first batch (median of ``reps`` timed calls after a
        warm-up) and avg_recall@k over all batches, as one stage."""

        def go():
            search(q_batches[0])
            walls = []
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                out = search(q_batches[0])
                sync()
                walls.append(time.perf_counter() - t0)
            labels = [out[1]] + [search(qb)[1] for qb in q_batches[1:]]
            labels = torch.cat([torch.as_tensor(lab) for lab in labels])
            labels = labels.cpu().numpy()
            return float(np.median(walls)), labels

        med, labels = stage(name, go)
        rec = stages[name]
        rec.update(batch_s=med, qps=q_batches[0].shape[0] / med,
                   recall_at_k=metrics.avg_recall(labels, gt, k))
        log(f"[100m] {name}: {rec['qps']:.1f} QPS, avg_recall@{k} "
            f"{rec['recall_at_k']:.4f}")
        return labels

    def events_ms(fn, reps: int) -> float:
        """Mean milliseconds a call over ``reps`` calls, by CUDA events."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    def d1_held():
        """D1 alone against the plain scan of the bf16 tier, first batch."""
        rows, norms = idx.decoded, idx.decoded_norms
        q = pca.project(q_batches[0], idx._eigvecs_device())
        q = q.to(torch.bfloat16).contiguous()
        kk = min(max(2 * k, k + 16), n)

        def d1():
            return scan_decoded.decoded_topk_scan(rows, norms, q, kk)

        def plain():
            return scan_decoded._scan_topk(rows, norms, q.float(), kk)

        got = scan_decoded._lowest_split_keys(d1(), kk)
        ok, detail = kernel_check.d1_check(rows, norms, q, got, plain())
        rec = {"kk": kk, "d1_check": ok, "d1_detail": detail,
               "rows_past_2_31_bytes": int(
                   (got.to(torch.int64) * 2 * rows.shape[1] >= 2**31).sum())}
        if cuda:
            rec.update(d1_ms=events_ms(d1, reps), plain_ms=events_ms(plain, 1))
        return rec

    cfg = vt.parse_method_string(config)
    src = stage("source", lambda: DeviceChunkSource(n, d, chunk, seed=seed,
                                                    device=dev))
    q_raw = src.queries(queries)
    q_host = io.pad_dims(q_raw, cfg.subspace_num)
    q_batches = [torch.as_tensor(q_host[s:s + batch], device=dev)
                 for s in range(0, queries, batch)]
    idx = vt.VAQIndex(cfg, device=dev)
    stage("train", lambda: idx.train(src.host_sample(train_sample)))
    stage("encode", lambda: idx.encode_chunks(src.chunk, n, chunk))
    _, gt = stage("groundtruth", lambda: distances.exact_search_chunked(
        q_host, src.chunk, n, chunk, GT_DEPTH, device=dev))

    launches = {}
    scan_codes.decode_window_scan.launches = 0
    scan_codes.decode_rescore.launches = 0
    tier("codes", lambda qb: idx.search_device(qb, k, backend="codes"),
         q_batches, gt)
    launches.update(decode_window_scan=scan_codes.decode_window_scan.launches,
                    decode_rescore=scan_codes.decode_rescore.launches)

    stage("decoded_build", idx._ensure_decoded)
    stages["decoded_build"]["resident_bytes"] = (
        idx.decoded.numel() * idx.decoded.element_size()
        + 4 * idx.decoded_norms.numel())
    scan_decoded.decoded_topk_scan.launches = 0
    tier("auto", lambda qb: idx.search(qb, k, query_batch=batch,
                                       backend="auto"),
         [q_raw[s:s + batch] for s in range(0, queries, batch)], gt)
    launches["decoded_topk_scan"] = scan_decoded.decoded_topk_scan.launches
    held = stage("d1", d1_held)
    stages["d1"].update(held)
    log(f"[100m] D1 against the plain scan: {stages['d1']}")
    idx.decoded = idx.decoded_norms = None
    if cuda:
        torch.cuda.empty_cache()

    stage("decoded8_build", idx._ensure_decoded8)
    tier("decoded8", lambda qb: idx.search_device(qb, k, backend="decoded8"),
         q_batches, gt)
    for depth in refines:
        def refine(depth=depth):
            cand = torch.cat([idx.search_device(qb, depth,
                                                backend="decoded8")[1]
                              for qb in q_batches])
            return distances.exact_rescore_chunked(q_host, cand, src.chunk,
                                                   n, chunk, k, device=dev)
        _, labels = stage(f"refine{depth}", refine)
        stages[f"refine{depth}"]["recall_at_k"] = metrics.avg_recall(
            labels, gt, k)
        log(f"[100m] refine {depth} -> {k}: avg_recall@{k} "
            f"{stages[f'refine{depth}']['recall_at_k']:.4f}")

    state = stage("ivf_build", lambda: ivf.build_ivf_streamed(
        idx, ti_cluster_num=clusters, ti_segment_num=segments,
        balance_cap_factor=1.0, chunk_rows=chunk))
    stages["ivf_build"].update(state.build_stats)
    resident = {
        "codes": idx.codes.numel() * idx.codes.element_size(),
        "decoded8": idx.decoded8.numel() + 4 * idx.decoded8_norms.numel(),
        "buckets": state.bucket_rows.numel() + 4 * state.bucket_ids.numel()}
    log(f"[100m] resident GB: " + ", ".join(
        f"{key} {v / 1e9:.2f}" for key, v in resident.items()))

    qp_batches = [pca.project(qb, idx._eigvecs_device()) for qb in q_batches]
    probe_scan.groupmin_window_scan.launches = 0
    rescore.gather_rescore.launches = 0
    sweep = []
    for visit in visits:
        searcher = ivf.IVFSearcher(state, visit)
        name = f"ivf_visit{visit}"
        tier(name, lambda qp, s=searcher: s.search(idx, qp, k), qp_batches,
             gt)
        p_visit, p_max, qcap, gs = searcher.params(k, qp_batches[0].shape[0])
        stages[name].update(p_visit=p_visit, p_max=p_max, qcap=qcap, gs=gs)
        sweep.append({"visit": visit, **stages[name]})
    launches.update(
        groupmin_window_scan=probe_scan.groupmin_window_scan.launches,
        gather_rescore=rescore.gather_rescore.launches)
    log(f"[100m] kernel launches: {launches}")
    report = {"metric": f"capacity tiers at {n} x {d}d, every tier resident",
            "n": n, "d": d, "config": config, "queries": queries, "k": k,
            "batch": batch, "chunk": chunk, "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
            "stages": stages, "ivf_sweep": sweep,
            "resident_bytes": resident, "launches": launches}
    return report, idx, state, torch.cat(qp_batches)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=100_000_000)
    p.add_argument("--d", type=int, default=96)
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=2_000_000)
    p.add_argument("--config", default="VAQ256m32min5max8var1,HEAP")
    p.add_argument("--train-sample", type=int, default=262_144)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default="build/capacity_100m_torch.json")
    args = p.parse_args()
    out, _, _, _ = run(n=args.n, d=args.d, queries=args.queries, k=args.k,
              batch=args.batch, chunk=args.chunk, config=args.config,
              train_sample=args.train_sample, seed=args.seed)
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
