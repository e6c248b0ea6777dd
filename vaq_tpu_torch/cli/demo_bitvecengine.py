"""demo_bitvecengine — query-mode matrix CLI, mirroring
``examples/demo_bitvecengine.cpp:41-396``; the counterpart of
``vaq_tpu/cli/demo_bitvecengine.py``, with its flags and printed lines, on
the card (``VAQ_TPU_PLATFORM=cpu`` runs it on the CPU). The reference's 10
query modes map onto the engine as:

  mode 0  binary only              → BinaryIndex.query
  mode 1  binary + rerank          → query_rerank
  mode 2  binary + cluster         → query
  mode 3  cluster + rerank         → query_rerank
  mode 4  ED naive (exact)         → query_naive
  mode 5  ED naive + cluster       → query_naive
  mode 6  ED naive parallel        → query_naive
  mode 7  ED disk-resident         → sharded exact search over the mesh
  mode 8  ED cluster disk-resident → sharded exact search over the mesh
  mode 9  ED triangle-inequality   → query_naive (exact; TI is a CPU prune)

Modes 7 and 8 run ``parallel.sharded_exact_search`` over ``make_mesh()``
(every visible card; the CPU under ``VAQ_TPU_PLATFORM=cpu``), the rows
placed by ``shard_rows_for``, as the JAX demo does.

plus --write-groundtruth (demo_bitvecengine.cpp:335-355) and --iteration
query-time averaging (cpp:311-333).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="demo_bitvecengine", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="")
    p.add_argument("--queries", default="")
    p.add_argument("--file-format-ori", default="fvecs")
    p.add_argument("--groundtruth", default="")
    p.add_argument("--groundtruth-format", default="ivecs")
    p.add_argument("--timeseries-size", type=int, default=128)
    p.add_argument("--dataset-size", type=int, default=0)
    p.add_argument("--queries-size", type=int, default=0)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--bit-budget", type=int, default=256)
    p.add_argument("--mode", type=int, default=0, choices=range(10))
    p.add_argument("--rerank-factor", type=int, default=10)
    p.add_argument("--iteration", type=int, default=1)
    p.add_argument("--write-groundtruth", default="")
    p.add_argument("--synthetic", type=int, default=0, metavar="N")
    p.add_argument("--metric", default="hamming",
                   choices=("hamming", "jaccard", "l2", "manhattan"),
                   help="bit-space metric for modes 0-3 (hamming/jaccard, "
                        "DistanceFunctions.hpp:164/218); exact metric for "
                        "modes 4-6/9 (l2/manhattan, hpp:232/254)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from vaq_tpu_torch.cli import platform_device
    device = platform_device()

    from vaq_tpu_torch import io, metrics
    from vaq_tpu_torch.binary import BinaryIndex
    from vaq_tpu_torch.cli.demo_vaq import load_matrix

    gt = None
    if args.synthetic:
        from vaq_tpu_torch.data import make_sift_like
        dataset, queries, gt = make_sift_like(
            n=args.synthetic, n_queries=args.queries_size or 100,
            d=args.timeseries_size, device=device)
    else:
        dataset = load_matrix(args.dataset, args.file_format_ori,
                              args.timeseries_size, args.dataset_size)
        queries = load_matrix(args.queries, args.file_format_ori,
                              args.timeseries_size, args.queries_size)
    if args.groundtruth:
        gt = (io.read_ivecs(args.groundtruth)
              if args.groundtruth_format == "ivecs"
              else np.loadtxt(args.groundtruth, delimiter=",", dtype=np.int64))

    idx = BinaryIndex(bit_budget=args.bit_budget,
                      device=device).train(dataset).encode(dataset)

    if args.write_groundtruth:
        _, gtl = idx.query_naive(queries, dataset, args.k)
        io.write_ivecs(args.write_groundtruth, gtl.astype(np.int32))
        print(f"groundtruth written to {args.write_groundtruth}")
        gt = gtl

    mode = args.mode
    times = []
    for _ in range(args.iteration):
        t0 = time.perf_counter()
        if mode in (0, 2):
            bit_metric = args.metric if args.metric in ("hamming", "jaccard") \
                else "hamming"
            dists, labels = idx.query(queries, args.k, metric=bit_metric)
        elif mode in (1, 3):
            dists, labels = idx.query_rerank(queries, dataset, args.k,
                                             factor=args.rerank_factor)
        elif mode in (4, 5, 6, 9):
            ex_metric = args.metric if args.metric in ("l2", "manhattan") \
                else "l2"
            dists, labels = idx.query_naive(queries, dataset, args.k,
                                            metric=ex_metric)
        else:  # 7, 8: sharded exact over the device mesh
            import torch

            from vaq_tpu_torch.parallel import make_mesh, sharded_exact_search
            from vaq_tpu_torch.parallel.dist_kmeans import shard_rows_for
            mesh = make_mesh(devices=None if device == "cuda" else [device])
            db_sh = shard_rows_for(mesh, np.asarray(dataset, np.float32))
            d_, l_ = sharded_exact_search(
                db_sh, torch.as_tensor(np.asarray(queries, np.float32),
                                       device=mesh.devices.flat[0]),
                args.k, dataset.shape[0], mesh)
            dists, labels = d_.cpu().numpy(), l_.cpu().numpy()
        times.append(time.perf_counter() - t0)
    print(f"== Querying time (avg over {args.iteration}): "
          f"{np.mean(times):.4f}s")

    if gt is not None:
        print(f"\tprecision(avg_recall): "
              f"{metrics.avg_recall(labels, gt, args.k):.6f}")
        print(f"\trecall@R: {metrics.recall_at_r(labels, gt, args.k):.6f}")
        print(f"\tMAP: "
              f"{metrics.mean_average_precision(labels, gt, args.k):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
