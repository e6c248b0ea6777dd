"""demo_binary — binary/scalar-quantization pipeline CLI, mirroring
``examples/demo_binary.cpp:42-253``: encode the dataset to packed bitstrings
(``binaryEncoding``) and run Hamming top-k, optionally with exact rerank, and
report recall metrics against groundtruth. The counterpart of
``vaq_tpu/cli/demo_binary.py``, with its flags and printed lines, on the
card (``VAQ_TPU_PLATFORM=cpu`` runs it on the CPU).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="demo_binary", description=__doc__)
    p.add_argument("--dataset", default="")
    p.add_argument("--queries", default="")
    p.add_argument("--file-format-ori", default="fvecs",
                   choices=["fvecs", "bvecs", "bin", "ascii"])
    p.add_argument("--groundtruth", default="")
    p.add_argument("--groundtruth-format", default="ivecs",
                   choices=["ascii", "ivecs", "bin"])
    p.add_argument("--timeseries-size", type=int, default=128)
    p.add_argument("--dataset-size", type=int, default=0)
    p.add_argument("--queries-size", type=int, default=0)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--bit-budget", type=int, default=256)
    p.add_argument("--rerank", type=int, default=0,
                   help="rerank factor (0 = binary only)")
    p.add_argument("--result", default="")
    p.add_argument("--save", default="")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "packed", "matmul"])
    p.add_argument("--encoding", default="milp",
                   choices=["milp", "simple"],
                   help="milp = per-dim bit allocation (binaryEncoding); "
                        "simple = sign bits (binaryEncodingSimple)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N")
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
        if not os.path.exists(args.dataset) or not os.path.exists(args.queries):
            print("Dataset or queries file doesn't exists", file=sys.stderr)
            return 1
        dataset = load_matrix(args.dataset, args.file_format_ori,
                              args.timeseries_size, args.dataset_size)
        queries = load_matrix(args.queries, args.file_format_ori,
                              args.timeseries_size, args.queries_size)
    if args.groundtruth:
        if args.groundtruth_format == "ivecs":
            gt = io.read_ivecs(args.groundtruth)
        else:
            gt = np.loadtxt(args.groundtruth, delimiter=",", dtype=np.int64)

    t0 = time.perf_counter()
    if args.save and os.path.exists(args.save):
        idx = BinaryIndex.load(args.save, device=device)
    else:
        idx = BinaryIndex(bit_budget=args.bit_budget, device=device)
        if args.encoding == "simple":
            idx.train_simple(dataset)
        else:
            idx.train(dataset, verbose=True)
        idx.encode(dataset)
        if args.save:
            idx.save(args.save)
    print(f"== Encoding time: {time.perf_counter() - t0:.3f}")

    t0 = time.perf_counter()
    if args.rerank > 0:
        dists, labels = idx.query_rerank(queries, dataset, args.k,
                                         factor=args.rerank)
    else:
        dists, labels = idx.query(queries, args.k, backend=args.backend)
    print(f"== Querying time: {time.perf_counter() - t0:.3f}")

    if args.result:
        io.write_knn_results(args.result, labels)
    if gt is not None:
        print(f"\tprecision(avg_recall): "
              f"{metrics.avg_recall(labels, gt, args.k):.6f}")
        print(f"\trecall@R: {metrics.recall_at_r(labels, gt, args.k):.6f}")
        print(f"\tMAP: "
              f"{metrics.mean_average_precision(labels, gt, args.k):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
