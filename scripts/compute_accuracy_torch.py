#!/usr/bin/env python
"""Offline accuracy checker on the PyTorch port: recall / recall@R / MAP
from a CSV answers file against a groundtruth file.

    python3 scripts/compute_accuracy_torch.py ANSWERS.csv GROUNDTRUTH \
        [--k 100] [--gt-offset 0]

The counterpart of ``scripts/compute_accuracy.py`` (the reference's
``scripts/compute_accuracy.py:5-41``) on ``vaq_tpu_torch.io.read_ivecs``
and ``vaq_tpu_torch.metrics``: the same flags and the same three printed
lines, byte for byte. It runs on the host only; the groundtruth is an
``.ivecs`` file or a CSV of ids, one query a line.
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from vaq_tpu_torch import io, metrics  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("answers", help="CSV answers, one query per line")
    p.add_argument("groundtruth", help="groundtruth (.ivecs or CSV)")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--gt-offset", type=int, default=0,
                   help="subtract from groundtruth ids (1-based files)")
    args = p.parse_args(argv)

    pred = np.loadtxt(args.answers, delimiter=",", dtype=np.int64, ndmin=2)
    if args.groundtruth.endswith(".ivecs"):
        gt = io.read_ivecs(args.groundtruth)
    else:
        gt = np.loadtxt(args.groundtruth, delimiter=",", dtype=np.int64,
                        ndmin=2)

    k = min(args.k, pred.shape[1], gt.shape[1])
    print(f"avg_recall: {metrics.avg_recall(pred, gt, k, args.gt_offset):.6f}")
    print(f"recall@R:   {metrics.recall_at_r(pred, gt, k, args.gt_offset):.6f}")
    print(f"MAP:        "
          f"{metrics.mean_average_precision(pred, gt, k, args.gt_offset):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
