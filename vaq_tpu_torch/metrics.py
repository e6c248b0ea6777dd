"""Quality metrics: average recall, recall@R, mean average precision.

The counterpart of ``vaq_tpu/metrics.py`` (ports of the reference harness,
``bitvecengine/utils/Experiment.hpp:234-369``, semantics kept bit for bit):

* ``avg_recall``      per query |predicted ∩ groundtruth[:k]| / k, averaged;
* ``recall_at_r``     fraction of queries whose true NN (groundtruth[0]) is
  among the first R predictions;
* ``mean_average_precision``  AP(q) = (1/K) Σ_{r=1..K} [pred[r-1] ∈ gt[:K]]
  · |pred[:r] ∩ gt[:r]| / r.

Inputs are (nq, k) prediction and (nq, ≥k) groundtruth label matrices (host
arrays, as ``VAQIndex.search`` returns them). ``gt_offset`` subtracts a
constant from groundtruth ids (1-based groundtruth files).
"""

from __future__ import annotations

import numpy as np


def _prep(pred, gt, gt_offset: int):
    pred = np.asarray(pred)
    gt = np.asarray(gt) - gt_offset
    if pred.ndim != 2 or gt.ndim != 2:
        raise ValueError("pred and gt must be (nq, k) matrices")
    if pred.shape[0] != gt.shape[0]:
        raise ValueError("pred and gt disagree on query count")
    return pred, gt


def avg_recall(pred, gt, k: int, gt_offset: int = 0) -> float:
    pred, gt = _prep(pred, gt, gt_offset)
    gt_k = gt[:, :k]
    member = (pred[:, :, None] == gt_k[:, None, :]).any(axis=2)
    return float(member.sum(axis=1).mean() / k)


def recall_at_r(pred, gt, r: int | None = None, gt_offset: int = 0) -> float:
    pred, gt = _prep(pred, gt, gt_offset)
    if r is None:
        r = pred.shape[1]
    true_nn = gt[:, 0]
    hit = (pred[:, :r] == true_nn[:, None]).any(axis=1)
    return float(hit.mean())


def mean_average_precision(pred, gt, k: int, gt_offset: int = 0) -> float:
    pred, gt = _prep(pred, gt, gt_offset)
    nq = pred.shape[0]
    pred = pred[:, :k]
    gt_k = gt[:, :k]
    rel = (pred[:, :, None] == gt_k[:, None, :]).any(axis=2)
    ap = np.zeros(nq, dtype=np.float64)
    for r in range(1, k + 1):
        inter = (pred[:, :r, None] == gt_k[:, None, :r]).any(axis=2).sum(axis=1)
        ap += rel[:, r - 1] * (inter / r)
    return float((ap / k).mean())
