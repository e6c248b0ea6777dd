"""Quality metrics: recall, mean average precision, kNN accuracy, clustering.

The counterpart of ``vaq_tpu/metrics.py`` (ports of the reference harness,
``bitvecengine/utils/Experiment.hpp:234-369``, semantics kept bit for bit):

* ``avg_recall``      per query |predicted ∩ groundtruth[:k]| / k, averaged;
* ``recall_at_r``     fraction of queries whose true NN (groundtruth[0]) is
  among the first R predictions;
* ``mean_average_precision``  AP(q) = (1/K) Σ_{r=1..K} [pred[r-1] ∈ gt[:K]]
  · |pred[:r] ∩ gt[:r]| / r;
* ``knn_classification_accuracy``, ``cluster_index`` and
  ``silhouette_score`` (vaq_tpu/metrics.py:70-114), the classification and
  clustering reports of the demos.

The recall metrics take (nq, k) prediction and (nq, ≥k) groundtruth label
matrices (host arrays, as ``VAQIndex.search`` returns them). Every function
is host numpy, as in JAX. ``gt_offset`` subtracts a
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


def knn_classification_accuracy(pred_labels, query_classes, db_classes) -> float:
    """kNN majority-vote accuracy (demo_bitvecengine.cpp:358-379): the vote
    goes to the most frequent class among a query's k labels, the lowest
    class on a tie (``np.unique`` sorts, ``argmax`` takes the first)."""
    pred_labels = np.asarray(pred_labels)
    query_classes = np.asarray(query_classes)
    db_classes = np.asarray(db_classes)
    votes = db_classes[pred_labels]  # (nq, k)
    correct = 0
    for i in range(votes.shape[0]):
        vals, counts = np.unique(votes[i], return_counts=True)
        if vals[np.argmax(counts)] == query_classes[i]:
            correct += 1
    return correct / votes.shape[0]


def cluster_index(assignments, X, centroids) -> float:
    """Mean within-cluster squared distance ("cluster index",
    Experiment.hpp:372-392), in f64 on the host."""
    X = np.asarray(X, dtype=np.float64)
    centroids = np.asarray(centroids, dtype=np.float64)
    assignments = np.asarray(assignments)
    diffs = X - centroids[assignments]
    return float(np.mean(np.sum(diffs * diffs, axis=1)))


def silhouette_score(X, assignments, centroids) -> float:
    """Simplified (centroid-based) silhouette, the clustering report of
    demo_cluster.cpp:18-60: per row, a = distance to its own centroid, b =
    to the nearest other one, s = (b − a) / max(a, b) (0 where both are 0),
    averaged; f64 on the host."""
    X = np.asarray(X, dtype=np.float64)
    centroids = np.asarray(centroids, dtype=np.float64)
    assignments = np.asarray(assignments)
    d = np.sqrt(
        np.maximum(
            (X * X).sum(1)[:, None]
            - 2 * X @ centroids.T
            + (centroids * centroids).sum(1)[None, :],
            0,
        )
    )
    a = d[np.arange(len(X)), assignments]
    d_masked = d.copy()
    d_masked[np.arange(len(X)), assignments] = np.inf
    b = d_masked.min(axis=1)
    denom = np.maximum(a, b)
    s = np.where(denom > 0, (b - a) / denom, 0.0)
    return float(s.mean())
