"""The port's clustering and classification metrics
(``vaq_tpu_torch/metrics.py``: ``knn_classification_accuracy``,
``cluster_index``, ``silhouette_score``) against ``vaq_tpu/metrics.py`` on
the same seeded inputs: host numpy in both packages, so the values are
equal exactly."""

import numpy as np
import pytest

from vaq_tpu import metrics as jmetrics
from vaq_tpu_torch import metrics


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,classes", [(1, 3), (4, 2), (10, 5)])
def test_knn_classification_accuracy_equals_jax(seed, k, classes):
    rng = np.random.default_rng(seed)
    db_classes = rng.integers(0, classes, 500)
    query_classes = rng.integers(0, classes, 60)
    pred = rng.integers(0, 500, (60, k))
    got = metrics.knn_classification_accuracy(pred, query_classes, db_classes)
    assert got == jmetrics.knn_classification_accuracy(
        pred, query_classes, db_classes)
    assert 0.0 <= got <= 1.0


def test_knn_vote_ties_go_to_the_lowest_class():
    """A query whose k labels split evenly between two classes votes for
    the lower one, in both packages."""
    db_classes = np.array([0, 1, 2, 3, 0, 1, 2, 3])
    pred = np.array([[3, 1, 7, 5],      # classes 3, 1, 3, 1: a tie → 1
                     [0, 2, 4, 6],      # 0, 2, 0, 2 → 0
                     [1, 2, 3, 5]])     # 1, 2, 3, 1 → 1
    for want, truth in ((1.0, [1, 0, 1]), (0.0, [3, 2, 2]),
                        (2 / 3, [1, 2, 1])):
        got = metrics.knn_classification_accuracy(pred, truth, db_classes)
        assert got == jmetrics.knn_classification_accuracy(
            pred, truth, db_classes) == pytest.approx(want)


def clustering(seed, n=400, d=12, k=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cents = rng.standard_normal((k, d)).astype(np.float32)
    assign = np.argmin(((x[:, None] - cents[None]) ** 2).sum(2), axis=1)
    return x, assign, cents


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cluster_index_equals_jax(seed):
    x, assign, cents = clustering(seed)
    got = metrics.cluster_index(assign, x, cents)
    assert got == jmetrics.cluster_index(assign, x, cents)
    want = np.mean([((x[i].astype(np.float64) - cents[a]) ** 2).sum()
                    for i, a in enumerate(assign)])
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_silhouette_score_equals_jax(seed):
    x, assign, cents = clustering(seed)
    got = metrics.silhouette_score(x, assign, cents)
    assert got == jmetrics.silhouette_score(x, assign, cents)
    assert -1.0 <= got <= 1.0


def test_one_member_cluster_and_a_row_on_its_centroid():
    """A cluster of one row that sits on its centroid (a = b = 0 is not
    reached: b > 0, so s = 1 there), and an empty cluster, whose centroid
    still counts for b."""
    x, assign, cents = clustering(5, n=50, k=4)
    cents = np.concatenate([cents, x[7:8], np.full((1, x.shape[1]), 9.0,
                                                   np.float32)])
    assign = assign.copy()
    assign[7] = 4                       # the only member of cluster 4
    assert (assign == 4).sum() == 1 and (assign == 5).sum() == 0
    for fn, args in ((metrics.cluster_index, (assign, x, cents)),
                     (metrics.silhouette_score, (x, assign, cents))):
        jfn = getattr(jmetrics, fn.__name__)
        assert fn(*args) == jfn(*args)
    # every row in one cluster: b is the other centroid's distance
    ones = np.zeros(50, dtype=np.int64)
    assert metrics.silhouette_score(x, ones, cents[:2]) == \
        jmetrics.silhouette_score(x, ones, cents[:2])
