"""Runs of a cell with the timed path changed underneath, for the control
and the fault tests; a normal run uses none of them.

* ``control``: the path one precision below the cell's, as its limits file
  names it: ``"control": {"traffic": {...}}`` overrides keys of the traffic
  mix (the program's own lower-precision backend); ``"answers":
  "reference_tf32"`` or ``"reference_fp8"`` puts the reference, computed at
  that precision, in the program's place (``check.numbers``).
* ``fault:half``: half of every batch (its odd rows) answered with the
  answers of the rows before them.
* ``fault:altered``: the first id of every answer moved to the next row.
* ``fault:untrained``: training leaves the rotation as it started (the
  identity) before the rows are encoded.
* ``fault:codebooks``: training leaves the codebooks as k-means starts them
  (distinct random training rows, no Lloyd iteration).
* ``fault:clusters``: the probe's clustering leaves its centroids as k-means
  starts them (random rows, no Lloyd iteration).
* ``fault:buckets``: each of the probe's buckets holds the rows of the next
  cluster's (the buckets moved on by one against their centroids).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def traffic_of(traffic: dict, limits: dict, variant) -> dict:
    if variant == "control":
        return {**traffic, **limits["control"].get("traffic", {})}
    return traffic


def after_train(idx, variant, train: torch.Tensor) -> None:
    if variant == "fault:untrained":
        idx.eigvecs = np.eye(idx.eigvecs.shape[0], dtype=np.float32)
        idx._ev_dev = None
    elif variant == "fault:codebooks":
        e = torch.as_tensor(idx.eigvecs[:, :idx.total_dim],
                            device=train.device)
        x = torch.nn.functional.pad(train, (0, e.shape[0] - train.shape[1]))
        gen = torch.Generator(device=train.device)
        gen.manual_seed(5)
        cents = idx.centroids.copy()
        sub = idx.subs_len
        for s, k in enumerate(idx.centroid_counts):
            pick = torch.randperm(x.shape[0], generator=gen,
                                  device=x.device)[:int(k)]
            cents[s, :int(k)] = (x[pick] @ e[:, s * sub:(s + 1) * sub]
                                 ).cpu().numpy()
        idx.centroids = cents


@contextlib.contextmanager
def building_probe(variant):
    """Around the probe's build: ``fault:clusters`` skips its Lloyd
    iterations."""
    if variant != "fault:clusters":
        yield
        return
    from vaq_tpu_torch import kmeans
    lloyd = kmeans.lloyd
    kmeans.lloyd = lambda x, c0, iters=25: c0
    try:
        yield
    finally:
        kmeans.lloyd = lloyd


def after_build(idx, variant) -> None:
    if variant in ("fault:half", "fault:altered"):
        _break_search(idx, variant.split(":")[1])
    elif variant == "fault:buckets":
        st = idx.ivf.state
        for t in (st.bucket_rows, st.bucket_ids, st.sizes):
            t.copy_(torch.roll(t, 1, dims=0))


def _copy(x):
    return x.clone() if torch.is_tensor(x) else x.copy()


def _half(d, i):
    d, i = _copy(d), _copy(i)
    h = d.shape[0] // 2
    d[1:2 * h:2], i[1:2 * h:2] = d[0:2 * h:2], i[0:2 * h:2]
    return d, i


def _altered(d, i, n):
    i = _copy(i)
    i[:, 0] = (i[:, 0] + 1) % n
    return d, i


def _break_search(idx, how: str) -> None:
    search, search_device = idx.search, idx.search_device

    def fix(d, i):
        return _half(d, i) if how == "half" else _altered(d, i, idx.n_rows)

    idx.search = lambda *a, **kw: fix(*search(*a, **kw))
    idx.search_device = lambda *a, **kw: fix(*search_device(*a, **kw))
