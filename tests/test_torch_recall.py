"""Port parity of a whole build: a vaq_tpu_torch index trained, encoded,
searched and refined by the port on the sift_like fixture reaches the recall
of a vaq_tpu index built from the same data.

Training differs from the JAX package's in the last bits (f32 sums in other
orders, see tests/test_torch_train.py), so the two indexes are held to their
recall, not their bits: within 0.5 point, ADC and refined.
"""

import numpy as np
import torch

import vaq_tpu
import vaq_tpu_torch
from vaq_tpu_torch import metrics

torch.set_num_threads(2)  # six test workers share the host


def test_port_trained_recall_matches_jax(sift_like):
    """Train + encode + search + refine in each package on the sift_like
    fixture: recall within 0.5 point (training drifts in the last bits)."""
    base, queries, gt = sift_like
    cfg = vaq_tpu.parse_method_string("VAQ256m32min7max8var1,HEAP")
    jidx = vaq_tpu.VAQIndex(cfg).train(base).encode(base)
    tidx = vaq_tpu_torch.VAQIndex(
        vaq_tpu_torch.parse_method_string("VAQ256m32min7max8var1,HEAP"))
    tidx.train(base).encode(base)
    np.testing.assert_array_equal(tidx.bits, jidx.bits)
    r = {}
    for name, idx in (("jax", jidx), ("port", tidx)):
        _, lab = idx.search(queries, 100)
        _, cand = idx.search(queries, 200)
        _, ref = idx.refine(queries, cand, base, 100)
        r[name] = (metrics.avg_recall(lab, gt, 100),
                   metrics.avg_recall(ref, gt, 100))
    assert abs(r["port"][0] - r["jax"][0]) <= 0.005, r
    assert abs(r["port"][1] - r["jax"][1]) <= 0.005, r
    assert r["port"][0] >= 0.8 and r["port"][1] >= 0.95, r
