"""``scripts/check_sharded_100k_torch.py`` against the steps of
``scripts/check_sharded_100k.py`` on the CPU, at the fixture's 4000 × 128
rows with a small TI config (``VAQ128m16min7max8var1,TI32m16``) at visit
1.0. JAX follows its script through ``vaq_tpu``'s API on the 8 virtual CPU
devices; the port's ``sharded_check`` runs on the converted JAX index and a
mesh of the CPU repeated 8 times. Both recalls must equal JAX's to 1e-6,
``delta`` and ``top1_agreement`` JAX's exactly, and qcap must drop no
(query, cluster) entry on either side."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu
from test_torch_compute_accuracy import load_script
from test_torch_ivf import converted
from vaq_tpu import ivf as jivf
from vaq_tpu import metrics as jmetrics
from vaq_tpu import parallel as jpar
from vaq_tpu.ops.distances import exact_search as jexact_search
from vaq_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)  # six test workers share the host

METHOD = "VAQ128m16min7max8var1,TI32m16"
K = 10


@pytest.fixture(scope="module")
def case(sift_like):
    """(queries, groundtruth@K, JAX index with its probe state at visit
    1.0 and its decoded tier resident, as the script leaves it)."""
    base, queries, _ = sift_like
    _, gt = jexact_search(jnp.asarray(queries), jnp.asarray(base), K)
    jidx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(METHOD))
    jidx.train(base).encode(base)
    jivf.attach_ivf(jidx, visit=1.0)
    return queries, np.asarray(gt), jidx


def jax_record(jidx0, queries, gt):
    """check_sharded_100k.py:52-65 on ``jidx0``'s copy."""
    jidx = copy.copy(jidx0)      # shard() sets the copy's mesh fields only
    _, l_ref = jidx.search(queries, K)
    r_ref = jmetrics.avg_recall(l_ref, gt, K)
    jidx.shard(jpar.make_mesh((8,), ("db",)), tiers=("decoded", "ivf"))
    assert jidx._sharded_ivf.rescore_rows is not None
    _, l_sh = jidx.search(queries, K)
    r_sh = jmetrics.avg_recall(l_sh, gt, K)
    agree = float(np.mean(l_sh[:, 0] == l_ref[:, 0]))
    return {"unsharded_recall": round(float(r_ref), 4),
            "sharded_recall": round(float(r_sh), 4),
            "delta": round(float(r_sh - r_ref), 4),
            "top1_agreement": round(agree, 4)}


def test_sharded_check_matches_jax(case):
    queries, gt, jidx = case
    want = jax_record(jidx, queries, gt)
    check = load_script("check_sharded_100k_torch")
    got = check.sharded_check(converted(jidx), queries, gt, K,
                              make_mesh(devices=["cpu"] * 8))
    for field in ("unsharded_recall", "sharded_recall"):
        assert abs(got[field] - want[field]) <= 1e-6, (field, got, want)
    assert got["delta"] == want["delta"]
    assert got["top1_agreement"] == want["top1_agreement"]
    assert got["recalls_agree"] and got["devices"] == 8
    assert got["n"] == jidx.n_rows and got["nq"] == len(queries)
    # at visit 1.0 every shard probes all its clusters for every query,
    # and qcap = nq (≤ 256 queries): nothing can drop
    assert got["sharded_p_visit_p_max_qcap_gs"][:3] == \
        [got["clusters_per_shard"]] * 2 + [len(queries)]
    assert got["unsharded_dropped_entries"] == 0
    assert got["sharded_dropped_entries"] == 0
