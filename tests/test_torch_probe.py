"""Port parity: the cluster-probe dispatch of vaq_tpu_torch (ops/probe.py)
against vaq_tpu's on the same seeded numpy inputs (CPU).

Integer results (probe lists, activity masks, the dispatch table and its
entry coordinates, qcap) must be equal; the cluster distances, f32 sums
taken in another order, agree to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaq_tpu.ops import probe as jprobe
from vaq_tpu_torch.ops import probe

torch.set_num_threads(2)  # six test workers share the host


def _dists(nq, ncl, seed):
    """Distances with no ties (distinct random values)."""
    rng = np.random.default_rng(seed)
    return (rng.random((nq, ncl)) * 100).astype(np.float32)


@pytest.mark.parametrize("nq,ncl,s", [(9, 32, 16), (64, 100, 64), (5, 7, 3)])
def test_cluster_sq_dists_matches_jax(nq, ncl, s):
    rng = np.random.default_rng(nq)
    q = rng.standard_normal((nq, s)).astype(np.float32)
    c = rng.standard_normal((ncl, s)).astype(np.float32)
    got = probe.cluster_sq_dists(torch.as_tensor(q), torch.as_tensor(c))
    ref = jprobe.cluster_sq_dists(jnp.asarray(q), jnp.asarray(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k,p_visit,p_max", [(10, 1, 8), (50, 2, 12),
                                             (1, 5, 5), (400, 3, 32)])
def test_dynamic_probe_matches_jax(k, p_visit, p_max):
    cd = _dists(24, 32, seed=k)
    sizes = np.random.default_rng(1).integers(0, 40, 32).astype(np.int32)
    pj, aj = jprobe.dynamic_probe(jnp.asarray(cd), jnp.asarray(sizes), k,
                                  p_visit, p_max)
    pt, at = probe.dynamic_probe(torch.as_tensor(cd), torch.as_tensor(sizes),
                                 k, p_visit, p_max)
    assert pt.dtype == torch.int32 and at.dtype == torch.bool
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_dynamic_probe_ties_go_to_the_lower_cluster():
    cd = np.array([[3.0, 1.0, 1.0, 0.5, 1.0]], np.float32)
    sizes = np.full(5, 10, np.int32)
    pj, _ = jprobe.dynamic_probe(jnp.asarray(cd), jnp.asarray(sizes), 5, 4, 4)
    pt, _ = probe.dynamic_probe(torch.as_tensor(cd), torch.as_tensor(sizes),
                                5, 4, 4)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert pt.tolist() == [[3, 1, 2, 4]]


@pytest.mark.parametrize("nq,ncl,p_max,qcap", [
    (24, 32, 8, 24),     # strict capacity: nothing drops
    (64, 16, 6, 8),      # tight capacity: entries drop
    (40, 10, 10, 40),    # every query probes every cluster
    (3, 50, 2, 1),
])
def test_dispatch_table_matches_jax(nq, ncl, p_max, qcap):
    cd = _dists(nq, ncl, seed=nq + ncl)
    sizes = np.random.default_rng(2).integers(1, 30, ncl).astype(np.int32)
    pj, aj = jprobe.dynamic_probe(jnp.asarray(cd), jnp.asarray(sizes), 20, 2,
                                  p_max)
    ref = jprobe.dispatch_table(pj, aj, ncl, qcap)
    got = probe.dispatch_table(torch.as_tensor(np.asarray(pj)),
                               torch.as_tensor(np.asarray(aj)), ncl, qcap)
    for name, g, r in zip(("table", "ok", "ent_c", "ent_r"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


@pytest.mark.parametrize("nq,p_max,ncl", [(512, 100, 1000), (512, 1000, 1000),
                                          (300, 3, 32), (1000, 250, 1000),
                                          (257, 1, 4096)])
def test_pick_qcap_matches_jax(nq, p_max, ncl):
    assert probe.pick_qcap(nq, p_max, ncl) == jprobe.pick_qcap(nq, p_max, ncl)
