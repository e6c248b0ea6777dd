"""``scripts/widebits_1m_torch.py`` on the CPU: its u16 gate on a converted
JAX wide-bits index must give the ids and the overlap of JAX's own gate
(``scripts/widebits_1m.py:93-112``: ``scan_jax.adc_scan_topk`` over the
codes against ``scan_decoded.decoded_scan_topk(exact=True)``), and its
``run`` at a small size must give JAX's record fields. JAX's hierarchical
training stays at 300 rows (tests/test_torch_kmeans_wide.py); the index
encodes 2000."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu
from test_torch_compute_accuracy import load_script
from test_torch_vaq import jax_state
from vaq_tpu import pca as jpca
from vaq_tpu.data import make_anisotropic_gaussian
from vaq_tpu.ops import scan_decoded as jscan_decoded
from vaq_tpu.ops import scan_jax
from vaq_tpu_torch.convert import index_from_numpy
from vaq_tpu_torch.ops.distances import exact_search

torch.set_num_threads(2)  # six test workers share the host

METHOD = "VAQ38m4min8max10var1,HEAP"   # 9- and 10-bit subspaces at d = 16
K = 10


@pytest.fixture(scope="module")
def wide():
    """(base, queries, JAX hierarchical wide-bits index trained on 300 rows
    and encoding 2000)."""
    base, queries = make_anisotropic_gaussian(2000, 16, 24, seed=6)
    cfg = dataclasses.replace(vaq_tpu.parse_method_string(METHOD),
                              hierarchical_kmeans=True, kmeans_iters=10)
    jidx = vaq_tpu.VAQIndex(cfg).train(base[:300]).encode(base)
    assert int(jidx.bits.max()) > 8 and jidx.codes.dtype == jnp.uint16
    return base, queries, jidx


def jax_gate(jidx, queries, ns, nq):
    """widebits_1m.py:95-111 on the first ``ns`` rows and ``nq`` queries."""
    qp = jpca.project(jnp.asarray(queries[:nq]), jidx.eigvecs,
                      jidx.total_dim)
    luts = scan_jax.build_luts(qp, jnp.asarray(jidx.centroids))
    _, l_l = scan_jax.adc_scan_topk(jnp.asarray(jidx.codes[:, :ns]).T, luts,
                                    K)
    jidx._ensure_decoded()
    _, l_d = jscan_decoded.decoded_scan_topk(
        jidx.decoded[:ns], jidx.decoded_norms[:ns], qp, K, exact=True)
    l_l, l_d = np.asarray(l_l), np.asarray(l_d)
    agree = np.mean([len(set(l_l[i]) & set(l_d[i])) / K
                     for i in range(l_l.shape[0])])
    return float(agree), l_l, l_d


@pytest.mark.parametrize("ns,nq", [(2000, 24), (1500, 16)])
def test_gate_matches_jax(wide, ns, nq):
    _, queries, jidx = wide
    gate = load_script("widebits_1m_torch").u16_gate
    tidx = index_from_numpy(*jax_state(jidx), "cpu")
    got = gate(tidx, queries, K, n_rows=ns, n_queries=nq)
    want = jax_gate(jidx, queries, ns, nq)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0] == want[0]
    assert got[1].shape == (nq, K) and (got[1] < ns).all()


def test_run_gives_jax_fields(wide):
    """``run`` end to end on the port (hierarchical training on the CPU),
    with every field of JAX's record."""
    base, queries, _ = wide
    wb = load_script("widebits_1m_torch")
    gt = exact_search(torch.as_tensor(queries), torch.as_tensor(base),
                      100)[1].numpy()
    out, idx = wb.run(base, queries, gt, k=K, iters=2, config=METHOD,
                      device="cpu")
    jax_fields = {"metric", "value", "unit", "vs_baseline", "config",
                  "hierarchical_kmeans", "n", "build_s", "bits_max", "bits",
                  "codes_dtype", "widebits_qps", "batch_ms",
                  "widebits_recall_at_k", "recall_at_100",
                  "recall_at_10_refined", "u16_gate_overlap"}
    assert jax_fields <= set(out)
    assert out["codes_dtype"] == "uint16" and out["bits_max"] == 10
    assert idx.codes.dtype == torch.int32
    assert out["n"] == 2000 and out["u16_gate_rows"] == 2000
    assert out["value"] > 0 and out["u16_gate_overlap"] >= 0.9
    assert out["recall_at_10_refined"] >= out["widebits_recall_at_k"]
