"""``scripts/oracle_bisect_torch.py`` against the stages of
``scripts/oracle_bisect.py`` on the CPU. On one JAX index (1000 × 32,
``VAQ64m8min4max8var1,HEAP``) converted to the port, the port's stages B
(exact top-k), C (f32 LUT gather) and D (the f64 host scan over the
engine's codes) must read JAX's own stage calls' recalls, E (the numpy
oracle) must be identical, and A must equal B (the port has no approximate
top-k). Then ``main`` once at a tiny size with ``--device cpu``."""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu
from test_torch_compute_accuracy import load_script
from test_torch_vaq import jax_state
from vaq_tpu import metrics as jmetrics
from vaq_tpu.data import make_anisotropic_gaussian
from vaq_tpu.io import pad_dims
from vaq_tpu.ops import scan_jax
from vaq_tpu.ops.distances import exact_search as jexact_search
from vaq_tpu_torch.convert import index_from_numpy

torch.set_num_threads(2)  # six test workers share the host

ROOT = Path(__file__).resolve().parent.parent
METHOD = "VAQ64m8min4max8var1,HEAP"
K = 10


def jax_stages(eng, base, queries, gt):
    """oracle_bisect.py:89-135's stages B-E (A ≡ B on the CPU) on ``eng``,
    unrounded."""
    cfg = eng.config
    _, l_b = eng.search_device(jnp.asarray(queries), K, exact=True)
    _, l_c = eng.search(queries, K, backend="lut_gather")
    sys.path.insert(0, str(ROOT / "tests"))
    from oracle_ref import OracleVAQ
    base_p = pad_dims(np.asarray(base, np.float32), cfg.subspace_num)
    q_p = pad_dims(np.asarray(queries, np.float32), cfg.subspace_num)
    o = OracleVAQ(cfg.bit_budget, cfg.subspace_num, cfg.min_bits,
                  cfg.max_bits, var=cfg.percent_var_explained, seed=cfg.seed)
    o.train(base_p).encode(base_p)
    _, olab = o.search(q_p, K)
    qp_eng = np.asarray(queries, np.float32) @ eng.eigvecs[:, :eng.total_dim]
    luts = np.asarray(scan_jax.build_luts(jnp.asarray(qp_eng),
                                          jnp.asarray(eng.centroids)))
    codes_rm = eng.codes_rowmajor().astype(np.int64)
    dists = np.zeros((len(queries), eng.n_rows), dtype=np.float64)
    for s in range(codes_rm.shape[1]):
        dists += luts[:, s, :][:, codes_rm[:, s]]
    l_d = np.argsort(dists, axis=1, kind="stable")[:, :K]
    rec = {name: round(jmetrics.avg_recall(np.asarray(lab), gt, K), 4)
           for name, lab in (("B_engine_exact_topk", l_b),
                             ("C_engine_f32_adc", l_c),
                             ("D_oracle_scan_engine_codes", l_d),
                             ("E_oracle_e2e", olab))}
    return rec, o


@pytest.fixture(scope="module")
def case():
    base, queries = make_anisotropic_gaussian(1000, 32, 32, seed=42)
    _, gt = jexact_search(jnp.asarray(queries), jnp.asarray(base), K)
    eng = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(METHOD))
    eng.train(base).encode(base)
    return base, queries, np.asarray(gt), eng


def test_stages_match_jax(case):
    base, queries, gt, eng = case
    ob = load_script("oracle_bisect_torch")
    got = ob.bisect(index_from_numpy(*jax_state(eng), "cpu"), base, queries,
                    gt, K)
    want, o = jax_stages(eng, base, queries, gt)
    for field, value in want.items():
        assert got[field] == value, (field, got, want)
    assert got["A_engine_default"] == got["B_engine_exact_topk"]
    assert got["share_approx"] == 0.0
    assert got["share_training"] == round(
        want["E_oracle_e2e"] - want["D_oracle_scan_engine_codes"], 4)
    assert got["engine_bits"] == np.asarray(eng.bits).tolist()
    assert got["oracle_bits"] == np.asarray(o.bits).tolist()
    assert got["engine_train_mse"] > 0 and got["oracle_train_mse"] > 0


def test_no_oracle_leaves_e_out(case):
    base, queries, gt, eng = case
    ob = load_script("oracle_bisect_torch")
    got = ob.bisect(index_from_numpy(*jax_state(eng), "cpu"), base, queries,
                    gt, K, oracle=False)
    assert got["E_oracle_e2e"] is None and got["delta_total"] is None
    assert got["share_training"] is None and got["oracle_bits"] is None
    assert got["C_engine_f32_adc"] >= got["B_engine_exact_topk"] - 0.01
    assert abs(got["D_oracle_scan_engine_codes"]
               - got["C_engine_f32_adc"]) <= 0.002


def test_main_on_the_cpu(tmp_path, capsys):
    ob = load_script("oracle_bisect_torch")
    out = tmp_path / "bisect.json"
    assert ob.main(["--device", "cpu", "--n", "600", "--d", "32",
                    "--queries", "16", "--config",
                    "VAQ32m8min2max6var1,HEAP", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["platform"] == "cpu" and rec["n"] == 600
    assert rec["device"] == "cpu" and rec["config"] == \
        "VAQ32m8min2max6var1,HEAP"
    for field in ("A_engine_default", "B_engine_exact_topk",
                  "C_engine_f32_adc", "D_oracle_scan_engine_codes",
                  "E_oracle_e2e"):
        assert 0.0 < rec[field] <= 1.0, field
