"""The port's ``demo_vaq`` CLI (vaq_tpu_torch/cli/demo_vaq.py) against the
JAX package's (vaq_tpu/cli/demo_vaq.py), both on the CPU
(``VAQ_TPU_PLATFORM=cpu``), flag for flag on the same synthetic data.

Each package trains its own index, so the recall lines agree within 0.05
(the training tolerance of tests/test_torch_kmeans_wide.py), with the flat
and the hierarchical k-means (``--kmeans-ver 0/1``) over 9- and 10-bit
subspaces. What one package's ``--save`` writes, the other's demo loads
(its "Reading saved index" path) and searches to the same recall, and both
``--result`` files parse alike.
"""

import re

import numpy as np
import pytest
import torch

import vaq_tpu
from vaq_tpu.cli import demo_vaq as jdemo
from vaq_tpu_torch.cli import demo_vaq, platform_device
from vaq_tpu_torch.errors import ConfigError, DeviceError

torch.set_num_threads(2)  # six test workers share the host

FLAGS = ["--synthetic", "3000", "--timeseries-size", "32", "--queries-size",
         "20", "--k", "10", "--method", "VAQ72m8min8max10var1,HEAP",
         "--refine", "0,20"]
METRICS = ("precision(avg_recall)", "recall@R", "MAP")


def run(main, argv, capsys):
    """(exit code, {metric: [value per --refine]}, stdout) of one demo."""
    rc = main(argv)
    out = capsys.readouterr().out
    got = {m: [float(v) for v in
               re.findall(rf"\t{re.escape(m)}: ([0-9.]+)", out)]
           for m in METRICS}
    return rc, got, out


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv("VAQ_TPU_PLATFORM", "cpu")


@pytest.mark.parametrize("kmeans_ver", ["0", "1"])
def test_demo_vaq_matches_jax(cpu_env, capsys, tmp_path, kmeans_ver):
    argv = FLAGS + ["--kmeans-ver", kmeans_ver]
    saves = {t: str(tmp_path / f"{t}.npz") for t in ("port", "jax")}
    results = {t: str(tmp_path / f"{t}.csv") for t in ("port", "jax")}
    rc_t, got_t, out_t = run(demo_vaq.main, argv + [
        "--save", saves["port"], "--result", results["port"]], capsys)
    rc_j, got_j, out_j = run(jdemo.main, argv + [
        "--save", saves["jax"], "--result", results["jax"]], capsys)
    assert rc_t == rc_j == 0
    # the same lines, in the same order, up to the numbers and file names
    # in them (the timing lines, "== ...", print what each package times)
    def lines(out, tag):
        out = out.replace(saves[tag], "SAVE").replace(results[tag], "RESULT")
        return [re.sub(r"[0-9.]+", "#", s) for s in out.splitlines()
                if "==" not in s]

    assert lines(out_t, "port") == lines(out_j, "jax")
    assert "Saving index to" in out_t and "Writing knn results" in out_t
    for m in METRICS:
        assert len(got_t[m]) == 2, (m, out_t)
        np.testing.assert_allclose(got_t[m], got_j[m], atol=0.05)
    assert got_t["precision(avg_recall)"][1] >= 0.9   # refined 20 → 10

    # each demo loads the other's saved index
    _, cross_t, out = run(demo_vaq.main, argv + ["--save", saves["jax"]],
                          capsys)
    assert "Reading saved index" in out
    np.testing.assert_allclose(cross_t["precision(avg_recall)"],
                               got_j["precision(avg_recall)"], atol=0.05)
    _, cross_j, out = run(jdemo.main, argv + ["--save", saves["port"]],
                          capsys)
    assert "Reading saved index" in out
    np.testing.assert_allclose(cross_j["precision(avg_recall)"],
                               got_t["precision(avg_recall)"], atol=0.05)
    back = vaq_tpu.VAQIndex.load(saves["port"])
    assert int(back.bits.max()) == 10

    for r in ("_R0", "_R20"):
        lab_t = np.loadtxt(results["port"] + r, delimiter=",", dtype=np.int64)
        lab_j = np.loadtxt(results["jax"] + r, delimiter=",", dtype=np.int64)
        assert lab_t.shape == lab_j.shape == (20, 10)
        # write_knn_results puts the distances beside: port_dists.csv_R20
        dist_t = np.loadtxt(results["port"].replace(".csv", "_dists.csv") + r,
                            delimiter=",")
        assert dist_t.shape == (20, 10) and np.isfinite(dist_t).all()


def test_demo_vaq_reads_files(cpu_env, capsys, tmp_path):
    """--dataset/--queries/--groundtruth from fvecs and ivecs files, as the
    reference's siftsmall invocation reads them."""
    from vaq_tpu_torch import io
    from vaq_tpu_torch.data import make_sift_like
    base, queries, gt = make_sift_like(n=2000, n_queries=10, d=32,
                                       device="cpu")
    paths = {n: str(tmp_path / f"{n}.{ext}") for n, ext in
             (("base", "fvecs"), ("q", "fvecs"), ("gt", "ivecs"))}
    io.write_fvecs(paths["base"], base)
    io.write_fvecs(paths["q"], queries)
    io.write_ivecs(paths["gt"], gt)
    rc, got, out = run(demo_vaq.main, [
        "--dataset", paths["base"], "--queries", paths["q"],
        "--groundtruth", paths["gt"], "--groundtruth-format", "ivecs",
        "--timeseries-size", "32", "--k", "10",
        "--method", "VAQ64m8min6max8var1,HEAP", "--backend", "codes"],
        capsys)
    assert rc == 0 and "Read groundtruth" in out
    assert got["precision(avg_recall)"][0] >= 0.5
    assert demo_vaq.main(["--dataset", str(tmp_path / "none.fvecs"),
                          "--queries", paths["q"]]) == 1


def test_platform_env(monkeypatch):
    """VAQ_TPU_PLATFORM picks the device where the JAX demos pick their
    platform: unset or cuda → the card (DeviceError without one), cpu → the
    CPU, anything else → ConfigError."""
    monkeypatch.delenv("VAQ_TPU_PLATFORM", raising=False)
    assert platform_device() == "cuda"
    monkeypatch.setenv("VAQ_TPU_PLATFORM", "cpu")
    assert platform_device() == "cpu"
    monkeypatch.setenv("VAQ_TPU_PLATFORM", "tpu")
    with pytest.raises(ConfigError, match="VAQ_TPU_PLATFORM"):
        demo_vaq.main(FLAGS)
    if not torch.cuda.is_available():
        monkeypatch.setenv("VAQ_TPU_PLATFORM", "cuda")
        with pytest.raises(DeviceError):
            demo_vaq.main(FLAGS)


def test_parser_has_every_jax_flag():
    def flags(parser):
        return sorted(o for a in parser._actions for o in a.option_strings)

    assert flags(demo_vaq.build_parser()) == flags(jdemo.build_parser())
