"""The port's ``demo_vaq`` CLI (vaq_tpu_torch/cli/demo_vaq.py) against the
JAX package's (vaq_tpu/cli/demo_vaq.py), both on the CPU
(``VAQ_TPU_PLATFORM=cpu``), flag for flag on the same synthetic data; then
``demo_binary`` and ``demo_bitvecengine`` likewise, and ``demo_cluster``,
``demo_boltcentroids`` and ``demo_vaq_paramsearch``. The binary engine
trains on the host in both packages, so their printed lines are equal
outright; the k-means of the clustering demos runs in each package's own
f32 order, so their numbers agree within a tolerance stated by each case.

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
from vaq_tpu.cli import demo_binary as jdemo_binary
from vaq_tpu.cli import demo_bitvecengine as jdemo_bve
from vaq_tpu.cli import demo_vaq as jdemo
from vaq_tpu.cli import demo_boltcentroids as jdemo_bolt
from vaq_tpu.cli import demo_cluster as jdemo_cluster
from vaq_tpu.cli import demo_vaq_paramsearch as jdemo_search
from vaq_tpu.cli import serve as jserve
from vaq_tpu_torch.cli import (demo_binary, demo_bitvecengine,
                               demo_boltcentroids, demo_cluster, demo_vaq,
                               demo_vaq_paramsearch, platform_device, serve)
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


BINARY_FLAGS = ["--synthetic", "4000", "--queries-size", "20", "--k", "10"]


def bare_lines(out):
    """The printed lines but the timing ones ("== ...")."""
    return [s for s in out.splitlines() if "==" not in s]


@pytest.mark.parametrize("extra", [[], ["--backend", "packed"],
                                   ["--rerank", "10"],
                                   ["--encoding", "simple", "--bit-budget",
                                    "64"]],
                         ids=["auto", "packed", "rerank", "simple"])
def test_demo_binary_matches_jax(cpu_env, capsys, tmp_path, extra):
    """The same lines, recall lines included, digit for digit; --save and
    --result written by the port and read back by JAX."""
    save, result = str(tmp_path / "b.npz"), str(tmp_path / "r.csv")
    rc_t, got_t, out_t = run(demo_binary.main, BINARY_FLAGS + extra + [
        "--save", save, "--result", result], capsys)
    rc_j, got_j, out_j = run(jdemo_binary.main, BINARY_FLAGS + extra, capsys)
    assert rc_t == rc_j == 0
    assert all(len(got_t[m]) == 1 for m in METRICS), out_t
    assert bare_lines(out_t) == bare_lines(out_j)
    rc, got, out = run(jdemo_binary.main, BINARY_FLAGS + extra + [
        "--save", save], capsys)                    # JAX loads the port's
    assert rc == 0 and bare_lines(out) == bare_lines(out_j)
    lab = np.loadtxt(result, delimiter=",", dtype=np.int64)
    assert lab.shape == (20, 10)


@pytest.mark.parametrize("mode,metric", [
    (0, "hamming"), (0, "jaccard"), (1, "hamming"), (2, "hamming"),
    (3, "hamming"), (4, "l2"), (4, "manhattan"), (5, "l2"), (6, "l2"),
    (7, "l2"), (8, "l2"), (9, "l2")])
def test_demo_bitvecengine_matches_jax(cpu_env, capsys, mode, metric):
    argv = BINARY_FLAGS + ["--mode", str(mode), "--metric", metric,
                           "--iteration", "2"]
    rc_t, got_t, out_t = run(demo_bitvecengine.main, argv, capsys)
    rc_j, got_j, out_j = run(jdemo_bve.main, argv, capsys)
    assert rc_t == rc_j == 0
    assert all(len(got_t[m]) == 1 for m in METRICS), out_t
    assert bare_lines(out_t) == bare_lines(out_j)
    if mode in (4, 5, 6, 7, 8, 9) and metric == "l2":  # exact: recall 1
        assert got_t["precision(avg_recall)"] == [1.0]


def test_demo_bitvecengine_writes_groundtruth(cpu_env, capsys, tmp_path):
    from vaq_tpu_torch import io as port_io
    path = str(tmp_path / "gt.ivecs")
    rc, got, out = run(demo_bitvecengine.main, BINARY_FLAGS + [
        "--write-groundtruth", path], capsys)
    assert rc == 0 and f"groundtruth written to {path}" in out
    assert port_io.read_ivecs(path).shape == (20, 10)


def test_binary_parsers_take_the_jax_flags():
    """Every flag JAX's binary and clustering demos define (read from their
    sources) the port's parsers define too."""
    import inspect
    for port, jax_mod in ((demo_binary, jdemo_binary),
                          (demo_bitvecengine, jdemo_bve),
                          (demo_cluster, jdemo_cluster),
                          (demo_boltcentroids, jdemo_bolt),
                          (demo_vaq_paramsearch, jdemo_search)):
        want = sorted(set(re.findall(r'add_argument\("(--[a-z-]+)"',
                                     inspect.getsource(jax_mod))))
        got = sorted(o for a in port.build_parser()._actions
                     for o in a.option_strings if o.startswith("--"))
        assert [f for f in got if f != "--help"] == want


def test_serve_parser_takes_the_jax_flags():
    """Every flag JAX's ``serve`` defines (read from its source), the port's
    parser defines too, with JAX's defaults."""
    import inspect
    src = inspect.getsource(jserve)
    want = sorted(set(re.findall(r'add_argument\("(--[a-z-]+)"', src)))
    parser = serve.build_parser()
    got = sorted(o for a in parser._actions for o in a.option_strings
                 if o.startswith("--"))
    assert [f for f in got if f != "--help"] == want
    assert vars(parser.parse_args([])) == {
        "index": "", "synthetic": 0, "dim": 128,
        "method": "VAQ256m32min7max8var1,HEAP", "host": "127.0.0.1",
        "port": 8080, "k": 10, "max_batch": 256, "max_wait_ms": 2.0,
        "backend": "decoded"}


def test_serve_answers_and_shuts_down(cpu_env, capsys):
    """``serve.main`` in a thread on port 0 with --synthetic: it warms the
    path, prints JAX's ``serving on http://...`` line, answers one /search
    as the index it built does, and returns 0 once stopped."""
    import json
    import threading
    import time
    import urllib.request

    stop = threading.Event()
    rc = []
    argv = ["--synthetic", "3000", "--dim", "32", "--method",
            "VAQ64m8min7max8var1,HEAP", "--port", "0", "--k", "5",
            "--max-batch", "8", "--backend", "codes"]
    th = threading.Thread(target=lambda: rc.append(serve.main(argv, stop)))
    th.start()
    out = ""
    try:
        deadline = time.monotonic() + 120
        while "serving on" not in out and time.monotonic() < deadline \
                and th.is_alive():
            time.sleep(0.1)
            out += capsys.readouterr().out
        url = re.search(r"serving on (http://\S+)", out).group(1)
        assert "(k=5, max_batch=8, backend=codes)" in out
        q = np.random.default_rng(0).standard_normal(32).astype(np.float32)
        req = urllib.request.Request(
            url + "/search", data=json.dumps({"query": q.tolist()}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        assert np.asarray(got["labels"]).shape == (1, 5)
        assert np.isfinite(np.asarray(got["distances"])).all()
    finally:
        stop.set()
        th.join(60)
    assert not th.is_alive() and rc == [0]


# --- demo_cluster, demo_boltcentroids, demo_vaq_paramsearch ----------------

SYNTH = ["--synthetic", "3000", "--timeseries-size", "32"]


def numbers_out(out):
    """The printed lines but the timing ones, numbers replaced by #."""
    return [re.sub(r"[0-9.]+", "#", s) for s in bare_lines(out)]


def reading(out, label):
    return float(re.search(rf"{label}: ([0-9.-]+)", out).group(1))


@pytest.mark.parametrize("version", ["simple", "fast", "kmeanspp"])
def test_demo_cluster_matches_jax(cpu_env, capsys, tmp_path, version):
    """The same lines up to their numbers; the cluster index within 1% and
    the silhouette within 0.02 of JAX's; --centroids-out readable by JAX's
    reader."""
    argv = SYNTH + ["--k", "100", "--iters", "25", "--silhouette",
                    "--version", version]
    path = str(tmp_path / "c.fvecs")
    rc_t, _, out_t = run(demo_cluster.main, argv + ["--centroids-out", path],
                         capsys)
    rc_j, _, out_j = run(jdemo_cluster.main, argv + ["--centroids-out", path],
                         capsys)
    assert rc_t == rc_j == 0
    assert numbers_out(out_t) == numbers_out(out_j)
    label = r"cluster index \(mean within-cluster sqdist\)"
    ci_t, ci_j = reading(out_t, label), reading(out_j, label)
    assert abs(ci_t - ci_j) <= 0.01 * ci_j, (ci_t, ci_j)
    assert abs(reading(out_t, "silhouette") -
               reading(out_j, "silhouette")) <= 0.02
    from vaq_tpu import io as jio
    assert jio.read_fvecs(path).shape == (100, 32)


def bolt_errors(path, subspaces, d=32):
    """Per subspace: the mean squared distance of the demo's rows to their
    nearest of the subspace's 16 centroids in the CSV."""
    from vaq_tpu_torch.data import make_anisotropic_gaussian
    x, _ = make_anisotropic_gaussian(3000, d, 1)
    cents = np.loadtxt(path, delimiter=",", dtype=np.float64)
    sub = d // subspaces
    out = []
    for s in range(subspaces):
        xs = x[:, s * sub:(s + 1) * sub].astype(np.float64)
        c = cents[16 * s:16 * (s + 1)]
        out.append(((xs[:, None] - c[None]) ** 2).sum(2).min(1).mean())
    return np.array(out), cents.shape


def test_demo_boltcentroids_matches_jax(cpu_env, capsys, tmp_path):
    """JAX's lines, a CSV of JAX's shape (16 lines of sub_len numbers per
    subspace), each subspace's within-cluster error within 1% of JAX's."""
    paths = {t: str(tmp_path / f"{t}.csv") for t in ("port", "jax")}
    argv = SYNTH + ["--subspace", "8"]
    rc_t, _, out_t = run(demo_boltcentroids.main,
                         argv + ["--save", paths["port"]], capsys)
    rc_j, _, out_j = run(jdemo_bolt.main, argv + ["--save", paths["jax"]],
                         capsys)
    assert rc_t == rc_j == 0
    assert numbers_out(out_t.replace(paths["port"], "P")) == \
        numbers_out(out_j.replace(paths["jax"], "P"))
    err_t, shape_t = bolt_errors(paths["port"], 8)
    err_j, shape_j = bolt_errors(paths["jax"], 8)
    assert shape_t == shape_j == (128, 4)
    np.testing.assert_allclose(err_t, err_j, rtol=0.01)


PARAMSEARCH = SYNTH + ["--queries-size", "20", "--k", "10", "--bit-budget",
                       "64", "--subspaces", "8,16", "--min-bits", "1,5",
                       "--max-bits", "8"]


def test_demo_vaq_paramsearch_matches_jax(cpu_env, capsys, tmp_path):
    """The same rows in the same order, the same combinations skipped
    (m=16 min=5: 16·5 > 64 bits) and none infeasible, recall within 0.05 of
    JAX's, as demo_vaq's cases allow."""
    paths = {t: str(tmp_path / f"{t}.csv") for t in ("port", "jax")}
    rc_t, _, out_t = run(demo_vaq_paramsearch.main,
                         PARAMSEARCH + ["--out", paths["port"]], capsys)
    rc_j, _, out_j = run(jdemo_search.main,
                         PARAMSEARCH + ["--out", paths["jax"]], capsys)
    assert rc_t == rc_j == 0
    rows = {t: np.loadtxt(p, delimiter=",", skiprows=1, ndmin=2)
            for t, p in paths.items()}
    assert rows["port"][:, :3].tolist() == rows["jax"][:, :3].tolist() == \
        [[8, 1, 8], [8, 5, 8], [16, 1, 8]]
    np.testing.assert_allclose(rows["port"][:, 3], rows["jax"][:, 3],
                               atol=0.05)
    assert (rows["port"][:, 4:] > 0).all()
    for out in (out_t, out_j):
        assert "infeasible" not in out
    heads = {t: [line.split(":")[0] for line in
                 out.replace(paths[t], "OUT").splitlines()]
             for t, out in (("port", out_t), ("jax", out_j))}
    assert heads["port"] == heads["jax"]
    with open(paths["port"]) as f:
        assert f.readline() == open(paths["jax"]).readline()


def test_demo_vaq_paramsearch_reports_infeasible_as_jax(cpu_env, capsys,
                                                        tmp_path, monkeypatch):
    """A training that raises ValueError prints JAX's "infeasible" line and
    the grid goes on; a combination outside the budget is skipped silently
    in both packages."""
    from vaq_tpu import vaq as jvaq
    from vaq_tpu_torch import vaq as tvaq
    for mod in (jvaq, tvaq):
        train = mod.VAQIndex.train

        def refuse(self, x, *a, _train=train, **kw):
            if self.config.min_bits == 5:
                raise ValueError("refused")
            return _train(self, x, *a, **kw)

        monkeypatch.setattr(mod.VAQIndex, "train", refuse)
    outs = []
    for main in (demo_vaq_paramsearch.main, jdemo_search.main):
        rc, _, out = run(main, PARAMSEARCH + ["--out",
                                              str(tmp_path / "o.csv")], capsys)
        assert rc == 0
        outs.append([s for s in out.splitlines() if "infeasible" in s])
    assert outs[0] == outs[1] == ["m=8 min=5 max=8: infeasible (refused)"]


@pytest.mark.parametrize("demo,extra", [
    (demo_cluster, []), (demo_boltcentroids, ["--save", "x.csv"]),
    (demo_vaq_paramsearch, [])])
def test_clustering_demos_need_the_card_unless_told_cpu(monkeypatch, demo,
                                                        extra):
    monkeypatch.setenv("VAQ_TPU_PLATFORM", "tpu")
    with pytest.raises(ConfigError, match="VAQ_TPU_PLATFORM"):
        demo.main(SYNTH + extra)
    if not torch.cuda.is_available():
        monkeypatch.setenv("VAQ_TPU_PLATFORM", "cuda")
        with pytest.raises(DeviceError):
            demo.main(SYNTH + extra)
