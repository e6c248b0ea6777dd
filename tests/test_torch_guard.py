"""Guards of the PyTorch port: it never imports jax or vaq_tpu (nor, for
bench_torch.py and the port's scripts, JAX's bench.py), it sets the
full-f32 precision policy at import, its entry points (the scripts' ``main``
included) run on the card unless asked for the CPU, and chip_smoke.py
refuses to run (and prints no result) without a CUDA card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "vaq_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "vaq_tpu", "bench")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def _python(code: str, cwd: Path = ROOT, env_extra=None):
    env = {**os.environ, "PYTHONPATH": str(ROOT), **(env_extra or {})}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def _port_scripts():
    """Every ``scripts/*.py`` of the port: each one that imports torch or
    vaq_tpu_torch."""
    return sorted(p for p in (ROOT / "scripts").glob("*.py")
                  if any(m.split(".")[0] in ("torch", "vaq_tpu_torch")
                         for m in _imports(p)))


PORT_SCRIPTS = ["capacity_100m_torch", "check_sharded_100k_torch",
                "compute_accuracy_torch", "fast4_breakdown",
                "fast4_tile_sweep", "k1_breakdown", "k5_breakdown",
                "oracle_bisect_torch", "rescore_breakdown", "search_qps",
                "widebits_1m_torch"]


def test_port_scripts_are_found_by_their_imports():
    assert [p.stem for p in _port_scripts()] == PORT_SCRIPTS


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py"] + _port_scripts(),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_vaq_tpu_import_in_source(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_import_loads_neither_jax_nor_vaq_tpu_and_sets_precision():
    proc = _python(
        "import json, sys, torch\n"
        "import vaq_tpu_torch, vaq_tpu_torch.convert, vaq_tpu_torch.data\n"
        "import vaq_tpu_torch.ops.scan_codes, vaq_tpu_torch.ops.scan_lut\n"
        "import vaq_tpu_torch.binary, vaq_tpu_torch.ops.hamming\n"
        "import vaq_tpu_torch.cli.demo_binary\n"
        "import vaq_tpu_torch.cli.demo_bitvecengine\n"
        "import vaq_tpu_torch.cli.serve, vaq_tpu_torch.serving_http\n"
        "import vaq_tpu_torch.profiling, vaq_tpu_torch.parallel\n"
        "import vaq_tpu_torch.parallel.dist_kmeans\n"
        "import vaq_tpu_torch.parallel.multihost\n"
        "import vaq_tpu_torch.fpgrowth, vaq_tpu_torch.metrics\n"
        "import vaq_tpu_torch.ops.kernel_check\n"
        "import vaq_tpu_torch.cli.demo_cluster\n"
        "import vaq_tpu_torch.cli.demo_boltcentroids\n"
        "import vaq_tpu_torch.cli.demo_vaq_paramsearch\n"
        "import runpy\n"
        f"for p in {[str(p) for p in _port_scripts()]!r}:\n"
        "    runpy.run_path(p)\n"
        "runpy.run_path('bench_torch.py')\n"
        "print(json.dumps({\n"
        "  'mods': sorted(m for m in sys.modules),\n"
        "  'tf32': torch.backends.cuda.matmul.allow_tf32,\n"
        "  'cudnn_tf32': torch.backends.cudnn.allow_tf32,\n"
        "  'prec': torch.get_float32_matmul_precision()}))\n")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in out["mods"] if _forbidden(m)]
    assert {"vaq_tpu_torch.vaq", "vaq_tpu_torch.binary",
            "vaq_tpu_torch.ops.hamming", "vaq_tpu_torch.serving",
            "vaq_tpu_torch.parallel.sharded", "vaq_tpu_torch.fpgrowth",
            "vaq_tpu_torch.ops.kernel_check",
            "vaq_tpu_torch.cli.demo_vaq_paramsearch"} <= set(out["mods"])
    assert out["tf32"] is False and out["cudnn_tf32"] is False
    assert out["prec"] == "highest"


def test_import_builds_nothing():
    """Kernels are built at first launch, never at import."""
    proc = _python("import vaq_tpu_torch.ops.scan_codes as s, sys\n"
                   "import vaq_tpu_torch._build as b\n"
                   "print(b.library.cache_info().currsize, "
                   "'triton' in sys.modules)")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", "False"]


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository it cannot run (and says nothing ok)."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _script_main(name: str, tmp_path):
    """``main`` of ``scripts/<name>.py``, its record sent under
    ``tmp_path``."""
    from test_torch_compute_accuracy import load_script
    main = load_script(name).main
    return lambda: main(["--out", str(tmp_path / f"{name}.json")])


def _entry_points(tmp_path):
    """Each public entry point that takes a device, called without one, on
    a small CPU-built state."""
    import numpy as np

    import vaq_tpu_torch as vt
    from vaq_tpu_torch import binary, convert, data, pca
    from vaq_tpu_torch.cli import serve
    from vaq_tpu_torch.ops import distances, scan_codes
    from vaq_tpu_torch.parallel import make_mesh
    from vaq_tpu_torch.parallel.multihost import pod_mesh

    x = np.random.default_rng(0).standard_normal((300, 16)).astype(np.float32)
    idx = vt.VAQIndex(vt.parse_method_string("VAQ16m4min2max4var1,HEAP"),
                      device="cpu").build(x)
    idx.save(str(tmp_path / "i.npz"))
    arrays, meta = idx.state()
    buckets = {"centroids": np.zeros((2, 4), np.float32), "seg_dims": 4,
               "cap": 512, "bucket_rows": np.zeros((2, 512, 16), np.int8),
               "bucket_ids": np.full((2, 512), -1, np.int32),
               "sizes": np.zeros(2, np.int32),
               "dim_scales": np.ones(16, np.float32)}
    bidx = binary.BinaryIndex(bit_budget=24, device="cpu").train(x).encode(x)
    bidx.save(str(tmp_path / "b.npz"))
    x.tofile(str(tmp_path / "x.bin"))
    clusters = {"centroids": np.zeros((2, 16), np.float32), "cap": 4,
                "bucket_words": np.zeros((2, 4, 1), np.uint32),
                "bucket_ids": np.full((2, 4), -1, np.int32),
                "sizes": np.zeros(2, np.int32)}
    return {
        "VAQIndex": lambda: vt.VAQIndex(idx.config),
        "VAQIndex.load": lambda: vt.VAQIndex.load(str(tmp_path / "i.npz")),
        "index_from_numpy": lambda: convert.index_from_numpy(arrays, meta),
        "ivf_state_from_numpy": lambda: convert.ivf_state_from_numpy(buckets),
        "make_sift_like": lambda: data.make_sift_like(n=50, n_queries=2,
                                                      d=16),
        "compute_groundtruth": lambda: distances.compute_groundtruth(
            x[:2], x, 5),
        "build_decode_table": lambda: scan_codes.build_decode_table(
            idx.centroids),
        "build_decode_rows": lambda: scan_codes.build_decode_rows(
            idx.centroids),
        "train_rotation": lambda: pca.train_rotation(x, 4),
        "DeviceChunkSource": lambda: data.DeviceChunkSource(300, 16, 100),
        "exact_search_chunked": lambda: distances.exact_search_chunked(
            x[:2], lambda i: x[i * 100:(i + 1) * 100], 300, 100, 5),
        "exact_rescore_chunked": lambda: distances.exact_rescore_chunked(
            x[:2], np.zeros((2, 5), np.int32),
            lambda i: x[i * 100:(i + 1) * 100], 300, 100, 5),
        "BinaryIndex": lambda: binary.BinaryIndex(bit_budget=24),
        "BinaryIndex.load": lambda: binary.BinaryIndex.load(
            str(tmp_path / "b.npz")),
        "ScalarLUTIndex": lambda: binary.ScalarLUTIndex(bit_budget=24),
        "query_naive_streaming": lambda: binary.query_naive_streaming(
            str(tmp_path / "x.bin"), 16, x[:2], 5),
        "build_hamming_clusters": lambda: binary.build_hamming_clusters(
            bidx, x, 2),
        "binary_index_from_numpy": lambda: convert.binary_index_from_numpy(
            *bidx.state()),
        "hamming_clusters_from_numpy":
            lambda: convert.hamming_clusters_from_numpy(clusters),
        "make_mesh": lambda: make_mesh(),
        "pod_mesh": lambda: pod_mesh(),
        "VAQIndex.shard": lambda: idx.shard(),
        "serve.main": lambda: serve.main(["--index",
                                          str(tmp_path / "i.npz")]),
        **{f"{name}.main": _script_main(name, tmp_path) for name in (
            "check_sharded_100k_torch", "widebits_1m_torch",
            "oracle_bisect_torch")},
    }


ENTRY_POINTS = ["VAQIndex", "VAQIndex.load", "index_from_numpy",
                "ivf_state_from_numpy", "make_sift_like", "compute_groundtruth",
                "build_decode_table", "build_decode_rows", "train_rotation",
                "DeviceChunkSource", "exact_search_chunked",
                "exact_rescore_chunked", "BinaryIndex", "BinaryIndex.load",
                "ScalarLUTIndex", "query_naive_streaming",
                "build_hamming_clusters", "binary_index_from_numpy",
                "hamming_clusters_from_numpy", "make_mesh", "pod_mesh",
                "VAQIndex.shard", "serve.main",
                "check_sharded_100k_torch.main", "widebits_1m_torch.main",
                "oracle_bisect_torch.main"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_cuda_and_raise_without_it(name, tmp_path,
                                                           monkeypatch):
    """The port runs on the card unless the caller asks for the CPU: with
    no CUDA an entry point called without ``device`` raises DeviceError and
    never falls back to the CPU."""
    import torch

    from vaq_tpu_torch.errors import DeviceError
    call = _entry_points(tmp_path)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match="device='cpu'"):
        call()
