"""Guards of the PyTorch port: it never imports jax or vaq_tpu, it sets the
full-f32 precision policy at import, and chip_smoke.py refuses to run (and
prints no result) without a CUDA card."""

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
    return top in ("jax", "jaxlib", "vaq_tpu")


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


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_vaq_tpu_import_in_source(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_import_loads_neither_jax_nor_vaq_tpu_and_sets_precision():
    proc = _python(
        "import json, sys, torch\n"
        "import vaq_tpu_torch, vaq_tpu_torch.convert, vaq_tpu_torch.data\n"
        "import vaq_tpu_torch.ops.scan_codes, vaq_tpu_torch.ops.scan_lut\n"
        "print(json.dumps({\n"
        "  'mods': sorted(m for m in sys.modules),\n"
        "  'tf32': torch.backends.cuda.matmul.allow_tf32,\n"
        "  'cudnn_tf32': torch.backends.cudnn.allow_tf32,\n"
        "  'prec': torch.get_float32_matmul_precision()}))\n")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in out["mods"] if _forbidden(m)]
    assert "vaq_tpu_torch.vaq" in out["mods"]
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


def _entry_points(tmp_path):
    """Each public entry point that takes a device, called without one, on
    a small CPU-built state."""
    import numpy as np

    import vaq_tpu_torch as vt
    from vaq_tpu_torch import convert, data, pca
    from vaq_tpu_torch.ops import distances, scan_codes

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
    }


ENTRY_POINTS = ["VAQIndex", "VAQIndex.load", "index_from_numpy",
                "ivf_state_from_numpy", "make_sift_like", "compute_groundtruth",
                "build_decode_table", "build_decode_rows", "train_rotation"]


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
