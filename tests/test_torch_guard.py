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
