"""The stdout contract of the port's bench (``bench_torch.py``), held to
``bench.py``'s: the same whitelist, budget and ``slim_line`` on the same
records, the same flags and defaults (``--device`` besides, ``cuda`` by
default), and no line at all without a card."""

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402  (bench.py imports jax only inside main)
import bench_torch  # noqa: E402
from test_bench_line import _full_record  # noqa: E402


def _over_budget():
    """Every whitelisted key present, ``config`` bloated: the line must
    shed keys from the tail of the whitelist."""
    out = _full_record()
    for key in bench._STDOUT_KEYS:
        out.setdefault(key, 123456.7)
    out["config"] = "VAQ" + "9" * 1200
    return out


def _with_errors():
    out = _full_record()
    out["capacity_error"] = "RuntimeError(" + "x" * 5000 + ")"
    out["ivf_error"] = "ConfigError('ti_cluster_num must be set')"
    out["tenm_ivf_error"] = "x" * 81
    return out


RECORDS = {"full": _full_record, "over_budget": _over_budget,
           "errors": _with_errors}


def test_whitelist_and_budget_equal_bench_py():
    assert bench_torch._STDOUT_KEYS == bench._STDOUT_KEYS
    assert bench_torch._STDOUT_BUDGET == bench._STDOUT_BUDGET == 1900


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_slim_line_equals_bench_py(name):
    out = RECORDS[name]()
    line = bench_torch.slim_line(out)
    assert line == bench.slim_line(out)
    assert len(line) <= bench_torch._STDOUT_BUDGET
    parsed = json.loads(line)
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in parsed, key
    # array-valued fields never reach stdout
    for key in ("serving_sweep", "tenm_ivf_sweep", "value_runs"):
        assert key not in parsed, key
    # what stays is a head of the whitelist: trimming drops its tail
    kept = [k for k in bench_torch._STDOUT_KEYS if k in out]
    scalars = [k for k in parsed if not k.endswith("_error")]
    assert scalars == kept[: len(scalars)]
    if name == "over_budget":
        assert len(scalars) < len(kept)
        assert "widebits_recall_at_k" not in parsed
    else:
        assert scalars == kept
    for key, value in out.items():
        if key.endswith("_error"):
            assert parsed[key] == str(value)[:80]


def _bench_parser() -> argparse.ArgumentParser:
    """bench.py's parser, caught as its ``main`` asks it to parse (before
    anything of JAX is imported)."""

    class Caught(Exception):
        pass

    def catch(self, *a, **kw):
        raise Caught(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        bench.main()
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("bench.main() parsed no arguments")


def _flags(p: argparse.ArgumentParser) -> dict:
    return {tuple(a.option_strings): (a.dest, a.default, a.type)
            for a in p._actions if a.option_strings != ["-h", "--help"]}


def test_flags_and_defaults_equal_bench_py_and_device_is_cuda():
    port = _flags(bench_torch.parser())
    assert port.pop(("--device",)) == ("device", "cuda", None)
    assert port == _flags(_bench_parser())
    assert bench_torch.parser().parse_args([]).device == "cuda"


def test_without_a_card_it_raises_device_error_and_prints_no_line(tmp_path):
    shutil.copy(ROOT / "bench_torch.py", tmp_path / "bench_torch.py")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "bench_torch.py", "--n", "2048", "--no-oracle"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "DeviceError" in proc.stderr
    assert proc.stdout.strip() == ""
    assert not (tmp_path / ".bench_cache").exists()


@pytest.mark.parametrize("out,status", [
    ({"value": 1.0, "kernel_parity_ok": True}, 0),
    ({"value": 1.0, "kernel_parity_ok": None}, 0),
    ({"value": 1.0}, 0),
    ({"value": 1.0, "ivf_error": "ConfigError('x')"}, 1),
    ({"value": 1.0, "kernel_parity_ok": False}, 1),
])
def test_exit_status_fails_on_an_error_field_or_a_failed_gate(out, status):
    # bench.py exits 0 in both failing cases; the port does not
    assert bench_torch.exit_status(out) == status
