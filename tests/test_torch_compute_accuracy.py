"""``scripts/compute_accuracy_torch.py`` against ``scripts/compute_accuracy.py``:
both ``main``\\ s on the same answers and groundtruth files must print the
same three lines, byte for byte (``.ivecs`` and CSV groundtruth, 1-based
ids with ``--gt-offset 1``, ``--k`` above and below the columns)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from vaq_tpu_torch import io

ROOT = Path(__file__).resolve().parent.parent


def load_script(name: str):
    """The module of ``scripts/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """answers.csv (40 × 12 ids, partly the groundtruth's), gt.ivecs and
    gt.csv (40 × 15), gt1.csv (the same ids 1-based)."""
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("accuracy")
    gt = np.stack([rng.permutation(500)[:15] for _ in range(40)])
    pred = np.where(rng.random((40, 12)) < 0.6, gt[:, :12],
                    rng.integers(0, 500, (40, 12)))
    np.savetxt(d / "answers.csv", pred, fmt="%d", delimiter=",")
    io.write_ivecs(str(d / "gt.ivecs"), gt)
    np.savetxt(d / "gt.csv", gt, fmt="%d", delimiter=",")
    np.savetxt(d / "gt1.csv", gt + 1, fmt="%d", delimiter=",")
    return d


@pytest.mark.parametrize("gt_name,extra", [
    ("gt.ivecs", []), ("gt.csv", []), ("gt1.csv", ["--gt-offset", "1"]),
    ("gt.ivecs", ["--k", "500"]), ("gt.csv", ["--k", "5"])])
def test_lines_equal_jax(files, capsys, gt_name, extra):
    argv = [str(files / "answers.csv"), str(files / gt_name), *extra]
    assert load_script("compute_accuracy").main(argv) == 0
    want = capsys.readouterr().out
    assert load_script("compute_accuracy_torch").main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    assert [line.split(":")[0] for line in got.splitlines()] == \
        ["avg_recall", "recall@R", "MAP"]
