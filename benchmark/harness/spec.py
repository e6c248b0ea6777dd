"""Find one cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Its configuration is the JSON file that ``configs[].file`` names, whose
``system`` key names ``systems/<system>.py`` (``build``, ``state``,
``numbers``: how the system is built from rows and judged); its mix is
``traffic/<traffic>.json``, whose ``loop`` key names ``loops/<loop>.py``
(``make(idx, queries, traffic, k, seed)``: what drives the timed path);
its numbers' limits and its control are ``limits/<workload>.json``; each
per-layer metric is read by ``layer_metrics/<metric>.py``, a module with
``read(ctx) -> float | None``. Adding a cell, a mix, a kind of traffic, a
system or a metric is adding such files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: Optional[Callable] = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    system: object
    loop: object


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<kind>/<name>.py`` of the benchmark, loaded by its path
    (a name may hold dots)."""
    path = bench_dir / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``layer_metrics/<name>.py``'s ``read``."""
    return load_module("layer_metrics", name, bench_dir).read


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, bench: Optional[dict] = None,
              root: Path = REPO_ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json`` (or of
    ``bench``), its files under ``root/benchmark``."""
    bench = bench or load_json(root / "BENCHMARK.json")
    bench_dir = root / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [Metric(m["name"], m["unit"])
           for m in bench["end_to_end"] if _reports(m, workload)]
    moved = {m.name for m in e2e}
    per_layer = [Metric(m["name"], m["unit"],
                        load_reader(m["name"], bench_dir))
                 for m in bench["per_layer"]
                 if _reports(m, workload) and m["moves"] in moved]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                limits=load_json(bench_dir / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer,
                system=load_module("systems", config["system"], bench_dir),
                loop=load_module("loops", traffic["loop"], bench_dir))
