"""``BENCHMARK.json`` against the rules it is read by: its keys, names and
units, bounds, and a file for every configuration, mix, limit and metric."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    return json.loads(raw)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and len(b["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and
               ".." not in p and not p.startswith("/") for p in b["paths"])
    assert all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert (ROOT / b["command"][1]).is_file()


def test_configs_cells_and_their_files():
    b = _bench()
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert (ROOT / "benchmark" / "systems" / f"{cfg['system']}.py"
                ).is_file()
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    four = 0
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
        mix = json.loads((ROOT / "benchmark" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "loops" / f"{mix['loop']}.py").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json"
                ).is_file()
    assert len(pairs) == len(b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_metrics():
    b = _bench()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(b["per_layer"]) <= 128
    seen = set()
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert all(_reports(e2e[m["moves"]], c) for c in
                   m.get("workloads", cells))
        assert (ROOT / "benchmark" / "layer_metrics" / f"{m['name']}.py"
                ).is_file()
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        mine = [n for n, m in e2e.items() if _reports(m, c)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(_reports(m, c) and _reports(e2e[m["moves"]], c)
                   for m in b["per_layer"])
