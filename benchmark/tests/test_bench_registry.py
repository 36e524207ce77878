"""BENCHMARK.json against its contract, and every name in it found by the
harness; a cell and a metric added as files are picked up without an edit."""

import json
import re
import shutil

import pytest

from benchmark.registry import ROOT, Registry
from benchmark.tests import tiny  # noqa: F401  (puts the checkout on sys.path)

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, cells // 4)
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_their_keys(section, keys):
    for entry in SPEC[section]:
        assert set(entry) - {"workloads"} == keys, entry["name"]
        if section == "per_layer":  # each per-layer metric names the cells that read it
            assert entry["workloads"], entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        for k in ("why", "layer", "source"):
            if k in entry:
                assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] and "\t" not in entry[k]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))


def test_metrics_sources_bounds_and_cells():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
    reg = Registry()
    for w in SPEC["workloads"]:
        cell = reg.cell(w["name"])
        assert {m["name"] for m in cell.end_to_end} - {"setup_s"}, w["name"]
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert cell.per_layer, w["name"]
        assert w["chips"] in (1, 4)


def test_every_name_is_found():
    reg = Registry()
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/configs/")
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert cfg["precision"] in ("f32", "tf32")
    used = set()
    for w in SPEC["workloads"]:
        cell = reg.cell(w["name"])
        used.add(w["config"])
        reg.driver(cell)
        assert set(cell.limits), w["name"]
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        mod = reg.reader(m["name"])
        assert (mod.NAME, mod.UNIT, mod.SOURCE, mod.LAYER, mod.MOVES) == \
            (m["name"], m["unit"], m["source"], m["layer"], m["moves"])
        assert mod.WORKLOADS == m["workloads"]


def test_layers_are_named_alike():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_new_cell_and_metric_need_only_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    (tmp_path / "benchmark/traffic/serve-k10.json").write_text(json.dumps(
        dict(json.loads((ROOT / "benchmark/traffic/serve.json").read_text()), cutoff=10)))
    (tmp_path / "benchmark/workloads/ganmf-ml1m.serve-k10.json").write_text('{"limits": {"list_gap": 1e-4}}')
    (tmp_path / "benchmark/layer_metrics/serve.calls_traced.py").write_text(
        'NAME = "serve.calls_traced"\nUNIT = "calls"\nSOURCE = "host_clock"\nLAYER = "serving"\n'
        'MOVES = "recommend_p99_ms"\nWORKLOADS = ["ganmf-ml1m.serve-k10"]\n\n\n'
        'def read(ctx):\n    return ctx.get("units_traced")\n')
    spec["workloads"].append({"name": "ganmf-ml1m.serve-k10", "config": "ganmf-ml1m", "traffic": "serve-k10",
                              "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "recommend_p99_ms":
            m["workloads"].append("ganmf-ml1m.serve-k10")
    spec["per_layer"].append({"name": "serve.calls_traced", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "serving", "moves": "recommend_p99_ms",
                              "workloads": ["ganmf-ml1m.serve-k10"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(tmp_path / "BENCHMARK.json", base=tmp_path / "benchmark")
    cell = reg.cell("ganmf-ml1m.serve-k10")
    assert cell.traffic["cutoff"] == 10 and cell.limits == {"list_gap": 1e-4}
    assert [m["name"] for m in cell.per_layer] == ["serve.calls_traced"]
    assert reg.reader("serve.calls_traced").read({"units_traced": 7}) == 7
    assert {m["name"] for m in cell.end_to_end} == {"recommend_p99_ms", "setup_s"}
