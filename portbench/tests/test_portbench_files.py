"""The benchmark's files: every configuration, cell and metric is found by
name and parses, every name and unit keeps to the allowed characters, and
a new configuration, cell and metric take only new files and entries."""
import json
import os
import re
import shutil

import pytest

from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _benchmark(root=bench.ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = _benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert os.path.getsize(os.path.join(bench.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keep_to_the_contract(section):
    b = _benchmark()
    names = [e["name"] for e in b[section]]
    assert len(names) == len(set(names))
    for e in b[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section in ("end_to_end", "per_layer"):
            assert e["source"] in SOURCES
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)
        if section == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    b = _benchmark()
    for w in b["workloads"]:
        cell = bench.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in _benchmark()["workloads"]])
def test_each_cell_and_its_files_are_found_by_name(cell):
    import importlib

    c = bench.load_cell(cell)
    importlib.import_module(f"portbench.generators.{c.traffic['generator']}")
    importlib.import_module(f"portbench.program.{c.config['series']}")
    importlib.import_module(f"portbench.reference.series.{c.config['series']}")
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.end_to_end + c.per_layer:
        assert callable(bench.reader(m["name"]))


def test_configs_are_used_and_their_files_lie_under_paths():
    b = _benchmark()
    used = {w["config"] for w in b["workloads"]}
    files = [c["file"] for c in b["configs"]]
    assert {c["name"] for c in b["configs"]} == used and len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/") and os.path.exists(os.path.join(bench.ROOT, f))


def test_a_new_configuration_cell_and_metric_take_only_new_files(tmp_path):
    """In a copy, add a configuration (Gamma4 at order 3), a traffic mix, a
    cell with its limits and a per-layer metric with its reader: the harness
    finds each by name, and no file that was there changed."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(bench.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(bench.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    cfg = json.loads((root / "portbench/configs/gamma4-o4.json").read_text())
    cfg["innerLoopNum"] = 3
    (root / "portbench/configs/gamma4-o3.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/mc-2048.json").write_text(json.dumps(
        {"generator": "mc_captured", "batch": 2048, "chunk_passes": 64, "check_chunks": 3,
         "trace_passes": 64}))
    (root / "portbench/checks/gamma4-o3.mc-2048.json").write_text('{"sum_err": 1e-5}')
    (root / "portbench/metrics/passes_per_chunk.mc.py").write_text(
        "def read(facts):\n    return facts.window.get('attempted')\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "gamma4-o3", "source": "https://example.org/gamma4",
                         "file": "portbench/configs/gamma4-o3.json", "reduced": [],
                         "why": "order 3"})
    b["workloads"].append({"name": "gamma4-o3.mc-2048", "config": "gamma4-o3",
                           "traffic": "mc-2048", "chips": 1, "why": "small levels"})
    b["per_layer"].append({"name": "passes_per_chunk.mc", "unit": "passes", "better": "higher",
                           "source": "host_clock", "layer": "device",
                           "moves": "samples_per_s", "workloads": ["gamma4-o3.mc-2048"]})
    for m in b["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append("gamma4-o3.mc-2048")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = bench.load_cell("gamma4-o3.mc-2048", root=str(root))
    assert cell.config["innerLoopNum"] == 3 and cell.traffic["batch"] == 2048
    assert cell.limits == {"sum_err": 1e-5}
    assert "passes_per_chunk.mc" in [m["name"] for m in cell.per_layer]
    read = bench.reader("passes_per_chunk.mc", root=str(root / "portbench"))
    assert read(bench.Facts("mc", 1.0, 1.0, {"attempted": 7}, 1, 4, 4, None, None)) == 7
    after = {p: p.read_bytes() for p in root.rglob("*") if p.is_file() and p in before}
    changed = [str(p.relative_to(root)) for p in before if after[p] != before[p]]
    assert changed == ["BENCHMARK.json"]
