"""BENCHMARK.json against the contract's names and shapes, and the harness
finding a new cell, configuration and metric by their files alone."""

import json
import re
import shutil

import pytest

from port_bench.core import spec
from port_bench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark(ROOT)


def test_top_level_and_entry_keys(bench):
    assert set(bench) == TOP
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in bench["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in bench["workloads"])
    assert all(set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
               for m in bench["end_to_end"])
    assert all(set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
               for m in bench["per_layer"])
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(bench, part):
    names = [e["name"] for e in bench[part]]
    assert len(names) == len(set(names))
    for e in bench[part]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_metrics_rules(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for w in cells:        # every cell: setup_s, another end-to-end metric, a per-layer one
        assert len(spec.end_to_end(bench, w)) >= 2
        assert spec.per_layer(bench, w)


def test_every_named_file_is_there(bench):
    assert bench["paths"] == ["port_bench"]
    for c in bench["configs"]:
        assert c["file"].startswith("port_bench/")
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"], ROOT)
        assert (ROOT / "port_bench" / "traffic" / f"{c['mix']['kind']}.py").is_file()
        assert set(c["workload"]["limits"])
    for m in bench["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"], ROOT).read)


def test_a_new_cell_config_and_metric_are_files_alone(tmp_path, bench):
    """A copy of the benchmark gains a configuration, a cell and a metric
    by new files and new entries; no file of the harness changes."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((ROOT / "port_bench/configs/ems-res10-ecs.json").read_text())
    cfg["name"] = "ems-res10-ecs-t2"
    cfg["T"] = 2
    (tmp_path / "port_bench/configs/ems-res10-ecs-t2.json").write_text(json.dumps(cfg))
    (tmp_path / "port_bench/workloads/res10t2-serve-b8.json").write_text(json.dumps(
        {"config": "ems-res10-ecs-t2", "traffic": "serve-b8-dashcam",
         "limits": {"site_gap": 0.1}}))
    (tmp_path / "port_bench/metrics/steps.serve.py").write_text(
        "def read(rec):\n    return float(rec['steps'])\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "ems-res10-ecs-t2", "source": "a copy at T=2",
                           "file": "port_bench/configs/ems-res10-ecs-t2.json",
                           "reduced": ["T"], "why": "a test"})
    new["workloads"].append({"name": "res10t2-serve-b8", "config": "ems-res10-ecs-t2",
                             "traffic": "serve-b8-dashcam", "chips": 1, "why": "a test"})
    new["per_layer"].append({"name": "steps.serve", "unit": "steps", "better": "higher",
                             "source": "program_counter", "layer": "serving step",
                             "moves": "serve_img_s", "workloads": ["res10t2-serve-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    c = spec.cell(spec.benchmark(tmp_path), "res10t2-serve-b8", tmp_path)
    assert c["config"]["T"] == 2 and c["mix"]["kind"] == "serve"
    layer = [m["name"] for m in spec.per_layer(spec.benchmark(tmp_path), "res10t2-serve-b8")]
    assert layer == ["steps.serve"]
    assert spec.load_module("metrics", "steps.serve", tmp_path).read({"steps": 7}) == 7.0
    assert spec.load_module("traffic", "serve", tmp_path).setup
