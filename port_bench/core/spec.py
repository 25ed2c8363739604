"""Finds a cell's files by the names ``BENCHMARK.json`` gives: the cell's
``workloads/<cell>.json``, its configuration's file, the traffic mix
``mixes/<traffic>.json``, the mix's generator ``traffic/<kind>.py`` and each
per-layer metric's reader ``metrics/<metric>.py``.  Adding a cell, a
configuration, a mix or a metric adds files; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json")


def _entry(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def cell(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry (``entry``), its own
    file (``workload``), its configuration (``config``) and its traffic mix
    (``mix``)."""
    entry = _entry(bench["workloads"], name, "workload")
    cfg_entry = _entry(bench["configs"], entry["config"], "config")
    bench_dir = root / BENCH_DIR.name
    return {"entry": entry,
            "workload": _json(bench_dir / "workloads" / f"{name}.json"),
            "config": _json(root / cfg_entry["file"]),
            "mix": _json(bench_dir / "mixes" / f"{entry['traffic']}.json")}


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(bench: Dict, workload: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if _applies(m, workload)]


def per_layer(bench: Dict, workload: str) -> List[Dict]:
    return [m for m in bench["per_layer"] if _applies(m, workload)]


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``<kind>/<name>.py`` under the benchmark's folder, imported by path
    (a metric's name may hold a dot)."""
    path = root / BENCH_DIR.name / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
