"""The manifest (``BENCHMARK.json``) and the files it names, found by name.

A cell is an entry of the manifest's ``workloads``; it names a
configuration (its entry gives the file), a traffic mix
(``traffic/<name>.json``) and is held to ``limits/<cell>.json``.  Every
metric, end-to-end or per-layer, is read by ``metrics/<name>.py``.  A later
change adds a configuration, a mix, a cell or a metric by adding files and
entries only."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A Python file loaded by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]        # the configuration file's contents
    traffic: Dict[str, Any]       # the traffic mix's parameters
    limits: Dict[str, Any]        # the check's limits for this cell
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def reported(metrics: List[Dict[str, Any]], cell: str) -> List[Dict]:
    """The metrics a cell reports: those without a ``workloads`` list, and
    those whose list names the cell."""
    return [m for m in metrics
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, manifest_path: Path = ROOT / "BENCHMARK.json",
              bench_dir: Path = BENCH_DIR) -> Cell:
    manifest = load_json(manifest_path)
    root = manifest_path.resolve().parent
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest_path.name}; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=reported(manifest["end_to_end"], name),
                per_layer=reported(manifest["per_layer"], name))


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``metrics/<name>.py``: a module whose ``read(run)`` returns the
    metric's value, or None where the run holds nothing to read."""
    return load_module(bench_dir / "metrics" / f"{name}.py")


def reference_module(config: Dict[str, Any],
                     bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The configuration's plain reference, ``reference/<name>.py``."""
    return load_module(bench_dir / "reference" / f"{config['reference']}.py")
