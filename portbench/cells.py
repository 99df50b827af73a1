"""Find a cell's files by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration
and traffic mix. The harness reads, all by name:
  the configuration        the `file` its entry in `configs` gives;
  the program path         portbench/programs/<program>.py, where the
                           configuration says `"program": "<program>"`,
                           and portbench/programs/gauss3d.py where it
                           names none (the functions it gives: README.md);
  the traffic mix          portbench/traffic/<traffic>.json;
  the cell's limits        portbench/limits/<workload>.json (the numbers
                           compared to decide `correct`, each with the
                           readings it was set from);
  each per-layer metric    portbench/metrics/<name>.py, whose `read(run)`
                           returns the value or None.
A new cell, configuration, program path, traffic mix or metric is a new
file and a new entry in BENCHMARK.json; no file of the harness changes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]
PKG = "portbench"
DEFAULT_PROGRAM = "gauss3d"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path
    program: Path


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell's files. Raises KeyError for a workload BENCHMARK.json does
    not name, and ValueError or FileNotFoundError for a program that is no
    name or whose file is not there."""
    spec = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load(root / configs[w["config"]]["file"])
    name = config.get("program", DEFAULT_PROGRAM)
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", name):
        raise ValueError(f"configuration {w['config']!r} names the program "
                         f"{name!r}, which is no name")
    program = root / PKG / "programs" / f"{name}.py"
    if not program.is_file():
        raise FileNotFoundError(
            f"configuration {w['config']!r} names the program {name!r}, and "
            f"{PKG}/programs/{name}.py is not there")
    traffic = _load(root / PKG / "traffic" / f"{w['traffic']}.json")
    limits = _load(root / PKG / "limits" / f"{workload}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, workload, names)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, root=root, program=program)


def program(cell: Cell) -> ModuleType:
    """The cell's program file as a module, loaded once a process for each
    path (a run and a test that patches it hold the same module)."""
    key = hashlib.sha256(str(cell.program).encode()).hexdigest()[:16]
    name = f"portbench_program_{cell.program.stem}_{key}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, cell.program)
        mod = importlib.util.module_from_spec(spec)
        # Registered before it runs: its dataclasses look their module up.
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def reader(root: Path, metric: str) -> Callable:
    """The `read` function of portbench/metrics/<metric>.py."""
    path = root / PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: reader(cell.root, m["name"]) for m in cell.per_layer}
