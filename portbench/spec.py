"""Everything a run finds by name: the cell in `BENCHMARK.json`, its
configuration and traffic files, its job kind (`jobs/<kind>.py`) and one
reader a metric (`metrics/<name>.py`).

A later change adds a configuration, a traffic mix, a job kind or a metric
by adding files and entries; no file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["Cell", "load_cell", "load_module", "metric_reader", "job_kind",
           "HERE", "ROOT"]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file, as loaded
    traffic: dict         # the traffic mix's file, as loaded
    end_to_end: list      # BENCHMARK.json's metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json, with its files loaded."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at `path` (its name may hold dots) as `name`, once."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def metric_reader(name: str) -> ModuleType:
    """`metrics/<name>.py`: its `read(run)` gives the metric's value, or
    None where the run holds nothing to read."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def job_kind(kind: str) -> ModuleType:
    """`jobs/<kind>.py`, the one module that knows the program's entry:
    `setup(config, traffic, seed, device)` -> state (inputs drawn, program
    warmed up; `state.facts` for the readers, `state.setup_parts`),
    `work(state)` (a job's work), `run(state, j)` (job j, its outputs on
    the host), `free(state)` (the program's device state dropped before
    the reference runs), `judge(state, outputs, workers)` -> ({number:
    (value, limit)}, details), `reference_workers()`, `SPANS` (the
    program's calls a traced run wraps), and for `control.py`
    `draw(config, traffic, seed)` and `control(state, jobs, workers)`."""
    return load_module(HERE / "jobs" / f"{kind}.py",
                       "portbench_job_" + kind)
