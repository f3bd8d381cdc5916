"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells, configurations
and metrics; everything that belongs to one of them is a file of its own
under ``portbench/``, found by its name:

* a configuration: ``configs/<name>.json`` (the file ``BENCHMARK.json``
  gives), whose ``family`` names ``references/<family>.py``, the plain
  reference and the product list of that kind of model;
* a traffic mix: ``traffic/<name>.json``;
* a metric, end to end or per layer: ``metrics/<name>.py``, a reader
  with ``read(run) -> float | None``;
* a cell's correctness limit: ``limits/<cell>.json`` (``logit_gap``, set
  between the program's largest reading and the control's smallest, which
  ``PERF.md`` gives).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: dict, name: str, root: Path,
                 here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(here / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.family = load_module(here / "references"
                                  / f"{self.config['family']}.py")
        self.limits = load_json(here / "limits" / f"{name}.json")
        self.here = here
        self.bench = bench

    def metrics(self, section: str) -> List[dict]:
        """The metrics of ``section`` (``end_to_end`` or ``per_layer``)
        that this cell reports: those without a ``workloads`` key and
        those that list it."""
        return [m for m in self.bench[section]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.here / "metrics" / f"{metric}.py")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


_MODULES: Dict[Path, ModuleType] = {}


def load_module(path: Path) -> ModuleType:
    """A module from its file (metric names hold dots, so not by import
    name); once per process."""
    path = Path(path).resolve()
    if path not in _MODULES:
        name = "portbench_" + path.parent.name + "_" + \
            path.stem.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def load_cell(name: str, root: Optional[Path] = None,
              here: Path = HERE) -> Cell:
    root = Path(root) if root is not None else here.parent
    return Cell(load_json(root / "BENCHMARK.json"), name, root, here)
