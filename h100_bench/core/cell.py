"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell (a configuration and a traffic mix);
everything else lives in files of its own that this module finds by
those names, so a later change adds a configuration, a traffic mix, a
per-layer metric or a kernel's counts as new files without editing one:

- ``configs/<config>/config.json``, ``model.py`` (builds the program's
  objects) and ``reference.py`` (the plain float32 twin);
- ``traffic/<traffic>.json`` (the mix's parameters, read by the driver
  that its ``driver`` key names) and ``corpora/<corpus>.json``; a mix
  that needs code adds ``traffic/<traffic>.py``, whose ``Driver`` class
  (a driver of its own) or ``Batches`` class (how the general train
  driver counts and checks its batches) is used in place of the core's;
- ``limits/<cell>.json``: each number that decides ``correct`` and its
  limit;
- ``metrics/<metric>.py``: a reader ``read(run)`` per per-layer metric;
- ``kernels/<kernel>.py``: a kernel's operation and byte counts.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str) -> ModuleType:
    """A Python file loaded by its path under a unique module name."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return _load_json(os.path.join(ROOT, "BENCHMARK.json"))


class Config:
    """One model configuration: its numbers, its builder, its reference."""

    def __init__(self, name: str):
        self.name = name
        self.dir = os.path.join(HERE, "configs", name)
        self.values = _load_json(os.path.join(self.dir, "config.json"))
        self._model = self._reference = None

    @property
    def model(self) -> ModuleType:
        if self._model is None:
            self._model = load_module(os.path.join(self.dir, "model.py"),
                                      f"h100_bench_config_{_ident(self.name)}"
                                      "_model")
        return self._model

    @property
    def reference(self) -> ModuleType:
        if self._reference is None:
            self._reference = load_module(
                os.path.join(self.dir, "reference.py"),
                f"h100_bench_config_{_ident(self.name)}_reference")
        return self._reference


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def traffic(name: str) -> dict:
    t = _load_json(os.path.join(HERE, "traffic", f"{name}.json"))
    t["corpus"] = _load_json(os.path.join(HERE, "corpora",
                                          f"{t['corpus']}.json"))
    return t


def traffic_code(name: str) -> Optional[ModuleType]:
    """``traffic/<name>.py``, where the mix has one."""
    path = os.path.join(HERE, "traffic", f"{name}.py")
    if not os.path.exists(path):
        return None
    return load_module(path, f"h100_bench_traffic_{_ident(name)}")


def metric_reader(name: str) -> ModuleType:
    return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                       f"h100_bench_metric_{_ident(name)}")


def kernel_counts(name: str) -> ModuleType:
    return load_module(os.path.join(HERE, "kernels", f"{name}.py"),
                       f"h100_bench_kernel_{_ident(name)}")


class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, bench: dict = None):
        bench = benchmark() if bench is None else bench
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        self.name = name
        self.chips = self.entry["chips"]
        self.config = Config(self.entry["config"])
        self.traffic_name = self.entry["traffic"]
        self.traffic = traffic(self.traffic_name)
        self.traffic_code = traffic_code(self.traffic_name)
        self.limits = _load_json(os.path.join(HERE, "limits",
                                              f"{name}.json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def all_cells() -> List[str]:
    return [w["name"] for w in benchmark()["workloads"]]
