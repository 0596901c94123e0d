"""Find a cell's files by name.

A cell of BENCHMARK.json is ``<config>.<mix>``: its configuration is the
file that the ``configs`` entry names (``configs/<config>.json``), its
traffic ``traffic/<mix>.json``, the limits of its correctness check
``limits/<cell>.json``, and each per-layer metric a reader
``metrics/<metric>.py`` with a function ``read(records)``, or, where no
such file is, the reader of its quantity, ``metrics/<quantity>.py``: a
metric ``<quantity>.<suffix>`` is one quantity split by the end-to-end
metric its cells report (``idle_pct.estimate`` and ``idle_pct.stream``
both read ``metrics/idle_pct.py``).

The model is found the same way. A configuration names its ``family``
(``pmctf_l`` where it names none), a module ``families/<family>.py``
that supplies the port's model, the plain reference, the run's inputs,
the reference's output, the layer table and the planted faults; a mix
names its ``path``, a module ``paths/<path>.py`` whose ``build(model,
mix, device)`` returns the timed path. A family lists the paths it
takes (``PATHS``); a cell that pairs it with another is refused here,
before any set-up. Adding a configuration, a mix, a cell, a metric, a
family or a path adds files and entries; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
DEFAULT_FAMILY = "pmctf_l"


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict
    family: str
    path: str
    bench_dir: str
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = os.path.join(root, "pmctf_bench")
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    mix = _load(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    family = config.get("family", DEFAULT_FAMILY)
    takes = load_family(family, bench_dir).PATHS
    if mix["path"] not in takes:
        raise ValueError(f"cell {name!r}: family {family!r} takes the paths {list(takes)}, "
                         f"and mix {w['traffic']!r} asks for path {mix['path']!r}")
    load_path(mix["path"], bench_dir)
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix,
        limits=_load(os.path.join(bench_dir, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        family=family, path=mix["path"], bench_dir=bench_dir)


_MODULES: Dict[str, ModuleType] = {}


def _module(path: str, name: str) -> ModuleType:
    """The module in file `path`, executed once a process."""
    path = os.path.realpath(path)
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


def load_family(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """``families/<name>.py``."""
    return _module(os.path.join(bench_dir, "families", f"{name}.py"),
                   f"pmctf_bench_family_{name}")


def load_path(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """``paths/<name>.py``."""
    return _module(os.path.join(bench_dir, "paths", f"{name}.py"), f"pmctf_bench_path_{name}")


def reader_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    """``metrics/<name>.py`` if there is one, else ``metrics/<quantity>.py``
    (the name up to its first dot)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    if os.path.exists(path):
        return path
    return os.path.join(bench_dir, "metrics", f"{name.split('.')[0]}.py")


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable[[Dict], Optional[float]]:
    """The ``read`` function of metric `name`'s reader (``reader_path``)."""
    path = reader_path(name, bench_dir)
    spec = importlib.util.spec_from_file_location(
        "pmctf_bench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
