"""Find a cell's files by name.

A cell of BENCHMARK.json is ``<config>.<mix>``: its configuration is the
file that the ``configs`` entry names (``configs/<config>.json``), its
traffic ``traffic/<mix>.json``, the limits of its correctness check
``limits/<cell>.json``, and each per-layer metric a reader
``metrics/<metric>.py`` with a function ``read(records)``, or, where no
such file is, the reader of its quantity, ``metrics/<quantity>.py``: a
metric ``<quantity>.<suffix>`` is one quantity split by the end-to-end
metric its cells report (``idle_pct.estimate`` and ``idle_pct.stream``
both read ``metrics/idle_pct.py``). Adding a
configuration, a mix, a cell or a metric adds files and entries; no file
of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict
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
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load(os.path.join(root, configs[w["config"]]["file"])),
        mix=_load(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
        limits=_load(os.path.join(bench_dir, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


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
