"""BENCHMARK.json against the contract's shape, discovery of cells,
configurations, mixes and metrics by name, and what the benchmark imports."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

from pmctf_bench.cells import (BENCH_DIR, load_cell, load_family, load_path, metric_reader,
                               reader_path)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "learned_pmctf_tpu"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["pmctf_bench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert os.path.exists(reader_path(m["name"]))
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in load_cell(w).end_to_end}, (m, w)
    for w in b["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] == 1
        assert len(w["why"]) <= 200
        cell = load_cell(w["name"])
        assert cell.mix["rate_metric"] in {m["name"] for m in cell.end_to_end}
        assert cell.per_layer


def test_new_files_are_found_without_editing(tmp_path):
    """A configuration, a mix, a cell, a metric, a family and a path added
    as files (and entries in BENCHMARK.json) are found; no file of the
    harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "pmctf_bench", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    before = {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
              for p in (root / "pmctf_bench").rglob("*.py")}
    d = root / "pmctf_bench"
    cfg = json.load(open(d / "configs" / "pmctf_l_f32.json"))
    json.dump({**cfg, "name": "pmctf_l_new"}, open(d / "configs" / "pmctf_l_new.json", "w"))
    mix = json.load(open(d / "traffic" / "estimate_gop16_1080p.json"))
    json.dump({**mix, "gop": 2}, open(d / "traffic" / "new_mix.json", "w"))
    json.dump({"plane_rmse": 1.0}, open(d / "limits" / "pmctf_l_new.new_mix.json", "w"))
    (d / "metrics" / "new_metric.x.py").write_text("def read(rec):\n    return 42.0\n")
    b["configs"].append({"name": "pmctf_l_new", "source": "x", "reduced": [], "why": "x",
                         "file": "pmctf_bench/configs/pmctf_l_new.json"})
    b["workloads"].append({"name": "pmctf_l_new.new_mix", "config": "pmctf_l_new",
                           "traffic": "new_mix", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "new_metric.x", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "x", "moves": "estimate_fps",
                           "workloads": ["pmctf_l_new.new_mix"]})
    json.dump(b, open(root / "BENCHMARK.json", "w"))
    cell = load_cell("pmctf_l_new.new_mix", root=str(root))
    assert cell.config["name"] == "pmctf_l_new" and cell.mix["gop"] == 2
    assert cell.limits == {"plane_rmse": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.x"]
    assert metric_reader("new_metric.x", str(d))({}) == 42.0
    # a quantity split by its cells' end-to-end metric: new_metric.y has
    # no file of its own and reads metrics/new_metric.py
    (d / "metrics" / "new_metric.py").write_text("def read(rec):\n    return 7.0\n")
    assert metric_reader("new_metric.y", str(d))({}) == 7.0
    assert metric_reader("new_metric.x", str(d))({}) == 42.0
    # a family and a path: a configuration names the one, a mix the other
    (d / "families" / "new_family.py").write_text(
        "PATHS = ('new_path',)\nMODEL_FAULTS, GLOBAL_FAULTS = {}, {}\n")
    (d / "paths" / "new_path.py").write_text("def build(model, mix, device):\n    return 'p'\n")
    json.dump({**cfg, "name": "new_family_cfg", "family": "new_family"},
              open(d / "configs" / "new_family_cfg.json", "w"))
    json.dump({**mix, "path": "new_path"}, open(d / "traffic" / "new_path_mix.json", "w"))
    json.dump({"plane_rmse": 1.0}, open(d / "limits" / "new_family_cfg.new_path_mix.json", "w"))
    b["configs"].append({"name": "new_family_cfg", "source": "x", "reduced": [], "why": "x",
                         "file": "pmctf_bench/configs/new_family_cfg.json"})
    b["workloads"].append({"name": "new_family_cfg.new_path_mix", "config": "new_family_cfg",
                           "traffic": "new_path_mix", "chips": 1, "why": "x"})
    json.dump(b, open(root / "BENCHMARK.json", "w"))
    cell = load_cell("new_family_cfg.new_path_mix", root=str(root))
    assert (cell.family, cell.path, cell.bench_dir) == ("new_family", "new_path", str(d))
    assert load_family(cell.family, cell.bench_dir).PATHS == ("new_path",)
    assert load_path(cell.path, cell.bench_dir).build(None, None, None) == "p"
    # a family is refused a path it does not take, before any set-up
    b["workloads"].append({"name": "pmctf_l_new.new_path_mix", "config": "pmctf_l_new",
                           "traffic": "new_path_mix", "chips": 1, "why": "x"})
    json.dump(b, open(root / "BENCHMARK.json", "w"))
    with pytest.raises(ValueError, match="family 'pmctf_l' takes the paths"):
        load_cell("pmctf_l_new.new_path_mix", root=str(root))
    after = {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
             for p in (root / "pmctf_bench").rglob("*.py")
             if p.name not in ("new_metric.x.py", "new_metric.py", "new_family.py",
                               "new_path.py")}
    assert after == before


CELLS = {"pmctf_l_f32.estimate_gop16_1080p": "estimate",
         "pmctf_l_bf16.estimate_gop8_2160p": "estimate",
         "pmctf_l_f32.stream_gop4_1080p": "stream"}


def test_cells_resolve_to_their_family_and_path():
    assert {w["name"] for w in bench()["workloads"]} == set(CELLS)
    for name, path in CELLS.items():
        cell = load_cell(name)
        assert "family" not in cell.config and (cell.family, cell.path) == ("pmctf_l", path)
        assert cell.path in load_family(cell.family).PATHS
        assert callable(load_path(cell.path).build)


# the harness's own files: the whole model is the family's, the entry
# points the paths'
GENERIC = ("harness.py", "layers.py", "trace.py", "work.py", "weights.py", "check.py", "cells.py")
MODEL_NAMES = re.compile(r"\b(PMCTF|PWave|code_gop|stream_gop)\b")


@pytest.mark.parametrize("name", GENERIC)
def test_harness_names_no_model_and_no_entry_point(name):
    text = open(os.path.join(BENCH_DIR, name)).read()
    assert not MODEL_NAMES.findall(text), name


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_reference_nothing_of_the_port():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & FORBIDDEN, path
            if os.sep + "reference" + os.sep in path:
                assert "learned_pmctf_tpu_torch" not in tops, path


def test_loaded_modules():
    """What the reference loads, and what a run loads, by top-level name."""
    code = ("import sys, json; sys.path.insert(0, %r); "
            "import pmctf_bench.reference.gop, pmctf_bench.reference.model; "
            "ref = sorted({m.split('.')[0] for m in sys.modules}); "
            "import pmctf_bench.harness, learned_pmctf_tpu_torch.gop, "
            "learned_pmctf_tpu_torch.codec.video_codec; "
            "run = sorted({m.split('.')[0] for m in sys.modules}); "
            "print(json.dumps([ref, run]))" % ROOT)
    ref, run = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True,
                                         text=True, check=True, cwd=ROOT).stdout)
    assert "learned_pmctf_tpu_torch" not in ref and not set(ref) & FORBIDDEN
    assert "learned_pmctf_tpu_torch" in run and not set(run) & FORBIDDEN


def test_run_refuses_without_a_card():
    """No CUDA card here: the command exits with 2 and prints no result."""
    import torch
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "pmctf_bench/run.py", "--workload",
                        "pmctf_l_f32.estimate_gop16_1080p", "--seed", "3000000000",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    root = tmp_path / "alone"
    shutil.copytree(BENCH_DIR, root / "pmctf_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    p = subprocess.run([sys.executable, "pmctf_bench/run.py", "--workload",
                        "pmctf_l_f32.estimate_gop16_1080p", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=root, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
