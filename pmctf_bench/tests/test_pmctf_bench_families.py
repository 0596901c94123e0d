"""A model of another architecture added as files: a still-image family
and its path, written into a checkout of the benchmark, run end to end
through ``harness.run`` with no file of the harness edited. The port's
pWave (four-step LL, tiny widths) codes 64x64 stills; the plain
reference's pWave judges them; a sound run is correct and a run with the
family's planted fault is not."""

import hashlib
import json
import shutil
import time

import pytest
import torch
from conftest import ROOT

from pmctf_bench import faults
from pmctf_bench.cells import BENCH_DIR, load_cell, load_family
from pmctf_bench.harness import run

FAMILY = '''"""Toy stills: the pWave image coder alone, on one picture a run."""
import torch

from pmctf_bench import frames as frame_gen
from pmctf_bench.reference.model import Conv2d, PWave as ReferencePWave

PATHS = ("toy_still",)


def reference_model(config):
    return ReferencePWave(**config["model"])


def attach(reference, numerics):
    for m in reference.modules():
        if isinstance(m, Conv2d):
            m.numerics = numerics
    return reference


def port_model(config):
    from learned_pmctf_tpu_torch.models.pwave import PWave
    return PWave(**config["model"])


def inputs(mix, seed, device):
    out = []
    for d in range(mix["distinct"]):
        luma, chroma = frame_gen.smooth_moving(1, mix["height"], mix["width"], device,
                                               frame_gen.input_seed(seed, d))
        out.append((luma[0], chroma[0]))
    return out


def frames(mix):
    return 1


@torch.no_grad()
def reference_output(reference, inp, mix):
    y, c = (reference(x, mix["q_index"]) for x in inp)
    return {"bits": {0: {"bits": float(y["bits"]) + float(c["bits"])}},
            "luma": [y["x_hat"]], "chroma": [c["x_hat"]]}


def layer_modules(model):
    out = [(m, "priors") for bands in model.context_fusion for m in bands.values()]
    return out + [(model.dequantModule, "postprocess")]


def altered(model):
    forward = model.forward

    def broken(x, *a, **k):
        out = dict(forward(x, *a, **k))
        out["x_hat"] = out["x_hat"].clone()
        out["x_hat"][..., :16, :16] += 2.0
        return out
    model.forward = broken


MODEL_FAULTS = {"altered": altered}
GLOBAL_FAULTS = {}
'''

PATH = '''"""Toy stills through the port's pWave: luma, then chroma."""
import torch


class StillPath:
    spans = ()

    def __init__(self, model, mix, device):
        self.model, self.mix, self.span_target = model, mix, model

    @torch.no_grad()
    def run(self, luma, chroma):
        y, c = (self.model(x, self.mix["q_index"]) for x in (luma, chroma))
        return {"bits": {0: {"bits": float(y["bits"].sum()) + float(c["bits"].sum())}},
                "luma": [y["x_hat"]], "chroma": [c["x_hat"]]}

    def counters(self):
        return {}

    def reset_counters(self):
        pass

    def close(self):
        pass


build = StillPath
'''

CELL = "toy_pwave.toy_still_64"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A checkout with the toy family, path, configuration, mix, limits
    and cell added as files and entries; the harness's files hashed
    before and after."""
    root = tmp_path_factory.mktemp("checkout")
    d = root / "pmctf_bench"
    shutil.copytree(BENCH_DIR, d, ignore=shutil.ignore_patterns("__pycache__"))
    harness_files = sorted(d.rglob("*.py"))
    before = [hashlib.sha256(p.read_bytes()).hexdigest() for p in harness_files]
    (d / "families" / "toy_pwave.py").write_text(FAMILY)
    (d / "paths" / "toy_still.py").write_text(PATH)
    json.dump({"name": "toy_pwave", "family": "toy_pwave", "precision": "f32",
               "control": "tf32", "model": {"decomp_levels": 2, "features": 16,
                                            "ar_features": 16}},
              open(d / "configs" / "toy_pwave.json", "w"))
    json.dump({"path": "toy_still", "height": 64, "width": 64, "q_index": 10.0,
               "distinct": 2, "rate_metric": "toy_still_fps"},
              open(d / "traffic" / "toy_still_64.json", "w"))
    json.dump({"bits_gap": 1e-4, "plane_rmse": 0.01}, open(d / "limits" / f"{CELL}.json", "w"))
    b = json.load(open(f"{ROOT}/BENCHMARK.json"))
    b["configs"].append({"name": "toy_pwave", "source": "x", "reduced": [], "why": "x",
                         "file": "pmctf_bench/configs/toy_pwave.json"})
    b["workloads"].append({"name": CELL, "config": "toy_pwave", "traffic": "toy_still_64",
                           "chips": 1, "why": "x"})
    b["end_to_end"].append({"name": "toy_still_fps", "unit": "frames/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": [CELL]})
    json.dump(b, open(root / "BENCHMARK.json", "w"))
    yield root
    assert [hashlib.sha256(p.read_bytes()).hexdigest() for p in harness_files] == before


@pytest.mark.parametrize("fault", [None, "altered"])
def test_toy_still_family_runs_through_the_harness(checkout, fault):
    cell = load_cell(CELL, root=str(checkout))
    assert (cell.family, cell.path) == ("toy_pwave", "toy_still")
    family = load_family(cell.family, cell.bench_dir)
    with faults.planted(fault, family) as break_port:
        result = run(cell, 2 ** 31 + 303, 0.2, False, torch.device("cpu"), time.perf_counter(),
                     break_port=break_port)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"toy_still_fps", "setup_s"}
    if fault is None:
        assert result["checks"]["plane_rmse"]["value"] == 0.0
    else:
        assert result["checks"]["plane_rmse"]["value"] > 0.1
