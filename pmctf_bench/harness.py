"""One run of one cell: set-up, the measured window, the traced input,
the check against the plain reference, and the result line.

The port (``learned_pmctf_tpu_torch``) is the system under test. The
cell's family (families/<family>.py, cells.py) supplies the port's model
and the plain reference, the run's inputs and the layer table; its path
(paths/<path>.py) runs the port's entry point on one input. Weights and
inputs are the harness's own (weights.py, the family's generator), drawn
from ``--seed``.

Set-up runs from process start to one warm-up run of the cell's shapes.
The window then runs the inputs back to back, cycling through the run's
distinct inputs, starting one while ``--seconds`` have not passed; the
last runs to its end and counts. A rate is all frames of all inputs over
the time from the first input's start to the last one's end. With
``--trace 1`` one more input runs under the profiler after the window.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from . import layers, trace
from .cells import Cell, load_cell, load_family, load_path, metric_reader
from .check import compare
from .frames import input_seed
from .reference.model import Numerics
from .weights import make_state
from .work import Work

FORBIDDEN = ("jax", "jaxlib", "flax", "learned_pmctf_tpu")
GIB = float(2 ** 30)


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def card(device: torch.device) -> Dict:
    """The card's name, count and power limit (nvidia-smi's words)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "power_limit": limit[device.index or 0] if limit else "not read"}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _loaded(build: Callable[[], torch.nn.Module], state: Dict, device) -> torch.nn.Module:
    """The module `build` makes on the meta device, on `device` with the
    run's weights."""
    with torch.device("meta"):
        model = build()
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.eval()


def measure_window(step: Callable[[int], None], seconds: float,
                   clock: Callable[[], float] = time.perf_counter):
    """Call step(0), step(1), ... while `seconds` have not passed since
    the first began (the first always runs); the last runs to its end.
    Returns (steps, seconds from the first's start to the last's end): a
    rate is steps over all that time, stalls included."""
    start, count = clock(), 0
    while count == 0 or clock() - start < seconds:
        step(count)
        count += 1
    return count, clock() - start


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float, break_port: Optional[Callable] = None,
        after_check: Optional[Callable] = None) -> Dict:
    """One run of `cell`. `break_port(model)` plants a fault in the port
    (the tests' broken runs); `t0` is the process's start (perf_counter).
    `after_check(kept=, expect=, reference=, sample=)`, if given, is
    called once the check is made, with the port's outputs checked, the
    reference's, the reference model and the sampled input (calibrate.py's
    readings)."""
    mix, cfg = cell.mix, cell.config
    family = load_family(cell.family, cell.bench_dir)
    per_input = family.frames(mix)

    marks = {"start": t0, "imported": time.perf_counter()}
    with torch.device("meta"):
        shapes = family.reference_model(cfg)
    state = make_state(shapes, seed, device)
    model = _loaded(lambda: family.port_model(cfg), state, device)
    if break_port is not None:
        break_port(model)
    inputs = family.inputs(mix, seed, device)
    distinct = len(inputs)
    _sync(device)
    marks["weights_frames"] = time.perf_counter()
    path = load_path(cell.path, cell.bench_dir).build(model, mix, device)
    marks["path"] = time.perf_counter()
    try:
        path.run(*inputs[0])                             # warm-up: every shape
        _sync(device)
        marks["warm_up"] = time.perf_counter()
        setup_s = marks["warm_up"] - t0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        path.reset_counters()
        last, gop_s = {}, []

        def step(i):
            t = time.perf_counter()
            last[i % distinct] = path.run(*inputs[i % distinct])
            _sync(device)
            gop_s.append(time.perf_counter() - t)
        coded, window_s = measure_window(step, seconds)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        counters = path.counters()
        # the output checked: the last run of one distinct input the
        # window ran, drawn from the seed
        sample = input_seed(seed, distinct) % min(distinct, coded)
        kept = [last.pop(sample)]
        last.clear()
        traced_rec = None
        if traced:
            traced_rec, out = traced_input(path, model, inputs[sample], device, family,
                                           per_input)
            kept.append(out)
            del out
    finally:
        path.close()
    del path, model
    inputs = [x if i == sample else None for i, x in enumerate(inputs)]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the plain reference, after the window and with the port's state freed
    work = Work(cfg["precision"])
    numerics = Numerics("f32", work)
    ref = family.attach(_loaded(lambda: family.reference_model(cfg), state, device), numerics)
    with layers.hooked(ref, lambda layer: numerics.layer.append(layer),
                       lambda _: numerics.layer.pop(), family):
        expect = family.reference_output(ref, inputs[sample], mix)
    checks = compare(kept, expect, cell.limits)
    failed = sum(not c["ok"] for c in checks["per_output"])
    if after_check is not None:
        after_check(kept=kept, expect=expect, reference=ref, sample=inputs[sample])

    frames = coded * per_input
    e2e = {"setup_s": setup_s, "peak_mem_gib": peak / GIB, mix["rate_metric"]: frames / window_s}
    metrics = {}
    if not traced:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": checks["correct"], "attempted": coded, "failed": failed,
              "metrics": metrics, "device": {**card(device), "memory_peak_bytes": peak},
              "setup_split_s": {k: marks[k] - marks[p] for p, k in
                                zip(list(marks), list(marks)[1:])},
              "gop_s": gop_s}
    if traced:
        records = {"path": cell.path, "gop": per_input,
                   "window": {"seconds": window_s, "gops": coded, "frames": frames,
                              "counters": counters},
                   "work": {**work.summary(), "ops_s": work.ops_time_s()},
                   "traced": traced_rec}
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.bench_dir)(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=traced_rec["busy_s"], window_s=traced_rec["window_s"])
        result["breakdown"] = {"device_ops": traced_rec["device_ops"],
                               "idle_gaps": traced_rec["idle_gaps"]}
        result["trace_summary"] = {k: traced_rec[k] for k in
                                   ("layer_device_s", "device_activities", "unmatched_launches")}
    result["checks"] = checks["numbers"]
    return result


def traced_input(path, model, inp, device, family, per_input: int):
    """One input under the profiler, with spans; its summaries and output."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    undo = trace.span_methods(path.span_target, path.spans, record_function)
    try:
        with trace.layer_spans(model, record_function, family), \
                profile(activities=activities) as prof:
            with record_function("traced gop"):
                out = path.run(*inp)
                _sync(device)
    finally:
        undo()
    events = prof.profiler.kineto_results.events()
    rec = trace.reduce(events, trace.window_of(events, "traced gop"),
                       {layer for _, layer in layers.layer_modules(model, family)})
    rec["frames_traced"] = per_input
    return rec, out


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description="the benchmark of learned_pmctf_tpu_torch")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

