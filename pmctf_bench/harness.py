"""One run of one cell: set-up, the measured window, the traced GOP, the
check against the plain reference, and the result line.

The port (``learned_pmctf_tpu_torch``) is the system under test; of it
the harness takes the model, its GOP entry points, the stream codec and
its counters, and nothing else. Weights and frames are the harness's own
(weights.py, frames.py), drawn from ``--seed``.

Set-up runs from process start to one warm-up GOP of the cell's shapes.
The window then codes GOPs back to back, cycling through the run's
distinct GOPs, starting GOPs while ``--seconds`` have not passed; the
last runs to its end and counts. A rate is all frames of all GOPs over
the time from the first GOP's start to the last GOP's end. With
``--trace 1`` one more GOP runs under the profiler after the window.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from . import frames as frame_gen
from . import layers, trace
from .cells import Cell, load_cell, metric_reader
from .check import compare
from .reference.gop import code_gop as reference_gop
from .reference.model import PMCTF as ReferencePMCTF, Numerics
from .weights import make_state
from .work import Work

FORBIDDEN = ("jax", "jaxlib", "flax", "learned_pmctf_tpu")
GIB = float(2 ** 30)


def gop_seed(seed: int, d: int) -> int:
    """The seed of the run's distinct GOP d."""
    return (seed * 1_000_003 + 7919 * (d + 1)) % (2 ** 63)


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


def build_port(config: Dict, state: Dict, device):
    """The port's PMCTF on `device` with the run's weights."""
    from learned_pmctf_tpu_torch.models.pmctf import PMCTF
    with torch.device("meta"):
        model = PMCTF(**config["model"])
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.eval()


def build_reference(config: Dict, state: Dict, device, numerics: Numerics):
    with torch.device("meta"):
        ref = ReferencePMCTF(**config["model"])
    ref = ref.to_empty(device=device)
    ref.load_state_dict(state)
    return ref.attach(numerics).eval()


class EstimatePath:
    """GOPs through ``gop.code_gop``: rates estimated on the device."""

    spans = ("forward_one_stage", "inverse_mctf")

    def __init__(self, model, mix, device):
        from learned_pmctf_tpu_torch.gop import code_gop
        self.model, self.mix, self.device, self._code = model, mix, device, code_gop
        self.span_target = model

    def run(self, luma, chroma) -> Dict:
        return self._code(self.model, luma, chroma, self.mix["q_index"], device=self.device)

    def counters(self) -> Dict:
        return {}

    def reset_counters(self):
        pass

    def close(self):
        pass


class StreamPath:
    """GOPs written to .bin streams through ``PMCTFCodec`` and decoded
    from them by ``gop.stream_gop``, which holds every decoded plane equal
    to the encoder side."""

    spans = ("encode_one_stage", "inverse_mctf")

    def __init__(self, model, mix, device):
        from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
        from learned_pmctf_tpu_torch.gop import stream_gop
        self.mix, self.device, self._code = mix, device, stream_gop
        self.codec = PMCTFCodec(model, device=device)
        self.codec.update()
        self.span_target = self.codec
        self._dir = tempfile.TemporaryDirectory(prefix="pmctf_bench_")

    def run(self, luma, chroma) -> Dict:
        out = self._code(self.codec, luma, chroma, self.mix["q_index"], self._dir.name,
                         device=self.device)
        bad = {k: v for k, v in out["max_err"].items() if v != 0.0}
        if len(out["max_err"]) != len(luma) - 1 or bad:
            raise RuntimeError(f"decoded planes differ from the encoder side: {out['max_err']}")
        return out

    def counters(self) -> Dict:
        s = self.codec.stats
        return {"syncs": s.syncs, "rans_s": s.rans_encode_s + s.rans_decode_s}

    def reset_counters(self):
        self.codec.stats.reset()

    def close(self):
        self.codec.close()
        self._dir.cleanup()


PATHS = {"estimate": EstimatePath, "stream": StreamPath}


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
    `after_check(kept=, expect=, reference=, gop=)`, if given, is called
    once the check is made, with the port's outputs checked, the
    reference's, the reference model and the frames of the sampled GOP
    (calibrate.py's readings)."""
    mix, cfg = cell.mix, cell.config
    n, h, w, distinct = mix["gop"], mix["height"], mix["width"], mix["distinct_gops"]
    gen = dict(mix["frames"])
    generator = getattr(frame_gen, gen.pop("generator"))

    marks = {"start": t0, "imported": time.perf_counter()}
    with torch.device("meta"):
        shapes = ReferencePMCTF(**cfg["model"])
    state = make_state(shapes, seed, device)
    model = build_port(cfg, state, device)
    if break_port is not None:
        break_port(model)
    gops = [generator(n, h, w, device, gop_seed(seed, d), **gen) for d in range(distinct)]
    _sync(device)
    marks["weights_frames"] = time.perf_counter()
    path = PATHS[mix["path"]](model, mix, device)
    marks["path"] = time.perf_counter()
    try:
        path.run(*gops[0])                               # warm-up: every shape
        _sync(device)
        marks["warm_up"] = time.perf_counter()
        setup_s = marks["warm_up"] - t0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        path.reset_counters()
        last, gop_s = {}, []

        def step(i):
            t = time.perf_counter()
            last[i % distinct] = path.run(*gops[i % distinct])
            _sync(device)
            gop_s.append(time.perf_counter() - t)
        coded, window_s = measure_window(step, seconds)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        counters = path.counters()
        # the output checked: the last GOP of one distinct GOP the window
        # coded, drawn from the seed
        sample = gop_seed(seed, distinct) % min(distinct, coded)
        kept = [last.pop(sample)]
        last.clear()
        traced_rec = None
        if traced:
            traced_rec, out = traced_gop(path, model, gops[sample], device)
            kept.append(out)
            del out
    finally:
        path.close()
    del path, model
    gops = [g if i == sample else None for i, g in enumerate(gops)]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the plain reference, after the window and with the port's state freed
    work = Work(cfg["precision"])
    numerics = Numerics("f32", work)
    ref = build_reference(cfg, state, device, numerics)
    with layers.hooked(ref, lambda layer: numerics.layer.append(layer),
                       lambda _: numerics.layer.pop()):
        expect = reference_gop(ref, *gops[sample], mix["q_index"])
    checks = compare(kept, expect, cell.limits)
    failed = sum(not c["ok"] for c in checks["per_output"])
    if after_check is not None:
        after_check(kept=kept, expect=expect, reference=ref, gop=gops[sample])

    frames = coded * n
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
        records = {"path": mix["path"], "gop": n,
                   "window": {"seconds": window_s, "gops": coded, "frames": frames,
                              "counters": counters},
                   "work": {**work.summary(), "ops_s": work.ops_time_s()},
                   "traced": traced_rec}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=traced_rec["busy_s"], window_s=traced_rec["window_s"])
        result["breakdown"] = {"device_ops": traced_rec["device_ops"],
                               "idle_gaps": traced_rec["idle_gaps"]}
        result["trace_summary"] = {k: traced_rec[k] for k in
                                   ("layer_device_s", "device_activities", "unmatched_launches")}
    result["checks"] = checks["numbers"]
    return result


def traced_gop(path, model, gop, device):
    """One GOP under the profiler, with spans; its summaries and output."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    undo = trace.span_methods(path.span_target, path.spans, record_function)
    try:
        with trace.layer_spans(model, record_function), profile(activities=activities) as prof:
            with record_function("traced gop"):
                out = path.run(*gop)
                _sync(device)
    finally:
        undo()
    events = prof.profiler.kineto_results.events()
    rec = trace.reduce(events, trace.window_of(events, "traced gop"),
                       {layer for _, layer in layers.layer_modules(model)})
    rec["frames_traced"] = len(gop[0])
    return rec, out


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description="pMCTF-L benchmark of learned_pmctf_tpu_torch")
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

