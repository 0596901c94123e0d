"""Throughput bench of the port: the JAX package's bench.py (GOP-16
estimate at padded 1080p, bench.py's own configuration) and, with
--secondary, its two other axes (bench.py:secondary_axes: the exact-warp
estimate and benchmarks/bench_stream.py:measure_write_stream).

    python -m learned_pmctf_tpu_torch.cli.bench [--secondary]
    python -m learned_pmctf_tpu_torch.cli.bench --device cpu --gop 2 \\
        --height 64 --width 128 --runs 1 --module_kwargs '{"features": 16}'

The headline: full-width pMCTF-L with bench.py's configuration
(decomp_levels 4, num_me_stages 4, four-step LL, fast warp, bf16
activations), seeded weights (build_pmctf, seed 0), bench.py's seeded
integer frames, q_index 10; a warm-up GOP, then --runs GOPs through
gop.code_gop, each ended by a synchronize. The secondary axes:
- the same GOP with the exact warp in f32 (the configuration of the
  port's other entry points; bench.py keeps bf16 on for this axis);
- a GOP-4 written to rANS streams and decoded again (gop.stream_gop) with
  the fast warp, f32 (streams always are), on bench_stream.py's smooth
  frames, every decoded plane held bit-equal to the encoder's.
Each axis is its median frames/s over its runs (bench.py times 2 runs of
the exact warp and bench_stream.py 1 of the stream; so does this), with
the runs beside it. A failing axis raises.

Prints one JSON line. It carries the card's name and power limit (as
nvidia-smi prints them) on CUDA; bench.py's vs_baseline, a target set
for a TPU, is not carried. Runs on CUDA unless --device cpu, and raises
without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..codec.video_codec import PMCTFCodec
from ..gop import code_gop, stream_gop
from ..models.pmctf import build_pmctf
from ..ops.conv3x3 import conv3x3
from ..runtime import resolve_device

METRIC = "pmctf_gop16_1080p_estimate_fastwarp_fps"
# bench.py:57-58
BENCH_CONFIG = dict(decomp_levels=4, num_me_stages=4, ll_mode="fourstep",
                    warp_mode="fast", act_bf16=True)
Q_INDEX = 10.0
STREAM_GOP = 4


def bench_frames(gop, h, w, device):
    """bench.py's frames: seeded integer planes, luma (1,1,H,W) and chroma
    (2,1,H/2,W/2), after the draw of its init frame."""
    g = np.random.default_rng(0)
    g.integers(0, 256, (1, 1, 128, 128))
    luma = [g.integers(0, 256, (1, 1, h, w)) for _ in range(gop)]
    chroma = [g.integers(0, 256, (2, 1, h // 2, w // 2)) for _ in range(gop)]
    return ([torch.tensor(f, dtype=torch.float32, device=device) for f in luma],
            [torch.tensor(f, dtype=torch.float32, device=device) for f in chroma])


def stream_frames(gop, h, w, device):
    """bench_stream.py's smooth frames (pure noise would inflate the rANS
    work): 8x8 blocks of seeded normals around 128, plus fine noise."""
    g = np.random.default_rng(0)
    g.integers(0, 256, (1, 1, 128, 128))
    base = g.normal(0, 30, (1, 1, h // 8, w // 8))
    up = np.kron(base, np.ones((1, 1, 8, 8))) + 128.0
    luma = [np.clip(up + g.normal(0, 4, up.shape), 0, 255) for _ in range(gop)]
    chroma = [np.clip(np.kron(g.normal(0, 10, (2, 1, h // 16, w // 16)),
                              np.ones((1, 1, 8, 8))) + 128.0, 0, 255)
              for _ in range(gop)]
    return ([torch.tensor(f, dtype=torch.float32, device=device) for f in luma],
            [torch.tensor(f, dtype=torch.float32, device=device) for f in chroma])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_runs(run, runs, device):
    """`runs` runs of run() after the caller's warm-up, each ended by a
    synchronize: their wall times in ms."""
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        run()
        _sync(device)
        times.append((time.perf_counter() - t) * 1e3)
    return times


def summary(times, frames):
    """Median frames/s of the runs, with the runs and their spread."""
    ms = statistics.median(times)
    return {"value": frames / (ms / 1e3), "median_ms": ms, "runs_ms": times,
            "spread_ms": max(times) - min(times),
            "fps_range": [frames / (max(times) / 1e3), frames / (min(times) / 1e3)]}


def estimate_axis(config, gop, h, w, runs, device):
    model = build_pmctf(device, seed=0, **config)
    luma, chroma = bench_frames(gop, h, w, device)
    conv3x3.launches, conv3x3.by_variant, conv3x3.per_call_by_variant = 0, {}, {}
    code_gop(model, luma, chroma, Q_INDEX, device=device)  # warm-up, counted
    _sync(device)
    # PostProcess's launches: the priors' residual blocks are counted apart
    priors = conv3x3.per_call_by_variant
    launches = {k: n - priors.get(k, 0) for k, n in conv3x3.by_variant.items()
                if n != priors.get(k, 0)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times = timed_runs(lambda: code_gop(model, luma, chroma, Q_INDEX, device=device),
                       runs, device)
    return {**summary(times, gop), "conv3x3_launches_by_variant": launches,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None}


def stream_axis(config, h, w, runs, device):
    model = build_pmctf(device, seed=0, **config)
    luma, chroma = stream_frames(STREAM_GOP, h, w, device)
    bits = []
    with PMCTFCodec(model, device=device) as codec, \
            tempfile.TemporaryDirectory() as d:
        codec.update()

        def run():
            out = stream_gop(codec, luma, chroma, Q_INDEX, d, device=device)
            bad = {k: v for k, v in out["max_err"].items() if v != 0.0}
            if len(out["max_err"]) != STREAM_GOP - 1 or bad:
                raise AssertionError(f"decoded planes differ from the encoder "
                                     f"side: {out['max_err']}")
            bits.append(sum(v for b in out["bits"].values() for v in b.values()))

        run()  # warm-up
        times = timed_runs(run, runs, device)
    return {**summary(times, STREAM_GOP), "bits_per_gop": bits[-1],
            "decoded_equal_encoder": True}


def card(device):
    """The card's name and power limit, as nvidia-smi prints them."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="pMCTF GOP bench (PyTorch port)")
    p.add_argument("--gop", type=int, default=16)
    p.add_argument("--height", type=int, default=1152)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    p.add_argument("--module_kwargs", type=json.loads, default={},
                   help="JSON object of PMCTF arguments over bench.py's "
                        "configuration (as bench.py:main(module_kwargs=...))")
    p.add_argument("--secondary", action="store_true",
                   help="also the exact-warp f32 estimate and the stream GOP-4")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = {**BENCH_CONFIG, **args.module_kwargs}
    h, w = args.height, args.width
    out = {"metric": METRIC, "unit": "frames/s"}
    head = estimate_axis(config, args.gop, h, w, args.runs, device)
    out.update(head)
    out["config"] = {**config, "gop": args.gop, "height": h, "width": w,
                     "chroma": [2, h // 2, w // 2], "q_index": Q_INDEX,
                     "runs": args.runs, "weights": "build_pmctf seed 0",
                     "frames": "bench.py seeded integers"}
    if args.secondary:
        exact = {**config, "warp_mode": "exact", "act_bf16": False}
        streamed = {**config, "warp_mode": "fast", "act_bf16": False}
        out["secondary"] = {
            "estimate_exact_warp_f32": {
                **estimate_axis(exact, args.gop, h, w, 2, device),
                "config": {"warp_mode": "exact", "act_bf16": False,
                           "gop": args.gop}},
            "write_stream_gop4": {
                **stream_axis(streamed, h, w, 1, device),
                "config": {"warp_mode": "fast", "act_bf16": False,
                           "gop": STREAM_GOP, "frames": "bench_stream.py smooth"}}}
    out["device"] = {"type": device.type, "card": card(device),
                     "kind": torch.cuda.get_device_name(device)
                     if device.type == "cuda" else None}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
