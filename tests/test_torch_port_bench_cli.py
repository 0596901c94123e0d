"""The port's bench (learned_pmctf_tpu_torch.cli.bench), the port of
bench.py:main and benchmarks/bench_stream.py:measure_write_stream, on
the CPU at a small size, in its own process: one JSON line with the
headline's keys and no vs_baseline (a target set for a TPU)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from learned_pmctf_tpu_torch.cli import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"decomp_levels": 2, "num_me_stages": 2, "channel_mv": 8, "channel_n": 8,
         "features": 16, "ar_features": 16}
KEYS = {"metric", "value", "unit", "median_ms", "runs_ms", "spread_ms", "fps_range",
        "conv3x3_launches_by_variant", "peak_mem_bytes", "config", "device"}


def run_bench(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "learned_pmctf_tpu_torch.cli.bench", "--device", "cpu",
         "--module_kwargs", json.dumps(SMALL), *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


def test_bench_prints_one_json_line_on_the_cpu():
    out = run_bench("--gop", "2", "--height", "64", "--width", "128", "--runs", "1")
    assert set(out) == KEYS and "vs_baseline" not in out
    assert out["metric"] == "pmctf_gop16_1080p_estimate_fastwarp_fps"
    assert out["unit"] == "frames/s" and len(out["runs_ms"]) == 1
    assert np.isclose(out["value"], 2 / (out["median_ms"] / 1e3))
    cfg = out["config"]
    assert (cfg["warp_mode"], cfg["act_bf16"], cfg["ll_mode"]) == ("fast", True, "fourstep")
    assert (cfg["gop"], cfg["height"], cfg["width"], cfg["chroma"]) == (2, 64, 128, [2, 32, 64])
    assert cfg["features"] == 16 and cfg["num_me_stages"] == 2
    assert out["device"] == {"type": "cpu", "card": None, "kind": None}
    assert out["peak_mem_bytes"] is None
    assert out["conv3x3_launches_by_variant"] == {}  # the CPU runs the plain version


def test_bench_secondary_axes_on_the_cpu():
    """--secondary: the exact-warp f32 estimate (2 runs) and the fast-warp
    stream GOP-4 (1 run), every decoded plane equal to the encoder's."""
    out = run_bench("--gop", "2", "--height", "128", "--width", "128", "--runs", "1",
                    "--secondary")
    sec = out["secondary"]
    exact, stream = sec["estimate_exact_warp_f32"], sec["write_stream_gop4"]
    assert exact["config"] == {"warp_mode": "exact", "act_bf16": False, "gop": 2}
    assert len(exact["runs_ms"]) == 2 and exact["value"] > 0
    assert stream["config"]["gop"] == 4 and stream["config"]["warp_mode"] == "fast"
    assert stream["decoded_equal_encoder"] and stream["bits_per_gop"] > 0
    assert len(stream["runs_ms"]) == 1 and stream["value"] > 0


def test_bench_frames_are_bench_py_frames():
    """bench.py:75-78 draws its frames after its init frame from
    default_rng(0); bench_stream.py:51-60 its smooth frames the same way."""
    luma, chroma = bench.bench_frames(2, 16, 32, "cpu")
    g = np.random.default_rng(0)
    g.integers(0, 256, (1, 1, 128, 128))
    want = [g.integers(0, 256, (1, 1, 16, 32)) for _ in range(2)]
    want_c = [g.integers(0, 256, (2, 1, 8, 16)) for _ in range(2)]
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(luma, want))
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(chroma, want_c))
    sl, sc = bench.stream_frames(4, 128, 256, "cpu")
    assert len(sl) == len(sc) == 4 and sl[0].shape == (1, 1, 128, 256)
    assert sc[0].shape == (2, 1, 64, 128)
    assert float(sl[0].min()) >= 0 and float(sl[0].max()) <= 255


def test_bench_raises_without_a_card():
    if bench.torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--gop", "2"])
