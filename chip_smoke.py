"""Chip smoke test of the PyTorch/CUDA port (learned_pmctf_tpu_torch).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. device: requires CUDA, prints the card's name and power limit,
   turns TF32 off;
2. build: compiles the conv3x3 CUDA kernels from csrc/ with nvcc (one
   nvcc a source, together) and reports ptxas' registers and spills;
3. kernel: at the main path's six shapes and at two shapes of the next
   slice, holds every variant that takes the shape against the plain
   PyTorch version (1e-3) and a float64 reference (1e-4: one TF32
   product would miss it), launches it twice for bit-equality, and times
   it beside the plain version, one cuDNN F.conv2d call (a yardstick the
   port never calls) and the bound of the unit it runs on;
4. small reference: a GOP-4 of a small model at 64x64 on the card
   against the same model on the CPU (the CPU path is what the tests
   hold against the JAX package);
5. slice: the full-width pMCTF-L (seeded random weights) codes a GOP-4
   of padded-1080p frames through code_gop; the conv3x3 launches of
   that run are counted, then the GOP is timed, and run once more with
   PostProcess on the plain version to compare the reconstructions; a
   GOP-16 (bench.py's length) is timed once, with its launches counted;
6. profile: one more GOP under torch.profiler, its device time split by
   layer (SpyNet, MV coding, lifting, LSTM context, four-step priors,
   PostProcess) and the device's idle share.

Then it prints the variants the main path did not take, the kernels line
(one entry a variant the main path launched) and, last,
{"ok": true, "device": ...}.
"""

import json
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# H100 SXM, dense, at the 700 W limit (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
TENSOR_VARIANTS = ("mma_sync_3xtf32", "wgmma_3xtf32")
KERNEL_TOL = 1e-3  # against the plain version (cuDNN f32, TF32 off)
F64_TOL = 1e-4     # against float64: one TF32 product errs by ~1.6e-3 here
GOP = 4
LUMA = (1152, 1920)  # 1080p padded to a multiple of 128


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=10):
    """Median time of fn on the card, in ms, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from learned_pmctf_tpu_torch.runtime import disable_tf32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    disable_tf32()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def parse_ptxas(log):
    """ptxas -v output -> one entry a kernel: registers and spill bytes."""
    entries, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            entries.append({"kernel": name})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entries[-1]["spill_stores"] = int(m.group(1))
            entries[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[-1]["registers"] = int(m.group(1))
    return entries


def phase_build():
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3
    t0 = time.perf_counter()
    log = c3.build(force=True)
    seconds = time.perf_counter() - t0
    ptxas = parse_ptxas(log)
    if not ptxas:
        raise AssertionError(f"no ptxas report in the build log:\n{log}")
    emit({"phase": "build", "kernel": "conv3x3", "seconds": seconds,
          "sources": [src.split("learned_pmctf_tpu_torch/")[-1]
                      for src in c3.SOURCES],
          "ptxas": ptxas})


def conv_bound(n, c, o, h, w, residual, variant):
    """Least time the card could take, in ms: the larger of bytes over the
    memory rate and operations over the peak rate of the unit the variant
    runs on (a tensor-core variant does three TF32 products)."""
    flops = 2.0 * n * h * w * 9 * c * o
    nbytes = 4.0 * (n * c * h * w + o * c * 9 + o + n * o * h * w
                    * (2 if residual else 1))
    t_f32 = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    if variant in TENSOR_VARIANTS:
        t_ops, unit = 3 * flops / PEAK_TF32_FLOPS * 1e3, "3 TF32 products, tensor cores"
    else:
        t_ops, unit = t_f32, "f32 cores"
    by = f"operations ({unit})" if t_ops >= t_bytes else "bytes"
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": by,
            "f32_core_bound_ms": max(t_f32, t_bytes)}


def measure_conv(label, n, c, o, hh, ww, act, res, g):
    """One shape of the kernel phase: the variant conv3x3 takes, held
    against the plain version and a float64 reference, launched twice for
    determinism, and timed beside the plain version, one cuDNN call and
    the other variants that take the shape."""
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3
    x = torch.randn(n, c, hh, ww, device="cuda", generator=g)
    wt = torch.randn(o, c, 3, 3, device="cuda", generator=g) / (3 * c ** 0.5)
    b = torch.randn(o, device="cuda", generator=g) * 0.1
    r = torch.randn(n, o, hh, ww, device="cuda", generator=g) if res else None
    variant, *others = c3.variants_for(c, o, ww)
    plain = c3.conv3x3_plain(x, wt, b, act=act, residual=r)
    ref64 = c3.conv3x3_plain(x.double(), wt.double(), b.double(), act=act,
                             residual=None if r is None else r.double())
    row = {"phase": "kernel", "name": "conv3x3", "shape": label,
           "x": [n, c, hh, ww], "o": o, "variant": variant, "tol": KERNEL_TOL,
           "f64_tol": F64_TOL,
           "plain_err_f64": float((plain.double() - ref64).abs().max())}
    for v in [variant] + others:
        run = lambda: c3.conv3x3_variant(v, x, wt, b, act=act, residual=r)  # noqa: E731
        y = run()
        torch.cuda.synchronize()
        err = float((y - plain).abs().max())
        err64 = float((y.double() - ref64).abs().max())
        same = torch.equal(y, run())
        if not err <= KERNEL_TOL:
            raise AssertionError(f"conv3x3 {label} {v}: max abs err {err} > {KERNEL_TOL}")
        if not err64 <= F64_TOL:
            raise AssertionError(f"conv3x3 {label} {v}: err {err64} against float64 > {F64_TOL}")
        if not same:
            raise AssertionError(f"conv3x3 {label} {v}: two launches differ")
        ms = cuda_ms(run)
        if v == variant:
            row.update({"max_abs_err": err, "err_f64": err64,
                        "deterministic": same, "ms": ms})
        else:
            row.update({f"{v}_ms": ms, f"{v}_max_abs_err": err,
                        f"{v}_err_f64": err64})
        del y
    del ref64, plain
    row["plain_ms"] = cuda_ms(lambda: c3.conv3x3_plain(x, wt, b, act=act, residual=r))
    row["library_ms"] = cuda_ms(lambda: F.conv2d(x, wt, b, padding=1))
    row.update(conv_bound(n, c, o, hh, ww, res, variant))
    if not row["ms"] >= row["bound_ms"]:
        raise AssertionError(f"conv3x3 {label}: {row['ms']} ms is under its "
                             f"bound {row['bound_ms']} ms")
    emit(row)
    return row


def phase_kernel():
    """The six shapes of the main path, then two shapes the main path does
    not send to the kernel yet (the four-step priors' 112 and 128
    channels at the level-1 subband plane), measured for the next slice."""
    h, w = LUMA
    cases = [  # (label, n, c, o, h, w, act, residual)
        ("luma 64->64 leaky_relu", 1, 64, 64, h, w, "leaky_relu", False),
        ("luma 64->64 residual", 1, 64, 64, h, w, None, True),
        ("luma 1->64", 1, 1, 64, h, w, None, False),
        ("luma 64->1", 1, 64, 1, h, w, None, False),
        ("chroma 64->64 leaky_relu", 2, 64, 64, h // 2, w // 2, "leaky_relu", False),
        ("chroma 64->64 residual", 2, 64, 64, h // 2, w // 2, None, True),
        ("subband 112->112 leaky_relu (off the main path)", 1, 112, 112,
         h // 2, w // 2, "leaky_relu", False),
        ("subband 128->128 leaky_relu (off the main path)", 1, 128, 128,
         h // 2, w // 2, "leaky_relu", False),
    ]
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = [measure_conv(*case, g) for case in cases]
    torch.cuda.empty_cache()
    return rows


def synthetic_gop(n, h, w, device, seed=0):
    """n smooth 8-bit frames moving by (2, 3) px per frame, made on the
    device: luma (1,1,H,W) and chroma (2,1,H/2,W/2)."""
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn(1, 1, h + 4 * n + 8, w + 6 * n + 8, device=device,
                       generator=g) * 40 + 128
    base = F.avg_pool2d(base, 5, stride=1)
    luma, chroma = [], []
    for t in range(n):
        y = base[..., 2 * t:2 * t + h, 3 * t:3 * t + w]
        y = y + torch.randn(y.shape, device=device, generator=g) * 2
        c = F.avg_pool2d(base[..., 2 * t:2 * t + h, 3 * t:3 * t + w], 2)
        c = torch.cat([c, 255 - c]) + torch.randn(
            (2, 1, h // 2, w // 2), device=device, generator=g) * 2
        luma.append(y.clamp(0, 255).contiguous())
        chroma.append(c.clamp(0, 255).contiguous())
    return luma, chroma


def compare_gops(a, b, what, bits_rel=1e-4, rec_abs=5e-2):
    for fi, bits in b["bits"].items():
        for key, r in bits.items():
            o = a["bits"][fi][key]
            if not abs(o - r) <= bits_rel * max(abs(r), 1.0):
                raise AssertionError(f"{what}: frame {fi} {key} {o} vs {r}")
    err = 0.0
    for plane in ("luma", "chroma"):
        for x, y in zip(a[plane], b[plane]):
            err = max(err, float((x.cpu() - y.cpu()).abs().max()))
    if not err < rec_abs:
        raise AssertionError(f"{what}: reconstructions differ by {err}")
    return err


def phase_small_reference():
    from learned_pmctf_tpu_torch.gop import code_gop
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    cfg = dict(decomp_levels=2, num_me_stages=2, channel_mv=8, channel_n=8,
               features=16, ar_features=16)
    luma, chroma = synthetic_gop(GOP, 64, 64, "cpu", seed=1)
    on_cpu = code_gop(build_pmctf("cpu", seed=1, **cfg), luma, chroma, 10.0,
                      device="cpu")
    on_card = code_gop(build_pmctf("cuda", seed=1, **cfg), luma, chroma, 10.0)
    err = compare_gops(on_card, on_cpu, "small GOP-4, card vs CPU")
    emit({"phase": "small_reference", "gop": GOP, "size": [64, 64],
          "max_abs_recon_diff": err, "bits_rel_tol": 1e-4, "recon_abs_tol": 5e-2})


def check_outputs(out, h, w):
    for fi in range(len(out["luma"])):
        y, c = out["luma"][fi], out["chroma"][fi]
        if tuple(y.shape) != (1, 1, h, w) or tuple(c.shape) != (2, 1, h // 2, w // 2):
            raise AssertionError(f"frame {fi}: shapes {y.shape} {c.shape}")
        if not (torch.isfinite(y).all() and torch.isfinite(c).all()):
            raise AssertionError(f"frame {fi}: non-finite reconstruction")
    bits = [v for b in out["bits"].values() for v in b.values()]
    if not all(v > 0 and v == v and v != float("inf") for v in bits):
        raise AssertionError(f"bad bit estimates {bits}")


def phase_slice(smi):
    from learned_pmctf_tpu_torch.gop import code_gop
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    from learned_pmctf_tpu_torch.models.postprocess import PostProcess
    from learned_pmctf_tpu_torch.ops.conv3x3 import conv3x3, variants_for
    h, w = LUMA
    t0 = time.perf_counter()
    model = build_pmctf("cuda", seed=0, num_me_stages=4)
    build_s = time.perf_counter() - t0
    luma, chroma = synthetic_gop(GOP, h, w, "cuda")

    def run():
        out = code_gop(model, luma, chroma, 10.0)
        torch.cuda.synchronize()
        return out

    run()  # warm-up
    conv3x3.launches, conv3x3.by_variant = 0, {}
    out = run()
    launches, by_variant = conv3x3.launches, dict(conv3x3.by_variant)
    if launches != 15 * 2 * GOP:
        raise AssertionError(f"conv3x3 launched {launches} times, "
                             f"expected {15 * 2 * GOP}")
    # a PostProcess call: one 1->64 conv, thirteen 64->64, one 64->1
    expected = {variants_for(1, 64, w)[0]: 2 * GOP,
                variants_for(64, 64, w)[0]: 13 * 2 * GOP,
                variants_for(64, 1, w)[0]: 2 * GOP}
    if by_variant != expected:
        raise AssertionError(f"launches by variant {by_variant}, expected {expected}")
    check_outputs(out, h, w)

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        run()
        times.append((time.perf_counter() - t) * 1e3)
    gop_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()

    # GOP-16, the length bench.py codes: one cold run of its 15 pairs
    luma16, chroma16 = synthetic_gop(16, h, w, "cuda", seed=2)
    conv3x3.launches = 0
    t = time.perf_counter()
    out16 = code_gop(model, luma16, chroma16, 10.0)
    torch.cuda.synchronize()
    gop16_ms = (time.perf_counter() - t) * 1e3
    launches16 = conv3x3.launches
    if launches16 != 15 * 2 * 16:
        raise AssertionError(f"GOP-16: conv3x3 launched {launches16} times")
    check_outputs(out16, h, w)
    del luma16, chroma16, out16

    posts = [m for m in model.modules() if isinstance(m, PostProcess)]
    for m in posts:
        m.use_kernel = False
    t = time.perf_counter()
    plain = run()
    plain_gop_ms = (time.perf_counter() - t) * 1e3
    for m in posts:
        m.use_kernel = True
    diff = compare_gops(out, plain, "GOP-4, kernel vs plain PostProcess")
    emit({"phase": "slice", "model": "pMCTF-L full width (seeded random weights)",
          "gop": GOP, "luma": [h, w], "chroma": [2, h // 2, w // 2],
          "q_index": 10, "model_build_s": build_s,
          "conv3x3_launches": launches, "conv3x3_launches_by_variant": by_variant,
          "gop_ms": gop_ms, "gop_ms_runs": times,
          "frames_per_s": GOP / (gop_ms / 1e3),
          "peak_mem_bytes": peak, "plain_postprocess_gop_ms": plain_gop_ms,
          "gop16_ms": gop16_ms, "gop16_frames_per_s": 16 / (gop16_ms / 1e3),
          "gop16_conv3x3_launches": launches16,
          "max_abs_recon_diff_vs_plain": diff,
          "bits": {str(k): v for k, v in out["bits"].items()},
          "card": smi})
    phase_profile(model, luma, chroma)
    return by_variant


def _layer_labels(model):
    """Module -> layer label, for the device-time breakdown."""
    from learned_pmctf_tpu_torch.models.context import LSTM2D, UpsampleModule
    from learned_pmctf_tpu_torch.models.layers import PredictUpdate
    labels = {model.optic_flow: "spynet"}
    for name in ("mv_encoder", "mv_decoder", "mv_hyper_prior_encoder",
                 "mv_hyper_prior_decoder", "mv_y_prior_fusion_adaptor_0",
                 "mv_y_prior_fusion_adaptor_1", "mv_y_prior_fusion",
                 "mv_y_spatial_prior", "mv_y_spatial_prior_adaptor_1",
                 "mv_y_spatial_prior_adaptor_2", "mv_y_spatial_prior_adaptor_3"):
        for m in getattr(model, name):
            labels[m] = "mv coding"
    for tf in model.temporal_filtering:
        labels[tf.P_t] = labels[tf.U_t] = "temporal lifting"
    for coder in (model.lp_coder, model.hp_coder):
        for m in coder.wavelet_transform.modules():
            if isinstance(m, PredictUpdate):
                labels[m] = "spatial lifting"
        for m in coder.context_prediction.modules():
            if isinstance(m, (LSTM2D, UpsampleModule)):
                labels[m] = "lstm context"
        for bands in coder.context_fusion:
            for m in bands.values():
                labels[m] = "four-step priors"
        labels[coder.dequantModule] = "postprocess (conv3x3)"
    return labels


def phase_profile(model, luma, chroma):
    """Device time of one GOP by layer (torch.profiler, CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from learned_pmctf_tpu_torch.gop import code_gop
    labels = _layer_labels(model)
    ranges = {}

    def pre(m, args):
        ranges[m] = record_function(labels[m])
        ranges[m].__enter__()

    def post(m, args, out):
        ranges.pop(m).__exit__(None, None, None)

    hooks = [h for m in labels for h in (m.register_forward_pre_hook(pre),
                                         m.register_forward_hook(post))]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            code_gop(model, luma, chroma, 10.0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        for h in hooks:
            h.remove()
    names = set(labels.values())
    # device time of each layer: the kernels launched inside its ranges
    by_layer = dict.fromkeys(sorted(names), 0.0)
    for e in prof.events():
        if e.name in names and e.device_type == DeviceType.CPU:
            by_layer[e.name] += e.device_time_total / 1e3
    # busy time: the kernels themselves (as torch's own table sums it)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms > 0:
        raise AssertionError("the profiler saw no kernel run on the device")
    # a ctypes launch is no torch op, so the profiler ties the conv3x3
    # kernel to no range; PostProcess is its only caller
    by_layer["postprocess (conv3x3)"] += sum(
        e.self_device_time_total for e in kernels
        if "conv3x3" in e.key and "_kernel" in e.key) / 1e3
    by_layer["other"] = busy_ms - sum(by_layer.values())
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    emit({"phase": "profile", "gop": GOP, "wall_ms_profiled": wall_ms,
          "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
          "device_ms_by_layer": by_layer,
          "top_device_ops_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                for e in top[:8]}})


# variant -> its source and the kernel-phase shape that stands for it
VARIANT_ROWS = {
    "wgmma_3xtf32": ("conv3x3_wgmma.cu", "luma 64->64 leaky_relu"),
    "mma_sync_3xtf32": ("conv3x3_mma.cu", "luma 64->64 leaky_relu"),
    "head_o1": ("conv3x3_head.cu", "luma 64->1"),
    "direct_f32": ("conv3x3.cu", "luma 1->64"),
}


def kernel_entries(rows, by_variant):
    """One entry a variant: the variant's numbers at the shape that stands
    for it, whether the shape took it or timed it beside its own."""
    by_shape = {r["shape"]: r for r in rows}
    entries = []
    for variant, (source, shape) in VARIANT_ROWS.items():
        row = by_shape[shape]
        own = row["variant"] == variant
        if not own and f"{variant}_ms" not in row:
            continue
        n, c, hh, ww = row["x"]
        bound = conv_bound(n, c, row["o"], hh, ww, False, variant)
        entries.append({
            "name": f"conv3x3/{variant}", "route": "cuda",
            "source": f"learned_pmctf_tpu_torch/csrc/{source}",
            "replaces": "learned_pmctf_tpu/ops/pallas_conv.py:159",
            "launches": by_variant.get(variant, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["variant"] == variant)
            if own else row[f"{variant}_max_abs_err"],
            "ms": row["ms"] if own else row[f"{variant}_ms"],
            "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
            "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"].split(" (")[0],
            "bound_unit": bound["bound_by"], "shape": shape})
    return entries


def main():
    smi = phase_device()
    phase_build()
    rows = phase_kernel()
    phase_small_reference()
    by_variant = phase_slice(smi)
    entries = kernel_entries(rows, by_variant)
    on_path = [e for e in entries if e["launches"] > 0]
    if {e["name"].split("/")[1] for e in on_path} != set(by_variant):
        raise AssertionError(f"no kernel-phase row for a variant of {by_variant}")
    # variants the kernel phase launched and checked but the main path did
    # not take: the same keys, on a line of their own
    emit({"off_path_variants": [e for e in entries if e["launches"] == 0]})
    emit({"kernels": on_path})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
