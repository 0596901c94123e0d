"""Chip smoke test of the PyTorch/CUDA port (learned_pmctf_tpu_torch).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. device: requires CUDA, prints the card's name and power limit,
   turns TF32 off;
2. build: compiles the conv3x3 CUDA kernels from csrc/ with nvcc (one
   nvcc a source, together) and reports ptxas' registers and spills;
3. kernel: at the main path's eight shapes, at two shapes of the next
   slice and at two 1->64 shapes off the path (a ragged plane with a
   residual and tanh; rows of no 16-byte multiple), holds every variant
   that takes the shape against the plain PyTorch version (1e-3) and a
   float64 reference (1e-4: one TF32 product would miss it), launches it
   twice for bit-equality, and times it (one launch after a synchronize,
   the wrapper's host time included, and back to back) beside the plain
   version, one cuDNN F.conv2d call (a yardstick the port never calls)
   and the bound of the unit it runs on; at the 1->64 shapes it also
   checks which of the direct variants' two kernels ran, and that the
   C = 1 kernel gives the general kernel's bits;
4. small reference: a GOP-4 of a small model at 64x64 on the card
   against the same model on the CPU (the CPU path is what the tests
   hold against the JAX package);
5. slice: the full-width pMCTF-L (seeded random weights) codes a GOP-4
   of padded-1080p frames through code_gop; the conv3x3 launches of
   that run are counted, then the GOP is timed, and run once more with
   PostProcess on the plain version to compare the reconstructions (the
   f32 exact-warp GOP-16 is timed by phase 20's bench);
6. profile: one more GOP under torch.profiler, its device time split by
   layer (SpyNet, MV coding, lifting, LSTM context, four-step priors,
   PostProcess) and the device's idle share;
7. stream small reference: the small model's GOP-4 at 64x64 written to
   rANS streams and decoded again (gop.stream_gop through PMCTFCodec), on
   the card and on the CPU: each side decodes bit-exactly what it
   encoded, and the two sides' reconstructions agree;
8. stream: the real-bitstream path at full width, the model and frames
   of the slice phase: GOP-4 encode+decode (a warm-up, then a timed
   run), an encode-only run and a run with overlapped (asynchronous)
   decodes. Every decoded band and mv_hat must equal the encoder side bit
   for bit, every stream file's bytes must be the same in every run, and
   the conv3x3 launches are counted (encoder and decoder both run
   PostProcess). It reports the stream's bits per frame beside the
   estimate path's, host time in rANS, the device-to-host copies, and
   the device's busy time and idle share in one profiled encode+decode
   GOP and one profiled encode-only GOP.

9. ar_causal: the AR LL net (ll_mode="ar") at full width on the partial
   plane of every wavefront (what the decoder evaluates) against the net
   on the whole plane (what the encoder evaluates), luma 72x120 and
   chroma 2x36x60: table indexes and rounded means must be the same at
   every front's positions;
10. ar_stream_small_reference: phase 7 with the AR LL coder;
11. ar_slice: the full-width pMCTF-L with the AR LL coder: the estimate
   GOP-4 (warm-up, 2 timed runs) and the stream GOP-4 as in phase 8,
   with the LL fronts, the device-to-host copies and the seconds in the
   AR decoder counted;
12. cli: the eval CLI (learned_pmctf_tpu_torch.cli.flex) in its own
   process on a synthetic 1080p GOP-4 at one q index (20), AR, with
   streams: exit code, its JSON files' keys, finite metrics, bits > 0.

13. train_kernel_grad: Conv3x3Function (the kernel forward, the kernel
   again for the input gradient) at the training shapes of PostProcess's
   four convs (pMCTF 8x128x128, pWave 16x256x256): d_x, d_w, d_b,
   d_residual against the plain version's autograd (1e-3) and float64
   (1e-4), relative to each gradient's largest magnitude; forward, the
   d_x launch (with the cached flipped weights, and flipped and packed
   anew) and the backward timed, d_x beside its bound and one
   torch.nn.grad.conv2d_input call;
14. train_small_reference: the small config's GOP-2 train loss and every
   gradient on the card against the CPU (same weights, noise drawn on
   the CPU) at a sub-pixel decoded motion: float64 within 1e-9, f32 with
   PostProcess on the kernel against the same run on its plain version,
   and f32 card against CPU; PostProcess's conv1/conv3 gradients
   non-zero on the card; the float64 disagreement at the seeded init
   (decoded motion exactly 0) reported;
15. train_pmctf: full-width pMCTF-L at train_pmctf.py's defaults (batch
   8, 128x128, exact warp): curriculum stage 6 (GOP-4) and stage 8
   (GOP-16) steps timed, conv3x3 launches counted against the reckoning,
   peak memory, finite non-zero gradient norms, weight packs fresh after
   the optimizer step (fused AdamW), the step with PostProcess's weight
   gradients by weight_grad against one call over the batch, and a profiled
   GOP-4 step (forward, recompute, backward, by layer, idle share);
16. train_pwave: full-width pWave at train_pwave.py's defaults (batch 16,
   256x256), timed;
17. train_cli: both training CLIs in their own processes on a synthetic
   PNG dataset: all 8 curriculum stages, a resume (as the one NCCL rank
   of a torchrun launcher, --data_parallel 1: its log names NCCL, it
   writes its log and checkpoint alone), 2 pWave steps and their
   validation pictures.

18. kernel_bf16 (run after phase 3): the bf16 instance of the kernel (act_bf16's operands:
   bf16 x, weights and residual, f32 bias, bf16 out) at the main path's
   seven shapes and the chroma 64->1, then two ragged shapes off the path
   (a height that is no multiple of the tiles, a right edge inside a
   tile) for wgmma_bf16 and head_bf16, a 128->64 conv (wgmma_bf16's
   weights in two loads) and phase 3's two 1->64 shapes off the path:
   each bf16 variant against its
   bf16 plain version (one bf16 ulp plus 1e-5 of the largest output, at
   most 1e-3 of the elements differing), against float64 on the
   bf16-rounded operands (half a bf16 ulp plus 1e-5 of the largest
   output), launched twice for bit-equality, timed beside its plain
   version, one cuDNN bf16 F.conv2d call and its bound (bf16 bytes over
   the memory rate, operations over the dense bf16 rate); ptxas'
   registers, static shared memory and spills of the bf16 kernels;
19. bench_small_reference: the small model's GOP-4 in bench.py's
   configuration (fast warp, act_bf16) at 64x64 on the card against the
   CPU: max |card - CPU| <= 0.25 max |card bf16 - card f32| on the bits
   of all frames and on the luma and chroma reconstructions;
20. bench: the port's bench (learned_pmctf_tpu_torch.cli.bench
   --secondary) in its own process: bench.py's configuration at full
   width, GOP-16 padded 1080p (median of 3), the exact-warp f32 GOP-16
   and the fast-warp stream GOP-4; then in this process the bench
   configuration's GOP-4 with its conv3x3 launches counted and one GOP
   profiled by layer, with the device's idle share.
Phase 15 also times the stage-6 GOP-4 step with the fast warp (the
trainer's default, cli/train_pmctf.py); its profile is the exact warp's.

21. lossless_small_reference: the small config's lossless (lossy=False)
   GOP-4 at 64x64 on the card and on the CPU: both give the input frames
   back exactly, the bits agree within 2e-3, the card's stream decodes
   the input;
22. lossless: full-width pMCTF-L, lossy=False, padded 1080p, q 10, exact
   warp, f32: an estimate GOP-4 and a stream GOP-4 after a warm-up each;
   the frames come back bit for bit, the two encodes write the same
   bytes, no conv3x3 launch (no PostProcess); frames/s, bits per pixel,
   peak memory, the largest band symbol against the coder's clip;
23. q_batch: a full-width GOP-4 at q 0, 7, 14 and 20 as one batch
   (PMCTFCodec.estimate_one_stage_multi, inverse_mctf_multi) against the
   four single-q GOPs: bits rel 1e-4, frames 5e-2, 120 conv3x3 launches
   (N = 4 luma, 8 chroma), timed beside the four;
24. ca_cli: the content-adaptive CLI (learned_pmctf_tpu_torch.cli.ca) in
   its own process, full width, 8 synthetic 256x256 frames (a GOP-8
   chunk), streams:
   exit code, one (GOP, factor) choice, finite bits and PSNRs, every
   decoded pair bit-equal to the encoder side;
25. extra_modules: PostProcessCtx, the layers_extra convs and
   CompressionModel on the card against the CPU with the same weights.

26. data_parallel_small_reference: the small config of
   tests/dp_equiv_script.py (GOP-2, batch 8, 64x128) through the
   data-parallel train step on 2 gloo ranks of 4 rows sharing the card
   against one process on the batch of 8: loss rel 1e-5, the reduced
   gradients 1e-5 of each top-level module's largest, parameters rtol
   5e-4 atol 1.5e-4 (the CPU test's tolerances);
27. data_parallel: the same at full width and the trainer's defaults
   (GOP-4, stage 6, batch 8, 128x128; phase 15's step, which times the
   single process): agreement, each rank's step ms, peak memory and
   conv3x3 launches (180 a rank, at N = 4), with phase 26's check in the
   same spawn of the ranks (``--only data_parallel`` runs both); phase 17
   runs the trainer CLI over NCCL, as the one rank of a torchrun launcher
   (--data_parallel 1). NCCL across two cards is not shown on a one-card
   machine;
28. shard_q: the eval CLI's --q_batch --shard_q at full width, a
   synthetic 720p GOP-4 at 2 rate points, on 2 gloo ranks sharing the
   card (each rank the CLI's own rank entry, 1 rate point, 120 conv3x3
   launches counted) against --q_batch in its own process: the JSONs key
   for key, rates rel 1e-5, PSNR 1e-4 dB, both wall times;
29. average_flow: the dataset's flow filter (cli/average_flow.py, the
   RGB SpyNet) on a synthetic 256x448 PNG tree (2 clips) on the card
   and with --device cpu: mean |flow| within 1e-4 a clip;
30. spatial_small_reference: the full stage of
   tests/test_torch_port_spatial_models.py (the JAX test's config, Q = 4
   at q 0, 7, 14, 20, 64x128) width-sharded (parallel/halo.py) on a
   2 x 2 (data x spatial) mesh of 4 gloo ranks sharing the card against
   one process on the card: bits rtol 1e-5 and atol 1e-4, planes 1e-3
   (the CPU test's tolerances), every rank the single process's conv3x3
   launches by variant;
31. spatial: full-width pMCTF-L (f32, exact warp, four-step LL) at
   padded 1080p, one stage at Q = 2 (estimate_one_stage_multi, then
   inverse_mctf_multi) on a 1 x 2 mesh of 2 gloo ranks sharing the card,
   960 columns each, against one process: the same checks; each rank's
   stage ms beside the single process's, its exchanges, their bytes and
   share of its wall time, its peak memory and its launches by variant
   (on planes widened by PostProcess's 16-column halo).
Phases 21-31 run after phase 20. Within the script's time, phases 8 and
11 time one encode+decode run (phase 11 profiles its encode+decode GOP
only), phase 11 one estimate GOP, phase 15 two GOP-4 steps (one with the fast warp), one
round of the weight-gradient A/B and its counted GOP-16 step, phase 16
two pWave steps and phase 27 one step after the first.

``python3 chip_smoke.py --only lossless,q_batch`` runs phases 1-2 and the
named phases of 21-31 alone (names as their JSON lines give them).
``python3 chip_smoke.py --kernels`` runs phases 1-3 and 18 alone, and
``python3 chip_smoke.py --kernels --ab DIR`` then times the variants of
both kernel phases' main-path shapes and of the training 1->64 input
gradients against those of the checkout at DIR (another commit of this
repo, built into DIR's own build directory), in turns: DIR's, this
tree's, this tree's, DIR's, on the same inputs; every variant must give
the same bits from both.

Then it prints the variants the main path did not take, the kernels line
(one entry a variant a path launched; ``launches`` counts the estimate
GOP-4 for the f32 variants and the bench configuration's GOP-4 for the
bf16 ones, ``stream_launches`` the stream GOP-4, ``ar_launches`` and
``ar_stream_launches`` the same with the AR LL coder, ``train_launches``
a GOP-4 train step, ``bench_launches`` the bench configuration's GOP-4,
``lossless_launches`` the lossless GOPs (none), ``q_batch_launches``
the q-batched GOP-4, ``dp_train_launches`` rank 0's data-parallel GOP-4
train step, ``shard_q_launches`` rank 0's half of the sharded q batch
and ``spatial_launches`` rank 0's half of the width-sharded stage;
each path launches exactly its variants: the f32 paths the f32 ones, the
bench the bf16 ones, and every launch of a direct variant on a path runs
its C = 1 kernel, as the C layer counts them) and, last, {"ok": true,
"device": ...}.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

# H100 SXM, dense, at the 700 W limit (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TENSOR_VARIANTS = ("mma_sync_3xtf32", "wgmma_3xtf32")
BF16_VARIANTS = ("wgmma_bf16", "head_bf16", "direct_bf16")
BF16_FLOOR = 1e-5  # of the largest output: the f32 sums' order, where they cancel
BF16_SHARE = 1e-3  # of the elements that may differ from the plain version
KERNEL_TOL = 1e-3  # against the plain version (cuDNN f32, TF32 off)
F64_TOL = 1e-4     # against float64: one TF32 product errs by ~1.6e-3 here
GOP = 4
LUMA = (1152, 1920)  # 1080p padded to a multiple of 128


T0 = time.perf_counter()


def emit(obj):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T0, 1)}), flush=True)


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


def cuda_ms_back_to_back(fn, reps=20, rounds=3):
    """Median over `rounds` of the time of `reps` launches of fn queued
    back to back, a launch's share, in ms: the card's time without the
    host's time between a synchronize and the next launch, which
    ``cuda_ms`` includes."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
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
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn": torch.backends.cudnn.version()})
    return smi


def parse_ptxas(log):
    """ptxas -v output -> one entry a kernel: registers, static shared
    memory, spill bytes and ptxas' performance warnings (C75xx: wgmma
    serialized)."""
    entries, name, warnings = [], None, {}
    for line in log.splitlines():
        m = re.search(r"\((C75\d\d)\) Potential Performance Loss.*function '(\w+)'", line)
        if m:
            warnings.setdefault(m.group(2), []).append(m.group(1))
            continue
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
            m = re.search(r"(\d+) bytes smem", line)
            entries[-1]["static_smem_bytes"] = int(m.group(1)) if m else 0
    for e in entries:
        e["perf_warnings"] = warnings.get(e["kernel"], [])
    return entries


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from learned_pmctf_tpu_torch import native
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3

    def timed(build):
        t0 = time.perf_counter()
        log = build(force=True)
        return log, time.perf_counter() - t0

    # the host rANS library (g++) builds beside the kernels (nvcc)
    with ThreadPoolExecutor(2) as pool:
        rans = pool.submit(timed, native.build)
        log, seconds = timed(c3.build)
        _, rans_seconds = rans.result()
    ptxas = parse_ptxas(log)
    if not ptxas:
        raise AssertionError(f"no ptxas report in the build log:\n{log}")
    emit({"phase": "build", "kernel": "conv3x3", "seconds": seconds,
          "sources": [src.split("learned_pmctf_tpu_torch/")[-1]
                      for src in c3.SOURCES],
          "ptxas": ptxas, "rans_library_seconds": rans_seconds,
          "rans_sources": [src.split("learned_pmctf_tpu_torch/")[-1]
                           for src in native.SOURCES]})
    return ptxas


def conv_bound(n, c, o, h, w, residual, variant):
    """Least time the card could take, in ms: the larger of bytes over the
    memory rate and operations over the peak rate of the unit the variant
    runs on (a tensor-core variant does three TF32 products); for the
    bf16 instance bf16 bytes (the bias f32) and the dense bf16 rate."""
    flops = 2.0 * n * h * w * 9 * c * o
    e = 2.0 if variant in BF16_VARIANTS else 4.0
    nbytes = e * (n * c * h * w + o * c * 9 + n * o * h * w
                  * (2 if residual else 1)) + 4.0 * o
    t_f32 = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    if variant in BF16_VARIANTS:
        t_ops, unit = flops / PEAK_BF16_FLOPS * 1e3, "dense bf16 rate"
    elif variant in TENSOR_VARIANTS:
        t_ops, unit = 3 * flops / PEAK_TF32_FLOPS * 1e3, "3 TF32 products, tensor cores"
    else:
        t_ops, unit = t_f32, "f32 cores"
    by = f"operations ({unit})" if t_ops >= t_bytes else "bytes"
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": by,
            "f32_core_bound_ms": max(t_f32, t_bytes)}


def unaligned(t):
    """t's values in a tensor one element off 16 bytes."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    u = flat[1:].view_as(t)
    u.copy_(t)
    return u


def direct_kernel_ran(dtype, launch):
    """Which of the direct variants' two kernels `launch` ran, as the C
    layer counted the C = 1 kernel's launches: "c1" or "general"."""
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3
    c3.direct_c1_launches(dtype, reset=True)
    y = launch()
    return y, "c1" if c3.direct_c1_launches(dtype, reset=True) else "general"


def direct_kernel_bits(row, variants, x, wt, b, act, r):
    """Which kernel of the direct variants ran a C = 1 shape; where it
    was the C = 1 kernel, it must give the general kernel's bits: the same
    values through an unaligned copy of x, which must run the general
    kernel."""
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3
    direct = "direct_bf16" if x.dtype == torch.bfloat16 else "direct_f32"
    if x.shape[1] != 1 or direct not in variants:
        return
    y, row["direct_kernel"] = direct_kernel_ran(x.dtype, lambda: c3.conv3x3_variant(
        direct, x, wt, b, act=act, residual=r))
    if row["direct_kernel"] == "c1":
        y_general, ran = direct_kernel_ran(x.dtype, lambda: c3.conv3x3_variant(
            direct, unaligned(x), wt, b, act=act, residual=r))
        if ran != "general":
            raise AssertionError(f"conv3x3 {row['shape']} {direct}: an unaligned x ran "
                                 f"the {ran} kernel")
        same = torch.equal(y, y_general)
        row["same_bits_as_general_kernel"] = same
        if not same:
            raise AssertionError(f"conv3x3 {row['shape']} {direct}: the C = 1 kernel and "
                                 "the general kernel differ")


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
                        "deterministic": same, "ms": ms,
                        "ms_back_to_back": cuda_ms_back_to_back(run)})
        else:
            row.update({f"{v}_ms": ms, f"{v}_max_abs_err": err,
                        f"{v}_err_f64": err64})
        del y
    del ref64, plain
    direct_kernel_bits(row, [variant] + others, x, wt, b, act, r)
    row["plain_ms"] = cuda_ms(lambda: c3.conv3x3_plain(x, wt, b, act=act, residual=r))
    row["library_ms"] = cuda_ms(lambda: F.conv2d(x, wt, b, padding=1))
    row.update(conv_bound(n, c, o, hh, ww, res, variant))
    if not row["ms"] >= row["bound_ms"]:
        raise AssertionError(f"conv3x3 {label}: {row['ms']} ms is under its "
                             f"bound {row['bound_ms']} ms")
    emit(row)
    return row


def f32_cases():
    """The eight shapes of the main path, then two shapes the main path
    does not send to the kernel yet (the four-step priors' 112 and 128
    channels at the level-1 subband plane), measured for the next slice."""
    h, w = LUMA
    return [  # (label, n, c, o, h, w, act, residual)
        ("luma 64->64 leaky_relu", 1, 64, 64, h, w, "leaky_relu", False),
        ("luma 64->64 residual", 1, 64, 64, h, w, None, True),
        ("luma 1->64", 1, 1, 64, h, w, None, False),
        ("luma 64->1", 1, 64, 1, h, w, None, False),
        ("chroma 64->64 leaky_relu", 2, 64, 64, h // 2, w // 2, "leaky_relu", False),
        ("chroma 64->64 residual", 2, 64, 64, h // 2, w // 2, None, True),
        ("chroma 1->64", 2, 1, 64, h // 2, w // 2, None, False),
        ("chroma 64->1", 2, 64, 1, h // 2, w // 2, None, False),
        ("subband 112->112 leaky_relu (off the main path)", 1, 112, 112,
         h // 2, w // 2, "leaky_relu", False),
        ("subband 128->128 leaky_relu (off the main path)", 1, 128, 128,
         h // 2, w // 2, "leaky_relu", False),
    ]


# off the path: 1->64 on a ragged plane with a residual and tanh (the C =
# 1 kernel: its stores clipped at both edges), and on rows of no 16-byte
# multiple (the direct variants' general kernel); phase 18 runs them too
F32_RAGGED = [
    ("ragged 2x1x75x200 1->64 residual tanh", 2, 1, 64, 75, 200, "tanh", True),
    ("unaligned 1x1x37x133 1->64", 1, 1, 64, 37, 133, None, False),
]


def main_path(cases):
    """The cases of the main path's shapes."""
    return [case for case in cases if case[0].split()[0] in ("luma", "chroma")
            and "off the main path" not in case[0]]


def check_direct_kernels(rows):
    """The 1->64 shapes on rows of a 16-byte multiple ran the direct
    variants' C = 1 kernel, the unaligned one the general kernel (as
    direct_kernel_ran saw them)."""
    for row in rows:
        if "1->64" in row["shape"]:
            want = "general" if row["shape"].startswith("unaligned") else "c1"
            if row.get("direct_kernel") != want:
                raise AssertionError(f"conv3x3 {row['shape']}: ran the direct variants' "
                                     f"{row.get('direct_kernel')} kernel, expected {want}")


def phase_kernel():
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = [measure_conv(*case, g) for case in f32_cases() + F32_RAGGED]
    check_direct_kernels(rows)
    torch.cuda.empty_cache()
    return rows


def bf16_ulp(v):
    """One bf16 ulp (8 significant bits) of |v|, elementwise."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def measure_conv_bf16(label, n, c, o, hh, ww, act, res, g):
    """One shape of the bf16 kernel phase: every bf16 variant that takes
    the shape against the bf16 plain version and float64 on the
    bf16-rounded operands, launched twice, timed beside the plain
    version, one cuDNN bf16 call and the bound."""
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3
    x = torch.randn(n, c, hh, ww, device="cuda", generator=g).bfloat16()
    wt = (torch.randn(o, c, 3, 3, device="cuda", generator=g) / (3 * c ** 0.5)).bfloat16()
    b = torch.randn(o, device="cuda", generator=g) * 0.1
    r = torch.randn(n, o, hh, ww, device="cuda", generator=g).bfloat16() if res else None
    variant, *others = c3.variants_for(c, o, ww, torch.bfloat16)
    plain = c3.conv3x3_plain(x, wt, b, act=act, residual=r).float()
    ref64 = c3.conv3x3_plain(x.double(), wt.double(), b.double(), act=act,
                             residual=None if r is None else r.double())
    floor, floor64 = (BF16_FLOOR * float(t.abs().max()) for t in (plain, ref64))
    row = {"phase": "kernel_bf16", "name": "conv3x3", "shape": label,
           "x": [n, c, hh, ww], "o": o, "variant": variant,
           "tol": "1 bf16 ulp + 1e-5 of the largest output, <= 1e-3 of the elements differing",
           "f64_tol": "half a bf16 ulp + 1e-5 of the largest output"}
    for v in [variant] + others:
        run = lambda: c3.conv3x3_variant(v, x, wt, b, act=act, residual=r)  # noqa: E731
        y = run()
        torch.cuda.synchronize()
        if y.dtype != torch.bfloat16:
            raise AssertionError(f"conv3x3 {label} {v}: wrote {y.dtype}")
        yf = y.float()
        d = (yf - plain).abs()
        ulps = float((d / (bf16_ulp(torch.maximum(yf.abs(), plain.abs())) + floor)).max())
        share = float((d > 0).float().mean())
        d64 = (y.double() - ref64).abs()
        ulps64 = float((d64 / (0.5 * bf16_ulp(ref64) + floor64)).max())
        same = torch.equal(y, run())
        if not (ulps <= 1.0 and share <= BF16_SHARE):
            raise AssertionError(f"conv3x3 {label} {v}: {ulps} of the allowed difference "
                                 f"from the plain version, {share} of the elements differ")
        if not ulps64 <= 1.0:
            raise AssertionError(f"conv3x3 {label} {v}: {ulps64} of the allowed "
                                 f"difference from float64")
        if not same:
            raise AssertionError(f"conv3x3 {label} {v}: two launches differ")
        stats = {"max_abs_err": float(d.max()), "of_allowed": ulps, "share_differing": share,
                 "err_f64": float(d64.max()), "of_allowed_f64": ulps64,
                 "deterministic": same, "ms": cuda_ms(run)}
        if v == variant:
            row.update(stats, ms_back_to_back=cuda_ms_back_to_back(run))
        else:
            row.update({f"{v}_{k}": val for k, val in stats.items()})
        del y, yf, d, d64
    del ref64, plain
    direct_kernel_bits(row, [variant] + others, x, wt, b, act, r)
    row["plain_ms"] = cuda_ms(lambda: c3.conv3x3_plain(x, wt, b, act=act, residual=r))
    bb = b.bfloat16()
    row["library_ms"] = cuda_ms(lambda: F.conv2d(x, wt, bb, padding=1))
    row.update(conv_bound(n, c, o, hh, ww, res, variant))
    if not row["ms"] >= row["bound_ms"]:
        raise AssertionError(f"conv3x3 {label}: {row['ms']} ms is under its "
                             f"bound {row['bound_ms']} ms")
    emit(row)
    return row


def bf16_cases():
    """The bf16 instance's main-path shapes: the seven of phase 3 and the
    chroma 64->1 (the bench's chroma PostProcess)."""
    h, w = LUMA
    return [
        ("luma 64->64 leaky_relu", 1, 64, 64, h, w, "leaky_relu", False),
        ("luma 64->64 residual", 1, 64, 64, h, w, None, True),
        ("luma 1->64", 1, 1, 64, h, w, None, False),
        ("luma 64->1", 1, 64, 1, h, w, None, False),
        ("chroma 64->64 leaky_relu", 2, 64, 64, h // 2, w // 2, "leaky_relu", False),
        ("chroma 64->64 residual", 2, 64, 64, h // 2, w // 2, None, True),
        ("chroma 64->1", 2, 64, 1, h // 2, w // 2, None, False),
        ("chroma 1->64", 2, 1, 64, h // 2, w // 2, None, False),
    ]


# off the path: a height no multiple of the tiles (4 and 8 rows), a right
# edge inside a tile (64 and 128 pixels), with a residual and with tanh;
# and 128 input channels (wgmma_bf16 loads its weights 64 at a time)
BF16_RAGGED = [
    ("ragged 2x64x75x200 64->64 residual", 2, 64, 64, 75, 200, None, True),
    ("ragged 1x64x37x136 64->64 tanh", 1, 64, 64, 37, 136, "tanh", False),
    ("ragged 2x64x75x200 64->1 residual", 2, 64, 1, 75, 200, None, True),
    ("ragged 1x64x37x136 64->1 tanh", 1, 64, 1, 37, 136, "tanh", False),
    ("128 channels 1x128x21x72 128->64 residual", 1, 128, 64, 21, 72, "leaky_relu", True),
] + F32_RAGGED


def bf16_kernels(ptxas):
    """The ptxas entries of the bf16 instance's kernels."""
    return [e for e in ptxas if "bf16" in e["kernel"] or "bfloat16" in e["kernel"]]


def phase_kernel_bf16(ptxas):
    """The bf16 instance at its main-path shapes, then the ragged ones."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = [measure_conv_bf16(*case, g) for case in bf16_cases() + BF16_RAGGED]
    check_direct_kernels(rows)
    emit({"phase": "kernel_bf16_ptxas", "kernels": bf16_kernels(ptxas)})
    torch.cuda.empty_cache()
    return rows


def load_conv3x3(root, name):
    """ops/conv3x3.py of the checkout at `root` as the module `name`: it
    builds its own sources into `root`'s build directory."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "learned_pmctf_tpu_torch", "ops", "conv3x3.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the input gradients of training's 64->1 convs (pMCTF's and pWave's
# batch and patch): 1->64 convs on the direct variants' C = 1 kernel
C1_TRAIN_CASES = [
    ("train d_x 8x1x128x128 1->64", 8, 1, 64, 128, 128, None, False),
    ("train d_x 16x1x256x256 1->64", 16, 1, 64, 256, 256, None, False),
]


def ab_turns(phase, other, cases):
    """Each case's variant as `other` (another build of ops/conv3x3.py)
    and this tree build it, on the same inputs, timed in turns: other,
    this, this, other. Both must give the same bits."""
    from learned_pmctf_tpu_torch.ops import conv3x3 as this
    g = torch.Generator(device="cuda").manual_seed(0)
    for (label, n, c, o, hh, ww, act, res), dtype in cases:
        x = torch.randn(n, c, hh, ww, device="cuda", generator=g).to(dtype)
        wt = (torch.randn(o, c, 3, 3, device="cuda", generator=g) / (3 * c ** 0.5)).to(dtype)
        b = torch.randn(o, device="cuda", generator=g) * 0.1
        r = torch.randn(n, o, hh, ww, device="cuda", generator=g).to(dtype) if res else None
        variant = this.variants_for(c, o, ww, dtype)[0]
        # each module caches its own pack on the weight tensor: one each
        runs = {name: (lambda m=m, w=w: m.conv3x3_variant(variant, x, w, b, act=act,
                                                          residual=r))
                for name, m, w in (("other", other, wt.clone()), ("this", this, wt))}
        this.direct_c1_launches(dtype, reset=True)
        outs = {name: run() for name, run in runs.items()}
        # the other tree's library counts its own launches, if it counts any
        c1 = this.direct_c1_launches(dtype, reset=True)
        same = torch.equal(outs["other"], outs["this"])
        if not same:
            raise AssertionError(f"{phase} {label} {variant}: the variant changed its bits")
        times = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            times[name].append(cuda_ms(runs[name]))
        row = {"phase": phase, "shape": label, "dtype": str(dtype).split(".")[-1],
               "variant": variant, "other_ms": times["other"], "this_ms": times["this"],
               "same_bits": same, "max_abs_diff": float(
                   (outs["other"].float() - outs["this"].float()).abs().max()),
               **conv_bound(n, c, o, hh, ww, res, variant)}
        if variant.startswith("direct"):
            row["direct_kernel"] = "c1" if c1 else "general"
        emit(row)
        del outs
    torch.cuda.empty_cache()


def phase_ab(other_root):
    """The variant each main-path shape takes, in f32 and bf16, and the
    training 1->64 input gradients, as built from the checkout at
    `other_root` ("other") and from this tree ("this"), in turns; every
    variant must give the same bits from both."""
    other = load_conv3x3(other_root, "other_conv3x3")
    ptxas = parse_ptxas(other.build(force=True))
    emit({"phase": "ab_build", "other": other_root,
          "other_ptxas": bf16_kernels(ptxas)})
    ab_turns("ab", other, [(case, torch.float32) for case in main_path(f32_cases())]
             + [(case, torch.float32) for case in C1_TRAIN_CASES]
             + [(case, torch.bfloat16) for case in bf16_cases()])


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


def postprocess_launches(w, planes, dtype=torch.float32):
    """conv3x3 launches by variant of `planes` PostProcess calls: one
    1->64 conv, thirteen 64->64, one 64->1 each."""
    from learned_pmctf_tpu_torch.ops.conv3x3 import variants_for
    return {variants_for(1, 64, w, dtype)[0]: planes,
            variants_for(64, 64, w, dtype)[0]: 13 * planes,
            variants_for(64, 1, w, dtype)[0]: planes}


def count_from_zero():
    """Set the launch counts to 0 before a path's counted run: the
    wrapper's by variant, and the C layer's of the direct variants' C = 1
    kernel."""
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3
    c3.conv3x3.launches, c3.conv3x3.by_variant = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        c3.direct_c1_launches(dtype, reset=True)


def counted(path):
    """The launches by variant since count_from_zero. Every launch of a
    direct variant on a path must have run its C = 1 kernel, as the C
    layer counted them: that kernel is the one the kernels line names."""
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3
    by_variant = dict(c3.conv3x3.by_variant)
    for variant, dtype in (("direct_f32", torch.float32), ("direct_bf16", torch.bfloat16)):
        c1 = c3.direct_c1_launches(dtype)
        if by_variant.get(variant, 0) != c1:
            raise AssertionError(f"{path}: {by_variant.get(variant, 0)} launches of "
                                 f"{variant}, {c1} of them on its C = 1 kernel")
    return by_variant


def timed_code_gop(model, luma, chroma, runs=3):
    """The estimate GOP: a warm-up, a run whose conv3x3 launches are
    counted (a GOP-4 reconstructs 2 planes a frame), then `runs` timed
    runs. Returns the counted run's output and the numbers."""
    from learned_pmctf_tpu_torch.gop import code_gop
    from learned_pmctf_tpu_torch.ops.conv3x3 import conv3x3
    h, w = LUMA

    def run():
        out = code_gop(model, luma, chroma, 10.0)
        torch.cuda.synchronize()
        return out

    run()  # warm-up
    count_from_zero()
    out = run()
    launches, by_variant = conv3x3.launches, counted("estimate GOP-4")
    expected = postprocess_launches(w, 2 * GOP)
    if launches != 15 * 2 * GOP or by_variant != expected:
        raise AssertionError(f"conv3x3 launched {launches} times, by variant "
                             f"{by_variant}, expected {expected}")
    check_outputs(out, h, w)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        run()
        times.append((time.perf_counter() - t) * 1e3)
    gop_ms = statistics.median(times)
    return out, {"conv3x3_launches": launches,
                 "conv3x3_launches_by_variant": by_variant,
                 "gop_ms": gop_ms, "gop_ms_runs": times,
                 "frames_per_s": GOP / (gop_ms / 1e3),
                 "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def phase_slice(smi):
    from learned_pmctf_tpu_torch.gop import code_gop
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    from learned_pmctf_tpu_torch.models.postprocess import PostProcess
    h, w = LUMA
    t0 = time.perf_counter()
    model = build_pmctf("cuda", seed=0, num_me_stages=4)
    build_s = time.perf_counter() - t0
    luma, chroma = synthetic_gop(GOP, h, w, "cuda")
    out, est = timed_code_gop(model, luma, chroma)
    by_variant = est["conv3x3_launches_by_variant"]

    posts = [m for m in model.modules() if isinstance(m, PostProcess)]
    for m in posts:
        m.use_kernel = False
    t = time.perf_counter()
    plain = code_gop(model, luma, chroma, 10.0)
    torch.cuda.synchronize()
    plain_gop_ms = (time.perf_counter() - t) * 1e3
    for m in posts:
        m.use_kernel = True
    diff = compare_gops(out, plain, "GOP-4, kernel vs plain PostProcess")
    emit({"phase": "slice", "model": "pMCTF-L full width (seeded random weights)",
          "gop": GOP, "luma": [h, w], "chroma": [2, h // 2, w // 2],
          "q_index": 10, "model_build_s": build_s, **est,
          "plain_postprocess_gop_ms": plain_gop_ms,
          "max_abs_recon_diff_vs_plain": diff,
          "bits": {str(k): v for k, v in out["bits"].items()},
          "card": smi})
    phase_profile(model, luma, chroma)
    return by_variant, (model, luma, chroma, out["bits"])


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


def device_kernels(prof):
    """The kernels a profile saw and their busy time in ms (the kernels
    themselves, as torch's own table sums them)."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms > 0:
        raise AssertionError("the profiler saw no kernel run on the device")
    return kernels, busy_ms


def phase_profile(model, luma, chroma, phase="profile"):
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
    kernels, busy_ms = device_kernels(prof)
    # a ctypes launch is no torch op, so the profiler ties the conv3x3
    # kernel to no range; PostProcess is its only caller
    conv_ms = {e.key[:100]: e.self_device_time_total / 1e3 for e in kernels
               if "conv3x3" in e.key and "_kernel" in e.key}
    by_layer["postprocess (conv3x3)"] += sum(conv_ms.values())
    by_layer["other"] = busy_ms - sum(by_layer.values())
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    emit({"phase": phase, "gop": GOP, "wall_ms_profiled": wall_ms,
          "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
          "device_ms_by_layer": by_layer, "conv3x3_kernels_ms": conv_ms,
          "top_device_ops_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                for e in top[:8]}})


def stream_files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def check_stream(out, what):
    """Every pair's decoded bands and mv_hat equal the encoder side."""
    if not out["max_err"] or any(v != 0.0 for v in out["max_err"].values()):
        raise AssertionError(f"{what}: decoded planes differ from the encoder "
                             f"side: {out['max_err']}")


def phase_stream_small_reference(ll_mode="fourstep"):
    """The small model's stream GOP-4 on the card and on the CPU; with
    ll_mode="ar" its AR nets at unit gain (see unit_gain_ar)."""
    from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
    from learned_pmctf_tpu_torch.gop import stream_gop
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    cfg = dict(decomp_levels=2, num_me_stages=2, channel_mv=8, channel_n=8,
               features=16, ar_features=16, ll_mode=ll_mode)
    name = "stream_small_reference" if ll_mode == "fourstep" else "ar_stream_small_reference"
    luma, chroma = synthetic_gop(GOP, 64, 64, "cpu", seed=1)
    outs, files = {}, {}
    for dev in ("cpu", "cuda"):
        model = build_pmctf(dev, seed=1, **cfg)
        if ll_mode == "ar":
            unit_gain_ar(model)
        with tempfile.TemporaryDirectory() as d, \
                PMCTFCodec(model, device=dev) as codec:
            codec.update()
            outs[dev] = stream_gop(codec, luma, chroma, 10.0, d, psize=64,
                                   device=dev)
            files[dev] = stream_files(d)
        check_stream(outs[dev], f"{name} on {dev}")
    err = 0.0
    for plane in ("luma", "chroma"):
        for x, y in zip(outs["cuda"][plane], outs["cpu"][plane]):
            err = max(err, float((x.cpu() - y).abs().max()))
    if not err < 5e-2:
        raise AssertionError(f"{name}: card and CPU differ by {err}")
    emit({"phase": name, "ll_mode": ll_mode, "gop": GOP, "size": [64, 64],
          "max_abs_recon_diff_card_vs_cpu": err, "recon_abs_tol": 5e-2,
          "bytes_equal_card_vs_cpu": files["cuda"] == files["cpu"],
          "files_differing": sorted(f for f in files["cpu"]
                                    if files["cpu"][f] != files["cuda"].get(f)),
          "bits_card": {str(k): v for k, v in outs["cuda"]["bits"].items()},
          "bits_cpu": {str(k): v for k, v in outs["cpu"]["bits"].items()}})


def stream_ar_expect(model):
    """What an AR stream GOP-4 must count: LL fronts (a GOP-4 codes 4
    luma and 4 chroma pWave planes, each coder's LL decoded front by
    front), and device-to-host copies with decoding (one a front, 4 a
    four-step subband, 4 MV passes a pair, one bulk copy a compress and
    a pair's MV encode, one check a pair) and without."""
    from learned_pmctf_tpu_torch.codec.image_codec import ar_wavefronts
    h, w = LUMA
    L = model.hp_coder.decomp_levels
    fronts = GOP * (len(ar_wavefronts(h >> L, w >> L))
                    + len(ar_wavefronts(h >> (L + 1), w >> (L + 1))))
    pairs, planes = GOP - 1, 2 * GOP
    bulk = 2 * GOP + pairs
    return {"ar_fronts": fronts,
            "syncs": fronts + planes * 4 * 3 * L + 4 * pairs + bulk + pairs,
            "encode_only_syncs": bulk}


def stream_runs(model, luma, chroma, est_bits, ll_mode="fourstep"):
    """The real-bitstream GOP-4 at full width (see the module docstring):
    a warm-up and a timed encode+decode run, an encode-only run, an
    overlapped-decode run and two profiled GOPs. Returns the phase's
    numbers and the launches by variant of one encode+decode run."""
    from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
    from learned_pmctf_tpu_torch.gop import stream_gop
    from learned_pmctf_tpu_torch.ops.conv3x3 import conv3x3
    h, w = LUMA
    # a GOP-4 reconstructs 8 planes a side (3 pairs' H bands, the L bands)
    per_side = postprocess_launches(w, 2 * GOP)
    ar = stream_ar_expect(model) if ll_mode == "ar" else None
    row = {"model": "pMCTF-L full width (seeded random weights)", "ll_mode": ll_mode,
           "gop": GOP, "luma": [h, w], "chroma": [2, h // 2, w // 2], "q_index": 10}
    t0 = time.perf_counter()
    codec = PMCTFCodec(model)
    codec.update()
    row["codec_setup_s"] = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="pmctf_stream_")
    ref_files = None

    def run(name, sides=2, **kw):
        nonlocal ref_files
        d = os.path.join(root, name)
        os.makedirs(d)
        codec.stats.reset()
        count_from_zero()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = stream_gop(codec, luma, chroma, 10.0, d, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        by_variant = counted(f"stream {name}")
        expected = {k: v * sides for k, v in per_side.items()}
        if by_variant != expected:
            raise AssertionError(f"stream {name}: conv3x3 launches by variant "
                                 f"{by_variant}, expected {expected}")
        if sides == 2:
            check_stream(out, f"stream {name}")
        check_outputs(out, h, w)
        files = stream_files(d)
        if ref_files is None:
            ref_files = files
        elif files != ref_files:
            raise AssertionError(f"stream {name}: stream bytes differ from the "
                                 "first run's")
        st = codec.stats
        stats = {"ms": ms, "syncs": st.syncs,
                 "rans_encode_ms": st.rans_encode_s * 1e3,
                 "rans_decode_ms": st.rans_decode_s * 1e3,
                 "conv3x3_launches": conv3x3.launches,
                 "ar_fronts": st.ar_fronts, "ar_decode_ms": st.ar_decode_s * 1e3}
        if ar is not None and not kw and (st.ar_fronts, st.syncs) != (
                ar["ar_fronts"], ar["syncs"]):
            raise AssertionError(f"stream {name}: {st.ar_fronts} AR fronts and "
                                 f"{st.syncs} copies, expected {ar}")
        if ar is not None and kw.get("skip_decoding") and (
                st.ar_fronts, st.syncs) != (0, ar["encode_only_syncs"]):
            raise AssertionError(f"stream {name}: {st.ar_fronts} AR fronts and "
                                 f"{st.syncs} copies encode-only, expected {ar}")
        return out, stats, by_variant

    try:
        run("warmup")
        torch.cuda.reset_peak_memory_stats()
        timed = [run(f"run{i}") for i in range(1)]
        peak = torch.cuda.max_memory_allocated()
        out, _, by_variant = timed[0]
        stats = dict(timed[-1][1], ms=statistics.median(s["ms"] for _, s, _ in timed))
        _, enc_stats, _ = run("encode_only", sides=1, skip_decoding=True)
        _, async_stats, _ = run("decode_async", decode_async=True)
        nbytes = {f: len(b) for f, b in ref_files.items()}
        # the AR stream's encode-only GOP is the four-step one's but for
        # its AR net: profiled once, with the four-step coder
        profiles = {name: profile_stream(codec, os.path.join(root, f"prof_{name}"),
                                         luma, chroma, **kw)
                    for name, kw in (("encode_decode", {}),
                                     ("encode_only", {"skip_decoding": True}))
                    if ll_mode == "fourstep" or name == "encode_decode"}
    finally:
        codec.close()
        shutil.rmtree(root)

    frames_bits = {}
    for fi, bits in out["bits"].items():
        frames_bits[str(fi)] = {
            k: {"stream": v, "estimate": est_bits[fi][k],
                "ratio": v / est_bits[fi][k]} for k, v in bits.items()}
    total_stream = sum(v for b in out["bits"].values() for v in b.values())
    total_est = sum(v for b in est_bits.values() for v in b.values())
    row.update({
        "stream_gop_ms": stats["ms"],
        "stream_gop_ms_runs": [s["ms"] for _, s, _ in timed],
        "frames_per_s": GOP / (stats["ms"] / 1e3),
        "median_run": stats,
        "encode_only": enc_stats,
        "encode_only_frames_per_s": GOP / (enc_stats["ms"] / 1e3),
        "decode_async": async_stats,
        "decode_async_frames_per_s": GOP / (async_stats["ms"] / 1e3),
        "peak_mem_bytes": peak,
        "conv3x3_launches_by_variant": by_variant,
        "max_err": max(max(o["max_err"].values()) for o, _, _ in timed),
        "bits_per_frame": frames_bits,
        "bits_total_stream": total_stream, "bits_total_estimate": total_est,
        "bits_ratio_stream_to_estimate": total_stream / total_est,
        "stream_file_bytes": nbytes,
        "bytes_identical_across_runs": True,
        "profile": profiles})
    if ar is not None:
        row["expected_counts"] = ar
    return row, by_variant


def phase_stream(smi, model, luma, chroma, est_bits):
    row, by_variant = stream_runs(model, luma, chroma, est_bits)
    emit({"phase": "stream", **row, "card": smi})
    return by_variant


def profile_stream(codec, d, luma, chroma, **kw):
    """Device busy time and idle share of one stream GOP (torch.profiler
    sees the kernels of every thread; they share one stream)."""
    from torch.profiler import ProfilerActivity, profile
    from learned_pmctf_tpu_torch.gop import stream_gop
    os.makedirs(d)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        stream_gop(codec, luma, chroma, 10.0, d, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels, busy_ms = device_kernels(prof)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "conv3x3_kernels_ms": sum(e.self_device_time_total for e in kernels
                                      if "conv3x3" in e.key and "_kernel" in e.key) / 1e3,
            "top_device_ops_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                  for e in top[:6]}}


AR_LL = {"luma": (1, 1, LUMA[0] >> 4, LUMA[1] >> 4),
         "chroma": (2, 1, LUMA[0] >> 5, LUMA[1] >> 5)}


def unit_gain_ar(model, seed=5):
    """Redraw every AR LL net in `model` at unit gain (std 1/sqrt(fan-in),
    bias std 0.5), seeded. At the init's std of 0.02 the nets' scales all
    fall in the lowest few table rows and their means round to 0, where
    neither a flipped bit nor the decoder's use of the means would show;
    at unit gain they span most of the table and the means reach tens."""
    from learned_pmctf_tpu_torch.models.context import ContextFusionSubband
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in model.modules():
            if not isinstance(net, ContextFusionSubband):
                continue
            for m in net.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                                   / m.weight[0].numel() ** 0.5)
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.5)
    return model


def ar_test_coder(features=128):
    """A pWave coder with the AR LL model at full width, seeded, its AR
    net at unit gain."""
    from learned_pmctf_tpu_torch.models.layers import init_params
    from learned_pmctf_tpu_torch.models.pwave import PWave
    coder = init_params(PWave(ll_mode="ar", ar_features=features),
                        torch.Generator().manual_seed(3))
    return unit_gain_ar(coder).to("cuda").eval()


def phase_ar_causal(coder):
    """The AR LL net on the partial plane of every front against the net
    on the whole plane, at full width (the decoder evaluates the first,
    the encoder the second): the table indexes and rounded means at each
    front's positions must be the same, or the range coder loses sync.
    Also counts the raw f32 scales and means that differ there, and times
    one evaluation (what the decoder pays a front on the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from learned_pmctf_tpu_torch.codec.image_codec import (PWaveCodec,
                                                           ar_wavefronts)
    codec = PWaveCodec(coder)
    g = torch.Generator(device="cuda").manual_seed(4)
    row = {"phase": "ar_causal", "ar_features": coder.context_fusion[-1]["ll"]
           .maskedConv1.out_channels, "planes": {}}
    with torch.no_grad():
        for name, shape in AR_LL.items():
            full = torch.round(torch.randn(shape, device="cuda", generator=g) * 60)
            ref = codec._ar_plane(full)
            ref_raw = torch.cat(coder.ar_params(full))
            order = torch.zeros(shape[2:], dtype=torch.long, device="cuda")
            fronts = ar_wavefronts(*shape[2:])
            for t, (rows, cols) in enumerate(fronts):
                order[rows, cols] = t
            compared = mismatches = raw_mismatches = 0
            for t, (rows, cols) in enumerate(fronts):
                partial = torch.where(order < t, full, torch.zeros_like(full))
                got = codec._ar_plane(partial)[:, :, :, rows, cols]
                raw = torch.cat(coder.ar_params(partial))[:, :, rows, cols]
                compared += got[0].numel()
                mismatches += int((got != ref[:, :, :, rows, cols]).any(0).sum())
                raw_mismatches += int((raw != ref_raw[:, :, rows, cols]).sum())
            row["planes"][name] = {"shape": list(shape), "fronts": len(fronts),
                                   "positions_compared": compared,
                                   "mismatches": mismatches,
                                   "raw_f32_mismatches": raw_mismatches,
                                   "ar_plane_ms": cuda_ms(lambda: codec._ar_plane(full))}
            # the kernels cuDNN runs the masked convs with (a Winograd or
            # FFT algorithm would mix the masked inputs into every output)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                codec._ar_plane(full)
                torch.cuda.synchronize()
            row["planes"][name]["device_kernels"] = sorted(
                {e.key[:100] for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation})
    emit(row)
    bad = {k: v["mismatches"] for k, v in row["planes"].items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"ar_causal: the partial-plane AR outputs differ "
                             f"from the full plane's at {bad} positions")
    return row


def phase_ar_slice(smi):
    """Full-width pMCTF-L with the AR LL coder (its AR nets at unit gain):
    the estimate GOP-4 and the stream GOP-4 as for the four-step model,
    with the AR front count and the copies to the host checked."""
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    h, w = LUMA
    model = unit_gain_ar(build_pmctf("cuda", seed=0, num_me_stages=4, ll_mode="ar"))
    luma, chroma = synthetic_gop(GOP, h, w, "cuda")
    out, est = timed_code_gop(model, luma, chroma, runs=1)
    stream, stream_by_variant = stream_runs(model, luma, chroma, out["bits"],
                                            ll_mode="ar")
    emit({"phase": "ar_slice", "estimate": est, "stream": stream, "card": smi})
    del model, luma, chroma
    torch.cuda.empty_cache()
    return est["conv3x3_launches_by_variant"], stream_by_variant


# the per-sequence log of the JAX package's test_pmctf_flex.py (its
# run_test plus main's two keys), its dataset average and its summary
CLI_LOG_KEYS = {
    "frame_pixel_num", "i_frame_num", "p_frame_num", "b_frame_num", "frame_bpp",
    "frame_bpp_mv", "frame_psnr", "frame_psnr_rgb", "frame_msssim", "frame_type",
    "test_time", "ave_i_frame_bpp", "ave_i_frame_psnr", "ave_i_frame_psnr_rgb",
    "ave_i_frame_msssim", "ave_p_frame_bpp", "ave_p_frame_psnr",
    "ave_p_frame_psnr_rgb", "ave_p_frame_msssim", "ave_p_frame_bpp_mv",
    "ave_all_frame_bpp", "ave_all_frame_bpp_mv", "ave_all_frame_psnr",
    "ave_all_frame_psnr_rgb", "ave_all_frame_msssim", "avg_p_encoding_time_ms",
    "avg_p_decoding_time_ms", "ds_name", "video_path"}
CLI_AVERAGE_KEYS = {
    "test_time", "ave_p_frame_bpp", "ave_p_frame_psnr", "ave_p_frame_psnr_rgb",
    "ave_p_frame_msssim", "ave_all_frame_bpp", "ave_all_frame_bpp_mv",
    "ave_all_frame_psnr", "ave_all_frame_psnr_rgb", "ave_all_frame_msssim"}
CLI_SUMMARY_KEYS = {"bpp", "psnr-rgb", "psnr-yuv", "quality", "ms-ssim-rgb", "bpp_mv"}


def phase_cli(smi):
    """The eval CLI as a user runs it, in its own process: a synthetic
    1080p GOP-4 at q index 20, AR LL, written to streams and decoded."""
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "learned_pmctf_tpu_torch.cli.flex",
               "--synthetic", "4", "--synthetic_size", "1080x1920",
               "--force_intra_period", "4", "--q_index_num", "1",
               "--num_me_stages", "4", "--ll_mode", "ar", "--write_stream", "1",
               "--output_path", os.path.join(d, "out.json"),
               "--stream_path", os.path.join(d, "bin")]
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        wall_s = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"cli exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-3000:]}")
        logs = {}
        for q in (20,):
            with open(os.path.join(d, f"out_qidx{q}.json")) as f:
                res = json.load(f)["synthetic_ds"]
            log = res["synthetic"]
            if set(log) != CLI_LOG_KEYS or set(res["AVERAGE"]) != CLI_AVERAGE_KEYS:
                raise AssertionError(f"cli q{q}: keys {sorted(set(log) ^ CLI_LOG_KEYS)}"
                                     f" {sorted(set(res['AVERAGE']) ^ CLI_AVERAGE_KEYS)}")
            vals = log["frame_psnr"] + log["frame_psnr_rgb"] + log["frame_msssim"]
            if not (all(v == v and abs(v) != float("inf") for v in vals)
                    and all(0 < v <= 1 for v in log["frame_msssim"])
                    and all(b > 0 for b in log["frame_bpp"])):
                raise AssertionError(f"cli q{q}: bad metrics or bits {log}")
            logs[q] = {k: log[k] for k in ("frame_bpp", "frame_psnr", "frame_psnr_rgb",
                                           "frame_msssim", "ave_all_frame_bpp",
                                           "ave_all_frame_psnr",
                                           "avg_p_encoding_time_ms",
                                           "avg_p_decoding_time_ms", "test_time")}
        with open(os.path.join(d, "out_summary.json")) as f:
            summary = json.load(f)
        if set(summary) != CLI_SUMMARY_KEYS or summary["quality"] != ["20"]:
            raise AssertionError(f"cli summary {summary}")
    emit({"phase": "cli", "command": " ".join(cmd[1:]), "wall_s": wall_s,
          "logs": logs, "summary": summary, "card": smi})


# ---- bench.py's configuration (phases 19-20) ----------------------------------

def _policy_gap(got, bf16, f32):
    """(max |got - bf16|, max |bf16 - f32|) over all values of an output."""
    flat = [torch.cat([torch.as_tensor(v, dtype=torch.float64).reshape(-1).cpu()
                       for v in vals]) for vals in (got, bf16, f32)]
    return (float((flat[0] - flat[1]).abs().max()),
            float((flat[1] - flat[2]).abs().max()))


def phase_bench_small_reference():
    """The small model in bench.py's configuration (fast warp, act_bf16),
    GOP-4 at 64x64: the card against the CPU, under the 0.25 rule against
    the card's own f32 run."""
    from learned_pmctf_tpu_torch.gop import code_gop
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    cfg = dict(SMALL, warp_mode="fast")
    luma, chroma = synthetic_gop(GOP, 64, 64, "cpu", seed=1)
    runs = {}
    for name, dev, bf16 in (("cpu", "cpu", True), ("card", "cuda", True),
                            ("card_f32", "cuda", False)):
        model = build_pmctf(dev, seed=1, act_bf16=bf16, **cfg)
        runs[name] = code_gop(model, luma, chroma, 10.0, device=dev)
    keys = [(fi, k) for fi in sorted(runs["card"]["bits"])
            for k in sorted(runs["card"]["bits"][fi])]
    names = ("cpu", "card", "card_f32")
    outputs = {"bits": [[[r["bits"][fi][k] for fi, k in keys]] for r in
                        (runs[n] for n in names)]}
    for plane in ("luma", "chroma"):
        outputs[plane] = [runs[n][plane] for n in names]
    outputs["reconstructions"] = [runs[n]["luma"] + runs[n]["chroma"] for n in names]
    gaps = {k: _policy_gap(*v) for k, v in outputs.items()}
    # the rule holds on the bits and on the reconstructions; luma and
    # chroma apart are reported (where the policy moves a plane by about
    # an ulp of PostProcess's output, one rounding that cuDNN's sums and
    # the CPU's put on different sides weighs as much as the policy)
    bad = {k: gaps[k] for k in ("bits", "reconstructions")
           if not (gaps[k][1] > 0 and gaps[k][0] <= 0.25 * gaps[k][1])}
    row = {"phase": "bench_small_reference", "gop": GOP, "size": [64, 64],
           "config": {**cfg, "act_bf16": True}, "rule": 0.25,
           "max_diff_cpu_vs_card_and_policy": gaps}
    if bad:
        raise AssertionError(f"bench_small_reference: {bad}: {row}")
    emit(row)


def phase_bench(smi):
    """The port's bench as a user runs it, in its own process (GOP-16 in
    bench.py's configuration, median of 3; --secondary: the exact-warp
    f32 GOP-16 and the fast-warp stream GOP-4), then the bench
    configuration's GOP-4 here: its conv3x3 launches counted, one GOP
    profiled by layer. Returns the GOP-4's launches by variant."""
    from learned_pmctf_tpu_torch.cli.bench import BENCH_CONFIG, METRIC, bench_frames
    from learned_pmctf_tpu_torch.gop import code_gop
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    h, w = LUMA
    cmd = [sys.executable, "-m", "learned_pmctf_tpu_torch.cli.bench", "--secondary"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines:\n{proc.stdout[-3000:]}")
    out = json.loads(lines[0])
    sec = out["secondary"]
    exact, stream = sec["estimate_exact_warp_f32"], sec["write_stream_gop4"]
    want = {"head": postprocess_launches(w, 2 * 16, torch.bfloat16),
            "exact": postprocess_launches(w, 2 * 16)}
    checks = [
        (out["metric"] == METRIC and "vs_baseline" not in out, "metric"),
        (all(0 < v < float("inf") for v in (out["value"], exact["value"],
                                             stream["value"])), "frames/s"),
        (len(out["runs_ms"]) == 3, "three timed runs"),
        (out["config"]["gop"] == 16 and [out["config"]["height"], out["config"]["width"]]
         == [h, w], "GOP-16 padded 1080p"),
        (all(out["config"][k] == v for k, v in BENCH_CONFIG.items()), "configuration"),
        (out["conv3x3_launches_by_variant"] == want["head"], "bf16 launches"),
        (exact["conv3x3_launches_by_variant"] == want["exact"], "f32 launches"),
        (stream["decoded_equal_encoder"], "stream decoded"),
        (out["device"]["card"] == smi, "card")]
    bad = [what for ok, what in checks if not ok]
    if bad:
        raise AssertionError(f"bench: {bad}: {out}")

    model = build_pmctf("cuda", seed=0, **BENCH_CONFIG)
    luma, chroma = bench_frames(GOP, h, w, "cuda")
    code_gop(model, luma, chroma, 10.0)  # warm-up
    torch.cuda.synchronize()
    count_from_zero()
    t = time.perf_counter()
    gop4 = code_gop(model, luma, chroma, 10.0)
    torch.cuda.synchronize()
    gop4_ms = (time.perf_counter() - t) * 1e3
    by_variant = counted("bench GOP-4")
    expected = postprocess_launches(w, 2 * GOP, torch.bfloat16)
    if by_variant != expected:
        raise AssertionError(f"bench GOP-4: conv3x3 launches {by_variant}, "
                             f"expected {expected}")
    check_outputs(gop4, h, w)
    emit({"phase": "bench", "command": " ".join(cmd[1:]), "wall_s": wall_s,
          "bench": out, "gop4_ms": gop4_ms, "gop4_conv3x3_launches_by_variant": by_variant,
          "card": smi})
    phase_profile(model, luma, chroma, phase="bench_profile")
    del model, luma, chroma, gop4
    torch.cuda.empty_cache()
    return by_variant


# ---- training (phases 13-17) -------------------------------------------------

SMALL = dict(decomp_levels=2, num_me_stages=2, channel_mv=8, channel_n=8,
             features=16, ar_features=16)
TRAIN_BATCH, TRAIN_PATCH = 8, (128, 128)  # train_pmctf.py's defaults
PWAVE_BATCH, PWAVE_PATCH = 16, (256, 256)  # train_pwave.py's defaults
GRAD_TOL = 1e-3   # against the plain version's autograd, of the largest |grad|
GRAD_F64_TOL = 1e-4  # against float64, of the largest |grad|


def _max_rel(a, b):
    return float((a.double() - b.double()).abs().max()) / max(
        float(b.double().abs().max()), 1e-30)


def conv_grads(fn, x, w, b, r, dy, act):
    """y and [d_x, d_w, d_b(, d_residual)] of fn by autograd."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    rr = r.detach().clone().requires_grad_() if r is not None else None
    y = fn(*leaves, act=act, residual=rr)
    y.backward(dy)
    return y.detach(), [t.grad for t in leaves] + ([rr.grad] if rr is not None else [])


def phase_train_kernel_grad(smi):
    """Conv3x3Function at the training shapes: the four PostProcess
    convs at pMCTF's (batch 8, 128x128) and pWave's (batch 16, 256x256)
    training shapes. Every gradient against the plain version's autograd
    and float64; the forward, the d_x launch (flipped weights packed and
    launched, as backward does it) and the full backward timed beside the
    plain version's and one torch.nn.grad.conv2d_input call."""
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3
    g = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for label, n, hh, ww in (("pmctf", TRAIN_BATCH, *TRAIN_PATCH),
                             ("pwave", PWAVE_BATCH, *PWAVE_PATCH)):
        for c, o, act, res in ((1, 64, None, False), (64, 64, "leaky_relu", False),
                               (64, 64, None, True), (64, 1, None, False)):
            x = torch.randn(n, c, hh, ww, device="cuda", generator=g)
            w = torch.randn(o, c, 3, 3, device="cuda", generator=g) / (3 * c ** 0.5)
            b = torch.randn(o, device="cuda", generator=g) * 0.1
            r = torch.randn(n, o, hh, ww, device="cuda", generator=g) if res else None
            dy = torch.randn(n, o, hh, ww, device="cuda", generator=g)
            before = c3.conv3x3.launches
            y, got = conv_grads(c3.conv3x3, x, w, b, r, dy, act)
            torch.cuda.synchronize()
            launches = c3.conv3x3.launches - before
            # the references take the kernel's activation pattern: where a
            # pre-activation lies within the forward's error of 0 the two
            # forwards may pick different sides of the LeakyReLU, which is
            # the forward's difference, not the backward's (counted below)
            g_pre = torch.where(y >= 0, dy, 0.2 * dy) if act == "leaky_relu" else dy
            _, plain = conv_grads(c3.conv3x3_plain, x, w, b, r, g_pre, None)
            z64 = c3.conv3x3_plain(x.double(), w.double(), b.double(), None,
                                   None if r is None else r.double())
            flips = int(((z64 >= 0) != (y >= 0)).sum()) if act else 0
            del z64
            # the weight gradient in one conv2d_weight call over the batch,
            # which Conv3x3Function does not use (see weight_grad)
            dw_one = torch.nn.grad.conv2d_weight(x, w.shape, g_pre, padding=1)
            _, f64 = conv_grads(c3.conv3x3_plain, x.double(), w.double(), b.double(),
                                None if r is None else r.double(), g_pre.double(), None)
            names = ["d_x", "d_w", "d_b", "d_residual"][:len(got)]
            errs = {k: _max_rel(a, e) for k, a, e in zip(names, got, plain)}
            errs64 = {k: _max_rel(a, e) for k, a, e in zip(names, got, f64)}
            dw_one_err64 = _max_rel(dw_one, f64[1])
            del dw_one
            shape = f"{label} {n}x{c}x{hh}x{ww} {c}->{o}" + (
                f" {act}" if act else "") + (" residual" if res else "")
            if launches != 2:
                raise AssertionError(f"train_kernel_grad {shape}: {launches} conv3x3 "
                                     "launches for forward+backward, expected 2")
            bad = {k: v for k, v in errs.items() if not v <= GRAD_TOL}
            bad.update({f"{k} vs f64": v for k, v in errs64.items()
                        if not v <= GRAD_F64_TOL})
            if bad:
                raise AssertionError(f"train_kernel_grad {shape}: {bad}")
            del plain, f64
            # the input gradient's own launch: a conv O->C on g, 'same'
            wf = c3.flipped_weights(w)
            zeros = w.new_zeros(c)
            d_variant = c3.variants_for(o, c, ww)[0]
            # as backward runs it (the flip and its pack cached on w); and the
            # launch alone on weights packed once
            dx_ms = cuda_ms(lambda: c3.conv3x3(dy, c3.flipped_weights(w), zeros))
            # flipped and packed anew on every call, as without the cache
            dx_uncached_ms = cuda_ms(lambda: c3.conv3x3(
                dy, w.flip(2, 3).transpose(0, 1).contiguous(), zeros))
            dx_kernel_ms = cuda_ms(lambda: c3.conv3x3(dy, wf, zeros))
            dx_library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_input(
                x.shape, w, dy, padding=1))
            dx_plain_ms = cuda_ms(lambda: c3.conv3x3_plain(dy, wf, zeros))
            leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]

            def fwd(fn):
                return fn(*leaves, act=act, residual=r)

            def bwd(fn):
                return lambda: fwd(fn).backward(dy)

            row = {"phase": "train_kernel_grad", "shape": shape,
                   "x": [n, c, hh, ww], "o": o,
                   "variant": c3.variants_for(c, o, ww)[0], "d_x_variant": d_variant,
                   "launches_forward_backward": launches,
                   "activation_sides_differing_from_f64": flips,
                   "rel_err_vs_plain": errs, "rel_err_vs_f64": errs64,
                   "tol": GRAD_TOL, "f64_tol": GRAD_F64_TOL,
                   "d_w_one_call_rel_err_vs_f64": dw_one_err64,
                   "d_w_ms": cuda_ms(lambda: c3.weight_grad(x, w.shape, dy)),
                   "d_w_one_call_ms": cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                       x, w.shape, dy, padding=1)),
                   "forward_ms": cuda_ms(lambda: fwd(c3.conv3x3).detach()),
                   "d_x_ms": dx_ms, "d_x_uncached_ms": dx_uncached_ms,
                   "d_x_kernel_ms": dx_kernel_ms,
                   "d_x_plain_ms": dx_plain_ms,
                   "d_x_library_ms": dx_library_ms,
                   "forward_backward_ms": cuda_ms(bwd(c3.conv3x3)),
                   "plain_forward_backward_ms": cuda_ms(bwd(c3.conv3x3_plain))}
            bound = conv_bound(n, o, c, hh, ww, False, d_variant)
            row.update({"d_x_bound_ms": bound["bound_ms"],
                        "d_x_bound_by": bound["bound_by"]})
            if not dx_kernel_ms >= bound["bound_ms"]:
                raise AssertionError(f"train_kernel_grad {shape}: d_x {dx_kernel_ms} ms "
                                     f"is under its bound {bound['bound_ms']} ms")
            emit(row)
            rows.append(row)
            del x, w, b, r, dy, y, got, leaves
            torch.cuda.empty_cache()
    return rows


def group_of(name):
    """A parameter's top-level module (SpyNet, the MV encoder, a coder)."""
    return name.split(".")[0]


def module_group_of(name):
    """A parameter's module group: its first two name parts."""
    return ".".join(name.split(".")[:2])


def module_of(name):
    """The module that owns a parameter (a conv's weight and bias)."""
    return name.rsplit(".", 1)[0]


# output biases of the MV decoders' last layer (2 flow channels x 4 pixel
# shuffle phases): a sub-pixel flow where the seeded init decodes exactly 0
MV_OFFSET = (0.37, -0.29, 0.43, -0.21, 0.31, -0.41, 0.23, -0.33)
F64_GRAD_AGREE = 1e-9  # float64 card against CPU, of the module's largest |grad|
KERNEL_GRAD_TOL = 1e-2  # kernel on against off, of the module group's largest |grad|
F32_PRECISION_X = 10.0  # card's median f32 gradient error over the CPU's


def small_train_grads(device, dtype, frames, noise, offset, use_kernel=True):
    """(loss, log, grads) of the small config's GOP-2 train loss from the
    seeded weights, the MV decoders' output biases moved by `offset`."""
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    from learned_pmctf_tpu_torch.training.steps import StageGates, pmctf_gop_loss
    model = build_pmctf(device, seed=1, **SMALL).to(dtype)
    for coder in (model.lp_coder, model.hp_coder):
        coder.dequantModule.use_kernel = use_kernel and dtype == torch.float32
    if offset is not None:
        with torch.no_grad():
            for dec in model.mv_decoder:
                dec.dec_3[1][0].bias += torch.tensor(offset, dtype=dtype, device=device)
    loss, log = pmctf_gop_loss(model, [f.to(device, dtype) for f in frames], 10.0,
                               0.05, StageGates.for_stage(5),
                               noise=[tuple(t.to(dtype) for t in n) for n in noise])
    loss.backward()
    return (float(loss.detach()), {k: float(v) for k, v in log.items()},
            {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()
             if p.grad is not None})


def _grad_worst(a, b, tol):
    """(max over parameters of |a - b| / tol(name), name)."""
    top = (0.0, None)
    for k in a:
        err = float((a[k] - b[k]).abs().max())
        top = max(top, (err / max(tol(k), 1e-300), k), key=lambda t: t[0])
    return top


def _largest(grads, key):
    out = {}
    for k, v in grads.items():
        out[key(k)] = max(out.get(key(k), 0.0), float(v.abs().max()))
    return out


def phase_train_small_reference():
    """The small config's GOP-2 train loss and gradients on the card and on
    the CPU, from the same weights and the same noise (drawn on the CPU).

    At the seeded init the decoded motion is exactly 0, so the warp samples
    at integer coordinates, where bilinear interpolation's derivative in
    the flow jumps, and the card and the CPU may take either side (their
    float64 gradients upstream of the motion are reported there, not
    held). The checks run with the MV decoders' output biases moved by
    MV_OFFSET, a sub-pixel flow where that derivative is smooth:
    - float64 (PostProcess on its plain version: the kernel takes f32
      only): losses within rel 1e-9, every gradient within 1e-9 of its
      module's largest magnitude;
    - f32 on the card, PostProcess on the kernel against the same run on
      its plain version: every gradient within 1e-2 of its module group's
      largest magnitude (the kernel's 3e-5 moves cancelling sums by a few
      percent of their own module's largest magnitude);
    - f32 precision, PostProcess on its plain version: the card's median
      error against its float64 run, each gradient's relative to its own
      size, within 10 times the CPU's (a card that lost precision, to
      TF32 say, would be a hundred times off or more); the losses (kernel on)
      within rel 1e-4; the f32 gradients of the card (kernel on) against
      the CPU's are reported: by the triangle inequality the checks above
      bound them, and a per-gradient bound from both sides' own f32
      errors would add nothing to them;
    - PostProcess's conv1/conv3 gradients non-zero on the card."""
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    from learned_pmctf_tpu_torch.training.steps import draw_pair_noise
    luma, _ = synthetic_gop(2, 64, 64, "cpu", seed=3)
    frames = [torch.cat([f, torch.flip(f, (3,))]) for f in luma]  # batch 2
    noise = draw_pair_noise(build_pmctf("cpu", seed=1, **SMALL), frames,
                            torch.Generator().manual_seed(4))
    f32, f64 = torch.float32, torch.float64
    init = {dev: small_train_grads(dev, f64, frames, noise, None)
            for dev in ("cuda", "cpu")}
    runs = {(dev, dtype, kern): small_train_grads(dev, dtype, frames, noise, MV_OFFSET,
                                                  use_kernel=kern)
            for dev, dtype, kern in (("cuda", f32, True), ("cuda", f32, False),
                                     ("cuda", f64, False), ("cpu", f32, False),
                                     ("cpu", f64, False))}
    g_kern, g_card = runs["cuda", f32, True][2], runs["cuda", f32, False][2]
    g64_card, g_cpu = runs["cuda", f64, False][2], runs["cpu", f32, False][2]
    g64_cpu = runs["cpu", f64, False][2]
    if not (set(g_kern) == set(g_card) == set(g64_card) == set(g_cpu) == set(g64_cpu)
            == set(init["cuda"][2]) == set(init["cpu"][2])):
        raise AssertionError("train_small_reference: gradients of other parameters")
    module_max = _largest(g64_cpu, module_of)
    group_max = _largest(g_cpu, module_group_of)
    f64_agree = _grad_worst(g64_card, g64_cpu,
                            lambda k: F64_GRAD_AGREE * module_max[module_of(k)])
    kernel = _grad_worst(g_kern, g_card,
                         lambda k: KERNEL_GRAD_TOL * group_max[module_group_of(k)])
    # reported, not held: the float64 agreement, the kernel check and the
    # precision check bound it
    card_cpu = _grad_worst(g_kern, g_cpu, lambda k: group_max[module_group_of(k)])

    def median_rel_err(g, g64):  # of the reached gradients, each of its own size
        return statistics.median(float((g[k] - g64[k]).abs().max() / g64[k].abs().max())
                                 for k in g64 if float(g64[k].abs().max()) > 0)

    precision = {"card": median_rel_err(g_card, g64_card),
                 "cpu": median_rel_err(g_cpu, g64_cpu)}
    precision["ratio"] = precision["card"] / max(precision["cpu"], 1e-300)
    top_max = _largest(init["cpu"][2], group_of)
    init_f64 = {}
    for k, v in init["cpu"][2].items():
        d = float((init["cuda"][2][k] - v).abs().max()) / max(top_max[group_of(k)], 1e-300)
        init_f64[group_of(k)] = max(init_f64.get(group_of(k), 0.0), d)
    post = {k: float(g_kern[f"hp_coder.dequantModule.{k}.weight"].abs().max())
            for k in ("conv1", "conv3")}
    loss = {f"{dev}_{str(dtype)[6:]}" + ("_kernel" if kern else ""): v[0]
            for (dev, dtype, kern), v in runs.items()}
    row = {"phase": "train_small_reference", "gop": 2, "batch": 2, "size": [64, 64],
           "mv_offset": MV_OFFSET, "loss": loss,
           "log_card": runs["cuda", f32, True][1], "log_cpu": runs["cpu", f32, False][1],
           "params_with_grad": len(g_card),
           "f64_card_vs_cpu_over_tol": f64_agree, "f64_tol": F64_GRAD_AGREE,
           "f32_kernel_vs_plain_over_tol": kernel, "kernel_tol": KERNEL_GRAD_TOL,
           "f32_card_kernel_vs_cpu_of_group_max": card_cpu,
           "f32_median_rel_err_vs_f64": precision,
           "init_loss_f64": {dev: init[dev][0] for dev in init},
           "init_f64_grad_err_of_group_max_by_group": init_f64,
           "postprocess_grad_max_card": post}
    emit(row)
    l_kern, l_cpu = loss["cuda_float32_kernel"], loss["cpu_float32"]
    l64_card, l64_cpu = loss["cuda_float64"], loss["cpu_float64"]
    if not (abs(l_kern - l_cpu) <= 1e-4 * abs(l_cpu)
            and abs(l64_card - l64_cpu) <= 1e-9 * abs(l64_cpu)):
        raise AssertionError(f"train_small_reference: losses {loss}")
    bad = {k: v for k, v in (("f64", f64_agree), ("kernel", kernel))
           if not v[0] <= 1.0}
    if not precision["ratio"] <= F32_PRECISION_X:
        bad["precision"] = precision
    if bad:
        raise AssertionError(f"train_small_reference: gradients off: {bad}")
    if not all(v > 0 for v in post.values()):
        raise AssertionError(f"train_small_reference: PostProcess gradients {post}")


def train_frames(n, batch, hw, seed):
    """(n, batch, 1, H, W) smooth 8-bit frames moving by (2, 3) px a frame,
    each sample its own crop, made on the card."""
    luma, _ = synthetic_gop(n, hw[0] * 2, hw[1] * 2, "cuda", seed=seed)
    clip = torch.stack(luma)[:, 0, 0]  # (n, 2H, 2W)
    g = torch.Generator().manual_seed(seed)
    crops = []
    for _ in range(batch):
        top = int(torch.randint(0, hw[0], (1,), generator=g))
        left = int(torch.randint(0, hw[1], (1,), generator=g))
        crops.append(clip[:, top:top + hw[0], left:left + hw[1]])
    return torch.stack(crops, 1)[:, :, None].contiguous()


def train_launch_expect(calls, w, recompute=True):
    """conv3x3 launches by variant of a train step with `calls`
    PostProcess calls (a GOP step: one a highpass pair, one for the
    lowpass band): each launches its 15 convs in the forward, again in
    the recompute under per-pair checkpointing, and once more for each
    conv's input gradient (a 1->64 conv's is 64->1, a 64->1's is 1->64)."""
    from learned_pmctf_tpu_torch.ops.conv3x3 import variants_for
    fwd = 2 if recompute else 1
    out = {}
    for (c, o), times in (((1, 64), fwd), ((64, 64), 13 * fwd), ((64, 1), fwd),
                          ((64, 1), 1), ((64, 64), 13), ((1, 64), 1)):
        v = variants_for(c, o, w)[0]
        out[v] = out.get(v, 0) + times * calls
    return out


def grad_norms(model):
    """Gradient norm of every trainable top-level module group."""
    norms = {}
    for k, p in model.named_parameters():
        if p.requires_grad and p.grad is not None:
            norms[group_of(k)] = norms.get(group_of(k), 0.0) + float(
                p.grad.double().pow(2).sum())
    return {k: v ** 0.5 for k, v in norms.items()}


def check_packs_fresh(model, step, frames, noise):
    """After an optimizer step (the fused AdamW, which bumps no version
    counter itself) the kernel must run the new weights, not the pack
    cached before it: one more train step must bump a PostProcess
    weight's version (the cache key), and the kernel then equals the plain
    version on the new weights and its cached pack a fresh one."""
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3
    o_pad = c3._load().conv3x3_padded_o(64)
    x = torch.randn(1, 64, 32, 64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))

    def launch_err(w, b):
        with torch.no_grad():
            return float((c3.conv3x3(x, w, b) - c3.conv3x3_plain(x, w, b)).abs().max())

    conv = model.hp_coder.dequantModule.resBlocks[0].conv1
    launch_err(conv.weight, conv.bias)  # caches the pack
    version = conv.weight._version
    step(frames, 10.0, 0.05, noise)
    checks = {"step_bumped_version": conv.weight._version != version,
              "step_launch_err": launch_err(conv.weight, conv.bias),
              "step_pack_fresh": torch.equal(
                  c3.packed_weights(conv.weight, "wgmma", o_pad),
                  c3.pack_weights(conv.weight.detach(), "wgmma", o_pad))}
    if not (checks["step_bumped_version"] and checks["step_pack_fresh"]
            and checks["step_launch_err"] <= KERNEL_TOL):
        raise AssertionError(f"stale conv3x3 weight packs after a step: {checks}")
    return checks


def timed_train_steps(step, frames, noise, steps, expect):
    """A warm-up step, whose conv3x3 launches are counted against
    `expect`, then `steps` timed steps (host clock, synchronized; with
    none, the counted step is the one timed); the loss of every step must
    be finite."""
    from learned_pmctf_tpu_torch.ops.conv3x3 import conv3x3, packed_weights

    def run():
        log = step(frames, 10.0, 0.05, noise)
        torch.cuda.synchronize()
        if not torch.isfinite(log["rd_loss"]):
            raise AssertionError(f"train step: non-finite loss {log}")
        return log

    count_from_zero()
    packs = packed_weights.packs
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    log = run()
    first_ms = (time.perf_counter() - t) * 1e3
    launches, by_variant = conv3x3.launches, counted("train step")
    packs = packed_weights.packs - packs
    if by_variant != expect:
        raise AssertionError(f"train step: conv3x3 launches by variant {by_variant}, "
                             f"expected {expect}")
    if steps:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        log = run()
        times.append((time.perf_counter() - t) * 1e3)
    times = times or [first_ms]
    return {"step_ms": statistics.median(times), "step_ms_min": min(times),
            "step_ms_max": max(times), "step_ms_runs": times,
            "conv3x3_launches": launches, "conv3x3_launches_by_variant": by_variant,
            "weight_packs": packs,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "log": {k: float(v) for k, v in log.items()}}


def weight_grad_ab(step, frames, noise, rounds=2):
    """Host time of a train step (ending in a synchronize) with
    PostProcess's weight gradients by ``weight_grad`` (one grouped
    conv2d_weight call, a sample a group, the parts summed) and by one
    plain conv2d_weight call over the batch, the two alternated step by
    step."""
    from learned_pmctf_tpu_torch.ops import conv3x3 as c3
    grouped = c3.weight_grad

    def one_call(x, w_shape, g):
        return torch.nn.grad.conv2d_weight(x, w_shape, g, padding=1)

    times = {"one_call": [], "weight_grad": []}
    try:
        for _ in range(rounds):
            for mode, fn in (("one_call", one_call), ("weight_grad", grouped)):
                c3.weight_grad = fn
                t = time.perf_counter()
                step(frames, 10.0, 0.05, noise)
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t) * 1e3)
    finally:
        c3.weight_grad = grouped
    out = {f"{k}_step_ms": statistics.median(v) for k, v in times.items()}
    out["runs"] = times
    out["weight_grad_cost_ms"] = out["weight_grad_step_ms"] - out["one_call_step_ms"]
    return out


def phase_train_pmctf(smi):
    """Full-width pMCTF-L (train_pmctf.py's model: num_me_stages 2) at the
    trainer's defaults (batch 8, 128x128 luma, exact warp), seeded:
    curriculum stage 6 (GOP-4, part All, quant_stage on; a warm-up whose
    launches are counted, 2 timed steps, the weight-gradient A/B) and
    stage 8 (GOP-16; a counted warm-up, 1 timed step), then a profile of
    one GOP-4 step."""
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    from learned_pmctf_tpu_torch.training.curriculum import PART_PREDICATES
    from learned_pmctf_tpu_torch.training.optim import make_optimizer, trainable_mask
    from learned_pmctf_tpu_torch.training.steps import StageGates, make_pmctf_train_step
    model = build_pmctf("cuda", seed=0, num_me_stages=2, quant_stage=False).train()
    model.quant_stage = True  # switched on from stage 6
    opt = make_optimizer(model, 1e-5, weight_decay=0.0, clip_norm=5.0,
                         trainable=trainable_mask(model, PART_PREDICATES["All"]))
    noise = torch.Generator(device="cuda").manual_seed(7)
    w = TRAIN_PATCH[1]
    row = {"phase": "train_pmctf", "model": "pMCTF-L full width (seeded random weights)",
           "batch": TRAIN_BATCH, "patch": list(TRAIN_PATCH), "warp_mode": "exact",
           "parameters": sum(p.numel() for p in model.parameters())}
    step4 = make_pmctf_train_step(model, opt, 4, StageGates.for_stage(5))
    frames4 = train_frames(4, TRAIN_BATCH, TRAIN_PATCH, seed=11)
    gop4 = timed_train_steps(step4, frames4, noise, 2, train_launch_expect(4, w))
    gop4["frames_per_s"] = TRAIN_BATCH * 4 / (gop4["step_ms"] / 1e3)
    # a step packs each PostProcess weight of both coders once after the
    # optimizer changed it (13 wgmma, 1 direct a coder) and the flipped
    # weights of every input gradient (13 wgmma, 1 direct a call; the
    # 64->1 head reads its weights unpacked)
    gop4["weight_packs_reckoned"] = 14 * (2 + 4)
    gop4["grad_norms"] = norms = grad_norms(model)
    if not all(0 < v < float("inf") for v in norms.values()):
        raise AssertionError(f"train_pmctf: gradient norms {norms}")
    gop4["packs"] = check_packs_fresh(model, step4, frames4, noise)
    gop4["weight_grad_ab"] = weight_grad_ab(step4, frames4, noise, rounds=1)
    row["gop4_stage6"] = gop4
    row["gop4_stage6_fast_warp"] = fast_warp_steps(model, step4, frames4, noise, w)
    step16 = make_pmctf_train_step(model, opt, 16, StageGates.for_stage(7))
    frames16 = train_frames(16, TRAIN_BATCH, TRAIN_PATCH, seed=12)
    # the GOP-16 pairs have the GOP-4 pairs' shapes: its counted step is
    # the one timed
    gop16 = timed_train_steps(step16, frames16, noise, 0, train_launch_expect(16, w))
    gop16["frames_per_s"] = TRAIN_BATCH * 16 / (gop16["step_ms"] / 1e3)
    gop16["weight_packs_reckoned"] = 14 * (2 + 16)
    row["gop16_stage8"] = gop16
    del frames16
    torch.cuda.empty_cache()
    row["profile_gop4"] = profile_train_step(model, opt, frames4, noise)
    emit({**row, "card": smi})
    return gop4["conv3x3_launches_by_variant"]


def fast_warp_steps(model, step, frames, noise, w):
    """The stage-6 GOP-4 step with the fast warp, cli/train_pmctf.py's
    default (the same model with warp_mode "fast" in the temporal lifting
    and SpyNet's pyramid, as build_pmctf(warp_mode="fast") makes it): a
    counted warm-up, a timed step, finite gradients."""
    model.warp_mode, model.optic_flow.fast_warp = "fast", True
    try:
        out = timed_train_steps(step, frames, noise, 1, train_launch_expect(4, w))
        out["frames_per_s"] = TRAIN_BATCH * 4 / (out["step_ms"] / 1e3)
        out["grad_norms"] = norms = grad_norms(model)
        if not all(0 < v < float("inf") for v in norms.values()):
            raise AssertionError(f"train_pmctf fast warp: gradient norms {norms}")
    finally:
        model.warp_mode, model.optic_flow.fast_warp = "exact", False
    return out


def profile_train_step(model, opt, frames, noise):
    """Device time of one GOP-4 train step: forward, backward (the
    recompute included), optimizer, each ended by a synchronize so that
    a kernel's device time falls in its part's window; the recompute is
    the device time of the module ranges that run inside backward; the
    forward and the recompute split by layer as the estimate profile
    splits them (conv3x3 launches through ctypes belong to no range: their
    time is reported whole); the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from learned_pmctf_tpu_torch.training.steps import StageGates, pmctf_gop_loss
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            opt.zero_grad()
            with record_function("train:forward"):
                loss, _ = pmctf_gop_loss(model, frames, 10.0, 0.05,
                                         StageGates.for_stage(5), noise=noise)
                torch.cuda.synchronize()
            with record_function("train:backward"):
                loss.backward()
                torch.cuda.synchronize()
            with record_function("train:optimizer"):
                opt.step()
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        for h in hooks:
            h.remove()
    events = prof.events()
    spans = {e.name.split(":")[1]: e.time_range for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith("train:")}
    part_ms = dict.fromkeys(spans, 0.0)
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            for part, span in spans.items():
                if span.start <= e.time_range.start < span.end:
                    part_ms[part] += e.time_range.elapsed_us() / 1e3
    names = set(labels.values())
    by_layer = {"forward": dict.fromkeys(sorted(names), 0.0),
                "recompute": dict.fromkeys(sorted(names), 0.0)}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in names:
            inside = spans["backward"].start <= e.time_range.start < spans["backward"].end
            by_layer["recompute" if inside else "forward"][e.name] += (
                e.device_time_total / 1e3)
    kernels, busy_ms = device_kernels(prof)
    conv_ms = sum(e.self_device_time_total for e in kernels
                  if "conv3x3" in e.key and "_kernel" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    recompute_ms = sum(by_layer["recompute"].values())
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_ms_by_part": part_ms,
            "recompute_device_ms": recompute_ms,
            "backward_without_recompute_device_ms": part_ms.get("backward", 0.0)
            - recompute_ms,
            "conv3x3_kernels_ms": conv_ms, "device_ms_by_layer": by_layer,
            "top_device_ops_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                  for e in top[:8]}}


def phase_train_pwave(smi):
    """Full-width pWave (features 112, four-step LL) at train_pwave.py's
    defaults (batch 16, 256x256; AdamW, weight decay 0.05, clip 1): a
    warm-up whose launches are counted (15 forward, 15 for the input
    gradients: no recomputation), 2 timed steps, peak memory."""
    from learned_pmctf_tpu_torch.models.layers import init_params
    from learned_pmctf_tpu_torch.models.pwave import PWave
    from learned_pmctf_tpu_torch.training.optim import make_optimizer
    from learned_pmctf_tpu_torch.training.steps import make_pwave_train_step
    model = init_params(PWave(), torch.Generator().manual_seed(0)).cuda().train()
    step = make_pwave_train_step(model, make_optimizer(model, 1e-4, 0.05, 1.0))
    x = train_frames(1, PWAVE_BATCH, PWAVE_PATCH, seed=13)[0]
    w = PWAVE_PATCH[1]

    def run():
        m = step(x, 10.0, 0.05)
        torch.cuda.synchronize()
        if not torch.isfinite(m["loss"]):
            raise AssertionError(f"train_pwave: non-finite loss {m}")
        return m

    count_from_zero()
    run()
    expect = train_launch_expect(1, w, recompute=False)
    by_variant = counted("train_pwave")
    post = {k: float(getattr(model.dequantModule, k).weight.grad.abs().max())
            for k in ("conv1", "conv3")}
    if by_variant != expect or not all(v > 0 for v in post.values()):
        raise AssertionError(f"train_pwave: launches {by_variant}, expected "
                             f"{expect}; PostProcess gradients {post}")
    torch.cuda.reset_peak_memory_stats()
    times, m = [], None
    for _ in range(2):
        t = time.perf_counter()
        m = run()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times)
    emit({"phase": "train_pwave", "model": "pWave full width (seeded random weights)",
          "batch": PWAVE_BATCH, "patch": list(PWAVE_PATCH),
          "parameters": sum(p.numel() for p in model.parameters()),
          "step_ms": step_ms, "step_ms_min": min(times), "step_ms_max": max(times),
          "step_ms_runs": times, "images_per_s": PWAVE_BATCH / (step_ms / 1e3),
          "conv3x3_launches": 30, "conv3x3_launches_by_variant": by_variant,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "postprocess_grad_max": post,
          "metrics": {k: float(v) for k, v in m.items()}, "card": smi})
    del model, x
    torch.cuda.empty_cache()


def write_png_dataset(root, sequences=4, frames=32, h=96, w=112, seed=0):
    """A Vimeo-layout folder of synthetic RGB PNGs (PIL), textured and
    moving by (1, 2) px a frame, with sep_trainlist.txt/sep_testlist.txt.
    32 frames a clip, as vimeo-32's: the GOP-16 stage draws frame
    intervals of 1 or 2."""
    import numpy as np
    from PIL import Image
    g = np.random.default_rng(seed)
    names = []
    for s in range(sequences):
        name = f"00001/{s + 1:04d}"
        d = os.path.join(root, "sequences", name)
        os.makedirs(d)
        base = g.integers(0, 256, (h // 4 + frames, w // 4 + frames, 3))
        base = np.kron(base, np.ones((4, 4, 1)))  # some structure to track
        for t in range(frames):
            Image.fromarray(base[t:t + h, 2 * t:2 * t + w].astype(np.uint8)).save(
                os.path.join(d, f"im{t + 1}.png"))
        names.append(name)
    for f in ("sep_trainlist.txt", "sep_testlist.txt"):
        with open(os.path.join(root, f), "w") as fh:
            fh.write("\n".join(names) + "\n")


def run_cli(module, args, cwd, timeout):
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout, wall_s


def logged(text, key):
    vals = [float(v) for v in re.findall(rf"{key} (\S+)", text)]
    if not vals or not all(v == v and abs(v) != float("inf") for v in vals):
        raise AssertionError(f"no finite {key!r} values in the log:\n{text[-3000:]}")
    return vals


def phase_train_cli(smi):
    """The training CLIs as a user runs them, each in its own process, on
    a synthetic PNG dataset: train_pmctf through all 8 stages of
    configs/train_mctf_smoke.json (1 step an epoch, batch 2, 64x64,
    exact warp), a resume from its stage-7 checkpoint over NCCL, and
    train_pwave for 2 steps."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "vimeo")
        write_png_dataset(data)
        common = ["-d", data, "--batch-size", "2", "--patchsize", "64", "64",
                  "--steps_per_epoch", "1", "--log_every", "1", "--warp_mode",
                  "exact", "--num-workers", "2",
                  "--config", os.path.join(root, "configs", "train_mctf_smoke.json")]
        mod = "learned_pmctf_tpu_torch.cli.train_pmctf"
        out, wall = run_cli(mod, common, d, 600)
        exp = os.path.join(d, "experiments", "pmctf_BS2")
        ckpts = sorted(f for f in os.listdir(exp) if f.startswith("state_epoch"))
        if ckpts != [f"state_epoch{i}" for i in range(8)]:
            raise AssertionError(f"train_pmctf checkpoints {ckpts}")
        for want in ("STAGE 8: part=All frames=16", "cloning ME stage 0 -> 1+",
                     "ENABLE TEMPORAL LAYER ADAPTIVE QUALITY SCALING"):
            if want not in out:
                raise AssertionError(f"train_pmctf log lacks {want!r}")
        with open(os.path.join(exp, "state_epoch7", "meta.json")) as f:
            meta = json.load(f)
        rd = logged(out, " rd")
        # the resume runs as the one rank of a torchrun launcher over NCCL
        # (--data_parallel 1): the data-parallel trainer's wiring
        logs = set(os.listdir(exp))
        out2, wall2 = run_cli("torch.distributed.run", [
            "--standalone", "--nproc_per_node", "1", "-m", mod, *common, "--checkpoint",
            os.path.join(exp, "state_epoch6"), "--resume", "--data_parallel", "1"], d, 300)
        nccl = "data parallel: 1 ranks of 2 rows (nccl)"
        wrote = sorted(set(os.listdir(exp)) - logs)
        if ("resume at epoch 7, stage 8" not in out2 or nccl not in out2
                or sorted(os.listdir(d)) != ["experiments", "vimeo"] or len(wrote) != 1
                or not wrote[0].startswith("train_")):
            raise AssertionError(f"resume over NCCL wrote {wrote}:\n{out2[-2000:]}")
        rd2 = logged(out2, " rd")
        out3, wall3 = run_cli("learned_pmctf_tpu_torch.cli.train_pwave",
                              ["-d", data, "--epochs", "1", "--batch-size", "2",
                               "--test-batch-size", "2", "--patch-size", "64", "64",
                               "--steps_per_epoch", "2", "-n", "2",
                               "--experiments_root", os.path.join(d, "pw")], d, 300)
        loss = logged(out3, r"\] loss")
        pw = os.path.join(d, "pw", "pwave_BS2_LR0.0001")
        if not os.path.isdir(os.path.join(pw, "checkpoint_best_loss")):
            raise AssertionError("train_pwave wrote no checkpoint")
        if not os.path.isfile(os.path.join(pw, "web", "index.html")):
            raise AssertionError("train_pwave drew no validation pictures")
    emit({"phase": "train_cli", "train_pmctf_s": wall, "resume_nccl_s": wall2,
          "resume_log_line": nccl,
          "train_pwave_s": wall3, "rd_losses": rd, "resume_rd_losses": rd2,
          "pwave_losses": loss, "last_meta": meta, "checkpoints": ckpts,
          "card": smi})


# variant -> its source and the kernel-phase shape that stands for it
VARIANT_ROWS = {
    "wgmma_3xtf32": ("conv3x3_wgmma.cu", "luma 64->64 leaky_relu"),
    "mma_sync_3xtf32": ("conv3x3_mma.cu", "luma 64->64 leaky_relu"),
    "head_o1": ("conv3x3_head.cu", "luma 64->1"),
    "direct_f32": ("conv3x3_direct_c1.cu", "luma 1->64"),
    "wgmma_bf16": ("conv3x3_wgmma_bf16.cu", "luma 64->64 leaky_relu"),
    "head_bf16": ("conv3x3_head.cu", "luma 64->1"),
    "direct_bf16": ("conv3x3_direct_c1.cu", "luma 1->64"),
}
# the path whose run gives an entry's "launches"
MAIN_PATH = {"f32": "launches", "bf16": "bench_launches"}


# ---- the lossless configuration, the q-batched estimate path, the CA CLI,
# the modules nothing builds (phases 21-25) ------------------------------------

LOSSLESS_BITS_REL = 2e-3  # a rounded lifting increment may flip between devices
EXTRA_TOL = 1e-4  # of the output's largest magnitude: cuDNN f32 against the CPU's


def lossless_gop(n, h, w, device, seed=0):
    """synthetic_gop's frames rounded to integers (lossless coding gives
    integer planes back exactly)."""
    luma, chroma = synthetic_gop(n, h, w, device, seed)
    return [torch.round(f) for f in luma], [torch.round(f) for f in chroma]


def check_lossless(out, luma, chroma, what):
    for fi in range(len(luma)):
        for got, want in ((out["luma"][fi], luma[fi]), (out["chroma"][fi], chroma[fi])):
            if not torch.equal(got.to(want.device), want):
                err = float((got.to(want.device) - want).abs().max())
                raise AssertionError(f"{what}: frame {fi} differs from the input by {err}")


def phase_lossless_small_reference():
    """The small config's lossless GOP-4 at 64x64 on the card and on the
    CPU: both reconstruct the input exactly, the estimate's bits agree
    within LOSSLESS_BITS_REL, and the card's stream decodes the input."""
    from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
    from learned_pmctf_tpu_torch.gop import code_gop, stream_gop
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    cfg = dict(decomp_levels=2, num_me_stages=2, channel_mv=8, channel_n=8,
               features=16, ar_features=16, lossy=False)
    luma, chroma = lossless_gop(GOP, 64, 64, "cpu", seed=1)
    on_cpu = code_gop(build_pmctf("cpu", seed=1, **cfg), luma, chroma, 10.0, device="cpu")
    card_model = build_pmctf("cuda", seed=1, **cfg)
    on_card = code_gop(card_model, luma, chroma, 10.0)
    check_lossless(on_cpu, luma, chroma, "lossless small GOP-4 on the CPU")
    check_lossless(on_card, luma, chroma, "lossless small GOP-4 on the card")
    worst = 0.0
    for fi, bits in on_cpu["bits"].items():
        for key, r in bits.items():
            rel = abs(on_card["bits"][fi][key] - r) / max(abs(r), 1.0)
            worst = max(worst, rel)
            if rel > LOSSLESS_BITS_REL:
                raise AssertionError(f"lossless small: frame {fi} {key} "
                                     f"{on_card['bits'][fi][key]} vs {r}")
    with tempfile.TemporaryDirectory() as d, PMCTFCodec(card_model) as codec:
        codec.update()
        streamed = stream_gop(codec, luma, chroma, 10.0, d, psize=64)
    check_stream(streamed, "lossless small stream")
    check_lossless(streamed, [f.cuda() for f in luma], [f.cuda() for f in chroma],
                   "lossless small stream on the card")
    emit({"phase": "lossless_small_reference", "gop": GOP, "size": [64, 64],
          "bits_max_rel_diff": worst, "bits_rel_tol": LOSSLESS_BITS_REL,
          "reconstructions_equal_input": True, "stream_decodes_input": True})


def phase_lossless(smi):
    """Full-width pMCTF-L with lossy=False (bench.py:57's widths), padded
    1080p, q 10, exact warp, f32: an estimate GOP-4 and a stream GOP-4,
    each after a warm-up. The frames come back bit for bit, the stream's
    bytes are the same in both encodes, and PostProcess never runs (no
    conv3x3 launch)."""
    from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
    from learned_pmctf_tpu_torch.entropy.coder import SYMBOL_CLIP
    from learned_pmctf_tpu_torch.gop import code_gop, stream_gop
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    from learned_pmctf_tpu_torch.ops.conv3x3 import conv3x3
    h, w = LUMA
    model = build_pmctf("cuda", seed=0, num_me_stages=4, lossy=False)
    luma, chroma = lossless_gop(GOP, h, w, "cuda")
    code_gop(model, luma, chroma, 10.0)  # warm-up
    torch.cuda.synchronize()
    count_from_zero()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = code_gop(model, luma, chroma, 10.0)
    torch.cuda.synchronize()
    est_ms = (time.perf_counter() - t) * 1e3
    est_peak = torch.cuda.max_memory_allocated()
    launches, by_variant = conv3x3.launches, counted("lossless estimate GOP-4")
    check_lossless(out, luma, chroma, "lossless estimate GOP-4")
    est_bits = sum(v for b in out["bits"].values() for v in b.values())

    root = tempfile.mkdtemp(prefix="pmctf_lossless_")
    files = []
    try:
        with PMCTFCodec(model) as codec:
            codec.update()
            for name in ("warmup", "timed"):
                d = os.path.join(root, name)
                os.makedirs(d)
                codec.stats.reset()
                count_from_zero()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t = time.perf_counter()
                streamed = stream_gop(codec, luma, chroma, 10.0, d)
                torch.cuda.synchronize()
                stream_ms = (time.perf_counter() - t) * 1e3
                launches += conv3x3.launches
                by_variant.update(counted(f"lossless stream {name}"))
                check_stream(streamed, f"lossless stream {name}")
                check_lossless(streamed, luma, chroma, f"lossless stream {name}")
                files.append(stream_files(d))
            stream_peak = torch.cuda.max_memory_allocated()
            symbol_peak = codec.stats.symbol_peak
    finally:
        shutil.rmtree(root)
    if files[0] != files[1]:
        raise AssertionError("lossless stream: bytes differ between the two encodes")
    if launches or by_variant:
        raise AssertionError(f"lossless paths launched conv3x3 {launches} times: {by_variant}")
    stream_bits = sum(v for b in streamed["bits"].values() for v in b.values())
    emit({"phase": "lossless", "model": "pMCTF-L full width (seeded random weights), lossy=False",
          "gop": GOP, "luma": [h, w], "q_index": 10, "warp_mode": "exact",
          "estimate_gop_ms": est_ms, "estimate_frames_per_s": GOP / (est_ms / 1e3),
          "estimate_bpp": est_bits / (GOP * h * w), "estimate_peak_mem_bytes": est_peak,
          "stream_gop_ms": stream_ms, "stream_frames_per_s": GOP / (stream_ms / 1e3),
          "stream_bpp": stream_bits / (GOP * h * w), "stream_peak_mem_bytes": stream_peak,
          "stream_file_bytes": {f: len(b) for f, b in files[1].items()},
          "bytes_identical_across_encodes": True, "decoded_equals_input": True,
          "lossless_launches": launches, "max_abs_symbol": symbol_peak,
          "symbol_clip": SYMBOL_CLIP, "symbols_at_clip": symbol_peak >= SYMBOL_CLIP,
          "card": smi})
    del model, luma, chroma, out, streamed
    torch.cuda.empty_cache()
    return by_variant


Q_BATCH = (0, 7, 14, 20)


def q_batch_gop(codec, luma, chroma, qs):
    """The estimate GOP-4 of len(qs) rate points as one batch
    (estimate_one_stage_multi, inverse_mctf_multi): per-frame bits (E,)
    and the frames with their leading element axis."""
    from learned_pmctf_tpu_torch.gop import gop_schedule
    from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
    n = len(qs)
    fr = [(y[None].expand(n, *y.shape).contiguous(), c[None].expand(n, *c.shape).contiguous())
          for y, c in zip(luma, chroma)]
    sched = gop_schedule(len(fr))
    mvs, bits = [None] * len(fr), {}
    cur_stage, dpb = -1, None
    for stage, fi, step, code_lt in sched:
        if stage != cur_stage:
            cur_stage, dpb = stage, empty_dpb()
        st = codec.model.me_index(stage)
        res = codec.estimate_one_stage_multi(fr[fi], fr[fi + step], code_lt, dpb, list(qs),
                                             stage_idx=st)
        dpb = res["dpb"]
        fr[fi], fr[fi + step] = (res["L_t"], res["L_tc"]), (res["H_t"], res["H_tc"])
        mvs[fi + step] = res["mv_hat"]
        bits[fi + step] = {"bit_H": res["bit_H"], "bit_ME": res["bit_ME"]}
        if code_lt:
            bits[fi] = {"bit_L": res["bit_L"]}
    for stage, fi, step, _ in reversed(sched):
        st = codec.model.me_index(stage)
        ry, cy = codec.inverse_mctf_multi(fr[fi][0], fr[fi + step][0], mvs[fi + step],
                                          stage_idx=st)
        rc, cc = codec.inverse_mctf_multi(fr[fi][1], fr[fi + step][1], mvs[fi + step],
                                          stage_idx=st, downscale=True)
        fr[fi], fr[fi + step] = (ry, rc), (cy, cc)
    return bits, fr


def phase_q_batch(smi):
    """A full-width GOP-4 (padded 1080p) at Q_BATCH's four rate points as
    one batch against the four single-q GOPs: bits rel 1e-4, frames 5e-2;
    PostProcess runs once a plane for all rate points (N = Q luma, 2Q
    chroma), 120 conv3x3 launches as one GOP-4."""
    from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
    from learned_pmctf_tpu_torch.gop import code_gop
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    from learned_pmctf_tpu_torch.ops.conv3x3 import conv3x3
    h, w = LUMA
    model = build_pmctf("cuda", seed=0, num_me_stages=4)
    with torch.no_grad():  # the rate points differ as the CLI's spread makes them
        for coder in (model.lp_coder, model.hp_coder):
            for qp in (coder.QP, coder.QP_ll):
                qp.copy_(torch.tensor([0.02, 0.5]).reshape(2, 1, 1, 1))
    luma, chroma = synthetic_gop(GOP, h, w, "cuda")
    with PMCTFCodec(model) as codec:
        q_batch_gop(codec, luma, chroma, Q_BATCH)  # warm-up
        torch.cuda.synchronize()
        count_from_zero()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        bits, frames = q_batch_gop(codec, luma, chroma, Q_BATCH)
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated()
    launches, by_variant = conv3x3.launches, counted("q-batched GOP-4")
    expected = postprocess_launches(w, 2 * GOP)
    if launches != 15 * 2 * GOP or by_variant != expected:
        raise AssertionError(f"q batch: conv3x3 launched {launches} times, by variant "
                             f"{by_variant}, expected {expected}")
    single_ms, worst_bits, worst_plane = [], 0.0, 0.0
    for e, q in enumerate(Q_BATCH):
        torch.cuda.synchronize()
        t = time.perf_counter()
        one = code_gop(model, luma, chroma, float(q))
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t) * 1e3)
        for fi, b in one["bits"].items():
            for key, r in b.items():
                rel = abs(float(bits[fi][key][e]) - r) / max(abs(r), 1.0)
                worst_bits = max(worst_bits, rel)
                if rel > 1e-4:
                    raise AssertionError(f"q batch: q {q} frame {fi} {key} "
                                         f"{bits[fi][key][e]} vs {r}")
        for fi in range(GOP):
            for got, want in ((frames[fi][0][e], one["luma"][fi]),
                              (frames[fi][1][e], one["chroma"][fi])):
                worst_plane = max(worst_plane, float((got - want).abs().max()))
        if worst_plane >= 5e-2:
            raise AssertionError(f"q batch: q {q} frames differ by {worst_plane}")
    emit({"phase": "q_batch", "model": "pMCTF-L full width (seeded random weights)",
          "gop": GOP, "luma": [h, w], "q_indexes": list(Q_BATCH),
          "batch_gop_ms": batch_ms, "single_gop_ms": single_ms,
          "single_gop_ms_sum": sum(single_ms),
          "batch_frames_per_s": GOP * len(Q_BATCH) / (batch_ms / 1e3),
          "peak_mem_bytes": peak, "conv3x3_launches": launches,
          "conv3x3_launches_by_variant": by_variant,
          "bits_max_rel_diff": worst_bits, "frames_max_abs_diff": worst_plane,
          "card": smi})
    del model, luma, chroma, frames
    torch.cuda.empty_cache()
    return by_variant


def phase_ca_cli(smi):
    """The content-adaptive CLI as a user runs it, in its own process:
    full width, 8 synthetic 256x256 frames, one GOP-8 chunk searched
    over GOP sizes {8, 4} and ME factors {1, 2, 4}, every trial
    written to streams and decoded (the CLI stops on a decoded plane that
    differs from the encoder side)."""
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "learned_pmctf_tpu_torch.cli.ca",
               "--synthetic", "8", "--synthetic_size", "256x256",
               "--force_intra_period", "8", "--q_index", "10", "--num_me_stages", "4",
               "--write_stream", "1", "--verbose", "1",
               "--output_path", os.path.join(d, "ca.json"),
               "--stream_path", os.path.join(d, "bin")]
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        wall_s = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"ca exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-3000:]}")
        with open(os.path.join(d, "ca.json")) as f:
            log = json.load(f)["synthetic_ds"]["synthetic"]
    checked = re.findall(r"decoded pairs bit-exact: (\d+)", proc.stdout)
    vals = log["frame_bpp"] + log["frame_psnr"]
    if not (len(log["gop_choice"]) == len(log["ds_choice"]) == 1
            and log["gop_choice"][0] in (8, 4) and log["ds_choice"][0] in (1, 2, 4)
            and all(v == v and abs(v) != float("inf") for v in vals)
            and all(b > 0 for b in log["frame_bpp"]) and checked and int(checked[-1]) > 0):
        raise AssertionError(f"ca: bad log {log} or no decode checks:\n{proc.stdout[-2000:]}")
    emit({"phase": "ca_cli", "command": " ".join(cmd[1:]), "wall_s": wall_s,
          "gop_choice": log["gop_choice"], "ds_choice": log["ds_choice"],
          "tested_opts": log["tested_opts"], "pairs_decoded_bit_exact": int(checked[-1]),
          "ave_all_frame_bpp": log["ave_all_frame_bpp"],
          "ave_all_frame_psnr": log["ave_all_frame_psnr"], "card": smi})


def _relative_err(got, want):
    return float((got.cpu() - want).abs().max()) / max(1.0, float(want.abs().max()))


def phase_extra_modules(smi):
    """The modules no model builds, at full width on the card against the
    CPU with the same weights: PostProcessCtx (stock convs; no kernel
    route, so no launch), the layers_extra convs with and without their
    masks, and CompressionModel's bits and tables."""
    from learned_pmctf_tpu_torch.entropy.bit_estimator import BitEstimator
    from learned_pmctf_tpu_torch.entropy.compression_model import CompressionModel
    from learned_pmctf_tpu_torch.models import layers_extra as extra
    from learned_pmctf_tpu_torch.models.postprocess import PostProcessCtx
    from learned_pmctf_tpu_torch.ops.conv3x3 import conv3x3
    g = torch.Generator().manual_seed(7)

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    cases = {
        "PostProcessCtx": (PostProcessCtx(), (rand(1, 1, 256, 256) * 40, rand(1, 64, 256, 256))),
        "DynamicDWConv": (extra.DynamicDWConv(64), (rand(2, 64, 64, 64),)),
        "MaskedDynamicDWConv": (extra.MaskedDynamicDWConv(64, mask_type="B"),
                                (rand(2, 64, 64, 64),)),
        "ConditionalConv": (extra.ConditionalConv(64, 64), (rand(2, 64, 64, 64),
                                                            torch.eye(5)[[1, 3]])),
        "ConditionalConv_A": (extra.ConditionalConv(64, 64, mask_type="A"),
                              (rand(2, 64, 64, 64), torch.eye(5)[[0, 4]])),
        "Conv3d": (extra.Conv3d(16, 16), (rand(1, 16, 8, 64, 64),)),
        "Conv3d_B": (extra.Conv3d(16, 16, mask_type="B"), (rand(1, 16, 8, 64, 64),)),
    }
    errs = {}
    count_from_zero()
    for name, (module, inputs) in cases.items():
        with torch.no_grad():
            for p in module.parameters():  # every weight, bias and norm drawn
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
            want = module(*inputs)
            got = module.cuda()(*[x.cuda() for x in inputs])
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        errs[name] = max(_relative_err(a, b) for a, b in zip(got, want))
        if errs[name] > EXTRA_TOL:
            raise AssertionError(f"{name}: card against CPU {errs[name]}")
    if conv3x3.launches:
        raise AssertionError(f"the extra modules launched conv3x3 {conv3x3.launches} times")
    est = BitEstimator(64)
    for p in est.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3, generator=g)
    y = torch.round(rand(1, 64, 64, 64) * 6)
    scales = torch.exp(rand(1, 64, 64, 64))
    for dist in ("laplace", "gaussian"):
        cm = CompressionModel(dist)
        cm.update()
        with torch.no_grad():
            errs[f"CompressionModel_{dist}_y_bits"] = _relative_err(
                cm.get_y_bits(y.cuda(), scales.cuda()), cm.get_y_bits(y, scales))
            errs[f"CompressionModel_{dist}_z_bits"] = _relative_err(
                cm.get_z_bits(y.cuda(), est.cuda().get_cdf), cm.get_z_bits(y, est.cpu().get_cdf))
    for name, err in errs.items():
        if name.startswith("CompressionModel") and err > 1e-3:
            raise AssertionError(f"{name}: card against CPU {err}")
    emit({"phase": "extra_modules", "max_rel_err_card_vs_cpu": errs,
          "tol": {"modules": EXTRA_TOL, "bits": 1e-3}, "conv3x3_launches": 0, "card": smi})


# ---- data parallelism and the dataset's flow filter (phases 26-29) ------------

DP_SMALL = dict(decomp_levels=1, num_me_stages=1, channel_mv=8, channel_n=8,
                features=8, ar_features=8, spynet_levels=2)  # dp_equiv_script.py's
DP_RANKS = 2
# tests/test_torch_port_parallel.py's (dp_equiv_script.py:91's): the loss,
# the reduced gradients of the largest in each top-level module, the
# parameters
DP_LOSS_RTOL, DP_GRAD_REL, DP_P_RTOL, DP_P_ATOL = 1e-5, 1e-5, 5e-4, 1.5e-4
SHARD_Q_SIZE = "720x1280"
FLOW_ABS = 1e-4  # the flow filter's mean |flow|, card against CPU


def dp_setup(config, group=None):
    """(model, step, frames) of the data-parallel check on this process:
    "small", the small config's GOP-2 (stage 3's gates, lr 1e-4:
    dp_equiv_script.py), or "full", full width at the trainer's defaults
    (GOP-4, stage 6, part All, batch 8, 128x128: phase 15's step); the
    frames of the global batch."""
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    from learned_pmctf_tpu_torch.training.curriculum import PART_PREDICATES
    from learned_pmctf_tpu_torch.training.optim import make_optimizer, trainable_mask
    from learned_pmctf_tpu_torch.training.steps import StageGates, make_pmctf_train_step
    if config == "full":
        model = build_pmctf("cuda", seed=0, num_me_stages=2, quant_stage=False).train()
        model.quant_stage = True
        opt = make_optimizer(model, 1e-5, weight_decay=0.0, clip_norm=5.0,
                             trainable=trainable_mask(model, PART_PREDICATES["All"]))
        step = make_pmctf_train_step(model, opt, 4, StageGates.for_stage(5), group=group)
        return model, step, train_frames(4, TRAIN_BATCH, TRAIN_PATCH, seed=11)
    import numpy as np
    model = build_pmctf("cuda", seed=1, **DP_SMALL).train()
    opt = make_optimizer(model, 1e-4)
    step = make_pmctf_train_step(model, opt, 2, StageGates.for_stage(2), group=group)
    frames = np.random.default_rng(0).integers(0, 256, (2, 8, 1, 64, 128))
    return model, step, torch.from_numpy(frames.astype(np.float32)).cuda()


def dp_steps(model, step, frames, timed):
    """The first step from the seeded weights (timed, its conv3x3 launches
    counted; its log, gradients and parameters kept on the host), then
    `timed` more steps (host clock, synchronized); the peak memory of
    them all."""
    noise = torch.Generator(device="cuda").manual_seed(7)
    count_from_zero()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    log = step(frames, 10.0, 0.05, noise)
    torch.cuda.synchronize()
    out = {"first_step_ms": (time.perf_counter() - t) * 1e3,
           "by_variant": counted("data-parallel step"),
           "log": {k: float(v) for k, v in log.items()},
           "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                     if p.grad is not None},
           "params": {k: p.detach().cpu() for k, p in model.named_parameters()}}
    times = []
    for _ in range(timed):
        t = time.perf_counter()
        step(frames, 10.0, 0.05, noise)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out.update(step_ms_runs=times, step_ms=statistics.median(times) if times else None,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    return out


def _dp_rank(timed, out_dir):
    """One rank of the data-parallel checks (`timed`: config -> timed
    steps): its rows of each global batch through the grouped step, on
    the card it shares with the other rank (gloo: NCCL refuses two ranks
    on one card)."""
    import torch.distributed as dist
    from learned_pmctf_tpu_torch.parallel import mesh
    dp = mesh.make_mesh(device="cuda", share=True)
    for config, steps in timed.items():
        model, step, frames = dp_setup(config, dist.group.WORLD)
        rows = mesh.data_rows(frames.shape[1], dp.rank, dp.world)
        out = dp_steps(model, step, frames[:, rows].contiguous(), steps)
        if dp.rank:  # rank 0's gradients and parameters stand for the group's
            out.pop("grads")
            out.pop("params")
        torch.save(out, os.path.join(out_dir, f"{config}{dp.rank}.pt"))
        del model, step, frames
        torch.cuda.empty_cache()


def dp_compare(single, ranks):
    """The group's step against the single process's: the largest
    relative loss gap, the largest gradient error as a share of the
    largest gradient of its top-level module, and the parameters' worst
    |diff|."""
    got = ranks[0]
    loss = max(abs(got["log"][k] - v) / max(abs(v), 1e-6) for k, v in single["log"].items())
    largest = {}
    for k, g in single["grads"].items():
        largest[group_of(k)] = max(largest.get(group_of(k), 0.0), float(g.abs().max()))
    if set(got["grads"]) != set(single["grads"]):
        raise AssertionError("data parallel: other parameters reached a gradient")
    grad = max(float((got["grads"][k] - g).abs().max()) / max(largest[group_of(k)], 1e-30)
               for k, g in single["grads"].items())
    bad = [k for k, p in single["params"].items()
           if not torch.allclose(got["params"][k], p, rtol=DP_P_RTOL, atol=DP_P_ATOL)]
    param = max(float((got["params"][k] - p).abs().max()) for k, p in single["params"].items())
    agree = {"loss_max_rel_diff": loss, "grad_max_share_of_group_largest": grad,
             "params_max_abs_diff": param, "params_outside_tol": bad[:10]}
    if loss > DP_LOSS_RTOL or grad > DP_GRAD_REL or bad:
        raise AssertionError(f"data parallel against one process: {agree}")
    return agree


def run_dp(timed):
    """Each config of `timed` (config -> the ranks' timed steps) on one
    process (its first step), then on DP_RANKS gloo ranks sharing the card
    (one mesh.spawn for all); config -> (single, ranks' results,
    agreement)."""
    from learned_pmctf_tpu_torch.parallel import mesh
    singles = {}
    for config in timed:
        model, step, frames = dp_setup(config)
        singles[config] = dp_steps(model, step, frames, 0)
        del model, step, frames
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        mesh.spawn(_dp_rank, DP_RANKS, (timed, d), device="cuda", backend="gloo")
        ranks = {c: [torch.load(os.path.join(d, f"{c}{r}.pt")) for r in range(DP_RANKS)]
                 for c in timed}
    return {c: (singles[c], ranks[c], dp_compare(singles[c], ranks[c])) for c in timed}


def emit_dp_small_reference(single, ranks, agree):
    if any(r["by_variant"] != single["by_variant"] for r in ranks):
        raise AssertionError(f"small data parallel: launches {[r['by_variant'] for r in ranks]}"
                             f" against {single['by_variant']}")
    emit({"phase": "data_parallel_small_reference", "config": DP_SMALL, "ranks": DP_RANKS,
          "batch": 8, "rows_a_rank": 8 // DP_RANKS, "backend": "gloo (one card)",
          "tol": {"loss_rel": DP_LOSS_RTOL, "grad_of_group_largest": DP_GRAD_REL,
                  "params_rtol": DP_P_RTOL, "params_atol": DP_P_ATOL},
          **agree, "rd_loss": single["log"]["rd_loss"]})


def phase_data_parallel_small_reference():
    """The small config's GOP-2 step on 2 gloo ranks of 4 rows on the card
    against one process on the batch of 8, to the CPU test's tolerances."""
    emit_dp_small_reference(*run_dp({"small": 0})["small"])


def phase_data_parallel(smi):
    """Phase 26 and the full-width check with one spawn of the ranks: at
    the trainer's defaults, 2 gloo ranks of 4 rows on the card against one
    process on the batch of 8 (loss, gradients and parameters after the
    step; each rank's step ms over 1 step after the first, peak memory
    and conv3x3 launches). Phase 17 runs the trainer CLI over NCCL (one
    rank); NCCL across two cards needs a machine with two."""
    res = run_dp({"small": 0, "full": 1})
    emit_dp_small_reference(*res["small"])
    single, ranks, agree = res["full"]
    expect = train_launch_expect(4, TRAIN_PATCH[1])
    for r, out in enumerate([single] + ranks):
        if out["by_variant"] != expect:
            raise AssertionError(f"data parallel {'rank ' + str(r - 1) if r else 'single'}: "
                                 f"launches {out['by_variant']}, expected {expect}")
    emit({"phase": "data_parallel", "model": "pMCTF-L full width (seeded random weights)",
          "gop": 4, "batch": TRAIN_BATCH, "patch": list(TRAIN_PATCH), "ranks": DP_RANKS,
          "rows_a_rank": TRAIN_BATCH // DP_RANKS, "backend": "gloo, two ranks on one card",
          **agree, "single_first_step_ms": single["first_step_ms"],
          "single_peak_mem_bytes": single["peak_mem_bytes"],
          "rank_first_step_ms": [r["first_step_ms"] for r in ranks],
          "rank_step_ms": [r["step_ms"] for r in ranks],
          "rank_step_ms_runs": [r["step_ms_runs"] for r in ranks],
          "rank_peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks],
          "conv3x3_launches_a_rank": [sum(r["by_variant"].values()) for r in ranks],
          "conv3x3_launches_by_variant_a_rank": ranks[0]["by_variant"],
          "trainer_cli_nccl": "phase 17 (train_cli): its resume runs as the one NCCL "
                              "rank of a torchrun launcher (--data_parallel 1)",
          "note": "NCCL across two cards is not shown on a one-card machine: the two "
                  "ranks share the card over gloo, and the NCCL group has one rank; "
                  "phase 15 times the single process's step",
          "card": smi})
    return ranks[0]["by_variant"]


def _shard_q_rank(argv, out_dir):
    """One rank of cli.flex --shard_q (its own rank entry, flex.shard_rank)
    with its conv3x3 launches counted."""
    from learned_pmctf_tpu_torch.cli import flex
    count_from_zero()
    flex.shard_rank(flex.parse_args(argv))
    torch.cuda.synchronize()
    with open(os.path.join(out_dir, f"launches{torch.distributed.get_rank()}.json"), "w") as f:
        json.dump(counted("sharded q batch"), f)


def _flex_jsons(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = json.load(f)
    return out


def _json_gap(got, want, where=""):
    """(largest relative rate gap, largest PSNR gap in dB) between two
    flex JSONs; raises where their keys or other values differ."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"shard_q: keys at {where}: {set(got) ^ set(want)}")
        gaps = [_json_gap(got[k], want[k], f"{where}/{k}") for k in want if "time" not in k]
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"shard_q: lengths at {where}")
        gaps = [_json_gap(a, b, f"{where}[{i}]") for i, (a, b) in enumerate(zip(got, want))]
    elif isinstance(want, float):
        if "psnr" in where:
            return 0.0, abs(got - want)
        return abs(got - want) / max(abs(want), 1e-6), 0.0
    else:
        if got != want:
            raise AssertionError(f"shard_q: {where} {got} != {want}")
        return 0.0, 0.0
    return (max([g[0] for g in gaps], default=0.0), max([g[1] for g in gaps], default=0.0))


def phase_shard_q(smi):
    """cli.flex --q_batch --shard_q at full width, a synthetic GOP-4 at 2
    rate points, on 2 gloo ranks sharing the card (each codes 1 rate
    point, its launches counted) against cli.flex --q_batch in its own
    process: the JSONs key for key, rates rel 1e-5, PSNR 1e-4 dB."""
    from learned_pmctf_tpu_torch.parallel import mesh
    args = ["--synthetic", "4", "--synthetic_size", SHARD_Q_SIZE, "--force_intra_period",
            "4", "--q_index_num", "2", "--num_me_stages", "4", "--q_batch"]
    with tempfile.TemporaryDirectory() as d:
        _, batch_s = run_cli("learned_pmctf_tpu_torch.cli.flex",
                             args + ["--output_path", os.path.join(d, "batch", "out.json")],
                             d, 600)
        t = time.perf_counter()
        mesh.spawn(_shard_q_rank, DP_RANKS, (args + ["--shard_q", "--output_path",
                                                     os.path.join(d, "shard", "out.json")], d),
                   device="cuda", backend="gloo")
        shard_s = time.perf_counter() - t
        launches = []
        for r in range(DP_RANKS):
            with open(os.path.join(d, f"launches{r}.json")) as f:
                launches.append(json.load(f))
        batch, shard = _flex_jsons(os.path.join(d, "batch")), _flex_jsons(os.path.join(d, "shard"))
    rate_gap, psnr_gap = _json_gap(shard, batch)
    if len(batch) != 3 or rate_gap > 1e-5 or psnr_gap > 1e-4:
        raise AssertionError(f"shard_q: {sorted(batch)}, rates {rate_gap}, PSNR {psnr_gap} dB")
    if any(sum(v.values()) != 15 * 2 * GOP for v in launches):
        raise AssertionError(f"shard_q: conv3x3 launches a rank {launches}")
    summary = batch["out_summary.json"]
    emit({"phase": "shard_q", "model": "pMCTF-L full width (seeded random weights)",
          "size": SHARD_Q_SIZE, "gop": GOP, "q_indexes": summary["quality"],
          "ranks": DP_RANKS, "backend": "gloo, two ranks on one card",
          "q_batch_wall_s": batch_s, "shard_q_wall_s": shard_s,
          "rate_max_rel_diff": rate_gap, "psnr_max_abs_diff_db": psnr_gap,
          "conv3x3_launches_by_variant_a_rank": launches, "bpp": summary["bpp"],
          "card": smi})
    return launches[0]


def phase_average_flow(smi):
    """cli.average_flow (the RGB SpyNet, seeded weights) on a synthetic
    PNG tree at vimeo's 256x448, on the card and with --device cpu: the
    same clips, each mean |flow| within FLOW_ABS."""
    stats, walls = {}, {}
    with tempfile.TemporaryDirectory() as d:
        write_png_dataset(os.path.join(d, "vimeo"), sequences=2, frames=8, h=256, w=448)
        for dev in ("cuda", "cpu"):
            out = os.path.join(d, f"{dev}.json")
            _, walls[dev] = run_cli("learned_pmctf_tpu_torch.cli.average_flow",
                                    ["--data", os.path.join(d, "vimeo"), "--out", out,
                                     "--device", dev], d, 300)
            with open(out) as f:
                stats[dev] = json.load(f)
    gap = max(abs(stats["cuda"][k] - v) for k, v in stats["cpu"].items())
    if list(stats["cuda"]) != list(stats["cpu"]) or len(stats["cpu"]) != 2 or gap > FLOW_ABS:
        raise AssertionError(f"average_flow: card {stats['cuda']} against CPU {stats['cpu']}")
    emit({"phase": "average_flow", "clips": len(stats["cpu"]), "size": [256, 448],
          "mean_abs_flow": stats["cuda"], "max_abs_diff_card_vs_cpu": gap, "tol": FLOW_ABS,
          "card_wall_s": walls["cuda"], "cpu_wall_s": walls["cpu"], "card": smi})


# tests/test_torch_port_spatial_models.py's full stage (the JAX test's
# config) and tolerances: bits rtol 1e-5 and atol 1e-4, planes 1e-3
SPATIAL_SMALL = dict(decomp_levels=2, num_me_stages=1, channel_mv=8, channel_n=8,
                     features=8, ar_features=8, spynet_levels=3)
SPATIAL_BITS_RTOL, SPATIAL_BITS_ATOL, SPATIAL_PLANE_ATOL = 1e-5, 1e-4, 1e-3
# config: (ranks, spatial axis, rate points)
SPATIAL_MESHES = {"small": (4, 2, (0, 7, 14, 20)), "full": (2, 2, (0, 20))}


def spatial_setup(config):
    """(model, ref, cur, q indexes) on the card: "small", the CPU test's
    stage (its biases drawn, 64x128 frames of the JAX test's draw), or
    "full", full-width pMCTF-L at padded 1080p (its rate points spread as
    phase 23's) on frames 0 and 1 of phase 5's synthetic GOP; ref and cur
    (y, chroma) with a leading axis of the rate points."""
    import numpy as np
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    qs = SPATIAL_MESHES[config][2]
    if config == "small":
        model = build_pmctf("cuda", seed=1, **SPATIAL_SMALL)
        g = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("bias"):
                    p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        rng = np.random.default_rng(7)
        y0, y1 = (rng.integers(0, 256, (1, 1, 64, 128)) for _ in range(2))
        c0, c1 = (rng.integers(0, 256, (2, 1, 32, 64)) for _ in range(2))
        frames = [(torch.from_numpy(y.astype(np.float32)).cuda(),
                   torch.from_numpy(c.astype(np.float32)).cuda()) for y, c in ((y0, c0), (y1, c1))]
    else:
        model = build_pmctf("cuda", seed=0, num_me_stages=4)
        with torch.no_grad():
            for coder in (model.lp_coder, model.hp_coder):
                for qp in (coder.QP, coder.QP_ll):
                    qp.copy_(torch.tensor([0.02, 0.5]).reshape(2, 1, 1, 1))
        luma, chroma = synthetic_gop(2, *LUMA, "cuda")
        frames = list(zip(luma, chroma))

    def tile(t):
        return t[None].expand(len(qs), *t.shape).contiguous()
    ref, cur = ((tile(y), tile(c)) for y, c in frames)
    return model, ref, cur, qs


def spatial_stage(model, ref, cur, qs, warm):
    """One stage as the q-batched path codes it (estimate_one_stage_multi,
    then inverse_mctf_multi of luma and chroma), on the process's planes;
    with `warm` a warm-up first; the run's ms, its conv3x3 launches,
    exchanges and peak memory. Planes and bits to the host."""
    from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
    from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
    from learned_pmctf_tpu_torch.parallel import halo

    def run():
        res = codec.estimate_one_stage_multi(ref, cur, True, empty_dpb(), list(qs))
        y = codec.inverse_mctf_multi(res["L_t"], res["H_t"], res["mv_hat"])
        c = codec.inverse_mctf_multi(res["L_tc"], res["H_tc"], res["mv_hat"], downscale=True)
        torch.cuda.synchronize()
        return {**{k: torch.as_tensor(res[k]).cpu() for k in
                   ("L_t", "H_t", "L_tc", "H_tc", "bit_L", "bit_H", "bit_ME")},
                "inv_ref": y[0].cpu(), "inv_cur": y[1].cpu(), "inv_ref_c": c[0].cpu(),
                "inv_cur_c": c[1].cpu()}

    with PMCTFCodec(model) as codec:
        if warm:
            run()
        count_from_zero()
        halo.counters(reset=True)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = run()
        stage_ms = (time.perf_counter() - t) * 1e3
    return {"planes": out, "stage_ms": stage_ms, "by_variant": counted("spatial stage"),
            "exchanges": halo.counters(), "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def _spatial_rank(config, out_dir):
    """One rank of a (data x spatial) mesh sharing the card over gloo: its
    rate points and its columns of the stage."""
    from learned_pmctf_tpu_torch.parallel import halo, mesh
    ranks, spatial, _ = SPATIAL_MESHES[config]
    grid = mesh.make_mesh(spatial=spatial, device="cuda", share=True)
    model, ref, cur, qs = spatial_setup(config)
    rows = mesh.data_rows(len(qs), grid.data_index, grid.data_size)
    w = ref[0].shape[-1]
    cols = (mesh.frame_columns(w, grid.spatial_index, spatial, model.spatial_align()),
            mesh.frame_columns(w // 2, grid.spatial_index, spatial))

    def block(planes):
        return tuple(t[rows][..., c].contiguous() for t, c in zip(planes, cols))
    with halo.spatial_shard(grid):
        out = spatial_stage(model, block(ref), block(cur), qs[rows], config == "full")
    out["grid"] = (grid.data_index, grid.data_size, grid.spatial_index, spatial)
    out["columns"] = w // spatial
    torch.save(out, os.path.join(out_dir, f"{config}{grid.rank}.pt"))


def spatial_compare(single, ranks, what):
    """The ranks' blocks against the single process: the largest relative
    bits gap and the largest plane difference; raises outside
    tolerance."""
    spatial = ranks[0]["grid"][3]
    grid = [ranks[i:i + spatial] for i in range(0, len(ranks), spatial)]
    bits_gap = plane_gap = 0.0
    for k, want in single["planes"].items():
        if k.startswith("bit"):
            for row in grid:
                if any(not torch.equal(r["planes"][k], row[0]["planes"][k]) for r in row):
                    raise AssertionError(f"{what}: the ranks of a row disagree on {k}")
            got = torch.cat([row[0]["planes"][k].reshape(-1) for row in grid]).double()
            want = want.reshape(-1).double()
            bad = (got - want).abs() > SPATIAL_BITS_ATOL + SPATIAL_BITS_RTOL * want.abs()
            bits_gap = max(bits_gap, float(((got - want).abs() / want.abs().clamp(min=1.0))
                                           .max()))
        else:
            got = torch.cat([torch.cat([r["planes"][k] for r in row], dim=-1)
                             for row in grid])
            gap = float((got - want).abs().max())
            plane_gap = max(plane_gap, gap)
            bad = torch.tensor([gap > SPATIAL_PLANE_ATOL])
        if bool(bad.any()):
            raise AssertionError(f"{what}: {k} against one process, bits {bits_gap}, "
                                 f"planes {plane_gap}")
    for r in ranks:
        if r["by_variant"] != single["by_variant"]:
            raise AssertionError(f"{what}: a rank launched {r['by_variant']}, one process "
                                 f"{single['by_variant']}")
    return bits_gap, plane_gap


def run_spatial(config):
    """The stage on one process, then on the config's mesh of gloo ranks
    sharing the card (mesh.spawn; a failing rank raises here); (single,
    ranks' results, bits gap, planes gap)."""
    from learned_pmctf_tpu_torch.parallel import mesh
    model, ref, cur, qs = spatial_setup(config)
    # the script's process: its kernels built and its full-width convs
    # run by the earlier phases, so no warm-up (a rank is a new process)
    single = spatial_stage(model, ref, cur, qs, False)
    del model, ref, cur
    torch.cuda.empty_cache()
    n = SPATIAL_MESHES[config][0]
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        mesh.spawn(_spatial_rank, n, (config, d), device="cuda", backend="gloo")
        spawn_s = time.perf_counter() - t
        ranks = [torch.load(os.path.join(d, f"{config}{r}.pt")) for r in range(n)]
    return (single, ranks, *spatial_compare(single, ranks, f"spatial {config}"), spawn_s)


def spatial_halos():
    from learned_pmctf_tpu_torch.models import context, mv_coder, pmctf, postprocess, wavelet
    return {"lifting_step_rows": wavelet.PU_RADIUS, "lifting_step_columns": wavelet.PU_RADIUS + 1,
            "temporal_filter": wavelet.PU_RADIUS, "lstm_step": context.LSTM_RADIUS,
            "hier_prior": context.HIER_RADIUS, "prior_pass": context.PASS_RADIUS,
            "ar_net": context.AR_RADIUS,
            "postprocess": postprocess.HALO,
            "mv_encoder_full_res": pmctf.MV_ENC_HALO, "mv_prior_at_1/64": pmctf.MV_PRIOR_HALO,
            "mv_prior_pass_at_1/16": mv_coder.PASS_RADIUS, "mv_decoder_at_1/16":
                pmctf.MV_DEC_HALO, "chroma_mv_downsample": pmctf.MV_DOWN_HALO,
            "spynet_and_exact_warp": "gathered at full width"}


def phase_spatial_small_reference(smi):
    """The CPU test's full stage (tests/test_torch_port_spatial_models.py:
    Q = 4 at 64x128) on a 2 x 2 (data x spatial) mesh of 4 gloo ranks
    sharing the card against one process on the card: bits rtol 1e-5 and
    atol 1e-4, planes 1e-3, the same conv3x3 launches by variant."""
    single, ranks, bits_gap, plane_gap, spawn_s = run_spatial("small")
    emit({"phase": "spatial_small_reference", "config": SPATIAL_SMALL,
          "q_indexes": list(SPATIAL_MESHES["small"][2]), "luma": [64, 128],
          "mesh": "2 x 2 (data x spatial)", "ranks": 4, "backend": "gloo, four ranks on one card",
          "tol": {"bits_rtol": SPATIAL_BITS_RTOL, "bits_atol": SPATIAL_BITS_ATOL,
                  "planes_atol": SPATIAL_PLANE_ATOL},
          "bits_max_rel_diff": bits_gap, "planes_max_abs_diff": plane_gap,
          "exchanges_a_rank": [r["exchanges"]["exchanges"] for r in ranks],
          "conv3x3_launches_by_variant_a_rank": ranks[0]["by_variant"],
          "ranks_wall_s": spawn_s, "card": smi})


def phase_spatial(smi):
    """Full-width pMCTF-L (f32, exact warp, four-step LL) at padded 1080p:
    one stage at Q = 2 (estimate_one_stage_multi, inverse_mctf_multi) on
    a 1 x 2 (data x spatial) mesh of 2 gloo ranks sharing the card, each
    coding 960 of the 1920 columns, against one process: bits rel 1e-5,
    planes 1e-3; each rank's stage ms (after a warm-up) beside the single
    process's (its first call at Q = 2), its exchanges, their bytes and their share of its wall
    time, its peak memory, and its conv3x3 launches by variant (the
    single process's variants and counts on the widened planes)."""
    single, ranks, bits_gap, plane_gap, spawn_s = run_spatial("full")
    h, w = LUMA
    emit({"phase": "spatial", "model": "pMCTF-L full width (seeded random weights), f32, "
                                       "exact warp, four-step LL",
          "luma": [len(SPATIAL_MESHES["full"][2]), 1, h, w],
          "chroma": [len(SPATIAL_MESHES["full"][2]), 2, h // 2, w // 2],
          "q_indexes": list(SPATIAL_MESHES["full"][2]), "mesh": "1 x 2 (data x spatial)",
          "ranks": 2, "columns_a_rank": ranks[0]["columns"],
          "backend": "gloo, two ranks on one card (CUDA tensors through host copies)",
          "halos": spatial_halos(),
          "tol": {"bits_rtol": SPATIAL_BITS_RTOL, "planes_atol": SPATIAL_PLANE_ATOL},
          "bits_max_rel_diff": bits_gap, "planes_max_abs_diff": plane_gap,
          "single_stage_ms": single["stage_ms"], "single_warm_up": False,
          "rank_stage_ms": [r["stage_ms"] for r in ranks],
          "exchanges_a_stage": [r["exchanges"]["exchanges"] for r in ranks],
          "exchange_bytes_a_stage": [r["exchanges"]["bytes"] for r in ranks],
          "exchange_s_a_stage": [r["exchanges"]["seconds"] for r in ranks],
          "exchange_share_of_rank_wall": [r["exchanges"]["seconds"] * 1e3 / r["stage_ms"]
                                          for r in ranks],
          "single_peak_mem_bytes": single["peak_mem_bytes"],
          "rank_peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks],
          "single_conv3x3_launches_by_variant": single["by_variant"],
          "conv3x3_launches_by_variant_a_rank": [r["by_variant"] for r in ranks],
          "ranks_wall_s": spawn_s,
          "note": "two ranks share one card and its host: the arithmetic of spatial "
                  "sharding, not its scaling; NCCL across cards is not shown",
          "card": smi})
    return ranks[0]["by_variant"]


def kernel_entries(rows, rows_bf16, launches):
    """One entry a variant: the variant's numbers at the shape that stands
    for it, whether the shape took it or timed it beside its own.
    `launches`: path -> launches by variant of that path's counted run;
    an entry's "launches" are those of its main path (MAIN_PATH)."""
    entries = []
    for variant, (source, shape) in VARIANT_ROWS.items():
        bf16 = variant in BF16_VARIANTS
        row = {r["shape"]: r for r in (rows_bf16 if bf16 else rows)}[shape]
        own = row["variant"] == variant
        if not own and f"{variant}_ms" not in row:
            continue
        n, c, hh, ww = row["x"]
        bound = conv_bound(n, c, row["o"], hh, ww, False, variant)
        entries.append({
            "name": f"conv3x3/{variant}", "route": "cuda",
            "source": f"learned_pmctf_tpu_torch/csrc/{source}",
            "replaces": "learned_pmctf_tpu/ops/pallas_conv.py:159",
            "dtype": "bf16" if bf16 else "f32",
            **{k: v.get(variant, 0) for k, v in launches.items()},
            "launches": launches[MAIN_PATH["bf16" if bf16 else "f32"]].get(variant, 0),
            "max_abs_err": max(r["max_abs_err"] for r in (rows_bf16 if bf16 else rows)
                               if r["variant"] == variant)
            if own else row[f"{variant}_max_abs_err"],
            "ms": row["ms"] if own else row[f"{variant}_ms"],
            "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
            "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"].split(" (")[0],
            "bound_unit": bound["bound_by"], "shape": shape})
    return entries


def check_paths(launches):
    """Each path launches exactly its variants: the f32 paths the f32
    ones the estimate launches, the bench the bf16 ones, the lossless
    paths none (no PostProcess)."""
    f32 = set(launches["launches"])
    if f32 & set(BF16_VARIANTS) or set(launches["bench_launches"]) != set(BF16_VARIANTS):
        raise AssertionError(f"the estimate or the bench launched the other dtype's "
                             f"variants: {launches}")
    if launches["lossless_launches"]:
        raise AssertionError(f"the lossless paths launched {launches['lossless_launches']}")
    for path, by_variant in launches.items():
        if path == "lossless_launches":
            continue
        want = set(BF16_VARIANTS) if path == "bench_launches" else f32
        if set(by_variant) != want or not all(by_variant.values()):
            raise AssertionError(f"{path} launched {by_variant}, expected {sorted(want)}")


# phases 21-31 by name, for ``--only``
NEW_PHASES = {"lossless_small_reference": lambda smi: phase_lossless_small_reference(),
              "lossless": phase_lossless, "q_batch": phase_q_batch,
              "ca_cli": phase_ca_cli, "extra_modules": phase_extra_modules,
              "data_parallel_small_reference":
                  lambda smi: phase_data_parallel_small_reference(),
              "data_parallel": phase_data_parallel, "shard_q": phase_shard_q,
              "average_flow": phase_average_flow,
              "spatial_small_reference": phase_spatial_small_reference,
              "spatial": phase_spatial}


def main(argv):
    smi = phase_device()
    ptxas = phase_build()
    if "--only" in argv:
        for name in argv[argv.index("--only") + 1].split(","):
            NEW_PHASES[name](smi)
        return 0
    rows = phase_kernel()
    rows_bf16 = phase_kernel_bf16(ptxas)
    if "--kernels" in argv:
        if "--ab" in argv:
            phase_ab(argv[argv.index("--ab") + 1])
        return 0
    phase_small_reference()
    by_variant, slice_run = phase_slice(smi)
    phase_stream_small_reference()
    stream_by_variant = phase_stream(smi, *slice_run)
    del slice_run
    torch.cuda.empty_cache()
    phase_ar_causal(ar_test_coder())
    phase_stream_small_reference("ar")
    ar_by_variant, ar_stream_by_variant = phase_ar_slice(smi)
    phase_cli(smi)
    phase_train_kernel_grad(smi)
    phase_train_small_reference()
    train_by_variant = phase_train_pmctf(smi)
    phase_train_pwave(smi)
    phase_train_cli(smi)
    phase_bench_small_reference()
    bench_by_variant = phase_bench(smi)
    phase_lossless_small_reference()
    lossless_by_variant = phase_lossless(smi)
    q_batch_by_variant = phase_q_batch(smi)
    phase_ca_cli(smi)
    phase_extra_modules(smi)
    dp_by_variant = phase_data_parallel(smi)  # phases 26 and 27
    shard_q_by_variant = phase_shard_q(smi)
    phase_average_flow(smi)
    phase_spatial_small_reference(smi)
    spatial_by_variant = phase_spatial(smi)
    # launches by path: the estimate GOP-4 ("launches"), the stream GOP-4,
    # both again with the AR LL coder, a GOP-4 train step (forward,
    # recompute and input gradients), the bench configuration's GOP-4,
    # the lossless estimate and stream GOP-4s (none), the q-batched
    # GOP-4 (four rate points), rank 0's data-parallel GOP-4 train step
    # (4 rows), rank 0's half of the sharded q batch (2 rate points) and
    # rank 0's half of the width-sharded stage (960 columns, Q = 2)
    launches = {"launches": by_variant, "stream_launches": stream_by_variant,
                "ar_launches": ar_by_variant,
                "ar_stream_launches": ar_stream_by_variant,
                "train_launches": train_by_variant,
                "bench_launches": bench_by_variant,
                "lossless_launches": lossless_by_variant,
                "q_batch_launches": q_batch_by_variant,
                "dp_train_launches": dp_by_variant,
                "shard_q_launches": shard_q_by_variant,
                "spatial_launches": spatial_by_variant}
    check_paths(launches)
    entries = kernel_entries(rows, rows_bf16, launches)
    on_path = [e for e in entries if e["launches"] > 0]
    if ({e["name"].split("/")[1] for e in on_path}
            != set(by_variant) | set(bench_by_variant)):
        raise AssertionError(f"no kernel-phase row for a variant of {launches}")
    # variants the kernel phase launched and checked but the main path did
    # not take: the same keys, on a line of their own
    emit({"off_path_variants": [e for e in entries if e["launches"] == 0]})
    emit({"kernels": on_path})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
