"""Fused 3x3 'same' conv: y = act(conv3x3(x, w) + b [+ residual]).

Replaces the TPU kernel learned_pmctf_tpu/ops/pallas_conv.py:conv3x3_hcw
with hand-written CUDA kernels for Hopper (csrc/conv3x3*.cu), on NCHW
instead of the TPU's (N, H, C, W) lane layout, and for any H, W, C, O
(the Pallas route needed W % 128 == 0, so chroma never took it).

The C side picks one of four variants from the shape (``variants_for``):

- ``wgmma_3xtf32`` (C % 8 == 0, O % 8 == 0, O <= 128, W % 4 == 0; the
  64->64 convs of PostProcess): bound by operations on the tensor cores,
  495 TFLOP/s dense in TF32 on an H100 SXM at 700 W against the 67 of the
  f32 cores. An implicit GEMM on ``wgmma`` with the pixels from registers
  and the weights from shared memory. f32 parity is kept by splitting every
  operand in two TF32 numbers (``tf32_split``) and summing three products
  per K step in the f32 accumulator. A producer thread streams activation
  windows (one TMA box a stage; out-of-bounds elements arrive as zeros,
  which is the padding) and packed weights through a ring in shared memory;
  two consumer warpgroups split the activations in registers. The weights
  are split and packed once per weight tensor here (``pack_weights``) and
  cached on the tensor (``packed_weights``);
- ``mma_sync_3xtf32`` (the same channel counts at any width): the same
  product on ``mma.sync``, which reaches about half the tensor cores'
  rate, with a ``cp.async`` ring;
- ``head_o1`` (O == 1): bound by bytes. Every thread works for the one
  output channel; the input planes stream through a ``cp.async`` ring;
- ``direct_f32`` (the rest, C == 1 among them): a direct conv on the f32
  CUDA cores.

All are deterministic (fixed summation order, no atomics) and fuse bias,
residual and activation into an f32 epilogue.

The TPU kernel also runs with bf16 operands: under the JAX package's
activation policy (``act_bf16``) PostProcess casts x, the weights and the
residual to bf16 and the Pallas kernel multiplies bf16 by bf16 into f32
accumulators, adds the f32 bias and residual in f32 and writes bf16.
``conv3x3`` takes that instance too (bf16 x, w and residual, f32 b; bf16
out), forward only, on three more variants:

- ``wgmma_bf16`` (C % 16 == 0, O % 8 == 0, O <= 64, W % 8 == 0): the
  64->64 convs, one ``wgmma.m64nNk16`` bf16 product a K step (bf16 is the
  tensor cores' own input: no split), 989 TFLOP/s dense on an H100 SXM;
  the weights packed by ``pack_weights_bf16``;
- ``head_bf16`` (O == 1) and ``direct_bf16`` (the rest, C == 1 among
  them): ``head_o1`` and ``direct_f32`` reading and writing bf16, with
  f32 weights (the bf16 weights upcast, exactly) and f32 arithmetic; a
  product of two bf16 values is exact in f32.

``conv3x3`` launches a kernel for CUDA tensors, or raises; it runs the
plain version ``conv3x3_plain`` only for tensors on the CPU. With grad
mode on and an input that requires grad it goes through
``Conv3x3Function``, whose input gradient is a 3x3 'same' conv of the
pre-activation gradient with the flipped, transposed weights and runs
through the kernels again (a 64->64 conv's is 64->64, a 1->64 conv's is
64->1 on ``head_o1``, a 64->1 conv's is 1->64 on ``direct_f32``); the
Pallas kernel had no backward (it was inference-only), and the weight
gradient is stock PyTorch, as XLA computed it for the JAX package.
``conv3x3_split_plain`` is the plain emulation of the three-product sum.
The plain version of the bf16 instance upcasts to f32, convolves and
applies the f32 epilogue there, and rounds once to bf16, as the Pallas
kernel does.
The shared library is built with nvcc from the repo's sources at first
use into ``learned_pmctf_tpu_torch/build/`` (one nvcc a source, run
together), and rebuilt when a source is newer.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch
import torch.nn.functional as F

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = tuple(os.path.join(CSRC, name) for name in
                ("conv3x3.cu", "conv3x3_mma.cu", "conv3x3_wgmma.cu",
                 "conv3x3_head.cu"))
HEADERS = (os.path.join(CSRC, "conv3x3_common.cuh"),)
BUILD_DIR = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD_DIR, "libconv3x3.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

ACTS = {None: 0, "leaky_relu": 1, "tanh": 2}
# conv3x3::Variant in csrc/conv3x3_common.cuh, and the weight layout each reads
VARIANTS = {"direct_f32": 1, "head_o1": 2, "mma_sync_3xtf32": 3,
            "wgmma_3xtf32": 4, "direct_bf16": 5, "head_bf16": 6,
            "wgmma_bf16": 7}
BF16_VARIANTS = ("direct_bf16", "head_bf16", "wgmma_bf16")
_VARIANT_NAMES = {v: k for k, v in VARIANTS.items()}
_LAYOUT_OF = {"direct_f32": "direct", "head_o1": "oihw",
              "mma_sync_3xtf32": "mma_sync", "wgmma_3xtf32": "wgmma",
              "direct_bf16": "direct", "head_bf16": "oihw",
              "wgmma_bf16": "wgmma_bf16"}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the conv3x3 CUDA kernels cannot be "
                           "built (needs the CUDA toolkit, sm_90a)")
    return path


def build(force: bool = False) -> str:
    """Compile csrc/conv3x3*.cu into build/libconv3x3.so if it is missing
    or older than a source: one nvcc per source, all started together,
    then one link. Returns the compilers' output ('' if up to date)."""
    newest = max(os.path.getmtime(p) for p in SOURCES + HEADERS)
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= newest):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    objects = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{os.getpid()}.o")
               for src in SOURCES]
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(SOURCES, objects)]
    try:
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{os.path.basename(src)}:\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objects, "-ldl"],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in objects:
            if os.path.exists(path):
                os.remove(path)
    return "".join(logs) + link.stdout + link.stderr


def _load():
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            lib.conv3x3_f32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
            lib.conv3x3_f32.restype = ctypes.c_int
            lib.conv3x3_bf16.argtypes = lib.conv3x3_f32.argtypes
            lib.conv3x3_bf16.restype = ctypes.c_int
            for fn, n in ((lib.conv3x3_pick, 4), (lib.conv3x3_pick_bf16, 4),
                          (lib.conv3x3_takes, 5), (lib.conv3x3_padded_o, 1)):
                fn.argtypes = [ctypes.c_int] * n
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def tf32_split(t):
    """Split f32 ``t`` in two TF32 numbers: ``big`` is ``t`` rounded to 10
    mantissa bits (to nearest, ties away from zero, as cvt.rna.tf32.f32
    rounds), ``small`` is ``t - big`` rounded the same way. Both are f32
    tensors whose low 13 mantissa bits are zero; ``big + small`` equals
    ``t`` to 2^-22 |t|."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    big = rna(t)
    return big, rna(t - big)


def _pack_axes(w, o_pad):
    """(part, n-tile, g, chunk, k-half, t, tap) view of the split weights."""
    o, c = w.shape[:2]
    if c % 8 or o_pad % 8 or o_pad < o:
        raise ValueError(f"cannot pack ({o}, {c}) weights to {o_pad} outputs: "
                         "C and the padded O must be multiples of 8")
    parts = torch.stack(tf32_split(w.reshape(o, c, 9)))
    parts = F.pad(parts, (0, 0, 0, 0, 0, o_pad - o))
    return parts.reshape(2, o_pad // 8, 8, c // 8, 2, 4, 9)


# layout -> where (chunk, tap, n-tile, g, t, part, k-half, ...) go
_PACK_PERM = {"mma_sync": (3, 6, 1, 2, 5, 0, 4),
              "wgmma": (3, 6, 0, 4, 1, 2, 5)}


def pack_weights(w, layout, o_pad=None):
    """Split OIHW weights with ``tf32_split`` and lay them out for a
    tensor-core variant's B tiles, as one flat f32 tensor.

    ``mma_sync``: [chunk of 8 channels][tap][n-tile of 8 outputs][lane]
    [big k, big k+4, small k, small k+4], where lane = 4 g + t holds output
    n-tile*8 + g and channel chunk*8 + t (the mma.m16n8k8 B fragment).
    ``wgmma``: [chunk][tap][big, small][k half][n-tile][output][4 k], the
    K-major core matrices (8 outputs x 16 bytes) of an unswizzled
    shared-memory descriptor. Outputs from O up to ``o_pad`` are zero."""
    o_pad = w.shape[0] if o_pad is None else o_pad
    return _pack_axes(w, o_pad).permute(_PACK_PERM[layout]).reshape(-1).contiguous()


def unpack_weights(pack, layout, o, c):
    """Inverse of ``pack_weights``: (big, small), each (O, C, 3, 3)."""
    o_pad = pack.numel() // (2 * 9 * c)
    perm = _PACK_PERM[layout]
    shape = (2, o_pad // 8, 8, c // 8, 2, 4, 9)
    inverse = [perm.index(i) for i in range(len(perm))]
    parts = pack.reshape([shape[i] for i in perm]).permute(inverse)
    parts = parts.reshape(2, o_pad, c, 3, 3)[:, :o]
    return parts[0].contiguous(), parts[1].contiguous()


# K index k of a 16-channel chunk -> its channel in ``pack_weights_bf16``.
# Thread t of a wgmma A fragment holds k = 2t, 2t+1, 2t+8, 2t+9; they are
# channels t, t+4, t+8, t+12, so that a fragment load reads four channel
# planes of the window that lie 24 banks apart (csrc/conv3x3_wgmma.cu).
BF16_K_CHANNEL = tuple((k % 2) * 4 + (k % 8) // 2 + 8 * (k // 8) for k in range(16))


def pack_weights_bf16(w, o_pad=None):
    """OIHW bf16 weights laid out for ``wgmma_bf16``'s B tiles, as one flat
    bf16 tensor: [chunk of 16 channels][tap][k half][n-tile of 8 outputs]
    [output][8 k], the K-major core matrices (8 outputs x 16 bytes) of an
    unswizzled shared-memory descriptor, with k -> channel as
    ``BF16_K_CHANNEL``. Outputs from O up to ``o_pad`` are zero."""
    o, c = w.shape[:2]
    o_pad = o if o_pad is None else o_pad
    if c % 16 or o_pad % 8 or o_pad < o:
        raise ValueError(f"cannot pack ({o}, {c}) weights to {o_pad} outputs: "
                         "C must be a multiple of 16, the padded O of 8")
    wk = F.pad(w.reshape(o, c, 9), (0, 0, 0, 0, 0, o_pad - o))
    wk = wk.reshape(o_pad, c // 16, 16, 9)[:, :, list(BF16_K_CHANNEL)]
    wk = wk.reshape(o_pad // 8, 8, c // 16, 2, 8, 9).permute(2, 5, 3, 0, 1, 4)
    return wk.reshape(-1).contiguous()


def unpack_weights_bf16(pack, o, c):
    """Inverse of ``pack_weights_bf16``: the (O, C, 3, 3) weights."""
    o_pad = pack.numel() // (9 * c)
    wk = pack.reshape(c // 16, 9, 2, o_pad // 8, 8, 8).permute(3, 4, 0, 2, 5, 1)
    wk = wk.reshape(o_pad, c // 16, 16, 9)
    out = torch.empty_like(wk)
    out[:, :, list(BF16_K_CHANNEL)] = wk
    return out.reshape(o_pad, c, 3, 3)[:o].contiguous()


def packed_weights(w, layout, o_pad=None):
    """``w`` in a variant's layout, cached on the tensor ``w`` itself and
    keyed on its storage and version: a second call packs nothing, an
    in-place update (an optimizer step, ``load_state_dict``) repacks.
    The CUDA-core variants read f32 weights: bf16 ones are upcast."""
    if layout == "oihw" and w.dtype == torch.float32:
        return w
    key = (w.data_ptr(), w._version, w.device, o_pad)
    # under the lock: threads that code streams at once share the weights
    with _lock:
        cache = w.__dict__.setdefault("_conv3x3_packs", {})
        hit = cache.get(layout)
        if hit is not None and hit[0] == key:
            return hit[1]
        with torch.no_grad():
            if layout == "direct":  # (C, 3, 3, O): a chunk's weights are one run
                pack = w.detach().permute(1, 2, 3, 0).float().contiguous()
            elif layout == "oihw":
                pack = w.detach().float().contiguous()
            elif layout == "wgmma_bf16":
                pack = pack_weights_bf16(w.detach(), o_pad)
            else:
                pack = pack_weights(w.detach(), layout, o_pad)
        packed_weights.packs += 1
        cache[layout] = (key, pack)
    return pack


packed_weights.packs = 0


def conv3x3_plain(x, w, b, act=None, residual=None):
    """Plain PyTorch version: F.conv2d plus the same f32 epilogue. For
    bf16 operands: upcast, all of it in f32, one rounding to bf16 at the
    end (the Pallas kernel's arithmetic)."""
    if x.dtype == torch.bfloat16:
        y = conv3x3_plain(x.float(), w.float(), b.float(), act,
                          None if residual is None else residual.float())
        return y.to(torch.bfloat16)
    return _epilogue(F.conv2d(x, w, b, padding=1), act, residual)


def _epilogue(y, act, residual):
    if residual is not None:
        y = y + residual
    if act == "leaky_relu":
        y = torch.where(y >= 0, y, 0.2 * y)
    elif act == "tanh":
        y = torch.tanh(y)
    elif act is not None:
        raise ValueError(f"unknown act {act!r}")
    return y


def conv3x3_split_plain(x, w, b, act=None, residual=None, products=3):
    """Plain emulation of the tensor-core variants' arithmetic: operands
    split with ``tf32_split``, the products big*big + (big*small +
    small*big) summed in f32 (a product of two TF32 numbers is exact in
    f32). ``products=1`` keeps big*big alone: one TF32 product."""
    (xb, xs), (wb, ws) = tf32_split(x), tf32_split(w)
    y = F.conv2d(xb, wb, padding=1)
    if products == 3:
        y = y + (F.conv2d(xb, ws, padding=1) + F.conv2d(xs, wb, padding=1))
    elif products != 1:
        raise ValueError(f"products must be 1 or 3, got {products}")
    return _epilogue(y + b.view(1, -1, 1, 1), act, residual)


def _check(x, w, b, act, residual):
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW, got {tuple(x.shape)}")
    n, c, h, wd = x.shape
    o = w.shape[0]
    if tuple(w.shape) != (o, c, 3, 3):
        raise ValueError(f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    if tuple(b.shape) != (o,):
        raise ValueError(f"b {tuple(b.shape)} must be ({o},)")
    if residual is not None and tuple(residual.shape) != (n, o, h, wd):
        raise ValueError(f"residual {tuple(residual.shape)} must be "
                         f"{(n, o, h, wd)}")
    # f32 throughout, or the bf16 instance: bf16 x, w and residual, f32 b
    want = x.dtype if x.dtype in (torch.float32, torch.bfloat16) else torch.float32
    for name, t in (("x", x), ("w", w), ("b", b), ("residual", residual)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        dtype = torch.float32 if name == "b" else want
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} (x is {x.dtype}), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, w, b, act, residual, variant):
    _check(x, w, b, act, residual)
    if x.device.type != "cuda":
        raise ValueError(f"the conv3x3 kernels run on cuda, not {x.device}")
    lib = _load()
    n, c, h, wd = x.shape
    o = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty((n, o, h, wd), dtype=x.dtype, device=x.device)
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in (x, residual, y))
    pick = lib.conv3x3_pick_bf16 if bf16 else lib.conv3x3_pick
    name = variant or _VARIANT_NAMES[pick(c, o, wd, aligned)]
    if (name in BF16_VARIANTS) != bf16:
        raise TypeError(f"variant {name} does not take {x.dtype} tensors")
    wk = packed_weights(w, _LAYOUT_OF[name], lib.conv3x3_padded_o(o))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launch = lib.conv3x3_bf16 if bf16 else lib.conv3x3_f32
        rc = launch(
            x.data_ptr(), wk.data_ptr(), b.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            y.data_ptr(), n, c, h, wd, o, ACTS[act], VARIANTS[name], stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3 kernel {name} launch failed: CUDA error {rc}")
    with _lock:  # the codec launches from several threads
        conv3x3.launches += 1
        conv3x3.by_variant[name] = conv3x3.by_variant.get(name, 0) + 1
    return y


def _forward(x, w, b, act, residual):
    """The kernel for CUDA tensors; the plain version only on the CPU."""
    if x.device.type == "cpu":
        _check(x, w, b, act, residual)
        return conv3x3_plain(x, w, b, act, residual)
    return _launch(x, w, b, act, residual, None)


def flipped_weights(w):
    """(C, O, 3, 3) weights of the input gradient of a 3x3 'same' conv
    with (O, C, 3, 3) weights ``w``: the taps flipped, the channels
    swapped. dL/dx = conv3x3(dL/dy, flipped_weights(w)), no bias."""
    return w.flip(2, 3).transpose(0, 1).contiguous()


def weight_grad(x, w_shape, g):
    """dL/dw of a 3x3 'same' conv with input x and pre-activation gradient
    g: one stock ``torch.nn.grad.conv2d_weight`` call with the batch folded
    into groups, so that each sample's products are summed on their own,
    then the N parts summed. One call over the batch accumulates N*H*W
    products a weight in cuDNN's f32 weight-gradient algorithm and misses
    float64 by about 1.5e-4 of the largest magnitude at 16x64x256x256
    (``chip_smoke.py`` measures both); per sample the sums are N times
    shorter."""
    n, c, h, w = x.shape
    o = w_shape[0]
    parts = torch.nn.grad.conv2d_weight(
        x.reshape(1, n * c, h, w), (n * o, c, 3, 3), g.reshape(1, n * o, h, w),
        padding=1, groups=n)
    return parts.view(n, o, c, 3, 3).sum(0)


class Conv3x3Function(torch.autograd.Function):
    """``conv3x3`` with a gradient. Forward: the kernel (its plain version
    on the CPU); saves x, w and the output. Backward: the pre-activation
    gradient g from the saved output (LeakyReLU: y >= 0 iff the
    pre-activation is, derivative 1 at 0 as the epilogue's ``>=``; tanh:
    1 - y^2), then d_residual = g, d_b = g summed over N, H, W,
    d_x = conv3x3(g, flipped_weights(w), 0) through the kernel again, and
    d_w by ``weight_grad`` (stock PyTorch: the JAX package has no backward
    kernel; XLA computed this gradient there)."""

    @staticmethod
    def forward(ctx, x, w, b, residual, act):
        if x.dtype != torch.float32:
            # the bf16 instance is the inference policy's, as the Pallas
            # kernel is inference-only
            raise TypeError(f"conv3x3 has no gradient for {x.dtype} inputs")
        y = _forward(x, w, b, act, residual)
        ctx.act = act
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        if ctx.act == "leaky_relu":
            g = torch.where(y >= 0, dy, 0.2 * dy)
        elif ctx.act == "tanh":
            g = dy * (1 - y * y)
        else:
            g = dy
        g = g.contiguous()
        need_x, need_w, need_b, need_r, _ = ctx.needs_input_grad
        d_x = d_w = d_b = None
        if need_x:
            d_x = _forward(g, flipped_weights(w), w.new_zeros(w.shape[1]), None,
                           None)
        if need_w:
            d_w = weight_grad(x, w.shape, g)
        if need_b:
            d_b = g.sum((0, 2, 3))
        return d_x, d_w, d_b, (g if need_r else None), None


def conv3x3(x, w, b, act=None, residual=None):
    """act(conv3x3(x, w) + b [+ residual]) with stride 1, 'same' zero pad.

    x (N,C,H,W), w (O,C,3,3), b (O,), residual (N,O,H,W); contiguous, all
    f32, or bf16 x, w and residual with an f32 b (bf16 out, forward only).
    act: None | 'leaky_relu' (slope 0.2) | 'tanh'. With grad mode on and an
    input that requires grad it goes through ``Conv3x3Function`` (which
    raises for bf16); otherwise it launches the kernel and records
    nothing.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b, residual)):
        return Conv3x3Function.apply(x, w, b, residual, act)
    return _forward(x, w, b, act, residual)


conv3x3.launches = 0
conv3x3.by_variant = {}


def variants_for(c: int, o: int, width: int, dtype=torch.float32) -> list:
    """The variants that take C input and O output channels on rows of
    ``width`` pixels (of a tensor aligned to 16 bytes) in `dtype`; the
    first is the one ``conv3x3`` launches."""
    lib = _load()
    bf16 = dtype == torch.bfloat16
    pick = lib.conv3x3_pick_bf16 if bf16 else lib.conv3x3_pick
    first = _VARIANT_NAMES[pick(c, o, width, 1)]
    return [first] + [name for name, v in VARIANTS.items()
                      if name != first and (name in BF16_VARIANTS) == bf16
                      and lib.conv3x3_takes(v, c, o, width, 1)]


def conv3x3_variant(name, x, w, b, act=None, residual=None):
    """Launch the named variant whatever the shape's own choice is, to
    measure one variant against another; it raises on a shape the variant
    does not take. The port itself calls ``conv3x3``."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}")
    return _launch(x, w, b, act, residual, name)
