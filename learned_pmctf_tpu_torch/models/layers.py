"""Neural layer library (NCHW, OIHW weights).

Counterpart of learned_pmctf_tpu/models/layers.py, limited to the blocks
the pMCTF-L coding paths reach. Submodules carry the reference torch
model's state_dict names (DepthConv's ``conv1.0``, ConvFFN's
``conv.0``/``conv.2``, SubpelConv's ``.0``, MaskedConv2d's ``mask``
buffer), so a reference checkpoint maps onto the port key for key.

Weights are drawn by ``init_params`` from an explicit torch.Generator:
truncated normal with std 0.02 (cut at two std, as flax's
``truncated_normal``), zero bias; fixed-tap convs take their taps.

The activation policy (``act_bf16`` of PWave and PMCTF) is the JAX
package's, with its rounding points, not ``torch.autocast``'s: under
``policy_scope`` every ``Conv2d`` that is not ``policy_exempt`` casts its
input and weight to bf16, convolves with f32 accumulation, rounds to
bf16 and then adds its bias in bf16; the elementwise ops between convs
run in bf16; the self-contained nets cast back to f32 at their return.
Stream entry points run inside ``f32_streams``, which switches the
policy off: the range coder needs encoder and decoder bit-identical.
The policy is one stack for the process, as the JAX package's (the
codec's worker threads inherit a stream's f32); it is not meant for an
estimate and a stream coded at once from two threads.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masks import causal_conv_mask

# flax's truncated_normal divides by the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


_CONV_COMPUTE_DTYPE = [None]
_FORCE_F32 = [False]


@contextlib.contextmanager
def conv_compute_dtype(dtype):
    """Run the policy convs inside at `dtype` (None: f32)."""
    _CONV_COMPUTE_DTYPE.append(dtype)
    try:
        yield
    finally:
        _CONV_COMPUTE_DTYPE.pop()


def f32_streams(fn):
    """Decorator of the codec entry points that touch real bitstreams:
    the bf16 policy is off inside, whatever the module asks for."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _FORCE_F32.append(True)
        try:
            return fn(*args, **kwargs)
        finally:
            _FORCE_F32.pop()
    return wrapped


def current_conv_dtype():
    return _CONV_COMPUTE_DTYPE[-1]


def policy_scope(fn):
    """Method decorator: run under the module's activation policy (bf16
    when ``self.act_bf16`` and no stream forces f32)."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if getattr(self, "act_bf16", False) and not _FORCE_F32[-1]:
            with conv_compute_dtype(torch.bfloat16):
                return fn(self, *args, **kwargs)
        return fn(self, *args, **kwargs)
    return wrapped


def net_boundary(x):
    """Where a self-contained net returns under the policy: bf16
    activations go back to f32 (JAX's astype(float32)); f32 and float64
    runs pass through."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with the JAX package's defaults: 'same' padding
    ((k-1)//2 on each side) unless given, fixed initial taps for the
    lifting skip convs (`init_taps`, shape (O, I/groups, kh, kw)), and
    the activation policy unless `policy_exempt`."""

    def __init__(self, in_ch: int, out_ch: int,
                 kernel: Union[int, Tuple[int, int]] = 3, stride: int = 1,
                 padding: Union[int, Tuple[int, int], None] = None,
                 groups: int = 1, bias: bool = True,
                 init_taps: Optional[tuple] = None,
                 policy_exempt: bool = False):
        kh, kw = _pair(kernel)
        if padding is None:
            padding = ((kh - 1) // 2, (kw - 1) // 2)
        super().__init__(in_ch, out_ch, (kh, kw), stride=stride,
                         padding=padding, groups=groups, bias=bias)
        self.policy_exempt = policy_exempt
        # nn.Conv2d.__init__ has drawn the weights through reset_parameters
        # below already; only fixed taps need a second pass
        self.init_taps = init_taps
        if init_taps is not None:
            self.reset_parameters()

    def reset_parameters(self, generator=None):
        taps = getattr(self, "init_taps", None)
        with torch.no_grad():
            if taps is not None:
                self.weight.copy_(torch.tensor(taps, dtype=self.weight.dtype)
                                  .reshape(self.weight.shape))
            else:
                std = 0.02 / _TRUNC_STD
                nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def policy_dtype(self):
        return None if self.policy_exempt else current_conv_dtype()

    def policy_conv(self, x, w, cdt):
        """The conv of x and w cast to `cdt`, summed in f32, rounded to
        `cdt`, without the bias: cuDNN's bf16 convolution, or the f32
        convolution of the rounded operands, rounded once. The second is
        XLA's result bit for bit on the CPU, where torch's (oneDNN's) bf16
        convolution sums in an order of its own and rounds about 1e-4 of
        the outputs apart from XLA's. On CUDA it takes the convs with
        fewer than 8 channels a group in or out, where the tensor cores
        have nothing to gain: cuDNN 9.2's bf16 algorithm returned garbage
        for 1->1 3x3 convs on 16x16 and 32x32 planes, from run to run
        (NVIDIA H100, cuDNN 92200; tests/test_torch_port_bench_card.py)."""
        x, w = x.to(cdt), w.to(cdt)
        if x.device.type == "cpu" or min(w.shape[:2]) < 8:
            return self._conv_forward(x.float(), w.float(), None).to(cdt)
        return self._conv_forward(x, w, None)

    def forward(self, x):
        cdt = self.policy_dtype()
        if cdt is None:
            return self._conv_forward(x, self.weight, self.bias)
        # JAX's order: conv rounded to bf16, then the bias added in bf16
        y = self.policy_conv(x, self.weight, cdt)
        return y if self.bias is None else y + self.bias.to(cdt).view(1, -1, 1, 1)


class MaskedConv2d(Conv2d):
    """PixelCNN-masked 'same' conv (mask types A/B/C, see
    ops.masks.causal_conv_mask). The mask is a buffer, as in the reference
    model, so its state_dict carries ``.mask``; it is applied to the
    weight at call time."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 mask_type: str = "A"):
        super().__init__(in_ch, out_ch, kernel)
        kh, kw = self.kernel_size
        self.register_buffer("mask", causal_conv_mask(kh, kw, mask_type,
                                                      out_ch, in_ch))

    def forward(self, x):
        w = self.weight * self.mask
        cdt = self.policy_dtype()
        if cdt is None:
            return self._conv_forward(x, w, self.bias)
        # as JAX: the f32 bias promotes the bf16 conv to f32
        return self.policy_conv(x, w, cdt) + self.bias.view(1, -1, 1, 1)


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from `generator`, in module order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator=generator)
    return module


def leaky_relu(x, slope: float):
    """JAX's where(x >= 0, x, slope * x); in bf16 the slope is rounded to
    bf16 first, as JAX's weakly typed scalar is (0.2 -> 0.2001953125)."""
    if x.dtype != torch.bfloat16:
        return F.leaky_relu(x, negative_slope=slope)
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))


class LeakyReLU(nn.Module):
    """nn.LeakyReLU that rounds its slope as ``leaky_relu`` does."""

    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return leaky_relu(x, self.slope)


class PredictUpdate(nn.Module):
    """Learned P/U lifting filter: 3x3 conv chain with tanh and an inner
    residual from conv1, 16 hidden channels."""

    def __init__(self, in_ch: int = 1, hidden: int = 16):
        super().__init__()
        self.conv1 = Conv2d(in_ch, hidden, 3)
        self.conv2 = Conv2d(hidden, hidden, 3)
        self.conv3 = Conv2d(hidden, hidden, 3)
        self.conv4 = Conv2d(hidden, in_ch, 3)

    def forward(self, x):
        c1 = self.conv1(x)
        x = torch.tanh(c1)
        x = torch.tanh(self.conv2(x))
        x = c1 + self.conv3(x)
        return net_boundary(self.conv4(x))


class ResBlock(nn.Module):
    """Residual block with LeakyReLU(0.2): x + conv2(lrelu(conv1(x)))."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3)
        self.conv2 = Conv2d(channels, channels, 3)

    def forward(self, x):
        return x + self.conv2(leaky_relu(self.conv1(x), 0.2))


# the fusion models' context branches use the same block shape
ContextResidual = ResBlock


def SubpelConv(in_ch: int, out_ch: int, r: int = 2, kernel: int = 1):
    """Conv + pixel shuffle upsampler (reference key layout ``.0``)."""
    return nn.Sequential(Conv2d(in_ch, out_ch * r ** 2, kernel),
                         nn.PixelShuffle(r))


class ResidualBlockWithStride(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 2):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, 3, stride=stride)
        self.conv2 = Conv2d(out_ch, out_ch, 3)
        self.downsample = (Conv2d(in_ch, out_ch, 1, stride=stride)
                           if stride != 1 else None)

    def forward(self, x):
        y = leaky_relu(self.conv1(x), 0.01)
        y = leaky_relu(self.conv2(y), 0.1)
        identity = x if self.downsample is None else self.downsample(x)
        return y + identity


class ResidualBlockUpsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, upsample: int = 2):
        super().__init__()
        self.subpel_conv = SubpelConv(in_ch, out_ch, upsample)
        self.conv = Conv2d(out_ch, out_ch, 3)
        self.upsample = SubpelConv(in_ch, out_ch, upsample)

    def forward(self, x):
        y = leaky_relu(self.subpel_conv(x), 0.01)
        y = leaky_relu(self.conv(y), 0.1)
        return y + self.upsample(x)


class DepthConv(nn.Module):
    """1x1 -> depthwise 3x3 -> 1x1 with residual."""

    def __init__(self, in_ch: int, out_ch: int, depth_kernel: int = 3,
                 stride: int = 1, slope: float = 0.01):
        super().__init__()
        self.conv1 = nn.Sequential(Conv2d(in_ch, in_ch, 1, stride=stride),
                                   LeakyReLU(slope))
        self.depth_conv = Conv2d(in_ch, in_ch, depth_kernel, groups=in_ch)
        self.conv2 = Conv2d(in_ch, out_ch, 1)
        if stride != 1:
            self.adaptor = Conv2d(in_ch, out_ch, 2, stride=2, padding=0)
        elif in_ch != out_ch:
            self.adaptor = Conv2d(in_ch, out_ch, 1)
        else:
            self.adaptor = None

    def forward(self, x):
        identity = x if self.adaptor is None else self.adaptor(x)
        y = self.conv2(self.depth_conv(self.conv1(x)))
        return y + identity


class ConvFFN(nn.Module):
    """Pointwise FFN with residual."""

    def __init__(self, in_ch: int, slope: float = 0.1):
        super().__init__()
        internal = max(min(in_ch * 4, 1024), in_ch * 2)
        self.conv = nn.Sequential(Conv2d(in_ch, internal, 1), LeakyReLU(slope),
                                  Conv2d(internal, in_ch, 1), LeakyReLU(slope))

    def forward(self, x):
        return x + self.conv(x)


class ConvFFN3(nn.Module):
    """Gated two-branch FFN."""

    def __init__(self, in_ch: int):
        super().__init__()
        internal = in_ch * 2
        self.conv = Conv2d(in_ch, internal * 2, 1)
        self.conv_out = Conv2d(internal, in_ch, 1)

    def forward(self, x):
        x1, x2 = self.conv(x).chunk(2, dim=1)
        y = leaky_relu(x1, 0.1) + leaky_relu(x2, 0.01)
        return x + self.conv_out(y)


class DepthConvBlock(nn.Module):
    """DepthConv + ConvFFN."""

    def __init__(self, in_ch: int, out_ch: int, depth_kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.block = nn.Sequential(DepthConv(in_ch, out_ch, depth_kernel, stride),
                                   ConvFFN(out_ch))

    def forward(self, x):
        return self.block(x)


class DepthConvBlock4(nn.Module):
    """DepthConv + ConvFFN3."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block = nn.Sequential(DepthConv(in_ch, out_ch), ConvFFN3(out_ch))

    def forward(self, x):
        return self.block(x)
