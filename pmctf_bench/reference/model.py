"""The plain reference of pMCTF-L's estimate path: plain PyTorch, f32.

A frozen copy of what the port's GOP estimate path computes
(learned_pmctf_tpu_torch/models/{pmctf,pwave,context,layers,wavelet,
spynet,mv_coder,postprocess}.py and ops/, four-step LL, lossy), with
every convolution through one plain ``F.conv2d`` (``Numerics.conv``):
no conv3x3 kernel, no activation policy, no spatial shards, no training
branches. Module and parameter names are the port's, so one state dict
loads into both. It imports nothing of the port.

``Numerics`` says in which precision the convolutions run: ``f32`` (TF32
off: the reference), or the controls one step below a configuration's
precision: ``tf32`` (each conv's input and weights rounded to TF32, ten
bits of mantissa, to nearest even, then summed in f32, as the tensor
cores do with TF32 on) and ``fp8`` (rounded to float8 e4m3 under a
per-tensor scale, then an f32 conv). The rounding is done here, so a
control reads the same on any device. It also counts every conv's
operations and bytes (work.py) under the layer the hooks of layers.py
have entered.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

_TRUNC_STD = 0.87962566103423978
CDF97 = (-1.586134342059924, -0.052980118572961, 0.882911075530934,
         0.443506852043971, 0.869864451624781, 1.149604398860241)
QP_NUM = 21
BANDS = ("lh", "hl", "hh")
MASK_SCHEDULE = ((0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2))
FP8_MAX = 448.0


class Numerics:
    """The precision of the reference's convolutions and the counter of
    their work. `precision`: "f32", "tf32" or "fp8"."""

    def __init__(self, precision: str = "f32", work=None):
        if precision not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.work = work
        self.layer = ["other"]

    def conv(self, x, w, b, stride, padding, groups):
        if self.precision != "f32":
            rounded = _tf32 if self.precision == "tf32" else _fp8
            x, w = rounded(x), rounded(w)
        y = F.conv2d(x, w, b, stride, padding, 1, groups)
        if self.work is not None:
            self.work.add_conv(self.layer[-1], x, w, y, groups)
        return y


@contextlib.contextmanager
def f32_math():
    """cuDNN convolutions and matmuls in full f32 (TF32 off) inside,
    whatever the process had set before; restored on leaving. The
    reference pins its own precision, so that it never follows the
    program it judges."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, matmul


def _tf32(t):
    """t rounded to TF32 (the low 13 bits of the f32 mantissa dropped,
    to nearest even), in f32."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _fp8(t):
    """t rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    amax = t.abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


# ---- layers ---------------------------------------------------------------

class Conv2d(nn.Conv2d):
    """'same' padding unless given; fixed taps for the lifting skip convs."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, padding=None,
                 groups=1, bias=True, init_taps=None):
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        if padding is None:
            padding = ((kh - 1) // 2, (kw - 1) // 2)
        super().__init__(in_ch, out_ch, (kh, kw), stride=stride,
                         padding=padding, groups=groups, bias=bias)
        self.init_taps = init_taps
        self.numerics: Optional[Numerics] = None

    def forward(self, x):
        return self.numerics.conv(x, self.weight, self.bias, self.stride,
                                  self.padding, self.groups)


def lrelu(x, slope):
    return F.leaky_relu(x, negative_slope=slope)


class LeakyReLU(nn.Module):
    def __init__(self, slope):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return lrelu(x, self.slope)


class PredictUpdate(nn.Module):
    def __init__(self, in_ch=1, hidden=16):
        super().__init__()
        self.conv1 = Conv2d(in_ch, hidden, 3)
        self.conv2 = Conv2d(hidden, hidden, 3)
        self.conv3 = Conv2d(hidden, hidden, 3)
        self.conv4 = Conv2d(hidden, in_ch, 3)

    def forward(self, x):
        c1 = self.conv1(x)
        x = torch.tanh(self.conv2(torch.tanh(c1)))
        return self.conv4(c1 + self.conv3(x))


class ResBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3)
        self.conv2 = Conv2d(channels, channels, 3)

    def forward(self, x):
        return x + self.conv2(lrelu(self.conv1(x), 0.2))


def SubpelConv(in_ch, out_ch, r=2, kernel=1):
    return nn.Sequential(Conv2d(in_ch, out_ch * r ** 2, kernel), nn.PixelShuffle(r))


class ResidualBlockWithStride(nn.Module):
    def __init__(self, in_ch, out_ch, stride=2):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, 3, stride=stride)
        self.conv2 = Conv2d(out_ch, out_ch, 3)
        self.downsample = Conv2d(in_ch, out_ch, 1, stride=stride) if stride != 1 else None

    def forward(self, x):
        y = lrelu(self.conv2(lrelu(self.conv1(x), 0.01)), 0.1)
        return y + (x if self.downsample is None else self.downsample(x))


class ResidualBlockUpsample(nn.Module):
    def __init__(self, in_ch, out_ch, upsample=2):
        super().__init__()
        self.subpel_conv = SubpelConv(in_ch, out_ch, upsample)
        self.conv = Conv2d(out_ch, out_ch, 3)
        self.upsample = SubpelConv(in_ch, out_ch, upsample)

    def forward(self, x):
        y = lrelu(self.conv(lrelu(self.subpel_conv(x), 0.01)), 0.1)
        return y + self.upsample(x)


class DepthConv(nn.Module):
    def __init__(self, in_ch, out_ch, depth_kernel=3, stride=1, slope=0.01):
        super().__init__()
        self.conv1 = nn.Sequential(Conv2d(in_ch, in_ch, 1, stride=stride), LeakyReLU(slope))
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
        return self.conv2(self.depth_conv(self.conv1(x))) + identity


class ConvFFN(nn.Module):
    def __init__(self, in_ch, slope=0.1):
        super().__init__()
        internal = max(min(in_ch * 4, 1024), in_ch * 2)
        self.conv = nn.Sequential(Conv2d(in_ch, internal, 1), LeakyReLU(slope),
                                  Conv2d(internal, in_ch, 1), LeakyReLU(slope))

    def forward(self, x):
        return x + self.conv(x)


class ConvFFN3(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.conv = Conv2d(in_ch, in_ch * 4, 1)
        self.conv_out = Conv2d(in_ch * 2, in_ch, 1)

    def forward(self, x):
        x1, x2 = self.conv(x).chunk(2, dim=1)
        return x + self.conv_out(lrelu(x1, 0.1) + lrelu(x2, 0.01))


class DepthConvBlock(nn.Module):
    def __init__(self, in_ch, out_ch, depth_kernel=3, stride=1):
        super().__init__()
        self.block = nn.Sequential(DepthConv(in_ch, out_ch, depth_kernel, stride),
                                   ConvFFN(out_ch))

    def forward(self, x):
        return self.block(x)


class DepthConvBlock4(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.block = nn.Sequential(DepthConv(in_ch, out_ch), ConvFFN3(out_ch))

    def forward(self, x):
        return self.block(x)


# ---- ops ------------------------------------------------------------------

def checkerboard_masks(h, w, like):
    masks = []
    for my, mx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        m = like.new_zeros((1, 1, h, w))
        m[..., my::2, mx::2] = 1.0
        masks.append(m)
    return masks


def laplace_bits(y, scale):
    scale = torch.clamp(scale, 1e-5, 1e10)

    def cdf(v):
        return 0.5 - 0.5 * torch.sign(v) * torch.expm1(-torch.abs(v) / scale)
    return torch.clamp_min(-torch.log(cdf(y + 0.5) - cdf(y - 0.5) + 1e-5) / math.log(2.0), 0.0)


def interp_q_scale(q_pair, q_index):
    lo, hi = torch.log(q_pair[0]), torch.log(q_pair[1])
    return torch.exp(lo + (hi - lo) / (QP_NUM - 1) * q_index)


def bilinear_upsample(x, factor=2):
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


def bilinear_downsample(x, factor=2):
    _, _, h, w = x.shape
    return F.interpolate(x, size=(h // factor, w // factor), mode="bilinear",
                         align_corners=False, antialias=True)


def flow_warp(feature, flow):
    """Bilinear backward warp, coordinates clamped to the image."""
    _, _, h, w = feature.shape
    col = torch.arange(w, dtype=flow.dtype, device=flow.device)
    row = torch.arange(h, dtype=flow.dtype, device=flow.device)
    gx = (col.view(1, 1, w) + flow[:, 0]) / ((w - 1) / 2.0) - 1.0
    gy = (row.view(1, h, 1) + flow[:, 1]) / ((h - 1) / 2.0) - 1.0
    return F.grid_sample(feature, torch.stack([gx, gy], dim=3), mode="bilinear",
                         padding_mode="border", align_corners=True)


def flow_warp_fast(feature, flow, max_disp):
    """The separable warp: displacements clamped to +-max_disp, rows
    blended by the vertical fraction first, then columns of that blend."""
    b, c, h, w = feature.shape
    d = float(max_disp)
    fx = flow[:, 0:1].clamp(-d, d)
    fy = flow[:, 1:2].clamp(-d, d)
    col = torch.arange(w, dtype=fx.dtype, device=fx.device).view(1, 1, 1, w)
    row = torch.arange(h, dtype=fy.dtype, device=fy.device).view(1, 1, h, 1)
    px = (col + fx).clamp(0.0, w - 1.0)
    py = (row + fy).clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()

    def rows(r):
        return torch.gather(feature, 2, r.clamp(max=h - 1).expand(b, c, h, w))
    v0 = rows(y0)
    v = v0 + (rows(y0 + 1) - v0) * wy

    def cols(q):
        return torch.gather(v, 3, q.clamp(0, w - 1).expand(b, c, h, w))
    h0 = cols(x0)
    return h0 + (cols(x0 + 1) - h0) * wx


# ---- wavelets --------------------------------------------------------------

def _skip_conv(taps):
    return Conv2d(1, 1, (3, 1), padding=0, groups=1, init_taps=taps)


class LearnedLifting1D(nn.Module):
    def __init__(self, bitdepth=8):
        super().__init__()
        c = CDF97
        self.dynamic_range = float(2 ** bitdepth)
        self.conv_P1 = _skip_conv((0.0, c[0], c[0]))
        self.conv_U1 = _skip_conv((c[1], c[1], 0.0))
        self.conv_P2 = _skip_conv((0.0, c[2], c[2]))
        self.conv_U2 = _skip_conv((c[3], c[3], 0.0))
        self.P_1, self.U_1 = PredictUpdate(), PredictUpdate()
        self.P_2, self.U_2 = PredictUpdate(), PredictUpdate()
        self.scale_l = nn.Parameter(torch.tensor(c[5]))
        self.scale_h = nn.Parameter(torch.tensor(c[4]))

    def _inc(self, source, skip_conv, net):
        skip = skip_conv(F.pad(source, (0, 0, 1, 1), mode="reflect"))
        return skip + net(skip / self.dynamic_range) * self.dynamic_range * 0.1

    def forward_lift(self, x):
        x_e, x_o = x[:, :, ::2, :], x[:, :, 1::2, :]
        x_o = x_o + self._inc(x_e, self.conv_P1, self.P_1)
        x_e = x_e + self._inc(x_o, self.conv_U1, self.U_1)
        x_o = x_o + self._inc(x_e, self.conv_P2, self.P_2)
        x_e = x_e + self._inc(x_o, self.conv_U2, self.U_2)
        return x_e * self.scale_l, x_o * self.scale_h

    def backward_lift(self, l, h):
        l, h = l / self.scale_l, h / self.scale_h
        l = l - self._inc(h, self.conv_U2, self.U_2)
        h = h - self._inc(l, self.conv_P2, self.P_2)
        l = l - self._inc(h, self.conv_U1, self.U_1)
        h = h - self._inc(l, self.conv_P1, self.P_1)
        b, c, h2, w = l.shape
        return torch.stack([l, h], dim=3).reshape(b, c, h2 * 2, w)


class LiftingScheme2D(nn.Module):
    def __init__(self, bitdepth=8):
        super().__init__()
        self.lift_h = LearnedLifting1D(bitdepth)

    def forward_lift_2d(self, x):
        lift = self.lift_h
        l, h = lift.forward_lift(x)
        ll, lh = lift.forward_lift(l.transpose(2, 3))
        hl, hh = lift.forward_lift(h.transpose(2, 3))
        t = lambda v: v.transpose(2, 3)  # noqa: E731
        return {"ll": t(ll), "lh": t(lh), "hl": t(hl), "hh": t(hh)}

    def backward_lift_2d(self, sb):
        lift = self.lift_h
        t = lambda k: sb[k].transpose(2, 3)  # noqa: E731
        l = lift.backward_lift(t("ll"), t("lh")).transpose(2, 3)
        h = lift.backward_lift(t("hl"), t("hh")).transpose(2, 3)
        return lift.backward_lift(l, h)


class TemporalLifting(nn.Module):
    def __init__(self):
        super().__init__()
        self.P_t, self.U_t = PredictUpdate(), PredictUpdate()
        self.scale_p = nn.Parameter(torch.tensor(1.0 / math.sqrt(2.0)))
        self.scale_u = nn.Parameter(torch.tensor(0.5))

    def predict_filter(self, x):
        return (x + self.P_t(x) * 0.1) * self.scale_p

    def update_filter(self, x):
        return (x + self.U_t(x) * 0.1) * self.scale_u


# ---- context models ------------------------------------------------------

class LSTM2D(nn.Module):
    def __init__(self, in_ch, hidden):
        super().__init__()
        self.conv_in = Conv2d(in_ch, hidden, 3)
        self.conv_hidden = Conv2d(hidden, hidden, 3)

    def forward(self, x, h, c):
        xh = self.conv_in(x) + self.conv_hidden(h)
        gate = torch.sigmoid(xh)
        c = gate * c + gate * torch.tanh(xh)
        return torch.sigmoid(xh) * torch.tanh(c), c


class UpsampleModule(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class SubbandContext(nn.Module):
    def __init__(self, decomp_levels=4, hidden=32):
        super().__init__()
        self.hidden = hidden
        self.LSTM1 = LSTM2D(1, hidden)
        self.LSTM2 = LSTM2D(hidden, hidden)
        self.LSTM3 = LSTM2D(hidden, 3)
        for j, ch in ((1, hidden), (2, hidden), (3, 3)):
            for kind in ("h", "c"):
                setattr(self, f"deconv_{kind}{j}",
                        nn.ModuleList(UpsampleModule(ch) for _ in range(decomp_levels - 1)))

    def init_states(self, like):
        b, _, h, w = like.shape
        z = lambda c: like.new_zeros((b, c, h, w))  # noqa: E731
        return [[z(self.hidden), z(self.hidden)], [z(self.hidden), z(self.hidden)],
                [z(3), z(3)]]

    def forward(self, subband, states, upsample_level=None):
        (h1, c1), (h2, c2), (h3, c3) = states
        h1, c1 = self.LSTM1(subband, h1, c1)
        h2, c2 = self.LSTM2(h1, h2, c2)
        h3, c3 = self.LSTM3(h2, h3, c3)
        if upsample_level is not None:
            i = upsample_level
            h1, c1 = self.deconv_h1[i](h1), self.deconv_c1[i](c1)
            h2, c2 = self.deconv_h2[i](h2), self.deconv_c2[i](c2)
            h3, c3 = self.deconv_h3[i](h3), self.deconv_c3[i](c3)
        return h3, [[h1, c1], [h2, c2], [h3, c3]]


class ContextFusionFourStep(nn.Module):
    """The four-pass checkerboard prior of a subband."""

    def __init__(self, ctx_ch=1, features=128, use_ctx=True):
        super().__init__()
        self.use_ctx = use_ctx
        if use_ctx:
            self.conv1_context = Conv2d(ctx_ch, features, 3)
            self.y_hierarchical_prior_enc = nn.Sequential(ResBlock(features), ResBlock(features))
            if ctx_ch > 1:
                self.lower_level_subband = nn.Sequential(
                    nn.Upsample(scale_factor=2, mode="nearest"), Conv2d(1, 1, 3))
        self.y_hierarchical_prior_out = DepthConvBlock(features if use_ctx else 1, 2)
        for k in (1, 2, 3):
            setattr(self, f"y_spatial_prior_{k}",
                    nn.Sequential(Conv2d(1, features, 3), ResBlock(features)))
            setattr(self, f"y_spatial_prior_{k}_out",
                    nn.Sequential(ResBlock(features), ResBlock(features),
                                  Conv2d(features, 2, 1)))

    def forward(self, x, context=None, prev_subband=None):
        """(symbols, reconstruction, scales) summed over the four passes."""
        if self.use_ctx:
            if prev_subband is not None:
                context = torch.cat([context, self.lower_level_subband(prev_subband)], dim=1)
            feat = self.y_hierarchical_prior_enc(self.conv1_context(context))
            params = self.y_hierarchical_prior_out(feat)
        else:
            feat = None
            params = self.y_hierarchical_prior_out(torch.zeros_like(x))
        scales, means = params.chunk(2, dim=1)
        masks = checkerboard_masks(x.shape[2], x.shape[3], x)
        x_q = s_hat = 0.0
        so_far = torch.zeros_like(x)
        for step in range(4):
            m = masks[step]
            q = torch.round((x - means * m) * m)
            x_q = x_q + q
            s_hat = s_hat + scales * m
            so_far = so_far + (q + means * m)
            if step < 3:
                y = getattr(self, f"y_spatial_prior_{step + 1}")(so_far)
                if feat is not None:
                    y = y + feat
                scales, means = getattr(self, f"y_spatial_prior_{step + 1}_out")(y).chunk(2, dim=1)
        return x_q, so_far, s_hat


class PostProcess(nn.Module):
    def __init__(self, channels=64, num_res=6):
        super().__init__()
        self.conv1 = Conv2d(1, channels, 3)
        self.resBlocks = nn.ModuleList(ResBlock(channels) for _ in range(num_res))
        self.conv2 = Conv2d(channels, channels, 3)
        self.conv3 = Conv2d(channels, 1, 3)

    def forward(self, x):
        t = conv1 = self.conv1(x)
        for blk in self.resBlocks:
            t = blk(t)
        return x + self.conv3(self.conv2(t) + conv1)


class PWave(nn.Module):
    """The wavelet image coder's estimate path: analysis, four-step
    priors with the LSTM context, Laplace rates, synthesis, PostProcess."""

    def __init__(self, decomp_levels=4, features=112, ar_features=128):
        super().__init__()
        self.decomp_levels = L = decomp_levels
        self.dynamic_range = 256.0
        self.wavelet_transform = LiftingScheme2D()
        self.context_prediction = SubbandContext(decomp_levels)
        self.dequantModule = PostProcess()
        fusion = []
        for lvl in range(L):
            bands = nn.ModuleDict({b: ContextFusionFourStep(1 if lvl == L - 1 else 2, features)
                                   for b in BANDS})
            if lvl == L - 1:
                bands["ll"] = ContextFusionFourStep(1, ar_features, use_ctx=False)
            fusion.append(bands)
        self.context_fusion = nn.ModuleList(fusion)
        self.QP = nn.Parameter(torch.full((2, 1, 1, 1), 1.0 / 16.0))
        self.QP_ll = nn.Parameter(torch.full((2, 1, 1, 1), 1.0 / 16.0))

    def forward(self, x, q_index, qp_scale=None) -> Dict[str, torch.Tensor]:
        q, q_ll = interp_q_scale(self.QP, q_index), interp_q_scale(self.QP_ll, q_index)
        if qp_scale is not None:
            q, q_ll = q * qp_scale, q_ll * qp_scale
        L, fusion = self.decomp_levels, self.context_fusion
        y, ll = {}, x
        for lvl in range(L):
            y[lvl] = self.wavelet_transform.forward_lift_2d(ll)
            ll = y[lvl]["ll"]
        quant = lambda s, qs: torch.clamp(s * qs, -8192.0, 8192.0)  # noqa: E731
        hat = {lvl: {} for lvl in range(L)}
        ll_q, ll_hat, s = fusion[L - 1]["ll"](quant(y[L - 1]["ll"], q_ll))
        bits = laplace_bits(ll_q, s).sum(dim=(1, 2, 3))
        hat[L - 1]["ll"] = ll_hat
        ctx_net = self.context_prediction
        states = ctx_net.init_states(ll_hat)
        context, states = ctx_net(ll_hat, states)
        for lvl in range(L - 1, -1, -1):
            for sidx, band in enumerate(BANDS):
                prev = hat[lvl + 1][band] if lvl < L - 1 else None
                s_q, s_hat, scales = fusion[lvl][band](
                    quant(y[lvl][band], q), context.chunk(3, dim=1)[sidx], prev)
                hat[lvl][band] = s_hat
                bits = bits + laplace_bits(s_q, scales).sum(dim=(1, 2, 3))
                up = lvl - 1 if (band == "hh" and lvl > 0) else None
                context, states = ctx_net(s_hat, states, up)
        rec = None
        for lvl in range(L - 1, -1, -1):
            sb = {b: hat[lvl][b] / q for b in BANDS}
            sb["ll"] = rec if rec is not None else hat[lvl]["ll"] / q_ll
            rec = self.wavelet_transform.backward_lift_2d(sb)
        x_hat = self.dequantModule(rec / self.dynamic_range) * self.dynamic_range
        return {"x_hat": x_hat, "bits": bits.sum()}


# ---- motion ---------------------------------------------------------------

class MEBasic(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(4, 32, 7)
        self.conv2 = Conv2d(32, 64, 7)
        self.conv3 = Conv2d(64, 32, 7)
        self.conv4 = Conv2d(32, 16, 7)
        self.conv5 = Conv2d(16, 2, 7)

    def forward(self, x):
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = F.relu(conv(x))
        return self.conv5(x)


class MESpynet(nn.Module):
    def __init__(self, levels, warp):
        super().__init__()
        self.levels = levels
        self.warp = warp
        self.moduleBasic = nn.ModuleList(MEBasic() for _ in range(levels))

    def forward(self, im1, im2):
        p1, p2 = [im1], [im2]
        for _ in range(self.levels - 1):
            p1.append(F.avg_pool2d(p1[-1], 2, 2))
            p2.append(F.avg_pool2d(p2[-1], 2, 2))
        b, _, h, w = p1[-1].shape
        flow = im1.new_zeros((b, 2, h // 2, w // 2))
        for level in range(self.levels):
            up = bilinear_upsample(flow) * 2.0
            idx = self.levels - 1 - level
            flow = up + self.moduleBasic[level](
                torch.cat([p1[idx], self.warp(p2[idx], up), up], dim=1))
        return flow


class MvEnc(nn.Module):
    def __init__(self, c=64):
        super().__init__()
        self.enc_1 = nn.Sequential(ResidualBlockWithStride(2, c, 2), DepthConvBlock(c, c))
        self.enc_2 = ResidualBlockWithStride(c, c, 2)
        self.adaptor_0 = DepthConvBlock(c, c)
        self.adaptor_1 = DepthConvBlock(c * 2, c)
        self.enc_3 = nn.Sequential(ResidualBlockWithStride(c, c, 2), DepthConvBlock(c, c),
                                   Conv2d(c, c, 3, stride=2))

    def forward(self, x, context, quant_step):
        out = self.enc_2(self.enc_1(x) * quant_step)
        out = self.adaptor_0(out) if context is None else self.adaptor_1(torch.cat([out, context], 1))
        return self.enc_3(out)


class MvDec(nn.Module):
    def __init__(self, c=64):
        super().__init__()
        self.dec_1 = nn.Sequential(DepthConvBlock(c, c), ResidualBlockUpsample(c, c, 2),
                                   DepthConvBlock(c, c), ResidualBlockUpsample(c, c, 2),
                                   DepthConvBlock(c, c))
        self.dec_2 = ResidualBlockUpsample(c, c, 2)
        self.dec_3 = nn.Sequential(DepthConvBlock(c, c), SubpelConv(c, 2, 2, kernel=1))

    def forward(self, x, quant_step):
        feature = self.dec_1(x)
        return self.dec_3(self.dec_2(feature) * quant_step), feature


class HyperEncoder(nn.Sequential):
    def __init__(self, n=64, c=64):
        super().__init__(DepthConvBlock4(c, n), Conv2d(n, n, 3, stride=2), LeakyReLU(0.01),
                         Conv2d(n, n, 3, stride=2))


class HyperDecoder(nn.Sequential):
    def __init__(self, n=64, c=64):
        super().__init__(ResidualBlockUpsample(n, n, 2), ResidualBlockUpsample(n, n, 2),
                         DepthConvBlock4(n, c))


class Bitparm(nn.Module):
    def __init__(self, channels, final=False):
        super().__init__()
        shape = (1, channels, 1, 1)
        self.h = nn.Parameter(torch.zeros(shape))
        self.b = nn.Parameter(torch.zeros(shape))
        self.a = None if final else nn.Parameter(torch.zeros(shape))

    def forward(self, x):
        x = x * F.softplus(self.h) + self.b
        return x if self.a is None else x + torch.tanh(x) * torch.tanh(self.a)


class BitEstimator(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.f1, self.f2, self.f3 = Bitparm(channels), Bitparm(channels), Bitparm(channels)
        self.f4 = Bitparm(channels, final=True)

    def z_bits(self, z):
        cdf = lambda v: torch.sigmoid(self.f4(self.f3(self.f2(self.f1(v)))))  # noqa: E731
        return torch.clamp_min(-torch.log(cdf(z + 0.5) - cdf(z - 0.5) + 1e-5) / math.log(2.0), 0.0)


class PMCTF(nn.Module):
    """pMCTF-L: SpyNet motion, the MV autoencoder with its four-part
    prior, learned temporal lifting, two pWave coders."""

    def __init__(self, decomp_levels=4, num_me_stages=4, channel_mv=64, channel_n=64,
                 features=112, ar_features=128, spynet_levels=6, warp_mode="exact",
                 warp_max_disp=32, bitdepth=8, lossy=True, quant_stage=True,
                 ll_mode="fourstep", act_bf16=False):
        super().__init__()
        if (bitdepth, lossy, quant_stage, ll_mode) != (8, True, True, "fourstep"):
            raise ValueError("the reference codes 8-bit lossy four-step pMCTF-L only")
        if warp_mode not in ("exact", "fast"):
            raise ValueError(f"unknown warp_mode {warp_mode!r}")
        n, c, cn = num_me_stages, channel_mv, channel_n
        self.num_me_stages = n
        self.dynamic_range = 255.0
        if warp_mode == "fast":
            self.warp = lambda x, f: flow_warp_fast(x, f, warp_max_disp)
        else:
            self.warp = flow_warp
        self.lp_coder = PWave(decomp_levels, features, ar_features)
        self.hp_coder = PWave(decomp_levels, features, ar_features)
        self.optic_flow = MESpynet(spynet_levels, self.warp)
        stage = lambda make: nn.ModuleList(make() for _ in range(n))  # noqa: E731
        self.mv_encoder = stage(lambda: MvEnc(c))
        self.mv_decoder = stage(lambda: MvDec(c))
        self.mv_hyper_prior_encoder = stage(lambda: HyperEncoder(cn, c))
        self.mv_hyper_prior_decoder = stage(lambda: HyperDecoder(cn, c))
        self.mv_y_prior_fusion_adaptor_0 = stage(lambda: DepthConvBlock(c, c * 2))
        self.mv_y_prior_fusion_adaptor_1 = stage(lambda: DepthConvBlock(c * 2, c * 2))
        self.mv_y_prior_fusion = stage(lambda: nn.Sequential(
            DepthConvBlock(c * 2, c * 3), DepthConvBlock(c * 3, c * 3)))
        self.mv_y_spatial_prior = stage(lambda: nn.Sequential(
            DepthConvBlock(c * 3, c * 3), DepthConvBlock(c * 3, c * 3),
            DepthConvBlock(c * 3, c * 2)))
        for k in (1, 2, 3):
            setattr(self, f"mv_y_spatial_prior_adaptor_{k}", stage(lambda: Conv2d(c * 4, c * 3, 1)))
        ones = lambda: nn.ParameterList(nn.Parameter(torch.ones(2, 1, 1, 1)) for _ in range(n))  # noqa: E731
        self.mv_y_q_scale_enc, self.mv_y_q_scale_dec, self.hp_q_scale = ones(), ones(), ones()
        self.mv_bit_est = stage(lambda: BitEstimator(c))
        self.temporal_filtering = stage(TemporalLifting)

    def attach(self, numerics: Numerics):
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.numerics = numerics
        return self

    def code_motion(self, ref, cur, q_index, dpb, me):
        """(mv_hat, dpb, bits of the motion)."""
        q_enc = interp_q_scale(self.mv_y_q_scale_enc[me], q_index)
        q_dec = interp_q_scale(self.mv_y_q_scale_dec[me], q_index)
        flow = self.optic_flow(cur / self.dynamic_range, ref / self.dynamic_range)
        mv_y = self.mv_encoder[me](flow, dpb["mv_feature"], q_enc)
        mv_z_hat = torch.round(self.mv_hyper_prior_encoder[me](mv_y))
        params = self.mv_hyper_prior_decoder[me](mv_z_hat)
        if dpb["ref_mv_y"] is None:
            params = self.mv_y_prior_fusion_adaptor_0[me](params)
        else:
            params = self.mv_y_prior_fusion_adaptor_1[me](torch.cat([params, dpb["ref_mv_y"]], 1))
        params = self.mv_y_prior_fusion[me](params)
        step, scales, means = params.chunk(3, dim=1)
        step = torch.clamp_min(step, 0.5)
        masks = checkerboard_masks(mv_y.shape[2], mv_y.shape[3], mv_y)
        y_quarters = (mv_y * (1.0 / step)).chunk(4, dim=1)
        scales_q, means_q = scales.chunk(4, dim=1), means.chunk(4, dim=1)
        q_acc, hat_acc, s_acc = [0.0] * 4, [0.0] * 4, [0.0] * 4
        so_far = None
        adaptors = [getattr(self, f"mv_y_spatial_prior_adaptor_{k}")[me] for k in (1, 2, 3)]
        for p in range(4):
            hats = []
            for i in range(4):
                m = masks[MASK_SCHEDULE[p][i]]
                q = torch.round((y_quarters[i] - means_q[i] * m) * m)
                y_hat = q + means_q[i] * m
                q_acc[i] = q_acc[i] + q
                hat_acc[i] = hat_acc[i] + y_hat
                s_acc[i] = s_acc[i] + scales_q[i] * m
                hats.append(y_hat)
            cur_hat = torch.cat(hats, dim=1)
            so_far = cur_hat if so_far is None else so_far + cur_hat
            if p < 3:
                chunks = self.mv_y_spatial_prior[me](
                    adaptors[p](torch.cat([so_far, params], dim=1))).chunk(8, dim=1)
                scales_q, means_q = chunks[:4], chunks[4:]
        mv_y_hat = torch.cat(hat_acc, dim=1) * step
        pixels = ref.shape[2] * ref.shape[3]
        bits_y = laplace_bits(torch.cat(q_acc, dim=1), torch.cat(s_acc, dim=1)).sum(dim=(1, 2, 3))
        bits_z = self.mv_bit_est[me].z_bits(mv_z_hat).sum(dim=(1, 2, 3))
        bits = (bits_y.sum() / pixels + bits_z.sum() / pixels) * pixels
        mv_hat, feature = self.mv_decoder[me](mv_y_hat, q_dec)
        return mv_hat, {"mv_feature": feature, "ref_mv_y": mv_y_hat}, bits

    def forward_mctf(self, ref, cur, mv_hat, me):
        tf = self.temporal_filtering[me]
        mv_hat = _tile(mv_hat, ref.shape[0])
        h_t = cur - tf.predict_filter(self.warp(ref, mv_hat))
        return ref + tf.update_filter(self.warp(h_t, -mv_hat)), h_t

    def inverse_mctf(self, l_t, h_t, mv_hat, me):
        tf = self.temporal_filtering[me]
        mv_hat = _tile(mv_hat, l_t.shape[0])
        ref = l_t - tf.update_filter(self.warp(h_t, -mv_hat))
        return ref, h_t + tf.predict_filter(self.warp(ref, mv_hat))


def _tile(mv_hat, batch):
    return mv_hat.repeat(batch // mv_hat.shape[0], 1, 1, 1) if batch > mv_hat.shape[0] else mv_hat


def halve_mv(mv_hat):
    """The chroma MVs: the luma MVs downsampled and halved."""
    return bilinear_downsample(mv_hat) / 2.0
