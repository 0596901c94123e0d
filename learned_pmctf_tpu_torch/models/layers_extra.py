"""Auxiliary conv variants of the layer library.

Counterpart of learned_pmctf_tpu/models/layers_extra.py. No model of
either package builds them; they complete the layer library. Parameter
names follow the JAX modules' (convert.module_params_from_jax carries
flax weights across).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masks import causal_conv_mask
from .layers import Conv2d, _TRUNC_STD

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


class _ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, C, 1, 1), as flax's
    LayerNorm(reduction_axes=1, feature_axes=1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).pow(2).mean(dim=1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + LAYER_NORM_EPS)
        return y * self.scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class DynamicDWConv(nn.Module):
    """Dynamic depthwise conv: each sample's k x k depthwise kernel is
    generated from its globally pooled features (1x1 reduce, LayerNorm,
    ReLU, 1x1 expand), then one grouped conv runs every sample's kernel."""

    mask_type = ""

    def __init__(self, dim: int, kernel_size: int = 3, reduction: int = 4):
        super().__init__()
        red = 1 if dim < 4 else reduction
        mid = dim // red
        self.dim, self.kernel_size = dim, kernel_size
        k = kernel_size
        self.reduce = Conv2d(dim, mid, 1, bias=False)
        self.norm = _ChannelLayerNorm(mid)
        self.expand = Conv2d(mid, dim * k * k, 1)
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.bias.zero_()

    def kernels(self, x):
        """(B, dim, 1, k, k): each sample's depthwise kernel."""
        k = self.kernel_size
        t = torch.relu(self.norm(self.reduce(x.mean(dim=(2, 3), keepdim=True))))
        w = self.expand(t).reshape(x.shape[0], self.dim, 1, k, k)
        if self.mask_type:
            w = w * causal_conv_mask(k, k, self.mask_type, 1, 1).to(w)
        return w

    def forward(self, x):
        b, c, h, w = x.shape
        k = self.kernel_size
        y = F.conv2d(x.reshape(1, b * c, h, w),
                     self.kernels(x).reshape(b * c, 1, k, k),
                     padding=k // 2, groups=b * c)
        return y.reshape(b, c, h, w) + self.bias.view(1, -1, 1, 1)


class MaskedDynamicDWConv(DynamicDWConv):
    """DynamicDWConv with each generated kernel causally masked (A/B/C)."""

    def __init__(self, dim: int, kernel_size: int = 3, mask_type: str = "A",
                 reduction: int = 4):
        super().__init__(dim, kernel_size, reduction)
        self.mask_type = mask_type


class ConditionalConv(nn.Module):
    """A conv scaled and shifted per channel by a one-hot rate-point
    vector: softplus(fc_scaling(onehot)) * conv(x) + fc_bias(onehot). The
    conv is unmasked without bias, or causally masked (A/B) with bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 num_lambdas: int = 5, mask_type: str = ""):
        super().__init__()
        from .layers import MaskedConv2d
        self.mask_type = mask_type
        self.fc_scaling = nn.Linear(num_lambdas, out_ch)
        self.fc_bias = nn.Linear(num_lambdas, out_ch)
        self.conv = (MaskedConv2d(in_ch, out_ch, kernel, mask_type) if mask_type
                     else Conv2d(in_ch, out_ch, kernel, bias=False))

    def forward(self, x, onehot):
        scaling = F.softplus(self.fc_scaling(onehot))
        bias = self.fc_bias(onehot)
        return scaling[:, :, None, None] * self.conv(x) + bias[:, :, None, None]


class Conv3d(nn.Module):
    """3-D 'same' conv on (B, C, D, H, W); with `mask_type` the depth
    kernel is 3 and causal: the first slice whole, the centre slice the
    2-D A/B mask, the last slice zero."""

    def __init__(self, in_ch: int, out_ch: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3), groups: int = 1,
                 mask_type: str = ""):
        super().__init__()
        kd, kh, kw = kernel
        self.groups = groups
        self.padding = ((kd - 1) // 2, (kh - 1) // 2, (kw - 1) // 2)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kd, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        if mask_type:
            if kd != 3:
                raise ValueError("a masked Conv3d has a depth kernel of 3")
            m2d = causal_conv_mask(kh, kw, mask_type, out_ch, in_ch // groups)
            self.register_buffer("mask", torch.stack(
                [torch.ones_like(m2d), m2d, torch.zeros_like(m2d)], dim=2))
        else:
            self.mask = None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        std = 0.02 / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.bias.zero_()

    def forward(self, x):
        w = self.weight if self.mask is None else self.weight * self.mask
        return F.conv3d(x, w, self.bias, padding=self.padding, groups=self.groups)
