"""PostProcess: the dequantization enhancement net of every pWave decode.

Counterpart of learned_pmctf_tpu/models/postprocess.py:PostProcess. All
15 of its 3x3 convs go through the conv3x3 kernel with bias, LeakyReLU
and the skips fused, as the Pallas route there does (PMCTF_PALLAS_POST=1).
Under the bf16 activation policy (models/layers.py) the input, the
weights and so the activations between convs are bf16, as that route
casts them, and the kernel's bf16 instance runs every conv; the output
goes back to f32 at the net's boundary. Unlike the Pallas route, the
kernel also takes widths that are no multiple of 128 (chroma's 960).
PostProcessCtx, the contextual variant, runs on stock PyTorch.

Under a spatial shard (parallel/halo.py) PostProcess exchanges one halo
of 16 columns: its fifteen 3x3 convs reach 15, rounded to 16 so that a
widened block keeps the variants' width rules (W % 8 == 0, rows of
16 bytes: ops/conv3x3.py) when the block does. Each rank then launches
the kernel on its widened plane, with the variants and the launch count
of the unsharded call.
"""

import torch
import torch.nn as nn

from ..ops.conv3x3 import conv3x3, conv3x3_plain
from ..parallel import halo
from .layers import Conv2d, ResBlock, current_conv_dtype, net_boundary, policy_cast

# fifteen 3x3 convs reach 15 columns; 16 keeps a widened block's width
# a multiple of 8 when the block's is
HALO = 16


class PostProcess(nn.Module):
    """iWave++-style dequant net: 6 res blocks at 64 channels + global skip.

    `use_kernel = False` runs the plain version of every conv instead of
    the kernel, on any device; it exists to hold the kernel against the
    plain version end to end."""

    def __init__(self, in_ch: int = 1, out_ch: int = 1, channels: int = 64,
                 num_res: int = 6):
        super().__init__()
        self.conv1 = Conv2d(in_ch, channels, 3)
        self.resBlocks = nn.ModuleList(ResBlock(channels) for _ in range(num_res))
        self.conv2 = Conv2d(channels, channels, 3)
        self.conv3 = Conv2d(channels, out_ch, 3)
        self.use_kernel = True

    def forward(self, x):
        return halo.halo_call(self._forward, x, r=HALO)

    def _forward(self, x):
        kernel = conv3x3 if self.use_kernel else conv3x3_plain
        cdt = current_conv_dtype()

        def conv(t, m, **kw):
            w = m.weight if cdt is None else policy_cast(m.weight, cdt)
            return kernel(t, w, m.bias, **kw)

        x = x.contiguous()
        t = conv1 = conv(x if cdt is None else policy_cast(x, cdt), self.conv1)
        for blk in self.resBlocks:
            y = conv(t, blk.conv1, act="leaky_relu")
            t = conv(y, blk.conv2, residual=t)
        t = conv(t, self.conv2, residual=conv1)
        t = conv(t, self.conv3)
        return x + net_boundary(t)


class PostProcessCtx(nn.Module):
    """The contextual variant of PostProcess, conditioned on a feature map
    (counterpart of the JAX package's PostProcessCtx, which no model of
    either package builds). Returns (feature, x + enhancement). It has no
    kernel route in the JAX package, so none here: its convs, the
    (ctx_ch + in_ch) -> channels conv1 among them, run on stock PyTorch."""

    def __init__(self, in_ch: int = 1, out_ch: int = 1, channels: int = 64,
                 ctx_ch: int = 64):
        super().__init__()
        self.conv1 = Conv2d(in_ch + ctx_ch, channels, 3)
        self.resBlocks = nn.ModuleList(ResBlock(channels) for _ in range(6))
        self.conv2 = Conv2d(channels, channels, 3)
        self.conv3 = Conv2d(channels, out_ch, 3)

    def forward(self, x, ctx):
        t = conv1 = self.conv1(torch.cat([ctx, x], dim=1))
        for blk in self.resBlocks:
            t = blk(t)
        feature = self.conv2(t) + conv1
        return feature, x + self.conv3(feature)
