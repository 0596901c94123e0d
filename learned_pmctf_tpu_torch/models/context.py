"""Context models for subband entropy coding.

Counterpart of learned_pmctf_tpu/models/context.py: the LSTM subband
context (``SubbandContext``), the masked-conv AR model of the LL subband
under ``ll_mode="ar"`` (``ContextFusionSubband``, without the context
branch, which no model builds) and the four-step checkerboard prior
(``ContextFusionFourStep``).

Under a spatial shard (parallel/halo.py) the LSTM exchanges its halo once
a step (three chained 3x3 gates, and the upsamplers' 3x3 conv at twice
the resolution: LSTM_RADIUS), the four-step prior once for its
hierarchical part (HIER_RADIUS) and once a pass (PASS_RADIUS), since each
pass reads what the passes before it decoded, and the AR net once
(AR_RADIUS). The checkerboard masks are built from a shard's own shape:
its first column must be even, which check_columns asserts rather than
shifting the masks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.masks import checkerboard_masks
from ..ops.quant import quant_ste, ste_round
from ..ops.resample import nearest_upsample
from ..parallel import halo
from .layers import (Conv2d, ContextResidual, DepthConvBlock, MaskedConv2d,
                     leaky_relu, net_boundary)

# columns each sub-network reaches (3x3 convs, one column each)
LSTM_RADIUS = 3       # LSTM1-3, chained; +1 (at the low resolution) to upsample
HIER_RADIUS = 8       # the lower subband's conv (2 columns here), conv1_context,
#                       two residual blocks, the DepthConv head; even: the lower
#                       subband is at half the resolution
PASS_RADIUS = 7       # a spatial prior: conv, residual block, two residual blocks
AR_RADIUS = 6         # the masked convs: conv1, two residual blocks, conv2


class LSTM2D(nn.Module):
    """Convolutional LSTM whose gates all share ONE pre-activation
    xh = conv_in(x) + conv_hidden(h), as the reference does:
    c = sigmoid(xh) * c + sigmoid(xh) * tanh(xh); h = sigmoid(xh) * tanh(c).
    """

    def __init__(self, in_ch: int, hidden: int):
        super().__init__()
        self.conv_in = Conv2d(in_ch, hidden, 3)
        self.conv_hidden = Conv2d(hidden, hidden, 3)

    def forward(self, x, h, c):
        # the gates in f32 under the policy: the carried states feed the
        # entropy parameter nets of all subbands
        xh = net_boundary(self.conv_in(x) + self.conv_hidden(h))
        gate = torch.sigmoid(xh)
        c = gate * net_boundary(c) + gate * torch.tanh(xh)
        h = torch.sigmoid(xh) * torch.tanh(c)
        return h, c


class UpsampleModule(nn.Module):
    """Nearest 2x upsample + 3x3 conv, growing LSTM states across levels."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3)

    def forward(self, x):
        return self.conv(nearest_upsample(x))


class SubbandContext(nn.Module):
    """LSTM context threaded across subbands in coding order.

    The state is an explicit tuple ((h1,c1), (h2,c2), (h3,c3)) with
    (32, 32, 3*in_ch) channels; each step returns a 3*in_ch-channel
    context map that the caller splits into lh/hl/hh contexts."""

    def __init__(self, in_ch: int = 1, decomp_levels: int = 4,
                 hidden: int = 32):
        super().__init__()
        self.hidden = hidden
        self.out_ch = 3 * in_ch
        self.LSTM1 = LSTM2D(in_ch, hidden)
        self.LSTM2 = LSTM2D(hidden, hidden)
        self.LSTM3 = LSTM2D(hidden, self.out_ch)
        n = decomp_levels - 1
        for j, ch in ((1, hidden), (2, hidden), (3, self.out_ch)):
            for kind in ("h", "c"):
                setattr(self, f"deconv_{kind}{j}",
                        nn.ModuleList(UpsampleModule(ch) for _ in range(n)))

    def init_states(self, batch: int, h: int, w: int, like: torch.Tensor):
        def z(c):
            return like.new_zeros((batch, c, h, w))
        return ((z(self.hidden), z(self.hidden)),
                (z(self.hidden), z(self.hidden)),
                (z(self.out_ch), z(self.out_ch)))

    def step(self, subband, states, upsample_level: Optional[int] = None):
        """Feed one reconstructed subband; with `upsample_level` i, grow
        the states with the i-th upsamplers (after 'hh' of level i+1).
        Returns (context, new_states)."""
        (h1, c1), (h2, c2), (h3, c3) = states
        return halo.halo_call(
            lambda *t: self._step(t[0], ((t[1], t[2]), (t[3], t[4]), (t[5], t[6])),
                                  upsample_level),
            subband, h1, c1, h2, c2, h3, c3,
            r=LSTM_RADIUS + (upsample_level is not None))

    def _step(self, subband, states, upsample_level):
        (h1, c1), (h2, c2), (h3, c3) = states
        h1, c1 = self.LSTM1(subband, h1, c1)
        h2, c2 = self.LSTM2(h1, h2, c2)
        h3, c3 = self.LSTM3(h2, h3, c3)
        if upsample_level is not None:
            i = upsample_level
            h1, c1 = self.deconv_h1[i](h1), self.deconv_c1[i](c1)
            h2, c2 = self.deconv_h2[i](h2), self.deconv_c2[i](c2)
            h3, c3 = self.deconv_h3[i](h3), self.deconv_c3[i](c3)
        return h3, ((h1, c1), (h2, c2), (h3, c3))


# Kernel size of every masked conv of the AR stack. The codec's wavefront
# decoder (codec/image_codec.ar_wavefronts) takes its slope t = 2*row + col
# from it: a causal 3x3 conv reaches at most one column to the right per
# row up. A larger kernel needs a steeper slope there, or the range coder
# loses sync.
AR_MASKED_KERNEL = 3


class MaskResidual(nn.Module):
    """Two B-masked 3x3 convs with LeakyReLU(0.2) between, and a residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = MaskedConv2d(channels, channels, AR_MASKED_KERNEL, "B")
        self.conv2 = MaskedConv2d(channels, channels, AR_MASKED_KERNEL, "B")

    def forward(self, x):
        return self.conv2(leaky_relu(self.conv1(x), 0.2)) + x


class ContextFusionSubband(nn.Module):
    """PixelCNN-style AR entropy-parameter net of the LL subband.

    The net is strictly causal in its input (an A-masked conv first,
    B-masked after it, then 1x1 convs), so the encoder runs it once on the
    whole teacher plane and the decoder re-runs it on the partial
    reconstruction: at each not yet decoded position the two agree.
    Returns (B, num_params, H, W) in f32: scales, then means."""

    def __init__(self, in_ch: int = 1, features: int = 128,
                 num_params: int = 2, residual_blocks: int = 2):
        super().__init__()
        self.maskedConv1 = MaskedConv2d(in_ch, features, AR_MASKED_KERNEL, "A")
        self.residualBlocks = nn.ModuleList(
            MaskResidual(features) for _ in range(residual_blocks))
        self.maskedConv2 = MaskedConv2d(features, features, AR_MASKED_KERNEL, "B")
        self.convs = nn.ModuleList([Conv2d(features, features, 1),
                                    Conv2d(features, features, 1),
                                    Conv2d(features, num_params, 1)])

    def forward(self, x):
        y = conv1 = self.maskedConv1(x)
        for block in self.residualBlocks:
            y = block(y)
        y = leaky_relu(self.maskedConv2(y + conv1), 0.2)
        for i, conv in enumerate(self.convs):
            y = conv(y)
            if i < len(self.convs) - 1:
                y = leaky_relu(y, 0.2)
        return y.float()


def process_with_mask(y, scales, means, mask, lossy: bool = True,
                      training: bool = False):
    """Quantize the masked positions around their predicted means: hard
    rounding on the estimate path, straight-through rounding in training."""
    if not lossy:
        means = ste_round(means)
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = quant_ste(y_res, training)
    y_hat = y_q + means_hat
    return y_res, y_q, y_hat, scales_hat


class ContextFusionFourStep(nn.Module):
    """DCVC-DC style 4-pass spatial prior for wavelet subbands: each pass
    codes one 2x2 checkerboard phase, conditioned on the reconstruction
    so far plus the (LSTM + lower-level subband) context."""

    def __init__(self, in_ch: int = 1, ctx_ch: int = 1, features: int = 128,
                 num_params: int = 2, use_ctx: bool = True, lossy: bool = True,
                 lower_subband: bool = True):
        super().__init__()
        self.use_ctx = use_ctx
        self.lossy = lossy
        if use_ctx:
            self.conv1_context = Conv2d(ctx_ch, features, 3)
            self.y_hierarchical_prior_enc = nn.Sequential(
                ContextResidual(features), ContextResidual(features))
            if ctx_ch > 1 and lower_subband:
                self.lower_level_subband = nn.Sequential(
                    nn.Upsample(scale_factor=2, mode="nearest"),
                    Conv2d(in_ch, in_ch, 3))
            hier_in = features
        else:
            hier_in = in_ch
        self.y_hierarchical_prior_out = DepthConvBlock(hier_in, num_params)
        for k in (1, 2, 3):
            setattr(self, f"y_spatial_prior_{k}", nn.Sequential(
                Conv2d(in_ch, features, 3), ContextResidual(features)))
            setattr(self, f"y_spatial_prior_{k}_out", nn.Sequential(
                ContextResidual(features), ContextResidual(features),
                Conv2d(features, num_params, 1)))

    def hier_params(self, context=None, prev_subband=None, like=None):
        """Context features + step-0 (scales, means)."""
        if self.use_ctx:
            if prev_subband is not None:
                prev = self.lower_level_subband(prev_subband)
                context = torch.cat([context, prev], dim=1)
            feat = self.y_hierarchical_prior_enc(self.conv1_context(context))
            params = self.y_hierarchical_prior_out(feat)
        else:
            feat = None
            params = self.y_hierarchical_prior_out(torch.zeros_like(like))
        # f32 heads under the policy: a bf16 ulp would coarsen the symbols
        scales, means = net_boundary(params).chunk(2, dim=1)
        return feat, scales, means

    def spatial_params(self, x_hat_so_far, ctx_feat, step: int):
        """(scales, means) for pass `step+1` given the recon so far."""
        y = getattr(self, f"y_spatial_prior_{step + 1}")(x_hat_so_far)
        if ctx_feat is not None:
            y = y + ctx_feat
        params = getattr(self, f"y_spatial_prior_{step + 1}_out")(y)
        scales, means = net_boundary(params).chunk(2, dim=1)
        return scales, means

    def forward(self, x, context=None, prev_subband=None,
                training: bool = False):
        """Returns (x_res, x_q, x_hat, scales_hat), summed over the passes."""
        ctx_feat, scales, means = halo.halo_call(self.hier_params, context, prev_subband,
                                                 x, r=HIER_RADIUS)
        _, _, h, w = x.shape
        halo.check_columns(x, 2, "the checkerboard masks' parity")
        masks = checkerboard_masks(h, w, x.dtype, x.device)
        x_res = x_q = s_hat = None
        x_hat_so_far = torch.zeros_like(x)
        for step in range(4):
            r, q, xh, s = process_with_mask(x, scales, means, masks[step],
                                            self.lossy, training)
            x_res = r if x_res is None else x_res + r
            x_q = q if x_q is None else x_q + q
            s_hat = s if s_hat is None else s_hat + s
            x_hat_so_far = x_hat_so_far + xh
            if step < 3:
                scales, means = halo.halo_call(
                    lambda a, f: self.spatial_params(a, f, step), x_hat_so_far, ctx_feat,
                    r=PASS_RADIUS)
        return x_res, x_q, x_hat_so_far, s_hat
