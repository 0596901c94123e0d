"""Motion-vector autoencoder, hyperprior, and the quad four-part prior.

Counterpart of learned_pmctf_tpu/models/mv_coder.py: the estimate path's
``four_part_prior_forward`` and the bitstream path's per-pass
``four_part_prior_decode_scales`` / ``four_part_prior_scatter``.

Under a spatial shard (parallel/halo.py) the four-part prior exchanges a
halo a pass (its spatial prior's three DepthConv blocks: PASS_RADIUS
columns of the latent), and its checkerboard needs an even first column
at 1/16. The encoder, hyper and decoder chains' radii and alignments are
models/pmctf.py's.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn as nn

from ..ops.masks import checkerboard_masks
from ..ops.quant import lower_bound, quant_ste
from ..parallel import halo
from .layers import (Conv2d, DepthConvBlock, DepthConvBlock4, LeakyReLU,
                     ResidualBlockUpsample, ResidualBlockWithStride, SubpelConv,
                     net_boundary)


class MvEnc(nn.Module):
    """MV latent encoder: 4x stride-2, mid-stream quant multiply and the
    DPB-conditional adaptor."""

    def __init__(self, in_ch: int = 2, channels: int = 64):
        super().__init__()
        c = channels
        self.enc_1 = nn.Sequential(ResidualBlockWithStride(in_ch, c, 2),
                                   DepthConvBlock(c, c))
        self.enc_2 = ResidualBlockWithStride(c, c, 2)
        self.adaptor_0 = DepthConvBlock(c, c)
        self.adaptor_1 = DepthConvBlock(c * 2, c)
        self.enc_3 = nn.Sequential(ResidualBlockWithStride(c, c, 2),
                                   DepthConvBlock(c, c),
                                   Conv2d(c, c, 3, stride=2))

    def forward(self, x, context, quant_step):
        out = self.enc_2(self.enc_1(x) * quant_step)
        if context is None:
            out = self.adaptor_0(out)
        else:
            out = self.adaptor_1(torch.cat([out, context], dim=1))
        # net boundary: the latent is quantized downstream, f32 under the policy
        return net_boundary(self.enc_3(out))


class MvDec(nn.Module):
    """MV latent decoder returning (mv, feature); feature feeds the DPB."""

    def __init__(self, out_ch: int = 2, channels: int = 64):
        super().__init__()
        c = channels
        self.dec_1 = nn.Sequential(
            DepthConvBlock(c, c), ResidualBlockUpsample(c, c, 2),
            DepthConvBlock(c, c), ResidualBlockUpsample(c, c, 2),
            DepthConvBlock(c, c))
        self.dec_2 = ResidualBlockUpsample(c, c, 2)
        self.dec_3 = nn.Sequential(DepthConvBlock(c, c),
                                   SubpelConv(c, out_ch, 2, kernel=1))

    def forward(self, x, quant_step):
        feature = self.dec_1(x)
        out = self.dec_2(feature) * quant_step
        return net_boundary(self.dec_3(out)), net_boundary(feature)


class HyperEncoder(nn.Sequential):
    def __init__(self, channels_n: int = 64, channels_in: int = 64):
        super().__init__(DepthConvBlock4(channels_in, channels_n),
                         Conv2d(channels_n, channels_n, 3, stride=2),
                         LeakyReLU(0.01),
                         Conv2d(channels_n, channels_n, 3, stride=2))

    def forward(self, x):
        return net_boundary(super().forward(x))  # z is rounded to symbols


class HyperDecoder(nn.Sequential):
    def __init__(self, channels_n: int = 64, channels_out: int = 64):
        super().__init__(ResidualBlockUpsample(channels_n, channels_n, 2),
                         ResidualBlockUpsample(channels_n, channels_n, 2),
                         DepthConvBlock4(channels_n, channels_out))

    def forward(self, x):
        return net_boundary(super().forward(x))


# columns of the MV latent a pass of the four-part prior reaches: three
# DepthConv blocks (a depthwise 3x3 each) after the 1x1 adaptor
PASS_RADIUS = 3

# mask index per (step, channel quarter)
MASK_SCHEDULE = ((0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2))


def separate_prior_enc_dec(params):
    """(q_enc, q_dec, scales, means) with LowerBound(0.5) reciprocal quant."""
    quant_step, scales, means = params.chunk(3, dim=1)
    quant_step = lower_bound(quant_step, 0.5)
    return 1.0 / quant_step, quant_step, scales, means


def _mask_process(y, scales, means, mask, training):
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = quant_ste(y_res, training)
    return y_res, y_q, y_q + means_hat, scales_hat


def four_part_prior_forward(y, common_params, adaptors: Sequence[Callable],
                            spatial_prior: Callable, training: bool = False):
    """Estimation (hard rounding) or training (straight-through rounding)
    forward of the quad prior over 16 groups (4 channel quarters x 4
    checkerboard phases), 4 passes.

    adaptors: 3 callables mapping cat(y_hat_so_far, common) to the spatial
    prior's input; spatial_prior maps that to 8 chunks (scales x4, means x4).
    Returns (y_res, y_q, y_hat, scales_hat)."""
    q_enc, q_dec, scales, means = separate_prior_enc_dec(common_params)
    _, _, h, w = y.shape
    halo.check_columns(y, 2, "the MV prior's checkerboard parity")
    masks = checkerboard_masks(h, w, y.dtype, y.device)

    y_quarters = (y * q_enc).chunk(4, dim=1)
    scales_q = scales.chunk(4, dim=1)
    means_q = means.chunk(4, dim=1)
    res_acc, q_acc, hat_acc, shat_acc = ([None] * 4 for _ in range(4))
    y_hat_so_far = None

    def acc(lst, i, v):
        lst[i] = v if lst[i] is None else lst[i] + v

    for step in range(4):
        step_hats = []
        for i in range(4):
            m = masks[MASK_SCHEDULE[step][i]]
            y_res, y_q, y_hat, s_hat = _mask_process(
                y_quarters[i], scales_q[i], means_q[i], m, training)
            acc(res_acc, i, y_res)
            acc(q_acc, i, y_q)
            acc(hat_acc, i, y_hat)
            acc(shat_acc, i, s_hat)
            step_hats.append(y_hat)
        y_hat_curr = torch.cat(step_hats, dim=1)
        y_hat_so_far = (y_hat_curr if y_hat_so_far is None
                        else y_hat_so_far + y_hat_curr)
        if step < 3:
            def pass_params(so_far, common, step=step):
                inp = torch.cat([so_far, common], dim=1)
                # f32 head: scales and means drive the symbol quantization
                return net_boundary(spatial_prior(adaptors[step](inp)))
            chunks = halo.halo_call(pass_params, y_hat_so_far, common_params,
                                    r=PASS_RADIUS).chunk(8, dim=1)
            scales_q, means_q = chunks[:4], chunks[4:]

    return (torch.cat(res_acc, dim=1), torch.cat(q_acc, dim=1),
            torch.cat(hat_acc, dim=1) * q_dec, torch.cat(shat_acc, dim=1))


def four_part_prior_decode_scales(scales_q, masks, step: int):
    """Dense scale plane of pass `step` for rANS: each spatial phase
    carries exactly one channel quarter under MASK_SCHEDULE."""
    out = 0.0
    for i in range(4):
        out = out + scales_q[i] * masks[MASK_SCHEDULE[step][i]]
    return out


def four_part_prior_scatter(y_q_r, means_q, masks, step: int):
    """Scatter one decoded dense plane of pass `step` into the 4 channel
    quarters, adding their means."""
    return torch.cat([(y_q_r + means_q[i]) * masks[MASK_SCHEDULE[step][i]]
                      for i in range(4)], dim=1)
