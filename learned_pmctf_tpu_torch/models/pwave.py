"""pWave++ wavelet image coder.

Counterpart of learned_pmctf_tpu/models/pwave.py: 4-level learned 2-D
lifting analysis, per-subband quantization with a log-interpolated QP
range (21 rate points), the LL subband coded by the masked-conv AR model
(``ll_mode="ar"``, the reference's) or a four-step checkerboard prior
(``ll_mode="fourstep"``), the lh/hl/hh subbands (coarse to fine, with the
LSTM subband context) by four-step priors, Laplace rate estimate,
synthesis and PostProcess. ``forward`` is the estimate path, and with
``training=True`` the training forward (straight-through rounding); the
bitstream codec (codec/image_codec.py) calls ``quantize_planes``,
``ctx_init``/``ctx_step``, ``ar_params``, the four-step modules'
``hier_params`` / ``spatial_params`` (through ``fusion_hier`` /
``fusion_spatial``) and ``reconstruct``. With ``act_bf16`` these run
under the bf16 activation policy (models/layers.py), as the JAX
package's do; the codec's stream entry points force f32.

Under a spatial shard (parallel/halo.py) ``forward`` codes this rank's
block of the columns: its sub-networks exchange their halos, and the
bits, the pixel count and the squared error are the frame's (summed over
the spatial group), on every rank.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..entropy.distributions import laplace_bits
from ..ops.quant import quant_ste, ste_clamp
from ..parallel import halo
from .context import (AR_RADIUS, ContextFusionFourStep, ContextFusionSubband,
                      SubbandContext)
from .layers import policy_scope
from .postprocess import PostProcess
from .wavelet import LiftingScheme2D

QP_NUM = 21  # rate points
BANDS = ("lh", "hl", "hh")


def interp_q_scale(q_pair, q_index, qp_num: int = QP_NUM):
    """Log-interpolate between the learned (min, max) q scales."""
    min_q, max_q = q_pair[0], q_pair[1]
    step = (torch.log(max_q) - torch.log(min_q)) / (qp_num - 1)
    return torch.exp(torch.log(min_q) + step * q_index)


class PWave(nn.Module):
    """Wavelet image codec: analysis, subband coding, synthesis."""

    def __init__(self, bitdepth: int = 8, decomp_levels: int = 4,
                 lossy: bool = True, features: int = 112,
                 ar_features: int = 128, ll_mode: str = "fourstep",
                 act_bf16: bool = False):
        super().__init__()
        if ll_mode not in ("fourstep", "ar"):
            raise ValueError(f"unknown ll_mode {ll_mode!r}")
        self.ll_mode = ll_mode
        self.act_bf16 = act_bf16
        self.decomp_levels = decomp_levels
        self.lossy = lossy
        self.dynamic_range = float(2 ** bitdepth)
        self.clip_value = 8192.0 if lossy else 32767.0
        self.wavelet_transform = LiftingScheme2D(1, bitdepth, lossy)
        self.context_prediction = SubbandContext(1, decomp_levels)
        self.dequantModule = PostProcess(1, 1)
        fusion = []
        for lvl in range(decomp_levels):
            ctx_ch = 1 if lvl == decomp_levels - 1 else 2
            bands = nn.ModuleDict({
                band: ContextFusionFourStep(1, ctx_ch, features, 2, lossy=lossy)
                for band in BANDS})
            if lvl == decomp_levels - 1 and ll_mode == "ar":
                bands["ll"] = ContextFusionSubband(1, ar_features, 2)
            elif lvl == decomp_levels - 1:
                bands["ll"] = ContextFusionFourStep(
                    1, 1, ar_features, 2, use_ctx=False, lossy=lossy)
            fusion.append(bands)
        self.context_fusion = nn.ModuleList(fusion)
        self.QP = nn.Parameter(torch.full((2, 1, 1, 1), 1.0 / 16.0))
        self.QP_ll = nn.Parameter(torch.full((2, 1, 1, 1), 1.0 / 16.0))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.QP.fill_(1.0 / 16.0)
            self.QP_ll.fill_(1.0 / 16.0)

    @staticmethod
    def get_qp_num() -> int:
        return QP_NUM

    def current_q(self, q_index, qp_scale=None):
        if q_index is None:
            qp, qp_ll = self.QP[-1], self.QP_ll[-1]
        else:
            qp = interp_q_scale(self.QP, q_index)
            qp_ll = interp_q_scale(self.QP_ll, q_index)
        if qp_scale is not None:
            qp = qp * qp_scale
            qp_ll = qp_ll * qp_scale
        return qp, qp_ll

    def spatial_align(self) -> int:
        """What a spatial shard's width must divide by: the lifting halves
        it at each level with even and odd columns, and the deepest
        subband's checkerboard needs an even first column."""
        return 2 ** (self.decomp_levels + 1)

    def analysis(self, x) -> Dict[int, Dict[str, torch.Tensor]]:
        subbands = {}
        ll = x
        for lvl in range(self.decomp_levels):
            sb = self.wavelet_transform.forward_lift_2d(ll)
            subbands[lvl] = sb
            ll = sb["ll"]
        return subbands

    def synthesis(self, subbands) -> torch.Tensor:
        y = None
        for lvl in range(self.decomp_levels - 1, -1, -1):
            sb = dict(subbands[lvl])
            if y is not None:
                sb["ll"] = y
            y = self.wavelet_transform.backward_lift_2d(sb)
        return y

    def postprocess(self, x_hat):
        if self.lossy:
            return self.dequantModule(x_hat / self.dynamic_range) * self.dynamic_range
        return x_hat

    def quantize_subband(self, subband, q_scale):
        """Scale + STE clamp (rounding happens in the entropy model)."""
        if self.lossy:
            subband = subband * q_scale
        return ste_clamp(subband, -self.clip_value, self.clip_value)

    def dequantize_subband(self, subband, q_scale):
        return subband / q_scale if self.lossy else subband

    @policy_scope
    def forward(self, x, q_index=None, qp_scale=None, training: bool = False):
        """Forward with entropy-estimated rate (no bitstream): hard
        rounding, or with ``training`` straight-through rounding.

        Returns dict with x_hat, per-sample bits, bits_total, bpp_total
        (the batch's bits over B*H*W), mse.
        """
        halo.check_columns(x, self.spatial_align(), "pWave's lifting levels")
        q_scale, q_scale_ll = self.current_q(q_index, qp_scale)
        y = self.analysis(x)
        L = self.decomp_levels
        fusion = self.context_fusion
        subbands_hat: Dict[int, Dict[str, torch.Tensor]] = {l: {} for l in range(L)}

        ll = self.quantize_subband(y[L - 1]["ll"], q_scale_ll)
        if self.ll_mode == "ar":
            ll_hat = quant_ste(ll, training)
            scales, means = halo.halo_call(self.ar_params, ll_hat, r=AR_RADIUS)
            bits = laplace_bits(ll_hat - means, scales).sum(dim=(1, 2, 3))
        else:
            _, ll_q, ll_hat, s_hat = fusion[L - 1]["ll"](ll, training=training)
            bits = laplace_bits(ll_q, s_hat).sum(dim=(1, 2, 3))
        subbands_hat[L - 1]["ll"] = ll_hat

        b, _, h, w = ll.shape
        states = self.context_prediction.init_states(b, h, w, ll)
        context, states = self.context_prediction.step(ll_hat, states)
        for lvl in range(L - 1, -1, -1):
            for sidx, band in enumerate(BANDS):
                ctx = context.chunk(3, dim=1)[sidx]
                prev = subbands_hat[lvl + 1][band] if lvl < L - 1 else None
                s_curr = self.quantize_subband(y[lvl][band], q_scale)
                _, s_q, s_hat_band, scales = fusion[lvl][band](
                    s_curr, context=ctx, prev_subband=prev, training=training)
                subbands_hat[lvl][band] = s_hat_band
                bits = bits + laplace_bits(s_q, scales).sum(dim=(1, 2, 3))
                up = lvl - 1 if (band == "hh" and lvl > 0) else None
                context, states = self.context_prediction.step(
                    s_hat_band, states, upsample_level=up)

        x_hat = self.reconstruct(subbands_hat, q_index, qp_scale)

        bits = halo.sum_over_width(bits)
        num_pixels = x.shape[0] * x.shape[2] * halo.global_width(x)
        return {
            "x_hat": x_hat,
            "bits": bits,
            "bits_total": bits.sum(),
            "bpp_total": bits.sum() / num_pixels,
            "mse": halo.mean_over_width((x - x_hat) ** 2),
        }

    # ---- sub-graphs of the bitstream codec -------------------------------

    @policy_scope
    def quantize_planes(self, x, q_index=None, qp_scale=None):
        """Quantized (continuous, pre-round) subbands in coding order: the
        teacher inputs of the codec's encode-as-decode replay."""
        q_scale, q_scale_ll = self.current_q(q_index, qp_scale)
        y = self.analysis(x)
        L = self.decomp_levels
        planes = {"ll": self.quantize_subband(y[L - 1]["ll"], q_scale_ll)}
        for lvl in range(L - 1, -1, -1):
            for band in BANDS:
                planes[f"{lvl}_{band}"] = self.quantize_subband(y[lvl][band], q_scale)
        return planes

    def ctx_init(self, like):
        b, _, h, w = like.shape
        return self.context_prediction.init_states(b, h, w, like)

    @policy_scope
    def ctx_step(self, subband, states, upsample_level=None):
        return self.context_prediction.step(subband, states, upsample_level)

    def fusion(self, key: str):
        """The entropy model of subband `key` ("ll" or "<level>_<band>")."""
        if key == "ll":
            return self.context_fusion[self.decomp_levels - 1]["ll"]
        lvl, band = key.split("_")
        return self.context_fusion[int(lvl)][band]

    @policy_scope
    def fusion_hier(self, key: str, context, prev_subband, like):
        return self.fusion(key).hier_params(context, prev_subband, like=like)

    @policy_scope
    def fusion_spatial(self, key: str, x_hat_so_far, ctx_feat, step: int):
        return self.fusion(key).spatial_params(x_hat_so_far, ctx_feat, step)

    @policy_scope
    def ar_params(self, partial_rec):
        """(scales, means) of the AR LL model on a (partial) reconstruction."""
        params = self.context_fusion[self.decomp_levels - 1]["ll"](partial_rec)
        scales, means = params.chunk(2, dim=1)
        return scales, means

    @policy_scope
    def reconstruct(self, subbands_hat, q_index=None, qp_scale=None):
        """Dequantize + synthesis + PostProcess (the decode tail)."""
        q_scale, q_scale_ll = self.current_q(q_index, qp_scale)
        rec = {}
        for lvl, bands in subbands_hat.items():
            rec[lvl] = {band: self.dequantize_subband(
                sb, q_scale_ll if band == "ll" else q_scale)
                for band, sb in bands.items()}
        return self.postprocess(self.synthesis(rec))
