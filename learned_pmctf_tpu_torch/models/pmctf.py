"""pMCTF-L video coder.

Counterpart of learned_pmctf_tpu/models/pmctf.py with
``spynet_luma=True``: f32 or the bf16 activation policy (``act_bf16``,
passed on to both pWave coders; models/layers.py), either warp
(``warp_mode="exact"``, the reference's, or the separable ``"fast"``,
clamped to +-``warp_max_disp``) and either LL coder
(``ll_mode="fourstep"`` or the reference's ``"ar"``, for both pWave
coders): two pWave coders for the temporal low/highpass bands, SpyNet
motion, the MV autoencoder with its four-part prior, learned temporal
lifting and per-stage highpass quality scaling. The DPB is an explicit
dict. ``forward_one_stage`` is the estimate path and, with
``training=True``, one pair of the training step
(training/steps.py); the ``mv_*`` methods are the sub-graphs of the
bitstream codec (codec/video_codec.py).

Under a spatial shard (parallel/halo.py) ``forward_one_stage`` codes this
rank's block of the columns (the estimate path; ``inverse_mctf`` too):
SpyNet runs on the planes gathered at full width, the MV encoder and its
hyper-encoder (six stride-2 convs, down to 1/64) exchange one halo of
MV_ENC_HALO columns aligned to 64, the hyper-decoder and the prior's
fusion one of MV_PRIOR_HALO columns of the hyper-latent, each pass of the
four-part prior one, the MV decoder one of MV_DEC_HALO columns of the
latent, the chroma MVs' antialiased downsample one of MV_DOWN_HALO, and
the warps and the pWave coders their own. The rates, pixel counts and
squared errors are the frame's on every rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..entropy.bit_estimator import BitEstimator
from ..entropy.distributions import laplace_bits
from ..ops.resample import bilinear_downsample, bilinear_upsample
from ..ops.quant import add_uniform_noise, quant_ste, ste_round
from ..ops.warp import flow_warp, flow_warp_fast
from ..parallel import halo
from ..runtime import disable_tf32, resolve_device
from .layers import Conv2d, DepthConvBlock, init_params, net_boundary, policy_scope
from .mv_coder import (HyperDecoder, HyperEncoder, MvDec, MvEnc,
                       four_part_prior_forward, separate_prior_enc_dec)
from .pwave import PWave, interp_q_scale
from .spynet import MESpynet
from .wavelet import TemporalLifting


# halos of the motion sub-networks under a spatial shard, in columns of
# their first input (the radius each reaches, rounded up to the alignment
# its strides need; tests/test_torch_port_spatial.py checks each)
MV_ENC_HALO = 128   # the flow at full resolution: MvEnc + HyperEncoder, to 1/64
MV_PRIOR_HALO = 2   # the hyper-latent at 1/64: HyperDecoder + the prior's fusion
MV_DEC_HALO = 3     # the MV latent at 1/16: MvDec, to full resolution
MV_DOWN_HALO = 2    # luma MVs: the chroma MVs' antialiased 2x downsample (one column)
MV_ALIGN = 64       # six stride-2 convs from the flow to the hyper-latent


def empty_dpb():
    return {"mv_feature": None, "ref_mv_y": None}


def _halve_mv(mv_hat):
    """The chroma MVs: the luma MVs downsampled and halved."""
    return halo.halo_call(bilinear_downsample, mv_hat, r=MV_DOWN_HALO, align=2) / 2.0


class PMCTF(nn.Module):
    """Motion-compensated temporal filtering video codec."""

    def __init__(self, bitdepth: int = 8, decomp_levels: int = 4,
                 lossy: bool = True, num_me_stages: int = 2,
                 quant_stage: bool = True, channel_mv: int = 64,
                 channel_n: int = 64, features: int = 112,
                 ar_features: int = 128, spynet_levels: int = 6,
                 ll_mode: str = "fourstep", warp_mode: str = "exact",
                 warp_max_disp: int = 32, act_bf16: bool = False):
        super().__init__()
        if warp_mode not in ("exact", "fast"):
            raise ValueError(f"unknown warp_mode {warp_mode!r}")
        self.ll_mode = ll_mode
        self.warp_mode = warp_mode
        self.warp_max_disp = warp_max_disp
        self.act_bf16 = act_bf16
        self.dynamic_range = float(2 ** bitdepth - 1)
        self.lossy = lossy
        self.num_me_stages = n = num_me_stages
        self.quant_stage = quant_stage
        self.channel_mv = channel_mv
        self.channel_n = channel_n
        c_mv, c_n = channel_mv, channel_n

        self.lp_coder = PWave(bitdepth, decomp_levels, lossy, features,
                              ar_features, ll_mode, act_bf16)
        self.hp_coder = PWave(bitdepth, decomp_levels, lossy, features,
                              ar_features, ll_mode, act_bf16)
        self.optic_flow = MESpynet(spynet_levels, warp_mode == "fast",
                                   warp_max_disp)

        def per_stage(make):
            return nn.ModuleList(make() for _ in range(n))

        self.mv_encoder = per_stage(lambda: MvEnc(2, c_mv))
        self.mv_decoder = per_stage(lambda: MvDec(2, c_mv))
        self.mv_hyper_prior_encoder = per_stage(lambda: HyperEncoder(c_n, c_mv))
        self.mv_hyper_prior_decoder = per_stage(lambda: HyperDecoder(c_n, c_mv))
        self.mv_y_prior_fusion_adaptor_0 = per_stage(
            lambda: DepthConvBlock(c_mv, c_mv * 2))
        self.mv_y_prior_fusion_adaptor_1 = per_stage(
            lambda: DepthConvBlock(c_mv * 2, c_mv * 2))
        self.mv_y_prior_fusion = per_stage(lambda: nn.Sequential(
            DepthConvBlock(c_mv * 2, c_mv * 3), DepthConvBlock(c_mv * 3, c_mv * 3)))
        self.mv_y_spatial_prior = per_stage(lambda: nn.Sequential(
            DepthConvBlock(c_mv * 3, c_mv * 3), DepthConvBlock(c_mv * 3, c_mv * 3),
            DepthConvBlock(c_mv * 3, c_mv * 2)))
        for k in (1, 2, 3):
            setattr(self, f"mv_y_spatial_prior_adaptor_{k}",
                    per_stage(lambda: Conv2d(c_mv * 4, c_mv * 3, 1)))

        def ones():
            return nn.ParameterList(nn.Parameter(torch.ones(2, 1, 1, 1))
                                    for _ in range(n))

        self.mv_y_q_scale_enc = ones()
        self.mv_y_q_scale_dec = ones()
        self.hp_q_scale = ones()
        self.mv_bit_est = per_stage(lambda: BitEstimator(c_mv))
        self.temporal_filtering = per_stage(lambda: TemporalLifting(lossy=lossy))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for plist in (self.mv_y_q_scale_enc, self.mv_y_q_scale_dec,
                          self.hp_q_scale):
                for p in plist:
                    p.fill_(1.0)

    # ---- helpers ---------------------------------------------------------

    @staticmethod
    def get_qp_num() -> int:
        return PWave.get_qp_num()

    def spatial_align(self) -> int:
        """What a spatial shard's luma width must divide by: 64 for the MV
        hyper chain, and the pWave coders' alignment on the chroma planes
        (half the luma width)."""
        return math.lcm(MV_ALIGN, 2 * self.hp_coder.spatial_align())

    def me_index(self, stage_idx: int) -> int:
        return min(self.num_me_stages - 1, stage_idx)

    def get_mv_y_q(self, q_index, stage_idx: int):
        return (interp_q_scale(self.mv_y_q_scale_enc[stage_idx], q_index),
                interp_q_scale(self.mv_y_q_scale_dec[stage_idx], q_index))

    def hp_qp_scale(self, q_index, stage_idx: int):
        if not self.quant_stage:
            return None
        return interp_q_scale(self.hp_q_scale[self.me_index(stage_idx)], q_index)

    def mv_prior_param_decoder(self, mv_z_hat, dpb, me_num: int):
        return halo.halo_call(lambda z, ref: self._prior_params(z, ref, me_num),
                              mv_z_hat, dpb.get("ref_mv_y"), r=MV_PRIOR_HALO)

    def _prior_params(self, mv_z_hat, ref_mv_y, me_num: int):
        mv_params = self.mv_hyper_prior_decoder[me_num](mv_z_hat)
        if ref_mv_y is None:
            mv_params = self.mv_y_prior_fusion_adaptor_0[me_num](mv_params)
        else:
            mv_params = self.mv_y_prior_fusion_adaptor_1[me_num](
                torch.cat([mv_params, ref_mv_y], dim=1))
        # f32 head: the quant step, scales and means are split from it
        return net_boundary(self.mv_y_prior_fusion[me_num](mv_params))

    def _adaptors(self, me_num: int):
        return [getattr(self, f"mv_y_spatial_prior_adaptor_{k}")[me_num]
                for k in (1, 2, 3)]

    # ---- motion ----------------------------------------------------------

    @policy_scope
    def compute_and_code_motion(self, ref_frame, cur_frame, q_index, dpb,
                                stage_idx: int = 0, me_downsample: int = 1,
                                training: bool = False, noise=None,
                                per_sample: bool = False):
        """Estimate, encode and decode motion.

        Estimate path: hard rounding, the bits of the batch summed (with
        ``per_sample``, each sample's, shape (B,)). With ``training``:
        straight-through rounding and the batch's mean of each sample's
        bits per pixel; ``noise`` = (n_y, n_z), uniform noise shaped as
        ``mv_noise_shapes`` gives, which then replaces the rounding in the
        two rate terms (no gradient flows into it)."""
        me_num = self.me_index(stage_idx)
        mv_y, mv_z = self._mv_latents(ref_frame, cur_frame, dpb, me_num,
                                      q_index, me_downsample)
        mv_z_hat = quant_ste(mv_z, training)
        mv_params = self.mv_prior_param_decoder(mv_z_hat, dpb, me_num)
        mv_y_res, mv_y_q, mv_y_hat, mv_scales_hat = four_part_prior_forward(
            mv_y, mv_params, self._adaptors(me_num),
            self.mv_y_spatial_prior[me_num], training=training)
        mv_hat, mv_feature = self.mv_decode_tail(mv_y_hat, me_num, q_index,
                                                 me_downsample)

        if training and noise is not None:
            mv_y_for_bit = add_uniform_noise(mv_y_res, noise[0])
            mv_z_for_bit = add_uniform_noise(mv_z, noise[1])
        else:
            mv_y_for_bit, mv_z_for_bit = mv_y_q, mv_z_hat
        bits_mv_y = laplace_bits(mv_y_for_bit, mv_scales_hat).sum(dim=(1, 2, 3))
        bits_mv_z = self.mv_bit_est[me_num].get_z_bits(mv_z_for_bit).sum(dim=(1, 2, 3))
        if halo.current() is not None:
            bits_mv_y, bits_mv_z = halo.sum_over_width(torch.stack([bits_mv_y, bits_mv_z]))
        pixel_num = ref_frame.shape[2] * halo.global_width(ref_frame)
        bpp_mv_y = bits_mv_y / pixel_num
        bpp_mv_z = bits_mv_z / pixel_num
        if training:
            bpp_mv_y, bpp_mv_z = bpp_mv_y.mean(), bpp_mv_z.mean()
        elif not per_sample:
            bpp_mv_y, bpp_mv_z = bpp_mv_y.sum(), bpp_mv_z.sum()
        ref_mv = {"mv_feature": mv_feature, "mv_y_hat": mv_y_hat}
        return mv_hat, ref_mv, bpp_mv_y, bpp_mv_z

    def mv_noise_shapes(self, batch: int, h: int, w: int):
        """Shapes of the training noise (n_y, n_z) for a (batch, 1, h, w)
        pair: the MV latent is h, w halved four times (rounding up), its
        hyper-latent two times more."""
        def down(n, times):
            for _ in range(times):
                n = (n + 1) // 2
            return n
        return ((batch, self.channel_mv, down(h, 4), down(w, 4)),
                (batch, self.channel_n, down(h, 6), down(w, 6)))

    def _mv_latents(self, ref_y, cur_y, dpb, me_num: int, q_index,
                    me_downsample: int = 1):
        """(mv_y, mv_z): the MV latent and its hyper-latent, unrounded."""
        mv_y_q_enc, _ = self.get_mv_y_q(q_index, me_num)
        mv_cur = cur_y / self.dynamic_range
        mv_ref = ref_y / self.dynamic_range
        if me_downsample > 1:
            if halo.current() is not None:
                raise ValueError("a spatial shard codes motion at full resolution: "
                                 "me_downsample 1")
            mv_cur = bilinear_downsample(mv_cur, me_downsample)
            mv_ref = bilinear_downsample(mv_ref, me_downsample)
        est_mv = self.optic_flow(mv_cur, mv_ref)

        def encode(flow, feature):
            mv_y = self.mv_encoder[me_num](flow, feature, mv_y_q_enc)
            return mv_y, self.mv_hyper_prior_encoder[me_num](mv_y)
        return halo.halo_call(encode, est_mv, dpb.get("mv_feature"), r=MV_ENC_HALO,
                              align=MV_ALIGN)

    # ---- sub-graphs of the bitstream codec -------------------------------

    @policy_scope
    def mv_latent_planes(self, ref_y, cur_y, dpb, stage_idx: int, q_index,
                         me_downsample: int = 1):
        """(mv_y, mv_z_hat): the latents only the encoder computes."""
        mv_y, mv_z = self._mv_latents(ref_y, cur_y, dpb,
                                      self.me_index(stage_idx), q_index,
                                      me_downsample)
        return mv_y, torch.round(mv_z)

    @policy_scope
    def mv_prior_params(self, mv_z_hat, dpb, stage_idx: int):
        return self.mv_prior_param_decoder(mv_z_hat, dpb, self.me_index(stage_idx))

    @staticmethod
    def mv_decode_split(mv_params):
        """(q_dec, scales quarters, means quarters) of the first pass."""
        _, q_dec, scales, means = separate_prior_enc_dec(mv_params)
        return q_dec, scales.chunk(4, dim=1), means.chunk(4, dim=1)

    @policy_scope
    def mv_decode_spatial(self, y_hat_so_far, mv_params, stage_idx: int,
                          step: int):
        """(scales quarters, means quarters) of pass `step + 1`."""
        me_num = self.me_index(stage_idx)
        inp = torch.cat([y_hat_so_far, mv_params], dim=1)
        out = self.mv_y_spatial_prior[me_num](self._adaptors(me_num)[step](inp))
        chunks = net_boundary(out).chunk(8, dim=1)
        return chunks[:4], chunks[4:]

    @policy_scope
    def mv_decode_tail(self, mv_y_hat, stage_idx: int, q_index,
                       me_downsample: int = 1):
        """(mv_hat, mv_feature) from the decoded MV latent."""
        me_num = self.me_index(stage_idx)
        _, mv_y_q_dec = self.get_mv_y_q(q_index, me_num)
        mv_hat, mv_feature = halo.halo_call(
            lambda y: self.mv_decoder[me_num](y, mv_y_q_dec), mv_y_hat, r=MV_DEC_HALO)
        if me_downsample > 1:
            mv_hat = bilinear_upsample(mv_hat, me_downsample) * me_downsample
        return mv_hat, mv_feature

    def mv_z_cdf_fn(self, x, stage_idx: int):
        """The MV hyper-latent's factorized CDF (for table building)."""
        return self.mv_bit_est[self.me_index(stage_idx)].get_cdf(x)

    # ---- temporal lifting ------------------------------------------------

    @staticmethod
    def _tile_mv(mv_hat, batch):
        if batch > mv_hat.shape[0]:
            mv_hat = mv_hat.repeat(batch // mv_hat.shape[0], 1, 1, 1)
        return mv_hat

    def _warp(self, x, mv):
        if self.warp_mode == "fast":
            return flow_warp_fast(x, mv, self.warp_max_disp)
        return flow_warp(x, mv)

    @policy_scope
    def forward_mctf(self, ref_frame, cur_frame, mv_hat, stage_idx: int = 0):
        """H_t = cur - P(warp(ref, mv)); L_t = ref + U(warp(H_t, -mv))."""
        tf = self.temporal_filtering[self.me_index(stage_idx)]
        mv_hat = self._tile_mv(mv_hat, ref_frame.shape[0])
        pred = self._warp(ref_frame, mv_hat)
        if not self.lossy:
            pred = ste_round(pred)
        pred = tf.predict_filter(pred)
        h_t = cur_frame - pred
        inv_pred = self._warp(h_t, -mv_hat)
        if not self.lossy:
            inv_pred = ste_round(inv_pred)
        inv_pred = tf.update_filter(inv_pred)
        l_t = ref_frame + inv_pred
        return l_t, h_t, pred, inv_pred

    @policy_scope
    def inverse_mctf(self, l_t, h_t, mv_hat, stage_idx: int = 0,
                     downscale: bool = False):
        """Inverse temporal lifting; `downscale` halves the MVs for chroma."""
        tf = self.temporal_filtering[self.me_index(stage_idx)]
        if downscale:
            mv_hat = _halve_mv(mv_hat)
        mv_hat = self._tile_mv(mv_hat, l_t.shape[0])
        inv_pred = self._warp(h_t, -mv_hat)
        if not self.lossy:
            inv_pred = ste_round(inv_pred)
        ref_frame = l_t - tf.update_filter(inv_pred)
        pred = self._warp(ref_frame, mv_hat)
        if not self.lossy:
            pred = ste_round(pred)
        cur_frame = h_t + tf.predict_filter(pred)
        return ref_frame, cur_frame

    # ---- one temporal stage ----------------------------------------------

    @policy_scope
    def forward_one_stage(self, ref_frame, cur_frame, q_index, code_lt: bool,
                          dpb, mv_hat=None, stage_idx: int = 0,
                          me_downsample: int = 1, training: bool = False,
                          noise=None, per_sample: bool = False):
        """Code one temporal decomposition pair: the estimate path, or
        with ``training`` (and optionally the MV rate terms' ``noise``,
        see compute_and_code_motion) one pair of the training step.

        With `mv_hat` (the luma MVs) this is the chroma pass: the MVs are
        halved and no motion is coded. With ``per_sample`` (the q-batched
        estimate path) `q_index` may be a (B,) tensor, one q a sample, and
        every rate comes back per sample, shape (B,)."""
        if torch.is_tensor(q_index) and q_index.dim() == 1:
            q_index = q_index.view(-1, 1, 1, 1)  # broadcasts over (B, C, H, W)
        halo.check_columns(ref_frame, self.spatial_align() // (1 if mv_hat is None else 2),
                           "a pMCTF stage")
        if mv_hat is not None:
            bpp_mv_y = bpp_mv_z = None
            ref_mv = {"mv_feature": None, "mv_y_hat": None}
            mv_hat = _halve_mv(mv_hat)
        else:
            mv_hat, ref_mv, bpp_mv_y, bpp_mv_z = self.compute_and_code_motion(
                ref_frame, cur_frame, q_index, dpb, stage_idx, me_downsample,
                training, noise, per_sample)

        l_t, h_t, pred, inv_pred = self.forward_mctf(
            ref_frame, cur_frame, mv_hat, stage_idx)
        res_h = self.hp_coder(h_t, q_index,
                              qp_scale=self.hp_qp_scale(q_index, stage_idx),
                              training=training)
        has_mv_bits = bpp_mv_y is not None
        pixels = ref_frame.shape[2] * halo.global_width(ref_frame)
        bit_h = res_h["bits"] if per_sample else res_h["bits_total"]
        bpp_h = bit_h / pixels if per_sample else res_h["bpp_total"]
        ret = {
            "bpp_mv_y": bpp_mv_y,
            "bpp_mv_z": bpp_mv_z,
            "bpp_me": bpp_mv_y + bpp_mv_z if has_mv_bits else None,
            "me_mse": halo.mean_over_width((pred - cur_frame) ** 2),
            "bpp": bpp_h + bpp_mv_y + bpp_mv_z if has_mv_bits else bpp_h,
            "bpp_H": bpp_h,
            "bit_H": bit_h,
            "bit_ME": (bpp_mv_y + bpp_mv_z) * pixels if has_mv_bits else None,
            "mse_H": res_h["mse"],
            "mv_hat": mv_hat,
            "dpb": {"mv_feature": ref_mv["mv_feature"],
                    "ref_mv_y": ref_mv["mv_y_hat"]},
            "H_t": res_h["x_hat"],
        }
        if code_lt:
            res_l = self.lp_coder(l_t, q_index, training=training)
            ret["bit_L"] = res_l["bits"] if per_sample else res_l["bits_total"]
            ret["bpp_L"] = (ret["bit_L"] / pixels if per_sample
                            else res_l["bpp_total"])
            ret["mse_L"] = res_l["mse"]
            ret["me_mse_inv"] = halo.mean_over_width((inv_pred - ref_frame) ** 2)
            ret["L_t"] = res_l["x_hat"]
        else:
            ret["L_t"] = l_t
        ret["bit"] = ret["bpp"] * pixels
        return ret


def build_pmctf(device="cuda", seed: int = 0, **config) -> PMCTF:
    """Construct a PMCTF with weights drawn from torch.Generator(seed), in
    eval mode on `device`. CUDA unless the caller asks for the CPU; TF32
    is turned off for the process."""
    dev = resolve_device(device)
    disable_tf32()
    model = PMCTF(**config)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
