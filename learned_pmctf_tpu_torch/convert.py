"""Weights from outside the port: the JAX package's params and the
reference model's torch checkpoints.

``params_from_jax`` takes the JAX ``PMCTF`` parameters as a nested dict of
numpy arrays (the flax tree, with or without its top-level "params") and
returns a state dict for the port's ``PMCTF`` that
``load_state_dict(strict=True)`` accepts. The port's names are the
reference torch model's state_dict keys, so this map is the inverse of
the JAX package's reference-checkpoint converter (flax names on the
left, reference names on the right). Every JAX leaf must be consumed;
anything left over raises. The AR LL model's ``mask`` buffers, which
flax does not keep, are made from ``causal_conv_mask``.

``load_reference_state_dict`` loads a reference checkpoint (or a state
dict the port saved) into a port ``PMCTF``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .ops.masks import causal_conv_mask


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = np.asarray(v, np.float32)
    return flat


class _Bridge:
    """JAX flat tree -> torch state dict, recording consumed leaves."""

    def __init__(self, flat: Dict[str, np.ndarray]):
        self.flat = flat
        self.used = set()
        self.out: Dict[str, torch.Tensor] = {}
        self.source: Dict[str, str] = {}  # port key -> JAX path

    def has(self, j: str) -> bool:
        return j in self.flat

    def leaf(self, j: str, t: str, index=None):
        v = self.flat[j]
        self.used.add(j)
        self.source[t] = j
        if index is not None:
            v = v[index]
        self.out[t] = torch.from_numpy(np.array(v, np.float32, order="C"))

    def conv(self, j: str, t: str):
        self.leaf(f"{j}/kernel", f"{t}.weight")
        if self.has(f"{j}/bias"):
            self.leaf(f"{j}/bias", f"{t}.bias")

    def resblock(self, j, t):
        self.conv(f"{j}/conv1", f"{t}.conv1")
        self.conv(f"{j}/conv2", f"{t}.conv2")

    def pu(self, j, t):
        for k in range(1, 5):
            self.conv(f"{j}/conv{k}", f"{t}.conv{k}")

    def depthconv(self, j, t):
        self.conv(f"{j}/conv1", f"{t}.conv1.0")
        self.conv(f"{j}/depth_conv", f"{t}.depth_conv")
        self.conv(f"{j}/conv2", f"{t}.conv2")
        if self.has(f"{j}/adaptor/kernel"):
            self.conv(f"{j}/adaptor", f"{t}.adaptor")

    def dcb(self, j, t):
        self.depthconv(f"{j}/depth", f"{t}.block.0")
        self.conv(f"{j}/ffn/up", f"{t}.block.1.conv.0")
        self.conv(f"{j}/ffn/down", f"{t}.block.1.conv.2")

    def dcb4(self, j, t):
        self.depthconv(f"{j}/depth", f"{t}.block.0")
        self.conv(f"{j}/ffn/conv", f"{t}.block.1.conv")
        self.conv(f"{j}/ffn/conv_out", f"{t}.block.1.conv_out")

    def rbws(self, j, t):
        self.conv(f"{j}/conv1", f"{t}.conv1")
        self.conv(f"{j}/conv2", f"{t}.conv2")
        if self.has(f"{j}/downsample/kernel"):
            self.conv(f"{j}/downsample", f"{t}.downsample")

    def rbus(self, j, t):
        self.conv(f"{j}/subpel/Conv2d_0", f"{t}.subpel_conv.0")
        self.conv(f"{j}/conv", f"{t}.conv")
        self.conv(f"{j}/upsample/Conv2d_0", f"{t}.upsample.0")

    def masked_conv(self, j, t, mask_type):
        self.conv(j, t)
        o, i, kh, kw = self.out[f"{t}.weight"].shape
        self.out[f"{t}.mask"] = causal_conv_mask(kh, kw, mask_type, o, i)

    def ar_fusion(self, j, t):
        """ContextFusionSubband: an A-masked conv, two MaskResiduals and a
        B-masked conv, then three 1x1 convs."""
        self.masked_conv(f"{j}/masked_conv1", f"{t}.maskedConv1", "A")
        for i in range(2):
            for k in (1, 2):
                self.masked_conv(f"{j}/res_blocks_{i}/conv{k}",
                                 f"{t}.residualBlocks.{i}.conv{k}", "B")
        self.masked_conv(f"{j}/masked_conv2", f"{t}.maskedConv2", "B")
        for i in range(3):
            self.conv(f"{j}/head_{i}", f"{t}.convs.{i}")

    def fourstep(self, j, t):
        if self.has(f"{j}/conv1_context/kernel"):
            self.conv(f"{j}/conv1_context", f"{t}.conv1_context")
            for i in range(2):
                self.resblock(f"{j}/hier_enc_{i}", f"{t}.y_hierarchical_prior_enc.{i}")
        if self.has(f"{j}/lower_conv/kernel"):
            self.conv(f"{j}/lower_conv", f"{t}.lower_level_subband.1")
        self.dcb(f"{j}/hier_out", f"{t}.y_hierarchical_prior_out")
        for k in (1, 2, 3):
            si, so = f"{j}/spatial_in_{k - 1}", f"{j}/spatial_out_{k - 1}"
            self.conv(f"{si}/layers_0", f"{t}.y_spatial_prior_{k}.0")
            self.resblock(f"{si}/layers_1", f"{t}.y_spatial_prior_{k}.1")
            self.resblock(f"{so}/layers_0", f"{t}.y_spatial_prior_{k}_out.0")
            self.resblock(f"{so}/layers_1", f"{t}.y_spatial_prior_{k}_out.1")
            self.conv(f"{so}/layers_2", f"{t}.y_spatial_prior_{k}_out.2")

    def pwave(self, j, t):
        self.leaf(f"{j}/QP", f"{t}.QP")
        self.leaf(f"{j}/QP_ll", f"{t}.QP_ll")
        lj, lt = f"{j}/wavelet/lift_h", f"{t}.wavelet_transform.lift_h"
        for step in ("p1", "u1", "p2", "u2"):
            big = step[0].upper()
            self.conv(f"{lj}/conv_{step}", f"{lt}.conv_{big}{step[1]}")
            self.pu(f"{lj}/{step}", f"{lt}.{big}_{step[1]}")
        self.leaf(f"{lj}/scale_l", f"{lt}.scale_l")
        self.leaf(f"{lj}/scale_h", f"{lt}.scale_h")
        cj, ct = f"{j}/context_prediction", f"{t}.context_prediction"
        for k in (1, 2, 3):
            self.conv(f"{cj}/lstm{k}/conv_in", f"{ct}.LSTM{k}.conv_in")
            self.conv(f"{cj}/lstm{k}/conv_hidden", f"{ct}.LSTM{k}.conv_hidden")
        levels = sum(1 for p in self.flat
                     if re.fullmatch(rf"{re.escape(j)}/context_fusion_\d+_lh/"
                                     r"hier_out/depth/conv1/kernel", p))
        for k in (1, 2, 3):
            for kind in ("h", "c"):
                for i in range(levels - 1):
                    self.conv(f"{cj}/up_{kind}{k}_{i}/Conv2d_0",
                              f"{ct}.deconv_{kind}{k}.{i}.conv")
        dj, dt = f"{j}/dequant", f"{t}.dequantModule"
        for k in (1, 2, 3):
            self.conv(f"{dj}/conv{k}", f"{dt}.conv{k}")
        i = 0
        while self.has(f"{dj}/res{i}/conv1/kernel"):
            self.resblock(f"{dj}/res{i}", f"{dt}.resBlocks.{i}")
            i += 1
        for lvl in range(levels):
            for band in ("lh", "hl", "hh"):
                self.fourstep(f"{j}/context_fusion_{lvl}_{band}",
                              f"{t}.context_fusion.{lvl}.{band}")
        ll = (self.ar_fusion if self.has(f"{j}/context_fusion_ll/masked_conv1/kernel")
              else self.fourstep)
        ll(f"{j}/context_fusion_ll", f"{t}.context_fusion.{levels - 1}.ll")

    def spynet(self, j, t, module=None):
        lvl = 0
        while self.has(f"{j}/basic_{lvl}/conv1/kernel"):
            for k in range(1, 6):
                self.conv(f"{j}/basic_{lvl}/conv{k}", f"{t}.moduleBasic.{lvl}.conv{k}")
            lvl += 1

    def pmctf(self):
        self.pwave("lp_coder", "lp_coder")
        self.pwave("hp_coder", "hp_coder")
        stages = self.flat["hp_q_scale"].shape[0]
        for name in ("hp_q_scale", "mv_y_q_scale_enc", "mv_y_q_scale_dec"):
            for i in range(stages):
                self.leaf(name, f"{name}.{i}", index=i)
        self.spynet("optic_flow", "optic_flow")
        for i in range(stages):
            e, te = f"mv_encoder_{i}", f"mv_encoder.{i}"
            self.rbws(f"{e}/enc_1/layers_0", f"{te}.enc_1.0")
            self.dcb(f"{e}/enc_1/layers_1", f"{te}.enc_1.1")
            self.rbws(f"{e}/enc_2", f"{te}.enc_2")
            self.dcb(f"{e}/adaptor_0", f"{te}.adaptor_0")
            self.dcb(f"{e}/adaptor_1", f"{te}.adaptor_1")
            self.rbws(f"{e}/enc_3_a", f"{te}.enc_3.0")
            self.dcb(f"{e}/enc_3_b", f"{te}.enc_3.1")
            self.conv(f"{e}/enc_3_c", f"{te}.enc_3.2")

            d, td = f"mv_decoder_{i}", f"mv_decoder.{i}"
            for k, kind in enumerate("dbdbd"):
                sub = (self.dcb if kind == "d" else self.rbus)
                sub(f"{d}/dec_1/layers_{k}", f"{td}.dec_1.{k}")
            self.rbus(f"{d}/dec_2", f"{td}.dec_2")
            self.dcb(f"{d}/dec_3/layers_0", f"{td}.dec_3.0")
            self.conv(f"{d}/dec_3/layers_1/Conv2d_0", f"{td}.dec_3.1.0")

            he, the = f"mv_hyper_enc_{i}", f"mv_hyper_prior_encoder.{i}"
            self.dcb4(f"{he}/DepthConvBlock4_0", f"{the}.0")
            self.conv(f"{he}/Conv2d_0", f"{the}.1")
            self.conv(f"{he}/Conv2d_1", f"{the}.3")
            hd, thd = f"mv_hyper_dec_{i}", f"mv_hyper_prior_decoder.{i}"
            self.rbus(f"{hd}/ResidualBlockUpsample_0", f"{thd}.0")
            self.rbus(f"{hd}/ResidualBlockUpsample_1", f"{thd}.1")
            self.dcb4(f"{hd}/DepthConvBlock4_0", f"{thd}.2")

            for a in (0, 1):
                self.dcb(f"mv_prior_fusion_adaptor_{a}_{i}",
                         f"mv_y_prior_fusion_adaptor_{a}.{i}")
            for k in range(2):
                self.dcb(f"mv_prior_fusion_{i}/layers_{k}",
                         f"mv_y_prior_fusion.{i}.{k}")
            for k in range(3):
                self.dcb(f"mv_spatial_prior_{i}/layers_{k}",
                         f"mv_y_spatial_prior.{i}.{k}")
                self.conv(f"mv_spatial_adaptors_{i}_{k}",
                          f"mv_y_spatial_prior_adaptor_{k + 1}.{i}")
            for k in (1, 2, 3, 4):
                for p in ("h", "b", "a"):
                    if self.has(f"mv_bit_est_{i}/f{k}/{p}"):
                        self.leaf(f"mv_bit_est_{i}/f{k}/{p}",
                                  f"mv_bit_est.{i}.f{k}.{p}")
            tj, tt = f"temporal_filtering_{i}", f"temporal_filtering.{i}"
            self.pu(f"{tj}/p_t", f"{tt}.P_t")
            self.pu(f"{tj}/u_t", f"{tt}.U_t")
            self.leaf(f"{tj}/scale_p", f"{tt}.scale_p")
            self.leaf(f"{tj}/scale_u", f"{tt}.scale_u")


    # ---- the modules nothing builds (models/layers_extra.py,
    # PostProcessCtx): their port names are the flax names

    def dense(self, j, t):
        """flax Dense (kernel (in, out)) -> nn.Linear (weight (out, in))."""
        self.leaf(f"{j}/kernel", f"{t}.weight")
        self.out[f"{t}.weight"] = self.out[f"{t}.weight"].T.contiguous()
        self.leaf(f"{j}/bias", f"{t}.bias")

    def postprocess_ctx(self, j, t, module):
        self.conv(f"{j}/conv1", f"{t}.conv1")
        for i in range(len(module.resBlocks)):
            self.resblock(f"{j}/res{i}", f"{t}.resBlocks.{i}")
        self.conv(f"{j}/conv2", f"{t}.conv2")
        self.conv(f"{j}/conv3", f"{t}.conv3")

    def dynamic_dw(self, j, t, module):
        self.conv(f"{j}/reduce", f"{t}.reduce")
        self.leaf(f"{j}/norm/scale", f"{t}.norm.scale")
        self.leaf(f"{j}/norm/bias", f"{t}.norm.bias")
        self.conv(f"{j}/expand", f"{t}.expand")
        self.leaf(f"{j}/bias", f"{t}.bias")

    def conditional_conv(self, j, t, module):
        self.dense(f"{j}/fc_scaling", f"{t}.fc_scaling")
        self.dense(f"{j}/fc_bias", f"{t}.fc_bias")
        if module.mask_type:
            self.masked_conv(f"{j}/conv", f"{t}.conv", module.mask_type)
        else:
            self.conv(f"{j}/conv", f"{t}.conv")

    def conv3d(self, j, t, module):
        self.conv(j, t)
        if module.mask is not None:
            self.out[f"{t}.mask"] = module.mask.detach().cpu().clone()


def _bridged(tree: Mapping, kind: str = "pmctf", module=None) -> _Bridge:
    """Map a flax tree of `kind`: "pmctf", "pwave", or (with the port
    `module` to fill) one of the modules nothing builds."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    # a sub-module's tree goes through its map under one prefix
    flat = _flatten(tree if kind == "pmctf" else {"m": tree})
    bridge = _Bridge(flat)
    if kind == "pmctf":
        bridge.pmctf()
    elif kind == "pwave":
        bridge.pwave("m", "m")
    else:
        getattr(bridge, kind)("m", "m", module)
    unused = sorted(set(flat) - bridge.used)
    if unused:
        raise ValueError(f"{len(unused)} JAX leaves have no home in the port: "
                         f"{unused[:10]}")
    if kind != "pmctf":
        bridge.out = {k[len("m."):]: v for k, v in bridge.out.items()}
        bridge.source = {k[len("m."):]: v[len("m/"):]
                         for k, v in bridge.source.items()}
    return bridge


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX PMCTF params (nested dict of arrays) -> port PMCTF state dict."""
    return _bridged(tree).out


def pwave_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX PWave params -> port PWave state dict."""
    return _bridged(tree, "pwave").out


# port module class -> its map
_MODULE_KINDS = {"MESpynet": "spynet",
                 "PostProcessCtx": "postprocess_ctx",
                 "DynamicDWConv": "dynamic_dw",
                 "MaskedDynamicDWConv": "dynamic_dw",
                 "ConditionalConv": "conditional_conv",
                 "Conv3d": "conv3d"}


def module_params_from_jax(module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params of MESpynet (either mode), PostProcessCtx,
    DynamicDWConv, MaskedDynamicDWConv, ConditionalConv or Conv3d -> the
    state dict of the port's `module` of the same class (its mask buffers
    made by the port). The port's CompressionModel has no parameters."""
    kind = _MODULE_KINDS[type(module).__name__]
    return _bridged(tree, kind, module).out


def jax_paths(tree: Mapping, pwave: bool = False) -> Dict[str, str]:
    """Port state-dict key -> the '/'-joined JAX path it is read from (a
    per-ME-stage scale of the port reads one row of its JAX leaf). The
    buffers the port makes itself (AR masks) have none."""
    return _bridged(tree, "pwave" if pwave else "pmctf").source


# Parameters of the port that the reference model does not save: the
# lifting and temporal-filter gains are constants there (not registered
# parameters), so a reference checkpoint leaves the port's init values,
# which equal those constants.
NOT_IN_REFERENCE = ("scale_l", "scale_h", "scale_p", "scale_u")


def load_reference_state_dict(path_or_dict, model):
    """Load a reference pMCTF checkpoint into the port's PMCTF `model`.

    `path_or_dict` is a file that torch.load reads (loaded with
    weights_only=True) or the state dict itself. As the JAX package's
    loader does, it unwraps a "state_dict" and then a "net" entry and
    strips "module." prefixes; then it
    - sums SpyNet conv1's RGB slices of an 8-input kernel (image 0:3,
      warped image 3:6, flow 6:8) into the port's 4 luma inputs, as the
      JAX package's converter does;
    - checks that every ``.lift_v.`` key equals its ``lift_h`` twin (the
      column pass shares the row module) and drops it;
    - checks that every masked conv's ``mask`` is the causal mask the
      wavefront decoder relies on;
    - loads strictly: a key the port lacks raises, and so does a port key
      the checkpoint lacks, unless the reference never saves it
      (NOT_IN_REFERENCE).
    A state dict saved by the port itself (4-input conv1, the gains
    included) loads through the same function. Returns `model`."""
    sd = path_or_dict
    if not isinstance(sd, Mapping):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if "net" in sd:
        sd = sd["net"]
    sd = {(k[len("module."):] if k.startswith("module.") else k):
          torch.as_tensor(v).detach().cpu().float() for k, v in sd.items()}

    for k in [k for k in sd if ".lift_v." in k]:
        twin = k.replace(".lift_v.", ".lift_h.")
        if twin not in sd or not torch.equal(sd[twin], sd[k]):
            raise ValueError(f"{k} differs from {twin}: the port shares one "
                             "lifting module between rows and columns")
        del sd[k]
    for k, w in sd.items():
        if (re.fullmatch(r"optic_flow\.moduleBasic\.\d+\.conv1\.weight", k)
                and w.shape[1] == 8):
            sd[k] = torch.cat([w[:, 0:3].sum(1, keepdim=True),
                               w[:, 3:6].sum(1, keepdim=True), w[:, 6:8]], dim=1)

    own = model.state_dict()
    extra = sorted(set(sd) - set(own))
    missing = sorted(k for k in set(own) - set(sd)
                     if k.rsplit(".", 1)[-1] not in NOT_IN_REFERENCE)
    if extra or missing:
        raise ValueError(f"checkpoint does not fit the model: {len(extra)} "
                         f"keys the port lacks {extra[:10]}, {len(missing)} "
                         f"port keys missing {missing[:10]}")
    for k in sd:
        if k.endswith(".mask") and not torch.equal(sd[k], own[k].cpu()):
            raise ValueError(f"{k} is not the causal mask of the port's model")
    model.load_state_dict({**own, **sd}, strict=True)
    return model


def load_reference_spynet(path_or_dict, spynet):
    """Load a reference SpyNet checkpoint into the port's MESpynet
    `spynet` (the trainer's ``--spynet_path``), as the JAX package's
    ``load_spynet_torch(luma_mode=True)`` converts one: a "state_dict" or
    "net" entry unwrapped, "module." stripped, the sniklaus names
    ``moduleBasic.{L}.moduleBasic.{2j}.*`` mapped to ``conv{j+1}``, keys
    outside ``moduleBasic.{L}.conv{j}.*`` dropped, and, for a luma-mode
    `spynet`, an 8-input conv1's RGB slices summed to its 4 luma inputs
    (an RGB `spynet`, ``luma_mode=False``, takes them as they are, as
    ``load_spynet_torch(luma_mode=False)`` does). Loads strictly.
    Returns `spynet`."""
    sd = path_or_dict
    if not isinstance(sd, Mapping):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if "net" in sd:
        sd = sd["net"]
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        for j in range(5):
            k = k.replace(f".moduleBasic.{2 * j}.", f".conv{j + 1}.")
        parts = k.split(".")
        if len(parts) != 4 or parts[0] != "moduleBasic":
            continue
        w = torch.as_tensor(v).detach().cpu().float()
        if (parts[2] == "conv1" and parts[3] == "weight" and w.shape[1] == 8
                and spynet.luma_mode):
            w = torch.cat([w[:, 0:3].sum(1, keepdim=True),
                           w[:, 3:6].sum(1, keepdim=True), w[:, 6:8]], dim=1)
        out[k] = w
    spynet.load_state_dict(out, strict=True)
    return spynet
