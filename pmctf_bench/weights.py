"""The weights of a run, made from its seed on the device.

The benchmark draws them itself and hands the same state dict to the
port and to the reference, so that neither side takes a number the other
made. The rule is the port's own initialisation, written out here:
convolution weights from a normal of std 0.02 cut at two std (flax's
``truncated_normal``), zero biases, the CDF 9/7 taps of the lifting skip
convs, the bit estimators' parameters from a normal of std 0.01, and the
gains and quantiser scales at their initial constants. The drawn leaves
come from two calls on one ``torch.Generator`` on the device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import CDF97, Conv2d, _TRUNC_STD

_CONSTANTS = {"QP": 1.0 / 16.0, "QP_ll": 1.0 / 16.0, "scale_l": CDF97[5],
              "scale_h": CDF97[4], "scale_p": 1.0 / math.sqrt(2.0), "scale_u": 0.5}
_UNIT = ("mv_y_q_scale_enc.", "mv_y_q_scale_dec.", "hp_q_scale.")


def make_state(ref_model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of `ref_model`'s parameters (a reference model,
    possibly on the meta device), drawn from `seed` on `device`."""
    taps = {f"{n}.weight": m.init_taps for n, m in ref_model.named_modules()
            if isinstance(m, Conv2d) and m.init_taps is not None}
    convs, bitparms, state = [], [], {}
    for name, p in ref_model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in taps:
            state[name] = torch.tensor(taps[name], dtype=torch.float32,
                                       device=device).reshape(p.shape)
        elif leaf == "weight" and p.dim() == 4:
            convs.append((name, p.shape))
        elif ".mv_bit_est." in f".{name}" and leaf in ("h", "b", "a"):
            bitparms.append((name, p.shape))
        elif leaf == "bias":
            state[name] = torch.zeros(p.shape, device=device)
        elif leaf in _CONSTANTS:
            state[name] = torch.full(p.shape, _CONSTANTS[leaf], device=device)
        elif name.startswith(_UNIT):
            state[name] = torch.ones(p.shape, device=device)
        else:
            raise ValueError(f"no rule draws parameter {name}")
    g = torch.Generator(device=device).manual_seed(seed)
    std = 0.02 / _TRUNC_STD
    state.update(_split(torch.nn.init.trunc_normal_(
        torch.empty(sum(s.numel() for _, s in convs), device=device),
        0.0, std, -2 * std, 2 * std, generator=g), convs))
    state.update(_split(torch.empty(sum(s.numel() for _, s in bitparms), device=device)
                        .normal_(0.0, 0.01, generator=g), bitparms))
    return state


def _split(flat, shapes):
    out, off = {}, 0
    for name, shape in shapes:
        out[name] = flat[off:off + shape.numel()].view(shape)
        off += shape.numel()
    return out
