"""Learned wavelet transforms: spatial 2-D lifting and temporal lifting.

Counterpart of learned_pmctf_tpu/models/wavelet.py. The scale_l/scale_h
and scale_p/scale_u gains are registered parameters here, as they are
flax params there. The fixed-tap skip convs carry the full-magnitude
signal and are exempt from the bf16 activation policy (a bf16 ulp at
|x| ~ 255 is a whole pixel step); the learned P/U nets return f32.

Under a spatial shard (parallel/halo.py) each lifting step and each
temporal filter exchanges its halo once: the P/U net's four 3x3 convs
reach PU_RADIUS columns; the column pass (the rows of the transposed
plane, where the width is dim 2) adds the skip conv's tap and the
reflection it pads with, which a shard takes from its neighbours except
at a frame edge.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from ..ops.lifting import (CDF97_COEFFS, merge_even_odd, reflect_pad_rows,
                           split_even_odd)
from ..ops.quant import ste_round
from ..parallel import halo
from .layers import Conv2d, PredictUpdate

# columns a PredictUpdate net reaches: four 3x3 convs
PU_RADIUS = 4


def _skip_conv(in_ch: int, taps):
    """Depthwise 3x1 conv initialised to the wavelet taps."""
    w = [[[[t] for t in taps]]] * in_ch  # (C,1,3,1)
    return Conv2d(in_ch, in_ch, (3, 1), padding=0, groups=in_ch,
                  init_taps=tuple(map(tuple, w)), policy_exempt=True)


class LearnedLifting1D(nn.Module):
    """Prediction-first learned lifting along rows (iWave1D): four steps,
    each a 3x1 skip conv plus a 0.1-scaled learned CNN residual."""

    def __init__(self, in_ch: int = 1, bitdepth: int = 8, lossy: bool = True):
        super().__init__()
        c = CDF97_COEFFS
        self.lossy = lossy
        self.dynamic_range = float(2 ** bitdepth)
        self.conv_P1 = _skip_conv(in_ch, (0.0, c[0], c[0]))
        self.conv_U1 = _skip_conv(in_ch, (c[1], c[1], 0.0))
        self.conv_P2 = _skip_conv(in_ch, (0.0, c[2], c[2]))
        self.conv_U2 = _skip_conv(in_ch, (c[3], c[3], 0.0))
        self.P_1 = PredictUpdate(in_ch)
        self.U_1 = PredictUpdate(in_ch)
        self.P_2 = PredictUpdate(in_ch)
        self.U_2 = PredictUpdate(in_ch)
        self.scale_l = nn.Parameter(torch.tensor(c[5], dtype=torch.float32))
        self.scale_h = nn.Parameter(torch.tensor(c[4], dtype=torch.float32))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale_l.fill_(CDF97_COEFFS[5])
            self.scale_h.fill_(CDF97_COEFFS[4])

    def _increment_local(self, source, skip_conv, pu_net):
        skip_path = skip_conv(reflect_pad_rows(source))
        resid = pu_net(skip_path / self.dynamic_range) * self.dynamic_range
        inc = skip_path + resid * 0.1
        return inc if self.lossy else ste_round(inc)

    def _increment(self, source, skip_conv, pu_net, wdim: int = 3):
        """One lifting step's increment; `wdim` is the frame's width
        axis: 3 in the row pass, 2 in the column pass, where the skip
        conv's tap and its reflection also reach across the width."""
        return halo.halo_call(
            lambda s: self._increment_local(s, skip_conv, pu_net), source,
            r=PU_RADIUS + (wdim == 2), dim=wdim)

    def forward_lift(self, x, wdim: int = 3):
        x_e, x_o = split_even_odd(x)
        x_o = x_o + self._increment(x_e, self.conv_P1, self.P_1, wdim)
        x_e = x_e + self._increment(x_o, self.conv_U1, self.U_1, wdim)
        x_o = x_o + self._increment(x_e, self.conv_P2, self.P_2, wdim)
        x_e = x_e + self._increment(x_o, self.conv_U2, self.U_2, wdim)
        if self.lossy:
            x_e = x_e * self.scale_l
            x_o = x_o * self.scale_h
        return x_e, x_o  # (l, h)

    def backward_lift(self, l, h, wdim: int = 3):
        if self.lossy:
            l = l / self.scale_l
            h = h / self.scale_h
        l = l - self._increment(h, self.conv_U2, self.U_2, wdim)
        h = h - self._increment(l, self.conv_P2, self.P_2, wdim)
        l = l - self._increment(h, self.conv_U1, self.U_1, wdim)
        h = h - self._increment(l, self.conv_P1, self.P_1, wdim)
        return merge_even_odd(l, h)


class LiftingScheme2D(nn.Module):
    """Separable 2-D lifting: rows, then columns of both branches. The
    column pass shares the row module (`lift_v` is `lift_h`). Under a
    spatial shard the column pass splits the width into even and odd
    columns, so every rank's first column must be even at every level
    (PWave.spatial_align)."""

    def __init__(self, in_ch: int = 1, bitdepth: int = 8, lossy: bool = True):
        super().__init__()
        self.lift_h = LearnedLifting1D(in_ch, bitdepth, lossy)

    @property
    def lift_v(self):
        return self.lift_h

    def forward_lift_2d(self, x) -> Dict[str, torch.Tensor]:
        l, h = self.lift_h.forward_lift(x)
        ll, lh = self.lift_v.forward_lift(l.transpose(2, 3), wdim=2)
        hl, hh = self.lift_v.forward_lift(h.transpose(2, 3), wdim=2)
        return {"ll": ll.transpose(2, 3), "lh": lh.transpose(2, 3),
                "hl": hl.transpose(2, 3), "hh": hh.transpose(2, 3),
                "l": l, "h": h}

    def backward_lift_2d(self, subbands: Dict[str, torch.Tensor]):
        t = lambda k: subbands[k].transpose(2, 3)  # noqa: E731
        l = self.lift_v.backward_lift(t("ll"), t("lh"), wdim=2).transpose(2, 3)
        h = self.lift_v.backward_lift(t("hl"), t("hh"), wdim=2).transpose(2, 3)
        return self.lift_h.backward_lift(l, h)


class TemporalLifting(nn.Module):
    """Learned temporal predict/update filters of the MCTF, with scalar
    gains 1/sqrt(2) and 0.5."""

    def __init__(self, in_ch: int = 1, lossy: bool = True):
        super().__init__()
        self.lossy = lossy
        self.P_t = PredictUpdate(in_ch)
        self.U_t = PredictUpdate(in_ch)
        self.scale_p = nn.Parameter(torch.tensor(1.0 / math.sqrt(2.0)))
        self.scale_u = nn.Parameter(torch.tensor(0.5))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale_p.fill_(1.0 / math.sqrt(2.0))
            self.scale_u.fill_(0.5)

    def _filter(self, x, net, scale):
        tmp = halo.halo_call(net, x, r=PU_RADIUS) * 0.1
        if not self.lossy:
            tmp = ste_round(tmp)
        x = x + tmp
        return x * scale if self.lossy else x

    def predict_filter(self, x):
        return self._filter(x, self.P_t, self.scale_p)

    def update_filter(self, x):
        return self._filter(x, self.U_t, self.scale_u)
