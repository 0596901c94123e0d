"""SpyNet coarse-to-fine optical flow.

Counterpart of learned_pmctf_tpu/models/spynet.py. The codec's net runs
in luma mode (the default here; JAX's PMCTF builds it with
luma_mode=True): 1-channel planes, so conv1 takes 4 inputs (current,
warped reference, 2 flow channels), the reference's RGB slices summed.
``luma_mode=False`` is the RGB net (conv1 takes 8 inputs) that the
dataset's flow filter runs (cli/average_flow.py). ``fast_warp`` warps
inside the pyramid with the separable ``flow_warp_fast``, clamped to
+-``fast_warp_disp`` (PMCTF wires both to its ``warp_mode`` and
``warp_max_disp``).

Under a spatial shard (parallel/halo.py) the pyramid's pooling, its zero
flow at the coarsest level, the upsampling and a warp at every level all
reach across the width: each rank gathers the two planes at full width
(one exchange), runs the whole pyramid and keeps its own columns of the
flow, exact by construction. Halos a level are later work.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resample import avg_pool2, bilinear_upsample
from ..ops.warp import flow_warp, flow_warp_fast
from ..parallel import halo
from .layers import Conv2d, net_boundary


class MEBasic(nn.Module):
    """One pyramid level's flow refiner: in_ch (4 luma, 8 RGB) -> 32 -> 64
    -> 32 -> 16 -> 2, 7x7."""

    def __init__(self, in_ch: int = 4):
        super().__init__()
        self.conv1 = Conv2d(in_ch, 32, 7)
        self.conv2 = Conv2d(32, 64, 7)
        self.conv3 = Conv2d(64, 32, 7)
        self.conv4 = Conv2d(32, 16, 7)
        self.conv5 = Conv2d(16, 2, 7)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        return net_boundary(self.conv5(x))


class MESpynet(nn.Module):
    """Pyramid flow from im1 (current) to im2 (reference), both (B,1,H,W),
    or (B,3,H,W) RGB without luma_mode."""

    def __init__(self, levels: int = 6, fast_warp: bool = False,
                 fast_warp_disp: int = 32, luma_mode: bool = True):
        super().__init__()
        self.levels = levels
        self.fast_warp = fast_warp
        self.fast_warp_disp = fast_warp_disp
        self.luma_mode = luma_mode
        in_ch = 4 if luma_mode else 8
        self.moduleBasic = nn.ModuleList(MEBasic(in_ch) for _ in range(levels))

    def _warp(self, im, flow):
        if self.fast_warp:
            return flow_warp_fast(im, flow, self.fast_warp_disp)
        return flow_warp(im, flow)

    def forward(self, im1, im2):
        if halo.current() is None:
            return self._forward(im1, im2)
        both = halo.gather_width(torch.cat([im1, im2], dim=1))
        with halo.suspended():
            flow = self._forward(*both.chunk(2, dim=1))
        return halo.own_columns(flow)

    def _forward(self, im1, im2):
        im1_list, im2_list = [im1], [im2]
        for _ in range(self.levels - 1):
            im1_list.append(avg_pool2(im1_list[-1]))
            im2_list.append(avg_pool2(im2_list[-1]))
        b, _, h_c, w_c = im1_list[-1].shape
        flow = im1.new_zeros((b, 2, h_c // 2, w_c // 2))
        for level in range(self.levels):
            flow_up = bilinear_upsample(flow) * 2.0
            idx = self.levels - 1 - level
            inp = torch.cat([im1_list[idx], self._warp(im2_list[idx], flow_up),
                             flow_up], dim=1)
            flow = flow_up + self.moduleBasic[level](inp)
        return flow
