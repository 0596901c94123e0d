"""Bilinear backward warp (motion compensation) on NCHW tensors.

Counterpart of learned_pmctf_tpu/ops/warp.py: ``flow_warp`` samples at
(x + flow_x, y + flow_y) with coordinates clamped to the image, which is
``grid_sample`` with border padding and align_corners=True;
``flow_warp_fast`` is the JAX package's separable warp (an opt-in,
``PMCTF(warp_mode="fast")``).

Under a spatial shard (parallel/halo.py) both warp this rank's block of
output columns at the frame's coordinates: the exact warp has no bound,
so it samples the reference gathered at full width, normalised by the
frame's width; the fast warp clamps its displacement to max_disp, so it
takes a halo of max_disp + 1 columns (the column after the last it
reads) and clamps at the frame's edges.
"""

import torch
import torch.nn.functional as F

from ..parallel import halo


def flow_warp(feature, flow):
    """Warp `feature` (B,C,H,W) backward by `flow` (B,2,H,W) in pixels.

    flow[:, 0] is the horizontal displacement, flow[:, 1] the vertical."""
    b, _, h, w = feature.shape
    first = 0
    if halo.current() is not None:
        first = halo.current().index * w
        feature = halo.gather_width(feature)
    col = torch.arange(first, first + w, dtype=flow.dtype, device=flow.device)
    row = torch.arange(h, dtype=flow.dtype, device=flow.device)
    full = feature.shape[3]
    gx = (col.view(1, 1, w) + flow[:, 0]) / ((full - 1) / 2.0) - 1.0
    gy = (row.view(1, h, 1) + flow[:, 1]) / ((h - 1) / 2.0) - 1.0
    grid = torch.stack([gx, gy], dim=3)
    return F.grid_sample(feature, grid, mode="bilinear",
                         padding_mode="border", align_corners=True)


def _clip(x, lo: float, hi: float):
    """jnp.clip with its gradient: half of it at a bound that x equals
    (torch.clamp passes all of it), as where the zero flow puts the first
    and last columns exactly on the border."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def flow_warp_fast(feature, flow, max_disp: int = 64):
    """The JAX package's separable warp, with the same numbers.

    Displacements are clamped to +-max_disp, and the warp is separable:
    the two source rows are picked per output position and blended by the
    vertical fraction first; then, within that blended row, the two
    source columns are picked per output position and blended by the
    horizontal fraction. So the value read at column x0 was blended with
    the vertical fraction of output column x0, not of the output's own
    column: exact where flow_y is horizontally smooth. The TPU version
    selects among 2 (2 max_disp + 1) shifted copies to avoid gathers;
    here each pick is one ``gather`` (its gradient a scatter-add, as the
    selects' is)."""
    sh, w = halo.current(), feature.shape[3]
    if sh is None:
        return _flow_warp_fast(feature, flow, max_disp, 0, w)
    # the widened block starts r columns before this rank's (none at the
    # frame's left edge)
    r, first = max_disp + 1, sh.index * w
    return halo.halo_call(
        lambda f, fl: _flow_warp_fast(f, fl, max_disp, first - min(r, first), sh.size * w),
        feature, flow, r=r)


def _flow_warp_fast(feature, flow, max_disp, first, width):
    """flow_warp_fast on the columns first, first + 1, ... of a frame
    `width` wide."""
    b, c, h, w = feature.shape
    d = float(max_disp)
    fx = _clip(flow[:, 0:1], -d, d)
    fy = _clip(flow[:, 1:2], -d, d)
    col = torch.arange(first, first + w, dtype=fx.dtype, device=fx.device).view(1, 1, 1, w)
    row = torch.arange(h, dtype=fy.dtype, device=fy.device).view(1, 1, h, 1)
    px = _clip(col + fx, 0.0, width - 1.0)
    py = _clip(row + fy, 0.0, h - 1.0)
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()
    if first:
        x0 = x0 - first

    def rows(r):
        return torch.gather(feature, 2, r.clamp(max=h - 1).expand(b, c, h, w))

    v0 = rows(y0)
    v = v0 + (rows(y0 + 1) - v0) * wy

    def cols(q):
        return torch.gather(v, 3, q.clamp(0, w - 1).expand(b, c, h, w))

    h0 = cols(x0)
    return h0 + (cols(x0 + 1) - h0) * wx
