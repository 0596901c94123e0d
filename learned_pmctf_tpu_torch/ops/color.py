"""Colour-space and chroma-format conversions (torch, NCHW or CHW).

Counterpart of learned_pmctf_tpu/ops/color.py: the JPEG-flavour
full-range YCbCr pair and the 4:2:0 <-> 4:4:4 chroma conversions the eval
metrics use.
"""

import torch
import torch.nn.functional as F


def rgb_to_ycbcr(rgb, bitdepth: int = 8):
    """JPEG-flavour RGB->YCbCr, full range. Input (..., 3, H, W)."""
    delta = 128.0 if bitdepth == 8 else 32768.0
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) * 0.564 + delta
    cr = (r - y) * 0.713 + delta
    return torch.stack([y, cb, cr], dim=-3)


def ycbcr_to_rgb(ycbcr, bitdepth: int = 8):
    """JPEG-flavour YCbCr->RGB. Input (..., 3, H, W)."""
    delta = 128.0 if bitdepth == 8 else 32768.0
    y = ycbcr[..., 0, :, :]
    cb = ycbcr[..., 1, :, :] - delta
    cr = ycbcr[..., 2, :, :] - delta
    r = y + 1.403 * cr
    g = y - 0.714 * cr - 0.344 * cb
    b = y + 1.773 * cb
    return torch.stack([r, g, b], dim=-3)


def yuv420_to_444(y, u, v, mode: str = "linear"):
    """Upsample chroma 2x and concatenate. y (B,1,H,W); u,v (B,1,H/2,W/2).

    "linear" is bilinear with align_corners=False (half-pixel centres,
    edge samples clamped); "nearest" replicates each sample 2x2."""
    size = tuple(y.shape[2:])
    if mode == "linear":
        up = lambda c: F.interpolate(c, size=size, mode="bilinear",  # noqa: E731
                                     align_corners=False)
    elif mode == "nearest":
        up = lambda c: c.repeat_interleave(2, 2).repeat_interleave(2, 3)  # noqa: E731
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return torch.cat([y, up(u), up(v)], dim=1)


def yuv444_to_420(ycbcr):
    """4:4:4 -> 4:2:0: average each 2x2 chroma block and round (half to
    even). Input (..., 3, H, W) with even H, W; returns (y, cb, cr) with
    chroma at half resolution."""
    y = ycbcr[..., 0:1, :, :]
    c = ycbcr[..., 1:3, :, :].float()
    c = (c[..., 0::2, 0::2] + c[..., 1::2, 0::2]
         + c[..., 0::2, 1::2] + c[..., 1::2, 1::2]) / 4.0
    c = torch.round(c)
    return y, c[..., 0:1, :, :], c[..., 1:2, :, :]
