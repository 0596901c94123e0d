"""Colour-space and chroma-format conversions (torch, NCHW or CHW).

Counterpart of learned_pmctf_tpu/ops/color.py: the JPEG-flavour
full-range YCbCr pair and the 4:2:0 <-> 4:4:4 chroma conversions the eval
metrics use; the integer studio-range YCbCr pair (BT.601 and BT.709) and
the lossless YCoCg pair of the lossless configuration (int32 arithmetic
with arithmetic right shifts, the JAX package's numbers exactly).
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


# studio-range fixed-point matrices, 8 fractional bits: rows Y, Cb, Cr
_STUDIO_FWD = {601: ((66, 129, 25), (-38, -74, 112), (112, -94, -18)),
               709: ((47, 157, 16), (-26, -87, 112), (112, -102, -10))}
# rows R, G, B on (Y - 16, Cb - 128, Cr - 128)
_STUDIO_INV = {601: ((298, 0, 409), (298, -100, -208), (298, 516, 0)),
               709: ((298, 0, 459), (298, -55, -136), (298, 541, 0))}


def _studio(table, flavor: int):
    if flavor not in table:
        raise ValueError(f"unknown conversion flavor {flavor}")
    return table[flavor]


def rgb_to_ycbcr_studio(rgb, flavor: int = 709):
    """Integer studio-range RGB->YCbCr: an 8-bit fixed-point matrix,
    arithmetic >> 8, headroom clamps (Y <= 235, Cb/Cr <= 240, all >= 16).
    Input (..., 3, H, W) in [0, 255]; returns int32."""
    x = rgb.to(torch.int32)
    rgb3 = (x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :])
    out = []
    for (a, b, c), offset, top in zip(_studio(_STUDIO_FWD, flavor),
                                      (16, 128, 128), (235, 240, 240)):
        v = ((a * rgb3[0] + b * rgb3[1] + c * rgb3[2] + 128) >> 8) + offset
        out.append(torch.clamp(v, 16, top))
    return torch.stack(out, dim=-3)


def ycbcr_to_rgb_studio(ycbcr, flavor: int = 709):
    """Integer studio-range YCbCr->RGB (the inverse matrix, arithmetic
    >> 8, clamped to [0, 255]). Input (..., 3, H, W); returns int32."""
    x = ycbcr.to(torch.int32)
    cde = (x[..., 0, :, :] - 16, x[..., 1, :, :] - 128, x[..., 2, :, :] - 128)
    out = [(a * cde[0] + b * cde[1] + c * cde[2] + 128) >> 8
           for a, b, c in _studio(_STUDIO_INV, flavor)]
    return torch.clamp(torch.stack(out, dim=-3), 0, 255)


def rgb_to_ycocg_lossless(x):
    """Lossless RGB->YCoCg (integer lifting); float32 out."""
    x = x.to(torch.int32)
    r, g, b = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    co = r - b
    tmp = b + (co >> 1)
    cg = g - tmp
    y = tmp + (cg >> 1)
    return torch.stack([y, co, cg], dim=-3).to(torch.float32)


def ycocg_to_rgb_lossless(x):
    """Lossless YCoCg->RGB, the exact inverse; float32 out."""
    x = x.to(torch.int32)
    y, co, cg = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    tmp = y - (cg >> 1)
    g = cg + tmp
    b = tmp - (co >> 1)
    r = b + co
    return torch.stack([r, g, b], dim=-3).to(torch.float32)
