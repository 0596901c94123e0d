"""Checkerboard masks of the four-step priors and the causal masks of the
AR LL model's masked convs.

Counterpart of learned_pmctf_tpu/ops/masks.py (checkerboard_masks,
causal_conv_mask).
"""

import torch

# 2x2 phases in the order of the reference micro-masks mask_0..mask_3
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


def checkerboard_masks(height: int, width: int, dtype=torch.float32,
                       device=None):
    """The four 2x2-phase masks as (1,1,H,W) tensors."""
    masks = []
    for my, mx in PHASES:
        m = torch.zeros((1, 1, height, width), dtype=dtype, device=device)
        m[..., my::2, mx::2] = 1.0
        masks.append(m)
    return tuple(masks)


def causal_conv_mask(kh: int, kw: int, mask_type: str, out_ch: int,
                     in_ch: int) -> torch.Tensor:
    """PixelCNN mask for an OIHW kernel: "A" zeroes the centre tap and
    every tap after it in raster order, "B" keeps the centre, "C" keeps
    only the rows above the centre."""
    if mask_type not in ("A", "B", "C"):
        raise ValueError(f"invalid mask_type {mask_type!r}")
    m = torch.ones((out_ch, in_ch, kh, kw), dtype=torch.float32)
    if mask_type == "C":
        m[:, :, kh // 2:, :] = 0.0
    else:
        m[:, :, kh // 2, kw // 2 + (mask_type == "B"):] = 0.0
        m[:, :, kh // 2 + 1:, :] = 0.0
    return m
