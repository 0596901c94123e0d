"""Quality metrics: PSNR, YUV-weighted PSNR, MS-SSIM (torch).

Counterpart of learned_pmctf_tpu/utils/metrics.py: multi-scale SSIM of
Wang et al. with an 11-tap Gaussian window (sigma 1.5) applied as two
depthwise 1-D passes with no padding, 2x2 average pooling between
scales and the five standard scale weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def psnr(a, b, data_range: float = 255.0):
    mse = torch.mean((torch.as_tensor(a, dtype=torch.float32)
                      - torch.as_tensor(b, dtype=torch.float32)) ** 2)
    return 20.0 * math.log10(data_range) - 10.0 * torch.log10(mse)


def yuv_psnr(psnr_y, psnr_cb, psnr_cr):
    """YUV PSNR with 6-1-1 weighting."""
    return (6.0 * psnr_y + psnr_cb + psnr_cr) / 8.0


def _gaussian_window(size: int = 11, sigma: float = 1.5):
    g = torch.exp(-(torch.arange(size, dtype=torch.float64) - (size - 1) / 2.0)
                  ** 2 / (2 * sigma ** 2))
    return g / g.sum()


def _blur(x, win):
    """Separable Gaussian filter on (B,C,H,W), valid padding."""
    c = x.shape[1]
    kh = win.to(x).reshape(1, 1, -1, 1).repeat(c, 1, 1, 1)
    x = F.conv2d(x, kh, groups=c)
    return F.conv2d(x, kh.transpose(2, 3), groups=c)


def _ssim_per_scale(x, y, data_range: float, win):
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x = _blur(x, win)
    mu_y = _blur(y, win)
    sigma_x = _blur(x * x, win) - mu_x ** 2
    sigma_y = _blur(y * y, win) - mu_y ** 2
    sigma_xy = _blur(x * y, win) - mu_x * mu_y
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) * cs
    return ssim.mean(), cs.mean()


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(x, y, data_range: float = 255.0):
    """Multi-scale SSIM on (B,C,H,W); needs H, W > 160 for 5 scales."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    win = _gaussian_window()
    levels = len(_MSSSIM_WEIGHTS)
    vals = []
    for i in range(levels):
        ssim, cs = _ssim_per_scale(x, y, data_range, win)
        vals.append(ssim if i == levels - 1 else cs)
        if i < levels - 1:
            h2, w2 = x.shape[2] // 2 * 2, x.shape[3] // 2 * 2
            x = F.avg_pool2d(x[:, :, :h2, :w2], 2)
            y = F.avg_pool2d(y[:, :, :h2, :w2], 2)
    vals = torch.stack(vals)
    weights = torch.tensor(_MSSSIM_WEIGHTS, dtype=vals.dtype, device=vals.device)
    return torch.prod(torch.clamp_min(vals, 0.0) ** weights)
