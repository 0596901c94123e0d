"""Differentiable rate estimates for quantized latents.

Counterpart of learned_pmctf_tpu/entropy/distributions.py.
"""

import math

import torch

_LOG2 = math.log(2.0)


def laplace_cdf(x, scale):
    """CDF of Laplace(0, scale)."""
    return 0.5 - 0.5 * torch.sign(x) * torch.expm1(-torch.abs(x) / scale)


def gaussian_cdf(x, scale):
    """CDF of Normal(0, scale)."""
    return 0.5 * (1.0 + torch.erf(x / (scale * math.sqrt(2.0))))


def probs_to_bits(probs):
    bits = -torch.log(probs + 1e-5) / _LOG2
    return torch.clamp_min(bits, 0.0)


def laplace_bits(y, scale):
    """Bits to code integer-quantized y under Laplace(0, scale)."""
    scale = torch.clamp(scale, 1e-5, 1e10)
    probs = laplace_cdf(y + 0.5, scale) - laplace_cdf(y - 0.5, scale)
    return probs_to_bits(probs)


def gaussian_bits(y, scale):
    """Bits to code integer-quantized y under Normal(0, scale)."""
    scale = torch.clamp(scale, 1e-5, 1e10)
    probs = gaussian_cdf(y + 0.5, scale) - gaussian_cdf(y - 0.5, scale)
    return probs_to_bits(probs)
