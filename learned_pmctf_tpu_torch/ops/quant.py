"""Straight-through quantization primitives.

Counterpart of learned_pmctf_tpu/ops/quant.py. ``torch.round`` rounds
half to even, like ``jnp.round``.
"""

import torch


def ste_round(x):
    """Round with a straight-through (identity) gradient."""
    return x + (torch.round(x) - x).detach()


def ste_clamp(x, min_val, max_val):
    """Clamp with a straight-through (identity) gradient."""
    return x + (torch.clamp(x, min_val, max_val) - x).detach()


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x, bound: float):
    """max(x, bound); the gradient passes where x >= bound or g < 0."""
    return _LowerBound.apply(x, bound)


def quant_ste(x, training: bool = True):
    """Quantize: STE round when training, hard round otherwise."""
    return ste_round(x) if training else torch.round(x)


def add_uniform_noise(x, noise):
    """x + U(-0.5, 0.5) noise, a proxy for rounding in training; no
    gradient flows into the noise. `noise` is the noise tensor itself
    (shaped like x) or an explicit torch.Generator to draw it from; the
    global generator is never used."""
    if isinstance(noise, torch.Generator):
        noise = torch.rand(x.shape, generator=noise, dtype=x.dtype,
                           device=noise.device) - 0.5
    return x + noise.to(x.device).detach()
