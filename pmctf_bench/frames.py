"""The frames of a run, made on the device from its seed.

``smooth_moving`` is the generator of every traffic mix; a mix file
gives its parameters. Each GOP gets smooth texture (a normal field
averaged over a square window), its own global motion of a few whole
pixels a frame (drawn from the seed, each component within
+-``max_motion`` and not both zero), and sensor noise. Luma is (1,1,H,W),
chroma (2,1,H/2,W/2) (U, and V its mirror image in value), 8-bit sample
values as f32. The sizes and the amount of motion are the same for every
seed; only where the texture lies and the direction of motion change.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F


def input_seed(seed: int, d: int) -> int:
    """The seed of the run's distinct input d (a GOP, a picture), and with
    d the number of inputs, the seed that picks the input checked."""
    return (seed * 1_000_003 + 7919 * (d + 1)) % (2 ** 63)


def gop_motion(seed: int, max_motion: int) -> Tuple[int, int]:
    """(dy, dx), a GOP's global motion in pixels a frame."""
    g = torch.Generator().manual_seed(seed)
    while True:
        dy, dx = (int(v) for v in torch.randint(-max_motion, max_motion + 1, (2,), generator=g))
        if dy or dx:
            return dy, dx


def smooth_moving(n: int, h: int, w: int, device, seed: int, texture_std: float = 40.0,
                  blur: int = 5, max_motion: int = 3, noise_std: float = 2.0
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """`n` frames of an `h` x `w` GOP drawn from `seed` on `device`."""
    dy, dx = gop_motion(seed, max_motion)
    m = max_motion * (n - 1)
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn(1, 1, h + 2 * m + blur - 1, w + 2 * m + blur - 1, device=device,
                       generator=g) * texture_std + 128
    base = F.avg_pool2d(base, blur, stride=1)
    luma, chroma = [], []
    for t in range(n):
        y0, x0 = m + dy * t, m + dx * t
        plane = base[..., y0:y0 + h, x0:x0 + w]
        y = plane + torch.randn(plane.shape, device=device, generator=g) * noise_std
        c = F.avg_pool2d(plane, 2)
        c = torch.cat([c, 255 - c]) + torch.randn((2, 1, h // 2, w // 2), device=device,
                                                  generator=g) * noise_std
        luma.append(y.clamp(0, 255).contiguous())
        chroma.append(c.clamp(0, 255).contiguous())
    return luma, chroma
