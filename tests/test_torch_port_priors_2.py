"""The index walk of the priors' per-call weight pack (csrc/conv3x3_pack.cu),
modelled in numpy and held to ``ops/conv3x3.py:pack_weights``' "wgmma"
layout on the CPU; the kernel itself is held to it on the card
(tests/test_torch_port_priors_card.py).
"""

import numpy as np
import pytest
import torch

from learned_pmctf_tpu_torch.ops import conv3x3 as c3


def _pack_model(w, o_pad):
    """csrc/conv3x3_pack.cu's walk in numpy: element i of the pack from
    its (chunk, tap, part, k half, n-tile, g, t) and the split weight."""
    o, c = w.shape[:2]
    nt_count = o_pad // 8
    big, small = (p.numpy() for p in c3.tf32_split(w))
    out = np.zeros(2 * 9 * c * o_pad, np.float32)
    r = np.arange(out.size)
    t, r = r % 4, r // 4
    g, r = r % 8, r // 8
    nt, r = r % nt_count, r // nt_count
    kh, r = r % 2, r // 2
    part, r = r % 2, r // 2
    tap, chunk = r % 9, r // 9
    oo, cc = 8 * nt + g, 8 * chunk + 4 * kh + t
    inside = oo < o
    parts = np.where(part[inside] == 0,
                     big[oo[inside], cc[inside], tap[inside] // 3, tap[inside] % 3],
                     small[oo[inside], cc[inside], tap[inside] // 3, tap[inside] % 3])
    out[inside] = parts
    return out


@pytest.mark.parametrize("o,c,o_pad", [(112, 112, 112), (128, 128, 128), (64, 64, 64),
                                       (16, 16, 64)])
def test_pack_kernel_walk_is_pack_weights(o, c, o_pad):
    """The pack kernel's index walk gives pack_weights' "wgmma" layout bit
    for bit, at the priors' widths, PostProcess's and a padded 16->16."""
    w = torch.randn(o, c, 3, 3, generator=torch.Generator().manual_seed(4)) * 0.05
    want = c3.pack_weights(w, "wgmma", o_pad).numpy()
    got = _pack_model(w, o_pad)
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), (o, c)
