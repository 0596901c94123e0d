"""Port parity, conv3x3 tensor-core variants: the weight packs' element
orders, the refusal of odd channel counts and the pack cache (the rest
of these tests, and their helpers, are in test_torch_port_conv3x3_split.py).
"""

import numpy as np
import pytest
import torch

from learned_pmctf_tpu_torch.ops import conv3x3 as c3
from test_torch_port_conv3x3_split import _numerics


def test_pack_weights_mma_sync_order():
    """The mma.m16n8k8 B fragment: lane 4 g + t of n-tile j holds output
    8 j + g at channels t and t + 4 of the chunk, big parts then small."""
    c, o = 16, 16
    w = torch.tensor(np.random.default_rng(0).normal(0, 1, (o, c, 3, 3))
                     .astype(np.float32))
    parts = c3.tf32_split(w)
    pack = c3.pack_weights(w, "mma_sync").reshape(c // 8, 9, o // 8, 32, 4)
    for chunk, tap, j, lane in [(0, 0, 0, 0), (1, 4, 1, 13), (1, 8, 0, 31), (0, 5, 1, 6)]:
        g, t = lane >> 2, lane & 3
        want = [float(parts[e >> 1][8 * j + g, 8 * chunk + t + 4 * (e & 1), tap // 3, tap % 3])
                for e in range(4)]
        assert pack[chunk, tap, j, lane].tolist() == want


def test_pack_weights_wgmma_order():
    """K-major core matrices: [chunk][tap][part][k half][8 outputs][output][4 k]."""
    c, o = 16, 16
    w = torch.tensor(np.random.default_rng(1).normal(0, 1, (o, c, 3, 3))
                     .astype(np.float32))
    parts = c3.tf32_split(w)
    pack = c3.pack_weights(w, "wgmma").reshape(c // 8, 9, 2, 2, o // 8, 8, 4)
    for chunk, tap, part, half, j, n, k in [(0, 0, 0, 0, 0, 0, 0), (1, 7, 1, 1, 1, 5, 3),
                                            (0, 3, 1, 0, 1, 7, 2), (1, 8, 0, 1, 0, 2, 1)]:
        want = float(parts[part][8 * j + n, 8 * chunk + 4 * half + k, tap // 3, tap % 3])
        assert float(pack[chunk, tap, part, half, j, n, k]) == want


def test_pack_weights_rejects_odd_channels():
    with pytest.raises(ValueError):
        c3.pack_weights(torch.zeros(8, 5, 3, 3), "mma_sync")
    with pytest.raises(ValueError):
        c3.pack_weights(torch.zeros(16, 8, 3, 3), "wgmma", 8)


@pytest.mark.parametrize("layout,o_pad", [("mma_sync", 64), ("wgmma", 64), ("direct", None)])
def test_pack_cache(layout, o_pad):
    conv = torch.nn.Conv2d(64, 64, 3, padding=1)
    w = conv.weight
    before = c3.packed_weights.packs
    first = c3.packed_weights(w, layout, o_pad)
    assert c3.packed_weights.packs == before + 1
    assert c3.packed_weights(w, layout, o_pad) is first  # a second call packs nothing
    assert c3.packed_weights.packs == before + 1
    with torch.no_grad():
        w.mul_(0.5)  # an in-place update, as an optimizer step makes
    second = c3.packed_weights(w, layout, o_pad)
    assert c3.packed_weights.packs == before + 2
    assert not torch.equal(second, first)
    conv.load_state_dict({"weight": torch.full_like(w, 0.25), "bias": conv.bias.detach()})
    third = c3.packed_weights(conv.weight, layout, o_pad)
    assert c3.packed_weights.packs == before + 3
    if layout != "direct":
        big, small = c3.unpack_weights(third, layout, 64, 64)
        assert bool((big == 0.25).all()) and not bool(small.any())
    # the OIHW layout is the tensor itself: nothing to pack
    assert c3.packed_weights(w, "oihw") is w
    assert c3.packed_weights.packs == before + 3
