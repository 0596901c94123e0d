"""Port parity, conv3x3 tensor-core variants: the weight packs' round trips
(the rest of these tests, and their helpers, are in
test_torch_port_conv3x3_split.py).
"""

import numpy as np
import pytest
import torch

from learned_pmctf_tpu_torch.ops import conv3x3 as c3
from test_torch_port_conv3x3_split import _numerics


@pytest.mark.parametrize("layout", ["mma_sync", "wgmma"])
@pytest.mark.parametrize("c,o", [(8, 8), (64, 64), (112, 112), (128, 64)])
def test_pack_weights_round_trip(layout, c, o):
    w = torch.tensor(np.random.default_rng(c + o).normal(0, 0.1, (o, c, 3, 3))
                     .astype(np.float32))
    big, small = c3.tf32_split(w)
    for o_pad in (o, o + 16):
        pack = c3.pack_weights(w, layout, o_pad)
        assert pack.dtype == torch.float32 and pack.shape == (2 * 9 * c * o_pad,)
        got_big, got_small = c3.unpack_weights(pack, layout, o, c)
        assert torch.equal(got_big, big) and torch.equal(got_small, small)
