"""Port parity, conv3x3 tensor-core variants: the plain emulation of the
three-product sum against conv3x3_plain and the JAX oracle, within 2e-5
(the rest of these tests, and their helpers, are in
test_torch_port_conv3x3_split.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.ops import pallas_conv as pc
from learned_pmctf_tpu_torch.ops import conv3x3 as c3
from test_torch_port_conv3x3_split import (_case64, _numerics)


@pytest.mark.parametrize("act,res", [(None, False), ("leaky_relu", False), (None, True),
                                     ("tanh", True)])
def test_split_plain_matches_plain_and_oracle(act, res):
    x, wt, b, r = _case64(5, res=res)
    tx, tw, tb = torch.tensor(x), torch.tensor(wt), torch.tensor(b)
    tr = None if r is None else torch.tensor(r)
    got = c3.conv3x3_split_plain(tx, tw, tb, act=act, residual=tr)
    plain = c3.conv3x3_plain(tx, tw, tb, act=act, residual=tr)
    assert float((got - plain).abs().max()) < 2e-5
    # the JAX oracle works on (N, H, C, W)
    hcw = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))  # noqa: E731
    ref = pc.conv3x3_hcw_reference(hcw(x), jnp.asarray(wt), jnp.asarray(b), act=act,
                                   residual=None if r is None else hcw(r))
    ref = np.asarray(ref).transpose(0, 2, 1, 3)
    assert float(np.max(np.abs(got.numpy() - ref))) < 2e-5
