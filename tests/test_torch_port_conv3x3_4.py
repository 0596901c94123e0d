"""Port parity, conv3x3: the port's fused 3x3 conv at a width the Pallas
kernel refuses (96) against the JAX package's XLA oracle, 1e-4 abs,
the first two of the shapes (helpers in test_torch_port_conv3x3.py).
"""

import numpy as np
import pytest

from learned_pmctf_tpu.ops import pallas_conv as pc
from test_torch_port_conv3x3 import EPILOGUES, SHAPES, _case, _jax_args, _numerics, _port


@pytest.mark.parametrize("n,h,c,o", SHAPES[:2])
@pytest.mark.parametrize("act,res", EPILOGUES)
def test_conv3x3_any_width_matches_oracle(n, h, c, o, act, res):
    # W=96 is no multiple of 128: the Pallas kernel refuses it, the port
    # takes any width (chroma rows are 960 wide)
    x, w, b, r = _case(n, h, c, o, 96, res, seed=1)
    jx, jw, jb, jr = _jax_args(x, w, b, r)
    ref = pc.conv3x3_hcw_reference(jx, jw, jb, act=act, residual=jr)
    got = _port(x, w, b, r, act)
    assert float(np.max(np.abs(got - np.asarray(ref)))) < 1e-4
