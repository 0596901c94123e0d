"""Port parity, conv3x3: the port's fused 3x3 conv against the JAX
package's Pallas kernel in interpret mode, 1e-4 abs, the last two of the shapes
(helpers in test_torch_port_conv3x3.py).
"""

import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from learned_pmctf_tpu.ops import pallas_conv as pc
from test_torch_port_conv3x3 import EPILOGUES, SHAPES, _case, _jax_args, _numerics, _port


@pytest.mark.parametrize("n,h,c,o", SHAPES[2:])
@pytest.mark.parametrize("act,res", EPILOGUES)
def test_conv3x3_matches_pallas_kernel(n, h, c, o, act, res):
    x, w, b, r = _case(n, h, c, o, 128, res)
    jx, jw, jb, jr = _jax_args(x, w, b, r)
    with pltpu.force_tpu_interpret_mode():
        ref = pc.conv3x3_hcw(jx, jw, jb, act=act, residual=jr)
    got = _port(x, w, b, r, act)
    assert float(np.max(np.abs(got - np.asarray(ref)))) < 1e-4
