"""Port parity, the AR LL coder: the causal conv masks, exact (kinds A
and B; kind C in test_torch_port_ar_4.py).
"""

import numpy as np
import pytest

from learned_pmctf_tpu.ops.masks import causal_conv_mask as jax_mask
from learned_pmctf_tpu_torch.ops.masks import causal_conv_mask
from test_torch_port_ar import _numerics


@pytest.mark.parametrize("kind", ["A", "B"])
@pytest.mark.parametrize("shape", [(3, 3, 4, 1), (5, 5, 2, 3), (3, 5, 1, 1)])
def test_causal_conv_mask_matches_jax(kind, shape):
    got = causal_conv_mask(*shape[:2], kind, *shape[2:])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_mask(*shape[:2], kind, *shape[2:])))
    with pytest.raises(ValueError):
        causal_conv_mask(3, 3, "D", 1, 1)
