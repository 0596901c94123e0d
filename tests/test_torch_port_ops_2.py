"""Port parity, ops: resampling and the lifting helpers and masks against
the JAX package, 1e-4 abs (exact where the op is a copy; the rest of
these tests are in test_torch_port_ops.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.ops import lifting as jlift
from learned_pmctf_tpu.ops import masks as jmasks
from learned_pmctf_tpu.ops import resample as jres
from learned_pmctf_tpu_torch.ops import lifting, masks, resample
from test_torch_port_ops import (_close, _numerics)


@pytest.mark.parametrize("shape", [(1, 2, 64, 64), (2, 1, 36, 20)])
def test_bilinear_downsample_antialias_matches_jax(shape):
    x = np.random.default_rng(1).normal(0, 60, shape).astype(np.float32)
    _close(resample.bilinear_downsample(torch.tensor(x)),
           jres.bilinear_downsample(jnp.asarray(x)))


def test_bilinear_upsample_avg_pool_nearest_match_jax():
    x = np.random.default_rng(2).normal(0, 60, (2, 2, 16, 24)).astype(np.float32)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    _close(resample.bilinear_upsample(tx), jres.bilinear_upsample(jx))
    _close(resample.avg_pool2(tx), jres.avg_pool2(jx))
    _close(resample.nearest_upsample(tx), jres.nearest_upsample(jx))


def test_lifting_helpers_and_masks_match_jax():
    x = np.random.default_rng(6).normal(0, 9, (1, 2, 12, 8)).astype(np.float32)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    for p, r in zip(lifting.split_even_odd(tx), jlift.split_even_odd(jx)):
        _close(p, r, atol=0)
    _close(lifting.merge_even_odd(*lifting.split_even_odd(tx)), x, atol=0)
    _close(lifting.reflect_pad_rows(tx), jlift.reflect_pad_rows(jx), atol=0)
    assert lifting.CDF97_COEFFS == jlift.CDF97_COEFFS
    for p, r in zip(masks.checkerboard_masks(6, 10),
                    jmasks.checkerboard_masks(6, 10)):
        _close(p, r, atol=0)
