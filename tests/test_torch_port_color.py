"""Port parity, the integer colour conversions of ops/color.py: the
studio-range YCbCr pair (BT.601 and BT.709) and the lossless YCoCg pair,
against the JAX package's on every one of the 2^24 8-bit triples (in
chunks), exactly; the YCoCg pair round-trips exactly, and the trainer's
numpy YCoCg (data/vimeo.py) is the same function.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.ops import color as jcolor

from learned_pmctf_tpu_torch.data.vimeo import _rgb_to_ycocg_np
from learned_pmctf_tpu_torch.ops import color

CHUNK = 1 << 22  # triples a chunk: 4 chunks cover all 2^24


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def all_triples():
    """Every 8-bit triple, as (1, 3, CHUNK / 256, 256) int32 planes."""
    for start in range(0, 1 << 24, CHUNK):
        v = np.arange(start, start + CHUNK, dtype=np.int32)
        x = np.stack([v >> 16, (v >> 8) & 255, v & 255])
        yield x.reshape(1, 3, CHUNK // 256, 256)


@pytest.mark.parametrize("flavor", [601, 709])
def test_studio_rgb_to_ycbcr_matches_jax(flavor):
    for x in all_triples():
        got = color.rgb_to_ycbcr_studio(torch.from_numpy(x), flavor)
        want = np.asarray(jcolor.rgb_to_ycbcr_studio(jnp.asarray(x), flavor))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("flavor", [601, 709])
def test_studio_ycbcr_to_rgb_matches_jax(flavor):
    for x in all_triples():
        got = color.ycbcr_to_rgb_studio(torch.from_numpy(x), flavor)
        want = np.asarray(jcolor.ycbcr_to_rgb_studio(jnp.asarray(x), flavor))
        np.testing.assert_array_equal(got.numpy(), want)


def test_studio_refuses_an_unknown_flavor():
    x = torch.zeros(1, 3, 2, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        color.rgb_to_ycbcr_studio(x, 2020)
    with pytest.raises(ValueError):
        color.ycbcr_to_rgb_studio(x, 2020)


def test_ycocg_matches_jax_and_round_trips():
    for x in all_triples():
        t = torch.from_numpy(x)
        ycocg = color.rgb_to_ycocg_lossless(t)
        assert ycocg.dtype == torch.float32
        np.testing.assert_array_equal(
            ycocg.numpy(), np.asarray(jcolor.rgb_to_ycocg_lossless(jnp.asarray(x))))
        back = color.ycocg_to_rgb_lossless(ycocg)
        np.testing.assert_array_equal(back.numpy(), x.astype(np.float32))
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jcolor.ycocg_to_rgb_lossless(jnp.asarray(ycocg.numpy()))))


def test_dataset_ycocg_is_the_same_function():
    """data/vimeo.py's numpy YCoCg (H, W, 3) gives ops/color.py's numbers."""
    x = next(all_triples())[0]                         # (3, h, 256)
    hwc = np.ascontiguousarray(x.transpose(1, 2, 0))
    np.testing.assert_array_equal(
        _rgb_to_ycocg_np(hwc).transpose(2, 0, 1),
        color.rgb_to_ycocg_lossless(torch.from_numpy(x)).numpy())
