"""Port parity, the codecs: the four-part prior's decode helpers against
JAX and the PWaveCodec round trip, bit-exact (helpers in
test_torch_port_codec.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models.mv_coder import (four_part_prior_decode_scales as jax_decode_scales,
                                               four_part_prior_scatter as jax_scatter)
from learned_pmctf_tpu.ops.masks import checkerboard_masks as jax_masks
from learned_pmctf_tpu_torch.codec.image_codec import PWaveCodec
from learned_pmctf_tpu_torch.models.mv_coder import (four_part_prior_decode_scales,
                                                     four_part_prior_scatter)
from learned_pmctf_tpu_torch.ops.masks import checkerboard_masks
from torch_port_helpers import assert_close
from test_torch_port_codec import (PSIZE, codec, models, _numerics)


def test_four_part_prior_decode_helpers():
    g = np.random.default_rng(9)
    scales = [g.normal(0, 1, (1, 2, 6, 10)).astype(np.float32) for _ in range(4)]
    means = [g.normal(0, 1, (1, 2, 6, 10)).astype(np.float32) for _ in range(4)]
    vals = np.round(g.normal(0, 3, (1, 2, 6, 10))).astype(np.float32)
    for step in range(4):
        ref = jax_decode_scales([jnp.asarray(s) for s in scales], jax_masks(6, 10), step)
        got = four_part_prior_decode_scales([torch.tensor(s) for s in scales],
                                            checkerboard_masks(6, 10), step)
        assert_close(got, ref, 1e-7, f"decode_scales[{step}]")
        ref = jax_scatter(jnp.asarray(vals), [jnp.asarray(m) for m in means],
                          jax_masks(6, 10), step)
        got = four_part_prior_scatter(torch.tensor(vals),
                                      [torch.tensor(m) for m in means],
                                      checkerboard_masks(6, 10), step)
        assert_close(got, ref, 1e-7, f"scatter[{step}]")


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("q_index", [0, 20])
def test_pwave_codec_round_trip(models, tmp_path, batch, q_index):
    _, _, port = models
    codec = PWaveCodec(port.hp_coder, device="cpu")
    x = torch.tensor(np.random.default_rng(12).normal(0, 25, (batch, 1, 64, 64)),
                     dtype=torch.float32)
    path = str(tmp_path / "x.bin")
    recon, stream = codec.compress(x, q_index, file_name=path,
                                   sideinfo=(1, batch, 64, 64))
    recon2, stream2 = codec.compress(x, q_index, coder=codec.make_coder())
    assert stream == stream2 and torch.equal(recon, recon2)
    decoded = codec.decompress(path, padding=PSIZE, q_index=q_index)["x_hat"]
    assert decoded.shape == x.shape
    assert torch.equal(decoded, recon)
    # the stream's reconstruction is the estimate path's
    with torch.no_grad():
        est = port.hp_coder(x, float(q_index))["x_hat"]
    assert float((est - recon).abs().max()) < 1e-3
