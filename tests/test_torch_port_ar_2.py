"""Port parity, the AR LL coder: MaskedConv2d (1e-5 abs), the wavefront
schedule (exact) and the AR PWaveCodec round trip (bit-exact). The other
AR tests, the models and their tolerances are in test_torch_port_ar.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.codec.image_codec import ar_wavefronts as jax_wavefronts
from learned_pmctf_tpu.models.layers import MaskedConv2d as JaxMaskedConv2d
from learned_pmctf_tpu_torch.codec.image_codec import PWaveCodec, ar_wavefronts
from learned_pmctf_tpu_torch.models.layers import MaskedConv2d
from learned_pmctf_tpu_torch.ops.masks import causal_conv_mask
from torch_port_helpers import assert_close
from test_torch_port_ar import (AR, Q, unit_models, _numerics)


@pytest.mark.parametrize("kind", ["A", "B"])
def test_masked_conv2d_matches_jax(kind):
    g = np.random.default_rng(1)
    w = g.normal(0, 0.1, (8, 3, 3, 3)).astype(np.float32)
    b = g.normal(0, 0.1, (8,)).astype(np.float32)
    x = g.normal(0, 30, (2, 3, 12, 20)).astype(np.float32)
    ref = JaxMaskedConv2d(3, 8, 3, kind).apply(
        {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(x))
    conv = MaskedConv2d(3, 8, 3, kind)
    conv.load_state_dict({"weight": torch.tensor(w), "bias": torch.tensor(b),
                          "mask": causal_conv_mask(3, 3, kind, 8, 3)}, strict=True)
    with torch.no_grad():
        got = conv(torch.tensor(x))
    assert_close(got, ref, 1e-5, f"MaskedConv2d {kind}")
    assert set(conv.state_dict()) == {"weight", "bias", "mask"}


@pytest.mark.parametrize("hw", [(1, 1), (4, 4), (9, 15), (5, 3)])
def test_ar_wavefronts_match_jax(hw):
    got, ref = ar_wavefronts(*hw), jax_wavefronts(*hw)
    assert len(got) == len(ref) == 2 * (hw[0] - 1) + hw[1]
    for (r, c), (jr, jc) in zip(got, ref):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(c, jc)
    cover = np.zeros(hw, int)
    for r, c in got:
        cover[r, c] += 1
    assert np.all(cover == 1)


@pytest.mark.parametrize("batch", [1, 2])
def test_pwave_codec_ar_round_trip(unit_models, tmp_path, batch):
    _, port = unit_models
    torch.backends.cudnn.deterministic = False
    codec = PWaveCodec(port.hp_coder, device="cpu")
    # the codec's convs must not depend on a timing-based algorithm pick
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.allow_tf32
    x = torch.tensor(np.random.default_rng(12).normal(0, 25, (batch, 1, 64, 64)),
                     dtype=torch.float32)
    path = str(tmp_path / "x.bin")
    recon, stream = codec.compress(x, Q, file_name=path, sideinfo=(1, batch, 64, 64))
    recon2, stream2 = codec.compress(x, Q, coder=codec.make_coder())
    assert stream == stream2 and torch.equal(recon, recon2)
    codec.stats.reset()
    decoded = codec.decompress(path, padding=64, q_index=Q)["x_hat"]
    assert torch.equal(decoded, recon)
    fronts = 2 * (16 - 1) + 16
    assert codec.stats.ar_fronts == fronts
    assert codec.stats.syncs == fronts + 4 * 3 * AR["decomp_levels"]
    with torch.no_grad():
        est = port.hp_coder(x, Q)["x_hat"]
    assert float((est - recon).abs().max()) < 1e-3
