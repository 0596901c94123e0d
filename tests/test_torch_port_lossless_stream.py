"""Port parity, the lossless configuration's bitstream path: PWaveCodec
and PMCTFCodec under lossy=False, with both LL coders (four-step and
AR). Decoded planes equal the input bit for bit and the estimate path's
reconstruction; stream bytes are identical across encodes.

The four-step coder codes each symbol around the rounded mean, as the
estimate path's process_with_mask does in lossless mode. The JAX
package's PWaveCodec codes around the unrounded mean, so its lossless
stream decodes to a plane off by whole units (ROADMAP.md C);
test_jax_pwave_codec_is_not_lossless shows it on the same weights and
plane the port codes exactly. The AR GOP-4 stream is marked slow (the AR
PWaveCodec round trip runs in tier-1).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.codec import PWaveCodec as JaxPWaveCodec
from learned_pmctf_tpu.models.pwave import PWave as JaxPWave

from learned_pmctf_tpu_torch.codec.image_codec import PWaveCodec
from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.convert import pwave_params_from_jax
from learned_pmctf_tpu_torch.gop import code_gop, stream_gop
from learned_pmctf_tpu_torch.models.layers import init_params
from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
from learned_pmctf_tpu_torch.models.pwave import PWave
from test_torch_port_lossless import lossless_frames
from torch_port_helpers import SMALL, _draw, numerics  # noqa: F401

Q = 10.0
PWAVE = dict(decomp_levels=2, features=16, ar_features=16)


def jax_lossless_pwave_params(ll_mode, seed=0, hw=32):
    """The lossy tree (flax makes no PostProcess parameters for a lossless
    PWave, which never calls it; the port's module has them, unused)."""
    x = jnp.zeros((1, 1, hw, hw), jnp.float32)
    shapes = jax.eval_shape(lambda: JaxPWave(ll_mode=ll_mode, **PWAVE).init(
        jax.random.PRNGKey(0), x, 10))
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(tuple(str(k.key) for k in p), s.shape, g)
        .astype(np.float32), shapes)


def port_lossless_pwave(params, ll_mode):
    m = PWave(lossy=False, ll_mode=ll_mode, **PWAVE).eval()
    m.load_state_dict(pwave_params_from_jax(params), strict=True)
    return m


def plane(seed, shape=(1, 1, 32, 32)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


@pytest.mark.parametrize("ll_mode", ["fourstep", "ar"])
def test_pwave_codec_is_lossless(ll_mode, tmp_path):
    """Decoded == input == the estimate's x_hat; bytes identical across
    two encodes; a batch of two planes."""
    m = port_lossless_pwave(jax_lossless_pwave_params(ll_mode), ll_mode)
    x = torch.from_numpy(plane(3, (2, 1, 32, 32)))
    codec = PWaveCodec(m, device="cpu")
    with torch.no_grad():
        est = m(x, Q)["x_hat"]
    streams = []
    for i in range(2):
        f = str(tmp_path / f"{i}.bin")
        enc, stream = codec.compress(x, Q, file_name=f, sideinfo=(1, 2, 32, 32))
        streams.append(stream)
        dec = codec.decompress(file_name=f, padding=32, q_index=Q)["x_hat"]
        assert torch.equal(dec, x) and torch.equal(enc, x)
    assert torch.equal(est, x)
    assert streams[0] == streams[1]


def test_jax_pwave_codec_is_not_lossless(tmp_path):
    """JAX's PWaveCodec in lossless mode, on weights and a plane the port
    codes exactly: its decoded plane is off by whole units (it codes
    round(y - m) and adds back the unrounded mean m)."""
    params = jax_lossless_pwave_params("fourstep", seed=1)
    x = plane(7)
    jcodec = JaxPWaveCodec(JaxPWave(lossy=False, **PWAVE), jax.tree_util.tree_map(
        jnp.asarray, params))
    f = str(tmp_path / "jax.bin")
    jcodec.compress(jnp.asarray(x), q_index=10, file_name=f, sideinfo=(1, 1, 32, 32))
    jdec = np.asarray(jcodec.decompress(file_name=f, padding=32, q_index=10)["x_hat"])
    jax_err = float(np.max(np.abs(jdec - x)))

    codec = PWaveCodec(port_lossless_pwave(params, "fourstep"), device="cpu")
    g = str(tmp_path / "port.bin")
    codec.compress(torch.from_numpy(x), Q, file_name=g, sideinfo=(1, 1, 32, 32))
    dec = codec.decompress(file_name=g, padding=32, q_index=Q)["x_hat"]
    assert float((dec - torch.from_numpy(x)).abs().max()) == 0.0
    assert jax_err >= 0.5, jax_err  # whole units off: not lossless
    print(f"JAX PWaveCodec lossless max error {jax_err}")


@pytest.fixture(scope="module")
def lossless_models():
    out = {}
    for ll_mode in ("fourstep", "ar"):
        m = build_pmctf(device="cpu", seed=3, lossy=False, ll_mode=ll_mode, **SMALL)
        init_params(m, torch.Generator().manual_seed(3))
        out[ll_mode] = m
    return out


@pytest.mark.parametrize("ll_mode", ["fourstep", pytest.param("ar", marks=pytest.mark.slow)])
def test_stream_gop4_is_lossless(lossless_models, ll_mode, tmp_path):
    """stream_gop under lossy=False: every decoded band equals the encoder
    side, the decoded frames equal the input and code_gop's frames, and a
    second encode writes the same bytes."""
    model = lossless_models[ll_mode]
    luma, chroma = lossless_frames(4)
    est = code_gop(model, luma, chroma, Q, device="cpu")
    files = []
    with PMCTFCodec(model, device="cpu") as codec:
        codec.update()
        for run in range(2):
            d = tmp_path / str(run)
            d.mkdir()
            got = stream_gop(codec, luma, chroma, Q, str(d), psize=64, device="cpu")
            assert set(got["max_err"].values()) == {0.0}
            for fi in range(4):
                np.testing.assert_array_equal(got["luma"][fi].numpy(), luma[fi])
                np.testing.assert_array_equal(got["chroma"][fi].numpy(), chroma[fi])
                assert torch.equal(got["luma"][fi], est["luma"][fi])
                assert torch.equal(got["chroma"][fi], est["chroma"][fi])
            files.append({p.name: p.read_bytes() for p in sorted(d.iterdir())})
    assert files[0] == files[1] and len(files[0]) >= 11
