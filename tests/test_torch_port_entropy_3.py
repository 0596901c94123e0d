"""Port parity, the host entropy side: table indexes, stream containers
and the coders' round trips (the rest of these tests are in
test_torch_port_entropy.py).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.entropy import coder as jcoder
from learned_pmctf_tpu.utils import stream as jstream
from learned_pmctf_tpu_torch.entropy import coder as pcoder
from learned_pmctf_tpu_torch.utils import stream as pstream


def test_build_indexes_from_scales_against_jax():
    g = np.random.default_rng(0)
    table = np.exp(np.linspace(math.log(0.01), math.log(64.0), 256))
    scales = np.concatenate([
        np.exp(g.uniform(math.log(1e-3), math.log(100.0), 1_000_000)),
        (table[None, :] * (1 + g.normal(0, 1e-6, (200, 256)))).ravel(),
        [0.0, 1e-6, 0.005, 0.01, 1.0, 64.0, 1e9],
    ]).astype(np.float32)
    ref = np.asarray(jcoder.build_indexes_from_scales(jnp.asarray(scales)))
    got = pcoder.build_indexes_from_scales(torch.from_numpy(scales)).numpy()
    assert got.dtype == np.int32
    # XLA's f32 log differs from torch's by an ulp at many points; an
    # index moves only where (log(s) - log_min) / step lies within a few
    # ulps of an integer, and then by one
    diff = np.flatnonzero(got != ref)
    assert np.all(np.abs(got[diff] - ref[diff]) == 1)
    exact = ((np.log(scales[diff].astype(np.float64)) - math.log(0.01))
             / ((math.log(64.0) - math.log(0.01)) / 255))
    assert np.all(np.abs(exact - np.round(exact)) < 5e-5), exact
    assert len(diff) < 1e-3 * scales.size
    assert got[-7:].tolist() == [0, 0, 0, 0, ref[-3], 255, 255]


def test_container_bytes_match_jax(tmp_path):
    payload = bytes(range(256)) * 3
    for fn_port, fn_jax, args in (
            (pstream.encode_image, jstream.encode_image, (1152, 1920, 2, payload)),
            (pstream.encode_image, jstream.encode_image, (64, 64, 1, b"\x01")),
            (pstream.encode_p, jstream.encode_p, (payload, 0)),
            (pstream.encode_p, jstream.encode_p, (b"\x07\x08", 513))):
        fn_port(*args, str(tmp_path / "port.bin"))
        fn_jax(*args, str(tmp_path / "jax.bin"))
        assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    pstream.encode_image(1152, 1920, 2, payload, str(tmp_path / "i.bin"))
    assert pstream.decode_image(str(tmp_path / "i.bin")) == (1152, 1920, 2, payload)
    pstream.encode_p(payload, 5, str(tmp_path / "p.bin"))
    assert pstream.decode_p(str(tmp_path / "p.bin")) == (5, payload)
    for h, w in ((1152, 1920), (64, 64), (1080, 1920), (100, 37)):
        assert (pstream.get_downsampled_shape(h, w, 64)
                == jstream.get_downsampled_shape(h, w, 64))


@pytest.mark.parametrize("stream_part", [1, 2])
def test_gaussian_encoder_round_trip_with_bypass(stream_part):
    """Symbols far outside the Laplace table (the bypass escape) and past
    the int16 clip come back as the coder's clipped symbols."""
    g = np.random.default_rng(1)
    em = pcoder.GaussianEncoder()
    em.update(force=True)
    coder = pcoder.EntropyCoder(True, stream_part)
    scales = np.exp(g.uniform(math.log(0.005), math.log(80), (2, 1, 32, 48)))
    symbols = np.round(g.laplace(0, scales)).astype(np.float32)
    symbols.reshape(-1)[:6] = [60, -200, 3000, -29999, 40000, -40000]
    idx = pcoder.build_indexes_from_scales(torch.tensor(scales, dtype=torch.float32))
    coder.reset()
    coder.encode_with_indexes(symbols, idx.numpy(), *em.tables())
    coder.flush()
    stream = coder.get_encoded_stream()
    dec = pcoder.EntropyCoder(False, stream_part)
    dec.set_stream(stream)
    out = dec.decode_stream(idx.numpy(), *em.tables())
    np.testing.assert_array_equal(out, np.clip(symbols, -30000, 30000).reshape(-1))


def test_factorized_coder_round_trip():
    em = pcoder.GaussianEncoder()
    em.update(force=True)
    channels = 8

    def cdf_fn(x):  # a logistic per channel
        scale = np.arange(1, channels + 1, dtype=np.float32).reshape(1, -1, 1, 1)
        return 1 / (1 + np.exp(-x / scale))

    fc = pcoder.FactorizedCoder(*pcoder.build_bit_estimator_tables(cdf_fn, channels),
                                channels)
    g = np.random.default_rng(2)
    z = np.round(g.logistic(0, 3, (1, channels, 3, 5))).astype(np.float32)
    z[0, 0, 0, 0] = 90  # bypass
    coder = pcoder.EntropyCoder()
    coder.reset()
    fc.encode(coder, z)
    coder.encode_with_indexes(np.array([3, -4]), np.array([10, 200]), *em.tables())
    coder.flush()
    dec = pcoder.EntropyCoder()
    dec.set_stream(coder.get_encoded_stream())
    np.testing.assert_array_equal(fc.decode_stream(dec, (3, 5)), z)
    np.testing.assert_array_equal(
        dec.decode_stream(np.array([10, 200]), *em.tables()), [3, -4])
