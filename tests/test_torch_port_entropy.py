"""Port parity, the host entropy side: learned_pmctf_tpu_torch's rANS copy,
CDF quantizer, table builders, index mapping and stream containers
against the golden streams and the JAX package.

Where the two frameworks' f32 math differs by an ulp (XLA's CPU ``log``
and ``expm1`` are its own approximations, neither torch's nor numpy's),
a test states the allowance it holds and checks that the construction
itself is exact: fed the JAX package's f32 CDF values, the port builds
the JAX package's tables entry for entry.
"""

import glob
import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.entropy import coder as jcoder
from learned_pmctf_tpu.entropy.distributions import laplace_cdf as jax_laplace_cdf
from learned_pmctf_tpu.models import PMCTF as JaxPMCTF
from learned_pmctf_tpu.utils import stream as jstream

from learned_pmctf_tpu_torch import native
from learned_pmctf_tpu_torch.entropy import coder as pcoder
from learned_pmctf_tpu_torch.utils import stream as pstream
from test_torch_port_models import (SMALL, jax_small_model, jax_small_params,
                                    port_small_model)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
RANS_CASES = sorted(os.path.basename(p)[5:-4]
                    for p in glob.glob(os.path.join(GOLDEN, "rans_*.npz")))


def test_port_builds_and_loads_its_own_library():
    lib = native._load()
    assert native.build() == ""  # built, and up to date
    assert lib._name == native.LIBRARY
    assert "learned_pmctf_tpu_torch" in native.LIBRARY
    assert os.path.dirname(native.SOURCES[0]).endswith(
        os.path.join("learned_pmctf_tpu_torch", "csrc", "rans"))


@pytest.mark.parametrize("name", RANS_CASES)
def test_rans_matches_golden_stream(name):
    case = dict(np.load(os.path.join(GOLDEN, f"rans_{name}.npz")))
    tables = (case["cdfs"], case["cdfs_sizes"], case["offsets"])
    parts = int(case["stream_part"])
    for multithread in (False, True):
        enc = native.RansEncoder(multithread, parts)
        enc.encode_with_indexes(case["symbols"], case["indexes"], *tables)
        enc.flush()
        assert enc.get_encoded_stream() == case["stream"].tobytes(), (name, multithread)
    dec = native.RansDecoder(parts)
    dec.set_stream(case["stream"].tobytes())
    out = dec.decode_stream(case["indexes"], *tables)
    keep = case["indexes"] >= 0
    np.testing.assert_array_equal(out[keep], case["symbols"].astype(np.int16)[keep])


@pytest.mark.parametrize("i", range(4))
def test_cdf_quantizer_matches_golden(i):
    data = np.load(os.path.join(GOLDEN, f"cdf_{i}.npz"))
    np.testing.assert_array_equal(native.pmf_to_quantized_cdf(data["pmf"]), data["cdf"])
    np.testing.assert_array_equal(native.pmf_to_quantized_cdf_plain(data["pmf"]),
                                  data["cdf"])


def test_cdf_quantizer_native_matches_plain():
    g = np.random.default_rng(0)
    pmfs = [g.dirichlet(np.full(n, a)).astype(np.float32)
            for n in (3, 17, 60, 103) for a in (0.05, 1.0, 20.0)]
    # pmf * 2^16 exactly k + 0.5: std::round goes away from zero, where
    # np.round would go to even
    half = np.array([0.5, 1.5, 2.5, 65530.5], np.float32) / 65536
    pmfs.append(np.append(half, 1 - half.sum()).astype(np.float32))
    for pmf in pmfs:
        np.testing.assert_array_equal(native.pmf_to_quantized_cdf(pmf),
                                      native.pmf_to_quantized_cdf_plain(pmf))


def _jax_laplace_cdf_f32(x, scales):
    return np.asarray(jax_laplace_cdf(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(scales, jnp.float32)))


def test_gaussian_encoder_tables_against_jax(monkeypatch):
    ref = jcoder.GaussianEncoder("laplace")
    ref.update(force=True)
    ref_tables = (ref._cdf, ref._cdf_length, ref._offset)

    port = pcoder.GaussianEncoder()
    port.update(force=True)
    cdf, length, offset = port.tables()
    np.testing.assert_array_equal(length, ref._cdf_length)
    np.testing.assert_array_equal(offset, ref._offset)
    # torch's f32 expm1 differs from XLA's by an ulp at some points; where
    # that moves a row's rounding, the row's normalization moves many of
    # its entries by one or two (measured: 3 of 256 rows, at most 2)
    rows = np.flatnonzero((cdf != ref._cdf).any(axis=1))
    assert len(rows) <= 3, rows
    assert np.abs(cdf.astype(np.int64) - ref._cdf).max() <= 2

    # the construction itself is exact: on XLA's CDF values, JAX's tables
    monkeypatch.setattr(pcoder, "_laplace_cdf_f32", _jax_laplace_cdf_f32)
    exact = pcoder.GaussianEncoder()
    exact.update(force=True)
    for got, want in zip(exact.tables(), ref_tables):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def models():
    params = jax_small_params()
    return (jax_small_model(), jax.tree_util.tree_map(jnp.asarray, params),
            port_small_model(params))


@pytest.mark.parametrize("stage", range(SMALL["num_me_stages"]))
def test_bit_estimator_tables_against_jax(models, stage):
    jm, jp, port = models
    channels = SMALL["channel_mv"]

    def jax_cdf(x):
        return np.asarray(jm.apply(jp, jnp.asarray(x), stage,
                                   method=JaxPMCTF.mv_z_cdf_fn))

    def port_cdf(x):
        with torch.no_grad():
            return port.mv_z_cdf_fn(torch.from_numpy(x), stage).numpy()

    ref = jcoder.build_bit_estimator_tables(jax_cdf, channels)
    # exact construction on the same f32 CDF values
    for got, want in zip(pcoder.build_bit_estimator_tables(jax_cdf, channels), ref):
        np.testing.assert_array_equal(got, want)
    # on the port's own CDF (torch's sigmoid/tanh/softplus, within 1.2e-7
    # of XLA's): the same lengths and offsets. A row's quantized CDF can
    # move where an ulp puts pmf * 2^16 on either side of k + 0.5: the
    # row's total then changes by one and its zero-width buckets steal
    # elsewhere (measured on these weights: one row of stage 1, entries
    # up to 80 of 2^16 apart; stage 0 entries at most 1 apart)
    cdf, length, offset = pcoder.build_bit_estimator_tables(port_cdf, channels)
    np.testing.assert_array_equal(length, ref[1])
    np.testing.assert_array_equal(offset, ref[2])
    rows = np.flatnonzero((cdf != ref[0]).any(axis=1))
    assert len(rows) <= 1, rows
    assert np.abs(cdf.astype(np.int64) - ref[0]).max() <= 128


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
