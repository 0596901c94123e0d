"""Port parity, the host entropy side: the CDF quantizer against its
goldens and its plain version, the Laplace and bit-estimator tables
against JAX (allowances stated in each test; the rest of these tests
are in test_torch_port_entropy.py).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.entropy import coder as jcoder
from learned_pmctf_tpu.entropy.distributions import laplace_cdf as jax_laplace_cdf
from learned_pmctf_tpu.models import PMCTF as JaxPMCTF
from learned_pmctf_tpu_torch import native
from learned_pmctf_tpu_torch.entropy import coder as pcoder
from torch_port_helpers import SMALL, jax_small_model, jax_small_params, port_small_model
from test_torch_port_entropy import GOLDEN


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
