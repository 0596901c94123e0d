"""Port parity, entropy/compression_model.py:CompressionModel against the
JAX package's: the Laplace and Gaussian bits (1e-4 abs plus 3e-3
relative: where a symbol's two f32 CDFs nearly cancel, torch's
expm1/erf/log and XLA's leave different remainders; measured 2.6e-4
for Laplace, 1.5e-3 for Gaussian tails at 16.5 bits, where 1 - erf is
at f32's resolution), quantization and
the mean-centred process (exact), the factorized z bits, and the CDF
tables its update builds: exact on XLA's CDF values; on torch's own the
Laplace table as tests/test_torch_port_entropy_2.py allows (at most 3
rows, 2 of 2^16), the Gaussian one at most 16 rows apart, by at most 2
of 2^16 but for one row, where an ulp of erf moves an exact k + 0.5 tie
and the row's normalization moves up to 128 (measured: 13 rows, 12 by
at most 2, one by 99). The module has no parameters, so there is
nothing to carry across.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.entropy.compression_model import CompressionModel as JaxModel

from learned_pmctf_tpu_torch.entropy.bit_estimator import BitEstimator
from learned_pmctf_tpu_torch.entropy.compression_model import CompressionModel
from learned_pmctf_tpu_torch.entropy.coder import build_indexes_from_scales


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _draws(seed=0):
    g = np.random.default_rng(seed)
    y = np.round(g.normal(0, 6, (2, 3, 9, 11))).astype(np.float32)
    scales = np.exp(g.normal(0, 1.5, y.shape)).astype(np.float32)
    return y, scales


@pytest.mark.parametrize("dist", ["laplace", "gaussian"])
def test_bits_match_jax(dist):
    y, scales = _draws()
    port, ref = CompressionModel(dist), JaxModel(dist)
    got = port.get_y_bits(torch.from_numpy(y), torch.from_numpy(scales)).numpy()
    want = np.asarray(ref.get_y_bits(jnp.asarray(y), jnp.asarray(scales)))
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=1e-4)
    other = (CompressionModel.get_y_gaussian_bits if dist == "laplace"
             else CompressionModel.get_y_laplace_bits)
    assert not np.allclose(other(torch.from_numpy(y), torch.from_numpy(scales)).numpy(),
                           want, atol=1e-2)
    # the table indexes of each distribution's scale range
    idx = build_indexes_from_scales(torch.from_numpy(scales), dist).numpy()
    from learned_pmctf_tpu.entropy.coder import build_indexes_from_scales as jidx
    mismatch = np.mean(idx != np.asarray(jidx(jnp.asarray(scales), dist)))
    assert mismatch < 1e-3, mismatch


def test_quant_process_noise_and_z_bits_match_jax():
    g = np.random.default_rng(1)
    y = g.normal(0, 4, (2, 4, 6, 6)).astype(np.float32)
    means = g.normal(0, 2, y.shape).astype(np.float32)
    ty, tm = torch.from_numpy(y), torch.from_numpy(means)
    np.testing.assert_array_equal(CompressionModel.quant(ty, False).numpy(),
                                  np.asarray(JaxModel.quant(jnp.asarray(y), False)))
    for got, want in zip(CompressionModel.process(ty, tm, False),
                         JaxModel.process(jnp.asarray(y), jnp.asarray(means), False)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    noise = g.uniform(-0.5, 0.5, y.shape).astype(np.float32)
    np.testing.assert_array_equal(CompressionModel.add_noise(ty, torch.from_numpy(noise)).numpy(),
                                  y + noise)
    est = BitEstimator(4)
    for p in est.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3, generator=torch.Generator().manual_seed(2))
    z = torch.round(ty)
    cdf_np = lambda x: jnp.asarray(est.get_cdf(torch.tensor(np.asarray(x))).detach().numpy())  # noqa: E731
    with torch.no_grad():
        got = CompressionModel.get_z_bits(z, est.get_cdf).numpy()
    want = np.asarray(JaxModel.get_z_bits(jnp.asarray(z.numpy()), cdf_np))
    np.testing.assert_allclose(got, want, atol=1e-4)


def _xla_cdf(dist):
    from learned_pmctf_tpu.entropy import distributions as jdist
    fn = jdist.laplace_cdf if dist == "laplace" else jdist.gaussian_cdf
    return lambda x, s: np.asarray(fn(jnp.asarray(np.asarray(x, np.float32)),
                                      jnp.asarray(np.asarray(s, np.float32))))


@pytest.mark.parametrize("dist", ["laplace", "gaussian"])
def test_update_builds_the_jax_tables(dist, monkeypatch):
    port, ref = CompressionModel(dist, stream_part=2), JaxModel(dist)
    port.update()
    ref.update()
    assert port.entropy_coder is not None
    cdf, length, offset = port.gaussian_encoder.tables()
    np.testing.assert_array_equal(length, ref.gaussian_encoder._cdf_length)
    np.testing.assert_array_equal(offset, ref.gaussian_encoder._offset)
    diff = np.abs(cdf.astype(np.int64) - ref.gaussian_encoder._cdf).max(axis=1)
    rows = np.flatnonzero(diff)
    if dist == "laplace":
        assert len(rows) <= 3 and diff.max() <= 2, (rows, diff[rows])
    else:
        assert len(rows) <= 16 and np.sum(diff > 2) <= 1 and diff.max() <= 128, (
            rows, diff[rows])
    # the construction itself is exact: on XLA's CDF values, JAX's tables
    from learned_pmctf_tpu_torch.entropy import coder as pcoder
    monkeypatch.setattr(pcoder, f"_{dist}_cdf_f32", _xla_cdf(dist))
    exact = CompressionModel(dist)
    exact.update()
    np.testing.assert_array_equal(exact.gaussian_encoder.tables()[0],
                                  ref.gaussian_encoder._cdf)
    # a round trip through the port's coder with this table
    y, scales = _draws(3)
    idx = build_indexes_from_scales(torch.from_numpy(scales), dist).numpy()
    coder = port.entropy_coder
    coder.reset()
    coder.encode_with_indexes(y, idx, cdf, length, offset)
    coder.flush()
    coder.set_stream(coder.get_encoded_stream())
    np.testing.assert_array_equal(
        coder.decode_stream(idx, cdf, length, offset).reshape(y.shape), y)


def test_refuses_an_unknown_distribution():
    with pytest.raises(ValueError):
        CompressionModel("cauchy")
    assert jax.__name__ == "jax"  # the JAX side is what the other tests hold it to
