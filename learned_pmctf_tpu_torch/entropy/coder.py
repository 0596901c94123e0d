"""Host-side entropy coding facades and CDF table construction.

Counterpart of learned_pmctf_tpu/entropy/coder.py: the device/host
boundary of the bitstream path. The device computes symbol and scale
planes; these classes marshal them (int16, clipped) into the port's rANS
library (``native``). The CDF tables are built once on the host, in f32,
by the JAX package's construction. Its f32 CDFs come from XLA's own CPU
``expm1``/``tanh``/``log``, which torch (and numpy) match only to an ulp:
where an ulp moves a rounding, a row of a table moves by a few of 2^16
(tests/test_torch_port_entropy.py states the allowances).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import native
from .distributions import gaussian_cdf, laplace_cdf

PRECISION = 16
SCALE_LEVELS = 256
SCALE_MIN, SCALE_MAX = 0.01, 64.0  # the Laplace scale table's range
GAUSSIAN_SCALE_MIN = 0.11  # the Gaussian table's lower end (same top)
SYMBOL_CLIP = 30000  # symbols leave for rANS as int16, clipped to this


def _scale_bounds(distribution: str):
    if distribution == "laplace":
        return SCALE_MIN, SCALE_MAX
    if distribution == "gaussian":
        return GAUSSIAN_SCALE_MIN, SCALE_MAX
    raise ValueError(f"unknown distribution {distribution!r}")


def build_indexes_from_scales(scales: torch.Tensor,
                              distribution: str = "laplace") -> torch.Tensor:
    """Map scale planes to CDF-table indices (of the Laplace table unless
    `distribution` says "gaussian"), on the tensor's device.

    Truncates like the reference's ``.int()`` (the values are >= 0 after
    the clip, so truncation is floor). ``log`` is the device's: CUDA's may
    differ from the CPU's by an ulp and move an index near an integer
    boundary, so a stream written on one device decodes only on a device
    of the same kind, never across (nor do streams of the JAX package
    decode here).
    """
    smin, smax = _scale_bounds(distribution)
    log_min = math.log(smin)
    step = (math.log(smax) - log_min) / (SCALE_LEVELS - 1)
    idx = (torch.log(torch.clamp_min(scales, 1e-5)) - log_min) / step
    return torch.clamp(idx, 0, SCALE_LEVELS - 1).to(torch.int32)


class EntropyCoder:
    """Facade over one native rANS encoder/decoder pair."""

    def __init__(self, ec_thread: bool = False, stream_part: int = 1):
        self.encoder = native.RansEncoder(ec_thread, stream_part)
        self.decoder = native.RansDecoder(stream_part)

    def reset(self):
        self.encoder.reset()

    def encode_with_indexes(self, symbols, indexes, cdf, cdf_length, offset):
        symbols = np.asarray(symbols).reshape(-1)
        symbols = np.clip(symbols, -SYMBOL_CLIP, SYMBOL_CLIP).astype(np.int16)
        indexes = np.asarray(indexes).reshape(-1).astype(np.int16)
        self.encoder.encode_with_indexes(symbols, indexes, cdf, cdf_length, offset)

    def flush(self):
        self.encoder.flush()

    def get_encoded_stream(self) -> bytes:
        return self.encoder.get_encoded_stream()

    def set_stream(self, stream: bytes):
        self.decoder.set_stream(stream)

    def decode_stream(self, indexes, cdf, cdf_length, offset) -> np.ndarray:
        indexes = np.asarray(indexes).reshape(-1).astype(np.int16)
        return self.decoder.decode_stream(indexes, cdf, cdf_length, offset)


def pmf_to_cdf_table(pmfs, tail_mass, pmf_lengths, max_length) -> np.ndarray:
    """Stack per-row quantized CDFs into one (N, max_length+2) table."""
    n = len(pmf_lengths)
    table = np.zeros((n, max_length + 2), dtype=np.int32)
    for i in range(n):
        prob = np.concatenate(
            [pmfs[i, : pmf_lengths[i]], np.atleast_1d(tail_mass[i])]
        ).astype(np.float32)
        cdf = native.pmf_to_quantized_cdf(prob, PRECISION)
        table[i, : cdf.size] = cdf
    return table


def _laplace_cdf_f32(x, scales) -> np.ndarray:
    """The Laplace CDF in f32 on the CPU (torch's ``expm1``), in the
    precision the JAX package (and the reference) build the tables in."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    scales = torch.as_tensor(np.asarray(scales, np.float32))
    return laplace_cdf(x, scales).numpy()


def _gaussian_cdf_f32(x, scales) -> np.ndarray:
    """The Gaussian CDF in f32 on the CPU (torch's ``erf``)."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    scales = torch.as_tensor(np.asarray(scales, np.float32))
    return gaussian_cdf(x, scales).numpy()


class GaussianEncoder:
    """Scale-indexed coder over a 256-entry log scale table: the Laplace
    table the codecs use, or with distribution="gaussian" the Gaussian
    one (CompressionModel's option)."""

    def __init__(self, distribution: str = "laplace"):
        smin, smax = _scale_bounds(distribution)
        self.distribution = distribution
        self.scale_table = np.exp(
            np.linspace(math.log(smin), math.log(smax), SCALE_LEVELS))
        self._cdf = None
        self._cdf_length = None
        self._offset = None

    def update(self, force: bool = False):
        if not force and self._offset is not None:
            return
        scales = self.scale_table
        # smallest i in [2, 50] with cdf(i) > 0.9999, else 50
        probe = np.arange(2, 51, dtype=np.float64)
        cdf_fn = (_laplace_cdf_f32 if self.distribution == "laplace"
                  else _gaussian_cdf_f32)
        cdf_at_i = cdf_fn(probe[None, :], scales[:, None])
        hit = cdf_at_i > 0.9999
        pmf_center = np.where(hit.any(axis=1), probe[hit.argmax(axis=1)], 50.0)
        pmf_center = pmf_center.astype(np.int32)

        pmf_length = 2 * pmf_center + 1
        max_length = int(pmf_length.max())
        samples = np.arange(max_length, dtype=np.float64)[None, :] - pmf_center[:, None]
        upper = cdf_fn(samples + 0.5, scales[:, None])
        lower = cdf_fn(samples - 0.5, scales[:, None])
        pmf = (upper - lower).astype(np.float32)
        tail_mass = (2.0 * lower[:, :1]).astype(np.float32).reshape(-1)

        self._cdf = pmf_to_cdf_table(pmf, tail_mass, pmf_length, max_length)
        self._cdf_length = (pmf_length + 2).astype(np.int32)
        self._offset = (-pmf_center).astype(np.int32)

    def tables(self):
        """(cdf, cdf_length, offset), the arguments of the coder calls."""
        return self._cdf, self._cdf_length, self._offset


def build_bit_estimator_tables(cdf_fn, channels: int):
    """CDF tables for a factorized BitEstimator.

    cdf_fn maps a (1, C, 1, L) f32 numpy array to its CDF values of the
    same shape (``BitEstimator.get_cdf`` on the CPU). Returns
    (cdf_table, cdf_length, offset) numpy arrays.
    """
    probe = np.arange(2, 51, dtype=np.float32)
    ones = np.ones((1, channels, 1, 1), np.float32)

    neg = np.asarray(cdf_fn(-probe[None, None, None, :] * ones)).reshape(channels, -1)
    hit = neg < 1e-4
    minima = np.where(hit.any(axis=1), probe[hit.argmax(axis=1)], 50.0).astype(np.int32)

    pos = np.asarray(cdf_fn(probe[None, None, None, :] * ones)).reshape(channels, -1)
    hit = pos > 0.9999
    maxima = np.where(hit.any(axis=1), probe[hit.argmax(axis=1)], 50.0).astype(np.int32)

    offset = -minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())

    samples = (np.arange(max_length, dtype=np.float32)[None, :]
               - minima[:, None].astype(np.float32))
    s = samples[None, :, None, :]
    upper = np.asarray(cdf_fn(s + np.float32(0.5))).reshape(channels, -1)
    lower = np.asarray(cdf_fn(s - np.float32(0.5))).reshape(channels, -1)
    pmf = upper - lower

    rows = np.arange(channels)
    tail_mass = lower[rows, 0] + (1.0 - upper[rows, pmf_length - 1])

    cdf_table = pmf_to_cdf_table(pmf, tail_mass, pmf_length, max_length)
    return cdf_table, (pmf_length + 2).astype(np.int32), offset.astype(np.int32)


class FactorizedCoder:
    """Host-side coder for factorized latents (one CDF per channel): the
    symbol indexes are the channel ids."""

    def __init__(self, cdf, cdf_length, offset, channels: int):
        self._cdf = cdf
        self._cdf_length = cdf_length
        self._offset = offset
        self.channels = channels

    def tables(self):
        return self._cdf, self._cdf_length, self._offset

    @staticmethod
    def build_indexes(shape):
        n, c, h, w = shape
        idx = np.arange(c, dtype=np.int16).reshape(1, -1, 1, 1)
        return np.broadcast_to(idx, (n, c, h, w))

    def encode(self, coder: EntropyCoder, x):
        x = np.asarray(x)
        coder.encode_with_indexes(x, self.build_indexes(x.shape), *self.tables())

    def decode_stream(self, coder: EntropyCoder, size) -> np.ndarray:
        h, w = size
        shape = (1, self.channels, h, w)
        vals = coder.decode_stream(self.build_indexes(shape), *self.tables())
        return vals.reshape(shape).astype(np.float32)
