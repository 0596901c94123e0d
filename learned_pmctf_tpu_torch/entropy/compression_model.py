"""CompressionModel: the reference's facade over quantization, bit
estimation and the entropy coder.

Counterpart of learned_pmctf_tpu/entropy/compression_model.py. The pieces
are the port's own functions (ops/quant.py, entropy/distributions.py,
entropy/coder.py); this class puts them behind the reference's surface.
No model of either package builds it, and it has no parameters.
"""

from __future__ import annotations

from typing import Optional

from ..ops.quant import add_uniform_noise, quant_ste
from .coder import EntropyCoder, GaussianEncoder
from .distributions import gaussian_bits, laplace_bits, probs_to_bits


class CompressionModel:
    """Laplace or Gaussian rate model and, after ``update``, a real
    entropy coder with the matching CDF table."""

    def __init__(self, y_distribution: str = "laplace",
                 ec_thread: bool = False, stream_part: int = 1):
        if y_distribution not in ("laplace", "gaussian"):
            raise ValueError(f"unknown y_distribution {y_distribution!r}")
        self.y_distribution = y_distribution
        self.ec_thread = ec_thread
        self.stream_part = stream_part
        self.entropy_coder: Optional[EntropyCoder] = None
        self.gaussian_encoder = GaussianEncoder(distribution=y_distribution)

    @staticmethod
    def quant(x, training: bool = True):
        return quant_ste(x, training)

    @staticmethod
    def process(y, means, training: bool = True):
        """Quantize y, then take the residual from the predicted means:
        (y_res, y_q, y_hat)."""
        y_q = quant_ste(y, training)
        y_res = y_q - means
        return y_res, y_q, y_res + means

    @staticmethod
    def add_noise(x, noise):
        """x plus uniform noise in [-0.5, 0.5): a tensor of it, or a
        torch.Generator to draw it from."""
        return add_uniform_noise(x, noise)

    @staticmethod
    def probs_to_bits(probs):
        return probs_to_bits(probs)

    def get_y_bits(self, y, scales):
        if self.y_distribution == "laplace":
            return laplace_bits(y, scales)
        return gaussian_bits(y, scales)

    get_y_laplace_bits = staticmethod(laplace_bits)
    get_y_gaussian_bits = staticmethod(gaussian_bits)

    @staticmethod
    def get_z_bits(z, cdf):
        """Bits of integer z under a factorized CDF: `cdf` maps x to
        P(Z <= x), e.g. a BitEstimator's get_cdf."""
        return probs_to_bits(cdf(z + 0.5) - cdf(z - 0.5))

    def update(self, force: bool = False):
        """Make the entropy coder (once) and build the CDF table."""
        if self.entropy_coder is None:
            self.entropy_coder = EntropyCoder(self.ec_thread, self.stream_part)
        self.gaussian_encoder.update(force=force)
