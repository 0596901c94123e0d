"""Port parity, the bf16 instance of the conv3x3 kernel: under the JAX
package's activation policy (act_bf16) PostProcess hands the Pallas
kernel bf16 x, weights and residual with an f32 bias; the kernel
multiplies bf16 by bf16 into f32, adds bias and residual in f32 and
writes bf16. The port's bf16 plain version (what conv3x3 runs for CPU
tensors) against the Pallas kernel in interpret mode, in the kernel's
(N, H, C, W) layout at W = 128.

Limit: on every element at most one bf16 ulp of its magnitude, plus 1e-5
of the output's largest magnitude; at most 1e-3 of the elements differ
at all. The floor is the f32 accumulation's: both sides sum the 9 C
products in f32 in different orders, and where bias and residual cancel
the sum, that difference is many ulps of the tiny result (at (1, 8, 64,
64) with a residual: exact -5.2676e-6, Pallas -5.2452e-6, torch's f32
conv -4.8876e-6, 12 ulps apart). It is the floor of the float64 check of
the kernels on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from learned_pmctf_tpu.ops import pallas_conv as pc

from learned_pmctf_tpu_torch.ops import conv3x3 as c3

EPILOGUES = [(None, False), ("leaky_relu", False), (None, True), ("tanh", True)]
SHARE = 1e-3
FLOOR = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def bf16_ulp(v):
    """One bf16 ulp (8 significant bits) of |v|, elementwise."""
    m = np.maximum(np.abs(v).astype(np.float64), 1e-30)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def assert_bf16_close(port, ref, what):
    """The limit of this file (module docstring)."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, what
    diff = np.abs(port - ref)
    allowed = bf16_ulp(np.maximum(np.abs(port), np.abs(ref))) + FLOOR * np.abs(ref).max()
    worst = float((diff / allowed).max())
    share = float((diff > 0).mean())
    assert worst <= 1.0 and share <= SHARE, (what, worst, share)
    return worst, share


def pallas_vs_port(n, h, c, o, act, res, seed=0):
    g = np.random.default_rng(seed)
    x = g.normal(0, 1, (n, h, c, 128)).astype(np.float32)
    w = g.normal(0, 0.1, (o, c, 3, 3)).astype(np.float32)
    b = g.normal(0, 1, (o,)).astype(np.float32)
    r = g.normal(0, 1, (n, h, o, 128)).astype(np.float32) if res else None
    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        ref = pc.conv3x3_hcw(bf(x), bf(w), jnp.asarray(b), act=act, residual=bf(r))
    assert ref.dtype == jnp.bfloat16

    def nchw(a):
        return torch.tensor(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).bfloat16()
    got = c3.conv3x3(nchw(x), torch.tensor(w).bfloat16(), torch.tensor(b), act=act,
                     residual=None if r is None else nchw(r))
    assert got.dtype == torch.bfloat16
    return (got.float().numpy().transpose(0, 2, 1, 3),
            np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("n,h,c,o", [(1, 8, 64, 64), (2, 6, 1, 64)])
@pytest.mark.parametrize("act,res", EPILOGUES)
def test_bf16_plain_matches_pallas(n, h, c, o, act, res):
    got, ref = pallas_vs_port(n, h, c, o, act, res)
    assert_bf16_close(got, ref, (n, h, c, o, act, res))
