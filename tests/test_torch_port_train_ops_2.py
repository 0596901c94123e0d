"""Port parity, training ops: the separable fast warp against the JAX
package, 1e-5, output and both gradients (the rest of these tests are
in test_torch_port_train_ops.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.ops.warp import flow_warp_fast as jax_flow_warp_fast
from learned_pmctf_tpu_torch.ops.warp import flow_warp_fast
from test_torch_port_train_ops import _numerics


def _warp_case(name):
    """The inputs of tests/test_warp_fast.py, by test name."""
    g = np.random.default_rng(0)
    if name == "identity":
        return g.normal(size=(1, 1, 16, 24)), np.zeros((1, 2, 16, 24)), 4
    if name == "constant":
        f = np.full((2, 2, 32, 48), 2.6)
        f[:, 1] = -1.4
        return g.normal(size=(2, 1, 32, 48)), f, 8
    if name == "smooth_fy":
        fy = np.tile(np.linspace(-3, 3, 32)[None, None, :, None], (1, 1, 1, 48))
        fx = g.normal(size=(1, 1, 32, 48)) * 2
        return g.normal(size=(1, 1, 32, 48)), np.concatenate([fx, fy], 1), 8
    if name == "clamped":
        return g.normal(size=(1, 1, 16, 16)), np.full((1, 2, 16, 16), 100.0), 4
    if name == "grads":
        return g.normal(size=(1, 1, 16, 16)), np.full((1, 2, 16, 16), 0.3), 4
    # rough motion across channels and both clamps
    return g.normal(size=(2, 3, 20, 28)), g.normal(0, 6, (2, 2, 20, 28)), 5


@pytest.mark.parametrize("name", ["identity", "constant", "smooth_fy",
                                  "clamped", "grads", "rough"])
def test_flow_warp_fast_matches_jax(name):
    """Output and the gradients for feature and flow of a random
    cotangent, 1e-5."""
    x, f, d = (a.astype(np.float32) if isinstance(a, np.ndarray) else a
               for a in _warp_case(name))
    ct = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    @jax.jit
    def jax_warp_vjp(a, b, cot):
        out, vjp = jax.vjp(lambda u, v: jax_flow_warp_fast(u, v, d), a, b)
        return out, vjp(cot)

    ref, (ref_dx, ref_df) = jax_warp_vjp(jnp.asarray(x), jnp.asarray(f),
                                         jnp.asarray(ct))
    xt, ft = torch.tensor(x, requires_grad=True), torch.tensor(f, requires_grad=True)
    y = flow_warp_fast(xt, ft, d)
    y.backward(torch.tensor(ct))
    for what, a, e in (("out", y.detach(), ref), ("d_feature", xt.grad, ref_dx),
                       ("d_flow", ft.grad, ref_df)):
        err = float(np.max(np.abs(a.numpy() - np.asarray(e))))
        assert err <= 1e-5, (name, what, err)
