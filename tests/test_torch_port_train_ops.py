"""Port parity, training ops: the STE and noise primitives and (in
test_torch_port_train_ops_2.py) the separable warp against the JAX
package; and, port only, where the
bilinear warp's derivative in the flow jumps (integer flow), which the
GOP train step meets at the seeded init.

Tolerances: quant_ste exact; the warp 1e-5 (an f32 blend of two
samples), output and both gradients; the jump test's bounds are stated
there.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.ops.quant import quant_ste as jax_quant_ste

from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
from learned_pmctf_tpu_torch.ops.quant import add_uniform_noise, quant_ste
from learned_pmctf_tpu_torch.training.steps import StageGates, pmctf_gop_loss
from test_torch_port_gop import synthetic_frames
from torch_port_helpers import SMALL

# output biases of the MV decoders' last layer: a sub-pixel decoded motion
MV_OFFSET = (0.37, -0.29, 0.43, -0.21, 0.31, -0.41, 0.23, -0.33)


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


# ---- quantization primitives ---------------------------------------------

def test_quant_ste_matches_jax():
    x = np.random.default_rng(0).normal(0, 4, (3, 5)).astype(np.float32)
    x[0, :3] = (0.5, 1.5, -2.5)  # ties round to even in both
    ct = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    for training in (True, False):
        xt = torch.tensor(x, requires_grad=True)
        y = quant_ste(xt, training)
        (y * torch.tensor(ct)).sum().backward()
        ref, ref_vjp = jax.vjp(lambda v: jax_quant_ste(v, training), jnp.asarray(x))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ref))
        np.testing.assert_array_equal(xt.grad.numpy(),
                                      np.asarray(ref_vjp(jnp.asarray(ct))[0]))


def test_add_uniform_noise():
    x = torch.randn(4, 6, requires_grad=True)
    n = (torch.rand(4, 6) - 0.5).requires_grad_()
    y = add_uniform_noise(x, n)
    assert torch.equal(y, x + n)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x)) and n.grad is None
    a = add_uniform_noise(torch.zeros(1000), torch.Generator().manual_seed(3))
    b = add_uniform_noise(torch.zeros(1000), torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and float(a.min()) >= -0.5 and float(a.max()) < 0.5
    assert abs(float(a.mean())) < 0.05


# ---- the separable warp ----------------------------------------------------


# ---- the warp's derivative at integer flow -----------------------------------

def _spynet_grads(offset):
    """float64 gradients of the small model's GOP-2 train loss (batch 1,
    no noise) in SpyNet, the MV decoders' output biases moved by
    `offset`."""
    model = build_pmctf("cpu", seed=1, **SMALL).double()
    for coder in (model.lp_coder, model.hp_coder):
        coder.dequantModule.use_kernel = False
    with torch.no_grad():
        for dec in model.mv_decoder:
            dec.dec_3[1][0].bias += torch.tensor(offset, dtype=torch.float64)
    luma, _ = synthetic_frames(2)
    loss, _ = pmctf_gop_loss(model, [torch.tensor(f, dtype=torch.float64) for f in luma],
                             10.0, 0.05, StageGates.for_stage(5))
    loss.backward()
    return {k: p.grad.clone() for k, p in model.optic_flow.named_parameters()}


@pytest.mark.parametrize("at", ["init", "sub_pixel"])
def test_motion_gradients_jump_at_integer_flow(at):
    """At the seeded init the decoded motion is exactly 0 (every MV latent
    rounds to 0, the decoder's biases are 0), so the warp samples at
    integer coordinates, where bilinear interpolation's derivative in the
    flow jumps. Moving the decoded motion by 1e-9 there moves SpyNet's
    float64 gradients by more than a tenth of their largest magnitude;
    at a sub-pixel motion (the biases moved by MV_OFFSET) by less than
    1e-6 of it. The card and the CPU may take either side of such a jump,
    so chip_smoke.py holds their float64 gradients at the sub-pixel
    motion."""
    base = (0.0,) * 8 if at == "init" else MV_OFFSET
    a = _spynet_grads(base)
    b = _spynet_grads(tuple(v + 1e-9 for v in base))
    top = max(float(v.abs().max()) for v in a.values())
    jump = max(float((a[k] - b[k]).abs().max()) for k in a) / top
    if at == "init":
        assert jump > 0.1, jump
    else:
        assert jump < 1e-6, jump
