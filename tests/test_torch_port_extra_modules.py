"""Port parity, the modules no model builds: PostProcessCtx and the
layers_extra convs (DynamicDWConv, MaskedDynamicDWConv, ConditionalConv,
Conv3d, each with and without its causal mask), against flax with the
same weights, carried across by convert.module_params_from_jax.

Weights are numpy draws (std 0.05, biases and norm parameters too) into
the parameter trees flax builds (names and shapes from jax.eval_shape of
init). Tolerance: 1e-5 of the larger of 1 and the output's largest
magnitude (f32 sums in different orders; PostProcessCtx's 15 64-channel
convs on a 16x24 plane).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models import layers_extra as jextra
from learned_pmctf_tpu.models.postprocess import PostProcessCtx as JaxPostProcessCtx

from learned_pmctf_tpu_torch.convert import module_params_from_jax
from learned_pmctf_tpu_torch.models import layers_extra as extra
from learned_pmctf_tpu_torch.models.postprocess import PostProcessCtx
from torch_port_helpers import numerics  # noqa: F401

TOL = 1e-5


def run_both(jax_module, port_module, *inputs, seed=0):
    """Draw flax params, carry them to the port module (strict), and run
    both on the same inputs; returns [(port, flax)] output pairs."""
    jin = [jnp.asarray(x) for x in inputs]
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *jin)
    g = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: g.normal(0, 0.05, s.shape).astype(np.float32), shapes)
    ref = jax_module.apply(params, *jin)
    port_module.load_state_dict(module_params_from_jax(port_module, params), strict=True)
    with torch.no_grad():
        got = port_module(*[torch.from_numpy(x) for x in inputs])
    if isinstance(got, tuple):
        return list(zip(got, ref))
    return [(got, ref)]


def assert_close(pairs, what):
    for got, ref in pairs:
        ref = np.asarray(ref)
        err = float(np.max(np.abs(got.numpy() - ref)))
        assert got.shape == ref.shape, (what, got.shape, ref.shape)
        assert err <= TOL * max(1.0, float(np.max(np.abs(ref)))), (what, err)


def test_postprocess_ctx_matches_jax():
    g = np.random.default_rng(1)
    x = g.normal(0, 1, (2, 1, 16, 24)).astype(np.float32)
    ctx = g.normal(0, 1, (2, 64, 16, 24)).astype(np.float32)
    port = PostProcessCtx()
    pairs = run_both(JaxPostProcessCtx(), port, x, ctx)
    assert_close(pairs, "PostProcessCtx")
    assert pairs[0][0].shape == (2, 64, 16, 24)  # (feature, x + t)
    # no kernel route: a plain module of stock convs, 1 + 6 * 2 + 2 of them
    assert sum(isinstance(m, torch.nn.Conv2d) for m in port.modules()) == 15


@pytest.mark.parametrize("mask_type", ["", "A", "B"])
def test_dynamic_dw_conv_matches_jax(mask_type):
    x = np.random.default_rng(2).normal(0, 1, (2, 8, 12, 10)).astype(np.float32)
    if mask_type:
        jm = jextra.MaskedDynamicDWConv(8, mask_type=mask_type)
        pm = extra.MaskedDynamicDWConv(8, mask_type=mask_type)
    else:
        jm, pm = jextra.DynamicDWConv(8), extra.DynamicDWConv(8)
    assert_close(run_both(jm, pm, x), f"DynamicDWConv {mask_type}")
    if mask_type:  # each sample's generated kernel is causal
        with torch.no_grad():
            k = pm.kernels(torch.from_numpy(x))
        assert not bool(k[..., 1, 2].any()) and not bool(k[..., 2, :].any())


@pytest.mark.parametrize("mask_type", ["", "A"])
def test_conditional_conv_matches_jax(mask_type):
    g = np.random.default_rng(3)
    x = g.normal(0, 1, (2, 8, 12, 10)).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[[1, 4]]
    jm = jextra.ConditionalConv(8, 6, mask_type=mask_type)
    pm = extra.ConditionalConv(8, 6, mask_type=mask_type)
    assert_close(run_both(jm, pm, x, onehot), f"ConditionalConv {mask_type}")


@pytest.mark.parametrize("mask_type", ["", "B"])
def test_conv3d_matches_jax(mask_type):
    x = np.random.default_rng(4).normal(0, 1, (2, 4, 5, 8, 6)).astype(np.float32)
    jm = jextra.Conv3d(4, 6, mask_type=mask_type)
    pm = extra.Conv3d(4, 6, mask_type=mask_type)
    assert_close(run_both(jm, pm, x), f"Conv3d {mask_type}")
    if mask_type:
        assert not bool(pm.mask[:, :, 2].any()) and bool(pm.mask[:, :, 0].all())
