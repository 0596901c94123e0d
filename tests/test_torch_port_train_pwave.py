"""Port parity, the pWave training forward and its gradients:
PWave.forward(training=True) against the JAX package's PWave at the
config of tests/test_training.py's pWave step (decomp_levels=2,
features=8, ar_features=8, a 2x1x32x32 batch of 8-bit planes), for each
LL mode. The loss is make_pwave_train_step's (lmbda * mse + the batch's
bits over B*H*W); the JAX side is jax.value_and_grad of it under
jax.jit, on the CPU (one compile a mode, which the persistent
compilation cache of tests/conftest.py keeps for later runs). Batch 2: the bits are reduced over the batch, which batch 1
would not show.

Weights as in test_torch_port_models: flax's parameter tree (from
jax.eval_shape of PWave.init) filled with numpy draws.

Tolerances: the loss rel 1e-4. A gradient is a sum over every pixel
of the batch of terms that cancel, and in f32 the port resolves some of
them only to a few percent of their own size (the entropy heads'
biases, the deep lifting steps). So each parameter's gradient is held
to the larger of 2e-3 of the largest gradient magnitude in its module
group (the lifting, the LSTM context, each subband's prior, PostProcess,
each QP) and 3 times the port's own f32 error on it, measured against
the same port run in float64 (PostProcess on its plain version there:
the conv3x3 wrapper takes f32 only); and to no more than the larger of
a tenth of its own largest magnitude and that 3 times its own error, so
that a gradient small in its group cannot pass with any value (JAX's
f32 resolved the cancelling ones here to 3.2% of their own size). A port
that differed from JAX by more than f32 noise fails either way.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models.pwave import PWave as JaxPWave

from learned_pmctf_tpu_torch.convert import jax_paths, pwave_params_from_jax
from learned_pmctf_tpu_torch.models.pwave import PWave
from torch_port_helpers import _draw

CFG = dict(decomp_levels=2, features=8, ar_features=8)
SHAPE = (2, 1, 32, 32)
Q, LMBDA = 10.0, 0.01
LOSS_REL = 1e-4
GRAD_REL = 2e-3
NOISE_X = 3.0
OWN_REL = 0.1


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


def jax_pwave_params(ll_mode, seed=0):
    x = jnp.zeros(SHAPE, jnp.float32)
    shapes = jax.eval_shape(lambda: JaxPWave(ll_mode=ll_mode, **CFG).init(
        jax.random.PRNGKey(0), x, 10))
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(tuple(str(k.key) for k in p), s.shape, g)
        .astype(np.float32), shapes)


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree["params"])[0]}


@pytest.mark.parametrize("ll_mode", ["fourstep", "ar"])
def test_pwave_train_loss_and_every_gradient_match_jax(ll_mode):
    params = jax_pwave_params(ll_mode)
    x = np.random.default_rng(1).integers(0, 256, SHAPE).astype(np.float32)
    module = JaxPWave(ll_mode=ll_mode, **CFG)
    n, _, h, w = SHAPE

    def loss_fn(p):  # make_pwave_train_step's loss
        out = module.apply(p, jnp.asarray(x), jnp.float32(Q))
        bpp = jnp.sum(out["bits"]) / (n * h * w)
        return LMBDA * out["mse"] + bpp, (out["mse"], bpp)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    (ref_loss, (ref_mse, ref_bpp)), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp)

    port = {}
    for dtype in (torch.float32, torch.float64):
        model = PWave(ll_mode=ll_mode, **CFG)
        model.load_state_dict(pwave_params_from_jax(params), strict=True)
        model = model.to(dtype)
        model.dequantModule.use_kernel = dtype == torch.float32
        out = model(torch.tensor(x, dtype=dtype), Q, training=True)
        bpp = out["bits"].sum() / (n * h * w)
        loss = LMBDA * out["mse"] + bpp
        loss.backward()
        port[dtype] = (model, out, bpp, loss)
    model, out, bpp, loss = port[torch.float32]
    assert float(out["bpp_total"].detach()) == float(bpp.detach())

    for what, got, want in (("loss", loss, ref_loss), ("mse", out["mse"], ref_mse),
                            ("bpp", bpp, ref_bpp)):
        assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want)), (
            what, float(got), float(want))
    flat, paths = _flat(ref_grads), jax_paths(params, pwave=True)
    grads64 = dict(port[torch.float64][0].named_parameters())
    group_max = {}
    for name, p in model.named_parameters():
        group_max[_group(name)] = max(group_max.get(_group(name), 0.0),
                                      float(p.grad.abs().max()))
    loose = []
    for name, p in model.named_parameters():
        # every parameter of the coder is reached by the loss
        assert p.grad is not None, name
        got = p.grad.double().numpy()
        want = flat[paths[name]].reshape(got.shape)
        own = float(np.max(np.abs(got - grads64[name].grad.numpy())))
        err = float(np.max(np.abs(got - want)))
        tol = grad_tol(GRAD_REL * group_max[_group(name)], own, want)
        assert err <= tol, (ll_mode, name, err, tol)
        if np.any(want != 0) and tol >= float(np.max(np.abs(want))):
            loose.append(name)
    print(f"{ll_mode}: {len(loose)} reached gradients held to a tolerance at or "
          f"above their own largest magnitude (the port's own f32 error): {loose}")


def grad_tol(floor, own, want):
    """A gradient's tolerance: the larger of `floor` (its share of the
    group's largest magnitude) and NOISE_X times the port's own f32 error
    `own`, capped at the larger of OWN_REL of its own largest magnitude
    and that multiple of `own`."""
    mine = NOISE_X * own
    return min(max(floor, mine), max(OWN_REL * float(np.max(np.abs(want))), mine))


def _group(name):
    """Module group of a parameter: each subband's prior on its own."""
    parts = name.split(".")
    return ".".join(parts[:3]) if parts[0] == "context_fusion" else parts[0]
