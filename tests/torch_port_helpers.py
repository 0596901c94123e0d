"""Helpers shared by the port's parity tests (tests/test_torch_port_*.py):
the small pMCTF-L configuration, its flax parameter draw and the port
model built from it, seeded frames, and the comparisons.

Small config (as tests/test_models.py): decomp_levels=2,
num_me_stages=2, channel_mv=8, channel_n=8, features=16, ar_features=16,
64x64 luma, 32x32 chroma. The flax side runs eagerly on the CPU.

Weights: the parameter tree is the one flax builds (its names and shapes
come from jax.eval_shape of PMCTF.init over full_init_graph); the values
are numpy draws from the distributions of flax's initializers, with
non-zero biases and perturbed scales so that every parameter matters.
(A jitted flax init of this model takes minutes to compile on the CPU.)
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models import PMCTF as JaxPMCTF
from learned_pmctf_tpu.ops.lifting import CDF97_COEFFS

from learned_pmctf_tpu_torch.convert import params_from_jax
from learned_pmctf_tpu_torch.models.pmctf import build_pmctf, empty_dpb


@pytest.fixture(scope="module", autouse=True)
def numerics():
    """Highest matmul precision on the JAX side, two torch threads (one
    fixture a test module that imports it)."""
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


SMALL = dict(decomp_levels=2, num_me_stages=2, channel_mv=8, channel_n=8,
             features=16, ar_features=16)


_SKIP_TAPS = {"conv_p1": (0.0, CDF97_COEFFS[0], CDF97_COEFFS[0]),
              "conv_u1": (CDF97_COEFFS[1], CDF97_COEFFS[1], 0.0),
              "conv_p2": (0.0, CDF97_COEFFS[2], CDF97_COEFFS[2]),
              "conv_u2": (CDF97_COEFFS[3], CDF97_COEFFS[3], 0.0)}


_SCALES = {"scale_l": CDF97_COEFFS[5], "scale_h": CDF97_COEFFS[4],
           "scale_p": 1.0 / np.sqrt(2.0), "scale_u": 0.5}


def jax_small_model(**config):
    """The small JAX PMCTF; `config` overrides SMALL and the defaults."""
    kw = dict(dict(ll_mode="fourstep", warp_mode="exact", spynet_luma=True),
              **SMALL)
    return JaxPMCTF(**dict(kw, **config))


def _draw(path, shape, g):
    name, parent = path[-1], path[-2] if len(path) > 1 else ""
    if name == "kernel" and parent in _SKIP_TAPS:
        return (np.asarray(_SKIP_TAPS[parent]).reshape(shape)
                + g.normal(0, 0.01, shape))
    if name == "kernel":
        return np.clip(g.normal(0, 0.0227, shape), -0.0455, 0.0455)
    if name == "bias":
        return g.normal(0, 0.02, shape)
    if name in ("QP", "QP_ll"):
        return np.exp(np.log(1 / 16) + g.normal(0, 0.3, shape))
    if name in ("hp_q_scale", "mv_y_q_scale_enc", "mv_y_q_scale_dec"):
        return np.exp(g.normal(0, 0.1, shape))
    if name in _SCALES:
        return np.full(shape, _SCALES[name] * (1 + g.normal(0, 0.01)))
    if name in ("h", "b", "a"):  # BitEstimator
        return g.normal(0, 0.01, shape)
    raise KeyError(path)


@functools.lru_cache(maxsize=None)
def small_shapes(**config):
    """The flax parameter tree's shapes of jax_small_model(**config), once
    a process (tracing the init takes tens of seconds)."""
    x = jnp.zeros((1, 1, 64, 64), jnp.float32)
    return jax.eval_shape(lambda: jax_small_model(**config).init(
        {"params": jax.random.PRNGKey(0)}, x, x, 10, empty_dpb(),
        method=JaxPMCTF.full_init_graph))


def jax_small_params(seed=0, **config):
    """{"params": tree} of numpy arrays for jax_small_model(**config)."""
    shapes = small_shapes(**config)
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(tuple(str(k.key) for k in p), s.shape, g)
        .astype(np.float32), shapes)


def port_small_model(params):
    model = build_pmctf(device="cpu", **SMALL)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def frames(seed, luma=(1, 1, 64, 64), chroma=(2, 1, 32, 32)):
    """A luma pair and a chroma pair of 8-bit planes, cur = ref + noise."""
    g = np.random.default_rng(seed)
    out = []
    for shape in (luma, chroma):
        ref = g.integers(0, 256, shape).astype(np.float32)
        cur = np.clip(ref + g.normal(0, 8, shape), 0, 255).astype(np.float32)
        out.append((ref, cur))
    return out


def numpy_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def assert_close(port, ref, tol, what):
    err = float(np.max(np.abs(numpy_of(port) - numpy_of(ref))))
    assert err < tol, (what, err, tol)


def assert_rel(port, ref, tol, what, floor=1.0):
    p, r = float(numpy_of(port)), float(numpy_of(ref))
    assert abs(p - r) <= tol * max(abs(r), floor), (what, p, r)


def assert_rounding_close(port, ref, what, share=0.01):
    """Lossless paths round every lifting increment: where an increment
    lies within float noise of a half, the two frameworks may round it
    apart. Such flips are whole steps and rare."""
    d = np.abs(numpy_of(port) - numpy_of(ref))
    assert np.all(np.abs(d - np.round(d)) < 2e-3), (what, float(d.max()))
    assert np.mean(d > 1e-3) < share, (what, float(np.mean(d > 1e-3)))
