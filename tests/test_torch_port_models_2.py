"""Port parity, models: the lifting transforms (lossy 2e-3; lossless
within whole-step flips of under 1% and exact perfect reconstruction),
the subband context's LSTM step and the four-step context fusion
against flax, 2e-3 (the rest of these tests are in
test_torch_port_models.py, the shared helpers in torch_port_helpers.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models.context import (ContextFusionFourStep as JaxFourStep,
                                              SubbandContext as JaxSubbandContext)
from learned_pmctf_tpu.models.wavelet import LiftingScheme2D as JaxLifting2D
from learned_pmctf_tpu_torch.models.wavelet import LiftingScheme2D
from test_torch_port_models import models, _numerics
from torch_port_helpers import SMALL, assert_close, assert_rounding_close, numpy_of


@pytest.mark.parametrize("lossy", [True, False])
def test_lifting_2d_forward_backward(models, lossy):
    _, jp, port, _ = models
    x = np.random.default_rng(1).integers(0, 256, (1, 1, 64, 64)).astype(np.float32)
    sub = {"params": jp["params"]["hp_coder"]["wavelet"]}
    jm = JaxLifting2D(in_ch=1, lossy=lossy)
    ref = jm.apply(sub, jnp.asarray(x))
    lift = LiftingScheme2D(1, 8, lossy)
    lift.load_state_dict(port.hp_coder.wavelet_transform.state_dict(), strict=True)
    check = ((lambda p, r, w: assert_close(p, r, 2e-3, w)) if lossy
             else assert_rounding_close)
    with torch.no_grad():
        got = lift.forward_lift_2d(torch.tensor(x))
        for k in ("ll", "lh", "hl", "hh", "l", "h"):
            check(got[k], ref[k], f"lift2d[{k}]")
        bands = {k: numpy_of(ref[k]) for k in ("ll", "lh", "hl", "hh")}
        ref_back = jm.apply(sub, {k: jnp.asarray(v) for k, v in bands.items()},
                            method=JaxLifting2D.backward_lift_2d)
        back = lift.backward_lift_2d({k: torch.tensor(v) for k, v in bands.items()})
        check(back, ref_back, "lift2d backward")
        own = lift.backward_lift_2d({k: got[k] for k in ("ll", "lh", "hl", "hh")})
    # perfect reconstruction; exact when every increment is rounded
    assert_close(own, x, 5e-2 if lossy else 1e-6, "lift2d perfect reconstruction")


@pytest.mark.parametrize("upsample_level", [None, 0])
def test_subband_context_step(models, upsample_level):
    _, jp, port, _ = models
    g = np.random.default_rng(3)
    sb = g.normal(0, 10, (1, 1, 16, 16)).astype(np.float32)
    states = tuple(tuple(g.normal(0, 0.5, (1, c, 16, 16)).astype(np.float32)
                         for _ in range(2)) for c in (32, 32, 3))
    sub = {"params": jp["params"]["hp_coder"]["context_prediction"]}
    ref_ctx, ref_states = JaxSubbandContext(in_ch=1, decomp_levels=2).apply(
        sub, jnp.asarray(sb), jax.tree_util.tree_map(jnp.asarray, states),
        upsample_level, method=JaxSubbandContext.step)
    with torch.no_grad():
        ctx, new_states = port.hp_coder.context_prediction.step(
            torch.tensor(sb), jax.tree_util.tree_map(torch.tensor, states),
            upsample_level)
    assert_close(ctx, ref_ctx, 2e-3, "context")
    for (h, c), (rh, rc) in zip(new_states, ref_states):
        assert_close(h, rh, 2e-3, "h")
        assert_close(c, rc, 2e-3, "c")


@pytest.mark.parametrize("key", ["0_lh", "1_hh", "ll"])
def test_context_fusion_four_step(models, key):
    _, jp, port, _ = models
    g = np.random.default_rng(4)
    lvl, band = (1, "ll") if key == "ll" else (int(key[0]), key[2:])
    size = 16 if lvl == 1 else 32
    x = (g.normal(0, 6, (1, 1, size, size))).astype(np.float32)
    ctx = g.normal(0, 1, (1, 1, size, size)).astype(np.float32)
    prev = (g.normal(0, 6, (1, 1, size // 2, size // 2)).astype(np.float32)
            if lvl == 0 else None)
    use_ctx = key != "ll"
    jm = JaxFourStep(in_ch=1, ctx_ch=2 if lvl == 0 else 1,
                     features=SMALL["ar_features" if key == "ll" else "features"],
                     use_ctx=use_ctx)
    sub = {"params": jp["params"]["hp_coder"][f"context_fusion_{key}"]}
    kw = {}
    if use_ctx:
        kw = dict(context=jnp.asarray(ctx),
                  prev_subband=None if prev is None else jnp.asarray(prev))
    ref = jm.apply(sub, jnp.asarray(x), training=False, **kw)
    if use_ctx:
        kw = dict(context=torch.tensor(ctx),
                  prev_subband=None if prev is None else torch.tensor(prev))
    with torch.no_grad():
        got = port.hp_coder.context_fusion[lvl][band](torch.tensor(x), **kw)
    for name, p, r in zip(("x_res", "x_q", "x_hat", "s_hat"), got, ref):
        assert_close(p, r, 2e-3, name)
