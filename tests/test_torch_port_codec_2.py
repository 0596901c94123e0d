"""Port parity, the codecs' model sub-graphs (PWave's quantize and
reconstruct, its context steps, the four-step fusion parameters, the MV
sub-graphs) against flax; tolerances as in test_torch_port_codec.py,
which holds the helpers and the round trips.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models import PMCTF as JaxPMCTF
from learned_pmctf_tpu.models.context import ContextFusionFourStep as JaxFourStep
from learned_pmctf_tpu.models.pwave import PWave as JaxPWave
from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
from torch_port_helpers import SMALL, assert_close, frames, numpy_of
from test_torch_port_codec import (Q, jax_pwave, models, t, _numerics)


def test_pwave_quantize_planes_and_reconstruct(models):
    _, jp, port = models
    sub = {"params": jp["params"]["hp_coder"]}
    x = np.random.default_rng(5).normal(0, 30, (2, 1, 64, 64)).astype(np.float32)
    qp = np.float32(0.8)
    ref = jax_pwave().apply(sub, jnp.asarray(x), jnp.float32(Q), qp,
                            method=JaxPWave.quantize_planes)
    with torch.no_grad():
        got = port.hp_coder.quantize_planes(torch.tensor(x), Q, torch.tensor(qp))
    assert list(got) == list(ref)  # coding order
    for key in ref:
        assert_close(got[key], ref[key], 2e-3, f"quantize_planes[{key}]")

    g = np.random.default_rng(6)
    sb = {lvl: {band: np.round(g.normal(0, 4, (1, 1, 32 >> lvl, 32 >> lvl)))
                .astype(np.float32) for band in ("lh", "hl", "hh")}
          for lvl in range(2)}
    sb[1]["ll"] = np.round(g.normal(0, 40, (1, 1, 16, 16))).astype(np.float32)
    for qps in (None, qp):
        ref = jax_pwave().apply(
            sub, jax.tree_util.tree_map(jnp.asarray, sb), jnp.float32(Q), qps,
            method=JaxPWave.reconstruct)
        with torch.no_grad():
            got = port.hp_coder.reconstruct(
                jax.tree_util.tree_map(torch.tensor, sb), Q,
                None if qps is None else torch.tensor(qps))
        assert_close(got, ref, 2e-2, f"reconstruct[qp={qps}]")


@pytest.mark.parametrize("upsample_level", [None, 0])
def test_pwave_ctx_init_and_step(models, upsample_level):
    _, jp, port = models
    sub = {"params": jp["params"]["lp_coder"]}
    sb = np.random.default_rng(7).normal(0, 10, (1, 1, 16, 16)).astype(np.float32)
    states = jax_pwave().apply(sub, jnp.asarray(sb), method=JaxPWave.ctx_init)
    ref_ctx, ref_states = jax_pwave().apply(sub, jnp.asarray(sb), states, None,
                                            method=JaxPWave.ctx_step)
    ref_ctx, ref_states = jax_pwave().apply(sub, ref_ctx[:, :1], ref_states,
                                            upsample_level, method=JaxPWave.ctx_step)
    with torch.no_grad():
        p_states = port.lp_coder.ctx_init(torch.tensor(sb))
        for s in jax.tree_util.tree_leaves(p_states):
            assert s.shape[2:] == (16, 16) and not s.any()
        ctx, p_states = port.lp_coder.ctx_step(torch.tensor(sb), p_states)
        ctx, p_states = port.lp_coder.ctx_step(ctx[:, :1], p_states, upsample_level)
    assert_close(ctx, ref_ctx, 2e-3, "ctx_step context")
    for p, r in zip(jax.tree_util.tree_leaves(p_states),
                    jax.tree_util.tree_leaves(ref_states)):
        assert p.shape == r.shape
        assert_close(p, r, 2e-3, "ctx_step state")


@pytest.mark.parametrize("key", ["0_hl", "1_lh", "ll"])
def test_fusion_hier_and_spatial_params(models, key):
    """The four-step passes as the codec runs them, one at a time, with
    `like` standing for the missing context of the LL model."""
    _, jp, port = models
    g = np.random.default_rng(8)
    lvl, band = (1, "ll") if key == "ll" else (int(key[0]), key[2:])
    size = 16 if lvl == 1 else 32
    use_ctx = key != "ll"
    ctx = g.normal(0, 1, (2, 1, size, size)).astype(np.float32) if use_ctx else None
    prev = g.normal(0, 6, (2, 1, size // 2, size // 2)).astype(np.float32) \
        if lvl == 0 else None
    like = np.zeros((2, 1, size, size), np.float32)
    jm = JaxFourStep(in_ch=1, ctx_ch=2 if lvl == 0 else 1, use_ctx=use_ctx,
                     features=SMALL["ar_features" if key == "ll" else "features"])
    sub = {"params": jp["params"]["lp_coder"][f"context_fusion_{key}"]}
    fusion = port.lp_coder.context_fusion[lvl][band]
    opt = (lambda a, f: None if a is None else f(a))
    ref = jm.apply(sub, opt(ctx, jnp.asarray), opt(prev, jnp.asarray),
                   like=jnp.asarray(like), method=JaxFourStep.hier_params)
    with torch.no_grad():
        got = fusion.hier_params(opt(ctx, torch.tensor), opt(prev, torch.tensor),
                                 like=torch.tensor(like))
    assert (got[0] is None) == (ref[0] is None)
    for p, r, name in zip(got, ref, ("ctx_feat", "scales", "means")):
        if r is not None:
            assert_close(p, r, 2e-3, f"hier_params {name}")
    x_hat = g.normal(0, 5, (2, 1, size, size)).astype(np.float32)
    for step in range(3):
        ref_s = jm.apply(sub, jnp.asarray(x_hat), ref[0], step,
                         method=JaxFourStep.spatial_params)
        with torch.no_grad():
            got_s = fusion.spatial_params(torch.tensor(x_hat), got[0], step)
        for p, r in zip(got_s, ref_s):
            assert_close(p, r, 2e-3, f"spatial_params[{step}]")


@pytest.fixture(scope="module")
def mv_runs(models):
    """The MV sub-graphs of one luma pair, JAX and port, with and without
    a DPB (stage 1: its own per-stage weights)."""
    jm, jp, port = models
    (ref_y, cur_y), _ = frames(11)
    stage = 1
    out = {}
    for name, dpb in (("first", None), ("dpb", "from first")):
        if dpb is None:
            jd, pd = {"mv_feature": None, "ref_mv_y": None}, empty_dpb()
        else:
            jd, pd = out["first"]["jax_dpb"], out["first"]["port_dpb"]
        mv_y, z = jm.apply(jp, jnp.asarray(ref_y), jnp.asarray(cur_y), jd, stage,
                           jnp.float32(Q), 1, method=JaxPMCTF.mv_latent_planes)
        with torch.no_grad():
            p_mv_y, p_z = port.mv_latent_planes(torch.tensor(ref_y),
                                                torch.tensor(cur_y), pd, stage, Q)
        # feed both sides the same rounded latent from here on
        mp = jm.apply(jp, z, jd, stage, method=JaxPMCTF.mv_prior_params)
        split = jm.apply(jp, mp, method=JaxPMCTF.mv_decode_split)
        yh = jnp.round(mv_y / split[0])
        spatial = [jm.apply(jp, yh, mp, stage, k, method=JaxPMCTF.mv_decode_spatial)
                   for k in range(3)]
        tail = jm.apply(jp, yh * split[0], stage, jnp.float32(Q), 1,
                        method=JaxPMCTF.mv_decode_tail)
        with torch.no_grad():
            p_mp = port.mv_prior_params(t(z), pd, stage)
            p_split = port.mv_decode_split(t(mp))
            p_spatial = [port.mv_decode_spatial(t(yh), t(mp), stage, k)
                         for k in range(3)]
            p_tail = port.mv_decode_tail(t(yh * split[0]), stage, Q)
        out[name] = {
            "latent": ((p_mv_y, p_z), (mv_y, z)), "prior": (p_mp, mp),
            "split": (p_split, split), "spatial": (p_spatial, spatial),
            "tail": (p_tail, tail),
            "jax_dpb": {"mv_feature": tail[1], "ref_mv_y": yh * split[0]},
            "port_dpb": {"mv_feature": t(tail[1]), "ref_mv_y": t(yh * split[0])}}
    return out


@pytest.mark.parametrize("mode", ["first", "dpb"])
def test_mv_sub_graphs(mv_runs, mode):
    run = mv_runs[mode]
    (p_mv_y, p_z), (mv_y, z) = run["latent"]
    assert_close(p_mv_y, mv_y, 5e-3, "mv_latent_planes mv_y")
    # z is rounded: where z lies within float noise of a half the two
    # frameworks may round apart, by one whole step
    d = np.abs(numpy_of(p_z) - numpy_of(z))
    assert np.all((d == 0) | (np.abs(d - 1) < 1e-6)) and d.mean() < 0.05, d.max()
    assert_close(*run["prior"], 2e-3, "mv_prior_params")
    p_split, split = run["split"]
    assert_close(p_split[0], split[0], 1e-6, "mv_decode_split q_dec")
    for part in (1, 2):
        assert len(p_split[part]) == len(split[part]) == 4
        for p, r in zip(p_split[part], split[part]):
            assert_close(p, r, 1e-6, "mv_decode_split quarters")
    for (ps, pm), (rs, rm) in zip(*run["spatial"]):
        for p, r in zip(ps + pm, rs + rm):
            assert_close(p, r, 2e-3, "mv_decode_spatial")
    (p_mv, p_feat), (mv, feat) = run["tail"]
    assert_close(p_mv, mv, 5e-3, "mv_decode_tail mv_hat")
    assert_close(p_feat, feat, 2e-3, "mv_decode_tail feature")
