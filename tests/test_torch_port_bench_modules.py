"""Port parity, the bf16 activation policy (act_bf16, bench.py's
configuration): each module under the policy against its flax
counterpart under the JAX package's policy, same weights, same numpy
inputs, widths 16-32 and planes of 64x64 (PostProcess 64x128, the Pallas
route's width). The flax side runs eagerly, so that JAX rounds after
every op as torch does.

The rule on every output (planes, bits, means and scales):
max |port_bf16 - jax_bf16| <= 0.25 max |jax_bf16 - jax_f32|, where
jax_f32 is the same flax call without the policy; jax_bf16 must differ
from jax_f32 (the policy ran on both sides), and the port's output
dtypes must be JAX's.

One allowance, for the nets whose output is their last conv's bf16
rounding (PostProcess, MEBasic, the LSTM states and the four-step
heads): one bf16 ulp of the output's largest magnitude on top. torch's
and XLA's f32 convolutions sum in different orders (70 to 87% of the f32
outputs of a 7x7 32->64 conv differ between the two on the CPU), so
about 1e-4 of the outputs of each bf16 conv round to the neighbouring
bf16 value, and where the policy moves such a net's output by only an
ulp or so (MEBasic: 5.4e-4 on flows of about 0.2), one such rounding
weighs as much as the policy itself. The single convs, PredictUpdate and
the MV coder agree bit for bit.
"""

import contextlib
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from learned_pmctf_tpu.models import PMCTF as JaxPMCTF
from learned_pmctf_tpu.models.context import (
    ContextFusionFourStep as JaxFourStep, SubbandContext as JaxSubbandContext)
from learned_pmctf_tpu.models.layers import (
    Conv2d as JaxConv2d, MaskedConv2d as JaxMaskedConv2d,
    PredictUpdate as JaxPredictUpdate, conv_compute_dtype as jax_policy)
from learned_pmctf_tpu.models.mv_coder import (
    HyperDecoder as JaxHyperDec, HyperEncoder as JaxHyperEnc, MvDec as JaxMvDec,
    MvEnc as JaxMvEnc)
from learned_pmctf_tpu.models.postprocess import PostProcess as JaxPostProcess
from learned_pmctf_tpu.models.spynet import MEBasic as JaxMEBasic
from learned_pmctf_tpu.ops.fold import fold_small_convs

from learned_pmctf_tpu_torch.convert import params_from_jax
from learned_pmctf_tpu_torch.models.layers import (
    Conv2d, MaskedConv2d, PredictUpdate, conv_compute_dtype)
from learned_pmctf_tpu_torch.models.pmctf import build_pmctf, empty_dpb
from learned_pmctf_tpu_torch.models.postprocess import PostProcess
from learned_pmctf_tpu_torch.models.spynet import MEBasic
from torch_port_helpers import _draw

# widths 16-32: the MV coder at 16 channels, the four-step priors at 32
MOD = dict(decomp_levels=2, num_me_stages=1, channel_mv=16, channel_n=16,
           features=32, ar_features=16)
RATIO = 0.25
Q = 10.0


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    torch.set_num_threads(2)


def jax_params_of(jm, seed=0):
    """{"params": tree} of numpy arrays for the flax PMCTF `jm` (as
    test_torch_port_models.jax_small_params)."""
    x = jnp.zeros((1, 1, 64, 64), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, x, x, 10, empty_dpb(),
        method=JaxPMCTF.full_init_graph))
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(tuple(str(k.key) for k in p), s.shape, g)
        .astype(np.float32), shapes)


@pytest.fixture(scope="module")
def models():
    jm = {bf: JaxPMCTF(ll_mode="fourstep", warp_mode="fast", spynet_luma=True,
                       act_bf16=bf, **MOD) for bf in (False, True)}
    params = jax_params_of(jm[True])
    port = build_pmctf("cpu", warp_mode="fast", act_bf16=True, **MOD)
    port.load_state_dict(params_from_jax(params), strict=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), port


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(max(abs(v), 1e-30))) - 7)


def check_policy(port, jax_bf16, jax_f32, what, rounded=False):
    """The rule of this file, output by output (`rounded`: with the
    allowance for a net whose output is a bf16 rounding); returns the
    worst ratio to the allowed difference."""
    worst, moved = 0.0, 0.0
    leaves = list(zip(_leaves(port), _leaves(jax_bf16), _leaves(jax_f32)))
    assert leaves and len(leaves) == len(_leaves(jax_bf16)), what
    for i, (p, b, f) in enumerate(leaves):
        assert _dtype(p) == _dtype(b), (what, i, p.dtype, b.dtype)
        p = p.detach().float().numpy().astype(np.float64)
        b = np.asarray(jnp.asarray(b, jnp.float32), np.float64)
        f = np.asarray(jnp.asarray(f, jnp.float32), np.float64)
        assert p.shape == b.shape == f.shape, (what, i)
        d_port, d_policy = float(np.abs(p - b).max()), float(np.abs(b - f).max())
        allowed = RATIO * d_policy + (bf16_ulp(np.abs(b).max()) if rounded else 0.0)
        assert d_port <= allowed, (what, i, d_port, d_policy, allowed)
        moved = max(moved, d_policy)
        worst = max(worst, d_port / allowed if allowed else 0.0)
    assert moved > 0, (what, "jax_bf16 equals jax_f32: the policy did not run")
    return worst


@contextlib.contextmanager
def jax_reference():
    """The JAX side without its TPU folds (ops/fold.py, not ported: exact
    in their products, but their f32 sums run in another order, which
    rounds bf16 outputs apart from the unfolded convs), and with
    PostProcess on the Pallas kernel in interpret mode where the width
    allows (PMCTF_PALLAS_POST=1, set and restored)."""
    old = os.environ.get("PMCTF_PALLAS_POST")
    os.environ["PMCTF_PALLAS_POST"] = "1"
    try:
        with fold_small_convs(False), pltpu.force_tpu_interpret_mode():
            yield
    finally:
        if old is None:
            del os.environ["PMCTF_PALLAS_POST"]
        else:
            os.environ["PMCTF_PALLAS_POST"] = old


def both_jax(fn):
    """fn() under JAX's policy and without it."""
    with jax_reference():
        with jax_policy(jnp.bfloat16):
            bf = fn()
        return bf, fn()


def port_bf16(fn):
    with torch.no_grad(), conv_compute_dtype(torch.bfloat16):
        return fn()


def _conv_params(g, o, c, k):
    return {"kernel": g.normal(0, 0.1, (o, c, k, k)).astype(np.float32),
            "bias": g.normal(0, 0.2, (o,)).astype(np.float32)}


def _load(module, params):
    """flax {"name": {"kernel", "bias"}} onto the port's submodules."""
    with torch.no_grad():
        for name, p in params.items():
            m = getattr(module, name) if name else module
            m.weight.copy_(torch.tensor(p["kernel"]))
            m.bias.copy_(torch.tensor(p["bias"]))
    return module


def test_conv2d_and_masked_conv2d_under_policy():
    g = np.random.default_rng(0)
    x = g.normal(0, 1, (1, 16, 64, 64)).astype(np.float32)
    for jmod, port, what in (
            (JaxConv2d(16, 32, 3), Conv2d(16, 32, 3), "conv2d"),
            (JaxConv2d(16, 32, 3, stride=2), Conv2d(16, 32, 3, stride=2), "strided"),
            (JaxMaskedConv2d(16, 32, 3, "B"), MaskedConv2d(16, 32, 3, "B"), "masked")):
        p = _conv_params(g, 32, 16, 3)
        jb, jf = both_jax(lambda: jmod.apply({"params": p}, jnp.asarray(x)))
        got = port_bf16(lambda: _load(port, {"": p})(torch.tensor(x)))
        check_policy(got, jb, jf, what)


def test_predict_update_under_policy():
    g = np.random.default_rng(1)
    p = {f"conv{i}": _conv_params(g, o, c, 3)
         for i, (c, o) in enumerate(((1, 16), (16, 16), (16, 16), (16, 1)), 1)}
    x = g.normal(0, 0.3, (1, 1, 64, 64)).astype(np.float32)
    jb, jf = both_jax(lambda: JaxPredictUpdate(1).apply({"params": p}, jnp.asarray(x)))
    got = port_bf16(lambda: _load(PredictUpdate(1), p)(torch.tensor(x)))
    assert got.dtype == torch.float32  # the net's boundary
    check_policy(got, jb, jf, "predict_update")


def test_postprocess_pallas_route_under_policy():
    """The JAX PostProcess through the Pallas kernel (PMCTF_PALLAS_POST=1,
    interpret mode) on a 64x128 plane; the port runs the kernel's bf16
    plain version for all its convs."""
    g = np.random.default_rng(2)
    p = {"conv1": _conv_params(g, 32, 1, 3), "conv2": _conv_params(g, 32, 32, 3),
         "conv3": _conv_params(g, 1, 32, 3)}
    for i in range(2):
        p[f"res{i}"] = {"conv1": _conv_params(g, 32, 32, 3),
                        "conv2": _conv_params(g, 32, 32, 3)}
    x = g.uniform(0, 1, (1, 1, 64, 128)).astype(np.float32)
    jm = JaxPostProcess(channels=32, num_res=2)
    jb, jf = both_jax(lambda: jm.apply({"params": p}, jnp.asarray(x)))
    port = PostProcess(1, 1, channels=32, num_res=2)
    _load(port, {k: p[k] for k in ("conv1", "conv2", "conv3")})
    for i, blk in enumerate(port.resBlocks):
        _load(blk, p[f"res{i}"])
    got = port_bf16(lambda: port(torch.tensor(x)))
    check_policy(got, jb, jf, "postprocess", rounded=True)


def test_mebasic_under_policy(models):
    _, jp, port = models
    g = np.random.default_rng(3)
    x = g.normal(0, 0.5, (1, 4, 64, 64)).astype(np.float32)
    sub = {"params": jp["params"]["optic_flow"]["basic_0"]}
    jb, jf = both_jax(lambda: JaxMEBasic(in_ch=4).apply(sub, jnp.asarray(x)))
    got = port_bf16(lambda: port.optic_flow.moduleBasic[0](torch.tensor(x)))
    check_policy(got, jb, jf, "mebasic", rounded=True)


def test_mv_coder_under_policy(models):
    """The MV encoder (with and without its DPB context), decoder and
    hyper encoder and decoder, with the (1,1,1) f32 quant steps the q
    scales give (f32 products in both frameworks)."""
    _, jp, port = models
    g = np.random.default_rng(4)
    c = MOD["channel_mv"]
    flow = g.normal(0, 2, (1, 2, 64, 64)).astype(np.float32)
    ctx = g.normal(0, 1, (1, c, 16, 16)).astype(np.float32)
    y = g.normal(0, 3, (1, c, 4, 4)).astype(np.float32)
    z = np.round(g.normal(0, 2, (1, c, 1, 1))).astype(np.float32)
    q = np.full((1, 1, 1), 1.3, np.float32)
    sub = lambda k: {"params": jp["params"][k]}  # noqa: E731
    J = jnp.asarray

    def jax_run():
        return (JaxMvEnc(2, c).apply(sub("mv_encoder_0"), J(flow), None, J(q)),
                JaxMvEnc(2, c).apply(sub("mv_encoder_0"), J(flow), J(ctx), J(q)),
                JaxMvDec(2, c).apply(sub("mv_decoder_0"), J(y), J(q)),
                JaxHyperEnc(c, c).apply(sub("mv_hyper_enc_0"), J(y)),
                JaxHyperDec(c, c).apply(sub("mv_hyper_dec_0"), J(z)))
    jb, jf = both_jax(jax_run)
    T = torch.tensor
    got = port_bf16(lambda: (
        port.mv_encoder[0](T(flow), None, T(q)),
        port.mv_encoder[0](T(flow), T(ctx), T(q)),
        port.mv_decoder[0](T(y), T(q)),
        port.mv_hyper_prior_encoder[0](T(y)),
        port.mv_hyper_prior_decoder[0](T(z))))
    check_policy(got, jb, jf, "mv coder")


def test_context_and_fusion_under_policy(models):
    """The LSTM subband context across a level (its upsamplers return bf16
    states) and the four-step priors of a subband with context and of
    the LL: (x_res, x_q, x_hat, s_hat), and the step-0 and spatial
    (scales, means)."""
    _, jp, port = models
    g = np.random.default_rng(5)
    sb = g.normal(0, 10, (1, 1, 16, 16)).astype(np.float32)
    states = tuple(tuple(g.normal(0, 0.5, (1, ch, 16, 16)).astype(np.float32)
                         for _ in range(2)) for ch in (32, 32, 3))
    x0 = g.normal(0, 6, (1, 1, 32, 32)).astype(np.float32)
    ctx0 = g.normal(0, 1, (1, 1, 32, 32)).astype(np.float32)
    prev = g.normal(0, 6, (1, 1, 16, 16)).astype(np.float32)
    ll = g.normal(0, 20, (1, 1, 16, 16)).astype(np.float32)
    hp = jp["params"]["hp_coder"]
    J = jnp.asarray
    fs0 = JaxFourStep(in_ch=1, ctx_ch=2, features=MOD["features"])
    fsll = JaxFourStep(in_ch=1, ctx_ch=1, features=MOD["ar_features"], use_ctx=False)

    def jax_run():
        step = JaxSubbandContext(in_ch=1, decomp_levels=2).apply(
            {"params": hp["context_prediction"]}, J(sb),
            jax.tree_util.tree_map(J, states), 0, method=JaxSubbandContext.step)
        p0 = {"params": hp["context_fusion_0_lh"]}
        out0 = fs0.apply(p0, J(x0), context=J(ctx0), prev_subband=J(prev),
                         training=False)
        feat, s, m = fs0.apply(p0, J(ctx0), J(prev), J(x0),
                               method=JaxFourStep.hier_params)
        spatial = fs0.apply(p0, J(x0), feat, 1, method=JaxFourStep.spatial_params)
        outll = fsll.apply({"params": hp["context_fusion_ll"]}, J(ll), training=False)
        return step, out0, (s, m), spatial, outll
    jb, jf = both_jax(jax_run)
    T = torch.tensor
    coder = port.hp_coder

    def port_run():
        step = coder.context_prediction.step(
            T(sb), jax.tree_util.tree_map(T, states), 0)
        fs = coder.context_fusion[0]["lh"]
        out0 = fs(T(x0), context=T(ctx0), prev_subband=T(prev))
        feat, s, m = fs.hier_params(T(ctx0), T(prev), like=T(x0))
        spatial = fs.spatial_params(T(x0), feat, 1)
        outll = coder.context_fusion[1]["ll"](T(ll))
        return step, out0, (s, m), spatial, outll
    check_policy(port_bf16(port_run), jb, jf, "context and fusion", rounded=True)


def test_pwave_forward_under_policy(models):
    """PWave.forward with act_bf16 (the pMCTF highpass coder) on a 64x128
    plane, whose PostProcess takes the Pallas route in JAX: x_hat, bits,
    bpp and mse."""
    jm, jp, port = models
    g = np.random.default_rng(6)
    x = g.normal(0, 20, (1, 1, 64, 128)).astype(np.float32)

    def run(m):
        return m.apply(jp, jnp.asarray(x), jnp.float32(Q), training=False,
                       method=lambda mod, *a, **k: mod.hp_coder(*a, **k))
    with jax_reference():
        jb, jf = run(jm[True]), run(jm[False])
    with torch.no_grad():
        got = port.hp_coder(torch.tensor(x), Q)
    assert port.hp_coder.act_bf16
    check_policy(got, jb, jf, "pwave")
