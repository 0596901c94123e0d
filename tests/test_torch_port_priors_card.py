"""The four-step priors' residual blocks on the conv3x3 kernel, on the card.

In f32 without a gradient every ``ContextResidual`` is two conv3x3
launches whose weights are packed for the call (csrc/conv3x3_pack.cu).
Here: the per-call pack against ``pack_weights`` bit for bit (through the
block's output), the priors on the kernel against cuDNN f32 and float64,
nothing cached, and the counters of each route.

This file imports torch and the port only, so that it also runs where the
JAX package's dependencies are not installed:

    python -m pytest tests/test_torch_port_priors_card.py -m cuda

Without a card the tests skip.
"""

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from learned_pmctf_tpu_torch import telemetry
from learned_pmctf_tpu_torch.models.context import ContextFusionFourStep
from learned_pmctf_tpu_torch.models.layers import (KERNEL_CONVS, STOCK_CONVS,
                                                   ContextResidual, conv_compute_dtype,
                                                   init_params, residual_convs)
from learned_pmctf_tpu_torch.ops import conv3x3 as c3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv3x3 kernels have no CPU mode")


@pytest.fixture
def f32_cudnn():
    """cuDNN in f32, as the f32 configuration runs it (TF32 off)."""
    _need_card()
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


def _prior(use_ctx, features, seed=0):
    m = ContextFusionFourStep(in_ch=1, ctx_ch=3, features=features, use_ctx=use_ctx)
    return init_params(m, torch.Generator().manual_seed(seed)).cuda()


def _inputs(h, w, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x_hat = torch.round(torch.randn(1, 1, h, w, device="cuda", generator=g) * 4)
    context = torch.randn(1, 2, h, w, device="cuda", generator=g)
    prev = torch.randn(1, 1, h // 2, w // 2, device="cuda", generator=g)
    return x_hat, context, prev


def _params(model, use_ctx, x_hat, context, prev):
    """Every (scales, means) the prior gives, on fixed inputs: step 0 from
    the context, steps 1-3 from the same partial reconstruction."""
    if use_ctx:
        feat, scales, means = model.hier_params(context, prev)
    else:
        feat, scales, means = model.hier_params(like=x_hat)
    out = [scales, means]
    for step in range(3):
        out += model.spatial_params(x_hat, feat, step)
    return out


@pytest.mark.cuda
def test_per_call_pack_is_pack_weights_on_card():
    """The block packs its weights for the call: its output equals two
    wgmma_3xtf32 launches on pack_weights' cached packs bit for bit (a
    flipped bit of a pack moves the sums), and it caches nothing."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for c, h, w in ((112, 36, 60), (128, 36, 60), (64, 36, 60), (16, 20, 24)):
        x = torch.randn(2, c, h, w, device="cuda", generator=g)
        w1, w2 = (torch.randn(c, c, 3, 3, device="cuda", generator=g) / (3 * c ** 0.5)
                  for _ in range(2))
        b1, b2 = (torch.randn(c, device="cuda", generator=g) * 0.1 for _ in range(2))
        before = c3.packed_weights.packs
        got = c3.residual_block3x3(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        assert c3.packed_weights.packs == before
        assert "_conv3x3_packs" not in w1.__dict__ and "_conv3x3_packs" not in w2.__dict__
        assert c3.variants_for(c, c, w)[0] == "wgmma_3xtf32"
        t = c3.conv3x3(x, w1, b1, act="leaky_relu")
        want = c3.conv3x3(t, w2, b2, residual=x)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), c
        # a shape wgmma_3xtf32 does not take is refused, not sent elsewhere
        with pytest.raises(ValueError):
            c3.residual_block3x3(x[..., :w - 2].contiguous(), w1, b1, w2, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("use_ctx,features,h,w", [
    (True, 112, 144, 240), (True, 112, 576, 960), (False, 128, 36, 60)])
def test_priors_on_kernel_against_cudnn_and_float64(f32_cudnn, monkeypatch, use_ctx,
                                                    features, h, w):
    """Scales and means of the kernel route (the LL band's prior too, at
    128 features without context) and of cuDNN f32 against float64,
    within 1e-4 of their largest magnitude (the split's three
    products err by 3e-5 to 6e-5 of a unit-scale conv, cuDNN f32 by 7e-6
    to 9e-6, one TF32 product by over 1e-3)."""
    model = _prior(use_ctx, features)
    ref = copy.deepcopy(model).double()
    x_hat, context, prev = _inputs(h, w)
    c3.conv3x3.per_call_by_variant = {}
    with torch.no_grad():
        kernel = _params(model, use_ctx, x_hat, context, prev)
        torch.cuda.synchronize()
        launched = dict(c3.conv3x3.per_call_by_variant)
        want = _params(ref, use_ctx, x_hat.double(), context.double(), prev.double())
        monkeypatch.setattr(ContextResidual, "takes_kernel", lambda self, x: False)
        stock = _params(model, use_ctx, x_hat, context, prev)
    assert launched == {"wgmma_3xtf32": residual_convs(model)}
    assert residual_convs(model) == (22 if use_ctx else 18)
    for i, (a, b, r) in enumerate(zip(kernel, stock, want)):
        scale = float(r.abs().max())
        assert scale > 0 or (i < 2 and not use_ctx)  # step 0 of zeros: 0
        for name, got in (("kernel", a), ("cudnn", b)):
            err = float((got.double() - r).abs().max())
            assert err <= 1e-4 * scale, (name, i, err, scale)


@pytest.mark.cuda
def test_priors_cache_no_pack(f32_cudnn):
    """The priors' packs live for their launch: the cache's count and the
    memory held between calls stay as they were."""
    model = _prior(True, 112)
    x_hat, context, prev = _inputs(144, 240)
    with torch.no_grad():
        model(x_hat, context, prev)  # the kernels loaded, the allocator warm
        torch.cuda.synchronize()
        packs, held = c3.packed_weights.packs, torch.cuda.memory_allocated()
        out = model(x_hat, context, prev)
        del out
        torch.cuda.synchronize()
        assert c3.packed_weights.packs == packs
        assert torch.cuda.memory_allocated() == held
    for block in model.modules():
        if isinstance(block, ContextResidual):
            assert "_conv3x3_packs" not in block.conv1.weight.__dict__


@pytest.mark.cuda
def test_priors_counters_on_card(f32_cudnn):
    """While a profiler runs, the counters name each residual conv's
    route: the kernel in f32 without a gradient; the stock path with a
    gradient, under the bf16 policy and on rows of no multiple of 4
    pixels, which launch nothing of the kernel."""
    model = _prior(True, 16)
    x_hat, context, prev = _inputs(32, 64)
    odd = _inputs(32, 30)

    def counts(run):
        telemetry.clear()
        c3.conv3x3.per_call_by_variant = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            run()
            torch.cuda.synchronize()
        got = telemetry.snapshot()["counters"]
        telemetry.clear()
        return (got.get(KERNEL_CONVS, 0), got.get(STOCK_CONVS, 0),
                sum(c3.conv3x3.per_call_by_variant.values()))

    def bf16():
        with conv_compute_dtype(torch.bfloat16):
            model(x_hat, context, prev)

    with torch.no_grad():
        assert counts(lambda: model(x_hat, context, prev)) == (22, 0, 22)
        assert counts(bf16) == (0, 22, 0)
        assert counts(lambda: model(*odd)) == (0, 22, 0)
    assert counts(lambda: model(x_hat, context, prev, training=True)) == (0, 22, 0)
