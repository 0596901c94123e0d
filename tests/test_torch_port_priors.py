"""The four-step priors' residual blocks (``models/layers.py:ContextResidual``).

On the CPU a block runs the composition of ``ResBlock``; its kernel route
(``ops/conv3x3.residual_block3x3``: two conv3x3 calls, LeakyReLU fused
into the first, bias and skip into the second) runs the wrapper's plain
version here and must give the composition's bits, so the epilogue's
order is the composition's. The route's choice, the per-call weight pack
and the kernel's numbers are held on the card
(tests/test_torch_port_priors_card.py); the index walk of the pack's
kernel (csrc/conv3x3_pack.cu) is modelled in tests/test_torch_port_priors_2.py.
"""

import pytest
import torch

from learned_pmctf_tpu_torch import telemetry
from learned_pmctf_tpu_torch.models.context import ContextFusionFourStep
from learned_pmctf_tpu_torch.models.layers import (KERNEL_CONVS, STOCK_CONVS,
                                                   ContextResidual, ResBlock,
                                                   init_params, leaky_relu,
                                                   residual_convs)
from learned_pmctf_tpu_torch.ops import conv3x3 as c3


def _fourstep(use_ctx, features=16, seed=0):
    m = ContextFusionFourStep(in_ch=1, ctx_ch=3, features=features, use_ctx=use_ctx)
    return init_params(m, torch.Generator().manual_seed(seed))


def _inputs(h=16, w=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, 1, h, w, generator=g) * 4
    context = torch.randn(1, 2, h, w, generator=g)
    prev = torch.randn(1, 1, h // 2, w // 2, generator=g)
    return x, context, prev


def _composition(block, x):
    """The block as it was before it had a kernel route."""
    return x + block.conv2(leaky_relu(block.conv1(x), 0.2))


def _fused(block, x):
    """The block's kernel route (on the CPU, the wrapper's plain version)."""
    c1, c2 = block.conv1, block.conv2
    return c3.residual_block3x3(x, c1.weight, c1.bias, c2.weight, c2.bias)


def test_context_residual_is_the_composition_bit_for_bit():
    block = init_params(ContextResidual(16), torch.Generator().manual_seed(2))
    with torch.no_grad():  # weights of unit scale: the sums are not small
        for p in block.parameters():
            p.mul_(20)
    x = torch.randn(2, 16, 9, 20, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = _composition(block, x)
        assert not block.takes_kernel(x)  # the CPU
        assert torch.equal(block(x), want)
        # the kernel route's arithmetic, on the wrapper's plain version
        assert torch.equal(_fused(block, x), want)
        # what the card's route takes: a contiguous x, not its transposed copy
        assert c3.takes_block(x)
        assert not c3.takes_block(x.transpose(2, 3).contiguous().transpose(2, 3))
    assert list(block.state_dict()) == list(ResBlock(16).state_dict())


@pytest.mark.parametrize("use_ctx", [True, False])
def test_small_fourstep_prior_keeps_its_bits(use_ctx, monkeypatch):
    """A 16-feature prior at 16x32: today's composition, the new block,
    and every block forced onto its kernel route give the same bits."""
    model = _fourstep(use_ctx)
    x, context, prev = _inputs()
    args = (context, prev) if use_ctx else ()
    with torch.no_grad():
        got = model(x, *args)
        monkeypatch.setattr(ContextResidual, "forward", _composition)
        want = model(x, *args)
        monkeypatch.setattr(ContextResidual, "forward", _fused)
        fused = model(x, *args)
    for a, b, c in zip(got, want, fused):
        assert torch.equal(a, b) and torch.equal(c, b)
    # every block of the prior, the LL band's (no context) too, one route
    assert residual_convs(model) == (22 if use_ctx else 18)


def test_grad_mode_takes_the_stock_path():
    """With grad on the priors build the stock graph (the trainers' path):
    no Conv3x3Function node, gradients reach every residual conv."""
    model = _fourstep(True)
    x, context, prev = _inputs()
    _, _, x_hat, scales = model(x, context.requires_grad_(), prev, training=True)
    seen, stack = set(), [x_hat.grad_fn, scales.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(n for n, _ in node.next_functions)
    names = {type(n).__name__ for n in seen}
    assert not any("Conv3x3" in n for n in names), names
    assert any("Convolution" in n for n in names), names
    (x_hat.sum() + scales.sum()).backward()
    for block in model.modules():
        if isinstance(block, ContextResidual):
            assert block.conv1.weight.grad is not None
            assert block.conv2.weight.grad is not None


def test_priors_counters_read_the_stock_route_on_the_cpu(monkeypatch):
    """Telemetry counts each residual conv by route while it is on (while
    a profiler runs, tests/test_torch_port_telemetry.py): 11 blocks with
    the hierarchical context, 9 without."""
    x, context, prev = _inputs()
    telemetry.clear()
    with torch.no_grad():
        _fourstep(True)(x, context, prev)  # off: nothing counted
        assert telemetry.snapshot()["counters"] == {}
        monkeypatch.setattr(telemetry, "on", lambda: True)
        _fourstep(True)(x, context, prev)
        _fourstep(False)(x)
    counters = telemetry.snapshot()["counters"]
    telemetry.clear()
    assert counters.get(STOCK_CONVS) == 22 + 18 == residual_convs(_fourstep(True)) + 18
    assert KERNEL_CONVS not in counters
