"""The training path on the card: Conv3x3Function (the conv3x3 kernels
forward and for the input gradient) against the plain version's
autograd at PostProcess's training shapes, and a small pWave train step
whose PostProcess gradients are non-zero and equal the plain version's.

This file imports torch and the port only, so that it also runs where the
JAX package's dependencies are not installed:

    python -m pytest tests/test_torch_port_train_card.py -m cuda

Without a card the tests skip.

Tolerances: each gradient within 1e-3 of its largest magnitude (the
tensor-core variants sum three TF32 products: 3e-5 of unit-scale
outputs against float64); the train step's gradients within 1e-2 of
their largest magnitude (the step runs the kernels through the whole
PostProcess and back).
"""

import pytest
import torch

from learned_pmctf_tpu_torch.models.layers import init_params
from learned_pmctf_tpu_torch.models.pwave import PWave
from learned_pmctf_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
from learned_pmctf_tpu_torch.training.optim import make_optimizer
from learned_pmctf_tpu_torch.training.steps import make_pwave_train_step


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("c,o,act,res", [(1, 64, None, False),
                                         (64, 64, "leaky_relu", False),
                                         (64, 64, None, True),
                                         (64, 1, None, False)])
def test_conv3x3_function_on_card(c, o, act, res):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(c + o)
    x = torch.randn(2, c, 64, 96, device="cuda", generator=g)
    w = torch.randn(o, c, 3, 3, device="cuda", generator=g) / (3 * c ** 0.5)
    b = torch.randn(o, device="cuda", generator=g) * 0.1
    r = torch.randn(2, o, 64, 96, device="cuda", generator=g) if res else None
    dy = torch.randn(2, o, 64, 96, device="cuda", generator=g)
    grads = {}
    cot = dy
    for name, fn, a in (("kernel", conv3x3, act), ("plain", conv3x3_plain, None)):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        rr = r.clone().requires_grad_() if res else None
        before = conv3x3.launches
        y = fn(*leaves, act=a, residual=rr)
        y.backward(cot)
        torch.cuda.synchronize()
        if name == "kernel":
            assert conv3x3.launches - before == 2  # forward and d_x
            # the plain reference takes the kernel's LeakyReLU sides: near a
            # pre-activation of 0 the two forwards may differ, not the backward
            if act == "leaky_relu":
                cot = torch.where(y >= 0, dy, 0.2 * dy)
        grads[name] = [t.grad for t in leaves] + ([rr.grad] if res else [])
    for k, p in zip(grads["kernel"], grads["plain"]):
        assert _rel_err(k, p) <= 1e-3


@pytest.mark.cuda
def test_pwave_train_step_on_card():
    _need_card()
    cfg = dict(decomp_levels=2, features=16, ar_features=16)
    x = torch.rand(2, 1, 64, 64, generator=torch.Generator().manual_seed(0)) * 255
    grads = {}
    for use_kernel in (True, False):
        model = init_params(PWave(**cfg), torch.Generator().manual_seed(1)).cuda()
        model.dequantModule.use_kernel = use_kernel
        opt = make_optimizer(model, 1e-4)
        before = conv3x3.launches
        metrics = make_pwave_train_step(model, opt)(x.cuda(), 10.0, 0.01)
        torch.cuda.synchronize()
        assert conv3x3.launches - before == (30 if use_kernel else 0)
        assert torch.isfinite(metrics["loss"])
        grads[use_kernel] = {n: p.grad.clone() for n, p in
                             model.dequantModule.named_parameters()}
    for n, g in grads[True].items():
        assert float(g.abs().max()) > 0, n
        assert _rel_err(g, grads[False][n]) <= 1e-2, n
