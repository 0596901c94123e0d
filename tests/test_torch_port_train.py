"""Port parity, training: the conv3x3 autograd path (Conv3x3Function's
gradients against autograd of the plain version, nothing recorded
without grad, PostProcess's gradients reaching every conv).

Tolerance: 1e-5 absolute (f32 sums of at most 96 unit-scale terms a
gradient entry, 2 x 6 x 8 pixels: the plain version's autograd and the
Function's backward sum in other orders, and a d_b of 2 x 12 x 20 pixels
already differed by 1.7e-5).

The training tests are spread over test_torch_port_train*.py, at most
eight a file, so that pytest-xdist's --dist loadfile, which hands out the
files with the most tests first, starts the long test_parallel.py (eight
tests) before them.
"""

import pytest
import torch

from learned_pmctf_tpu_torch.models.layers import init_params
from learned_pmctf_tpu_torch.models.postprocess import PostProcess
from learned_pmctf_tpu_torch.ops import conv3x3 as c3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


# ---- conv3x3 with a gradient ---------------------------------------------

def _conv_case(n, c, o, h, w, res, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g)
    wt = torch.randn(o, c, 3, 3, generator=g) / (3 * c ** 0.5)
    b = torch.randn(o, generator=g) * 0.1
    r = torch.randn(n, o, h, w, generator=g) if res else None
    dy = torch.randn(n, o, h, w, generator=g)
    return x, wt, b, r, dy


def _grads(fn, x, wt, b, r, dy):
    leaves = [t.clone().requires_grad_() for t in (x, wt, b)]
    if r is not None:
        leaves.append(r.clone().requires_grad_())
    y = fn(*leaves[:3], residual=leaves[3] if r is not None else None)
    y.backward(dy)
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("act", [None, "leaky_relu", "tanh"])
@pytest.mark.parametrize("res", [False, True])
def test_conv3x3_function_backward_matches_plain_autograd(act, res, monkeypatch):
    """d_x, d_w, d_b, d_residual against autograd of conv3x3_plain, 1e-5,
    for 8->8, 1->8 and 8->1 convs; the input gradient goes through the
    conv3x3 wrapper's own forward (the kernel on the card): two calls of
    it per forward+backward."""
    calls = []
    forward = c3._forward

    def counting(*args):
        calls.append(tuple(args[0].shape))
        return forward(*args)

    monkeypatch.setattr(c3, "_forward", counting)
    for c, o in ((8, 8), (1, 8), (8, 1)):
        x, wt, b, r, dy = _conv_case(2, c, o, 6, 8, res, seed=c + 3 * o)
        calls.clear()
        y, got = _grads(lambda *a, **k: c3.conv3x3(*a, act=act, **k),
                        x, wt, b, r, dy)
        y_ref, want = _grads(lambda *a, **k: c3.conv3x3_plain(*a, act=act, **k),
                             x, wt, b, r, dy)
        assert calls == [(2, c, 6, 8), (2, o, 6, 8)]
        assert torch.equal(y, y_ref)
        for name, a, e in zip(("d_x", "d_w", "d_b", "d_residual"), got, want):
            err = float((a - e).abs().max())
            assert err <= 1e-5, (c, o, name, err)


def test_conv3x3_records_nothing_without_grad():
    x, wt, b, _, _ = _conv_case(1, 8, 8, 6, 6, False, seed=0)
    wt.requires_grad_()
    with torch.no_grad():
        assert c3.conv3x3(x, wt, b).grad_fn is None
    assert c3.conv3x3(x, wt.detach(), b).grad_fn is None
    assert type(c3.conv3x3(x, wt, b).grad_fn).__name__ == "Conv3x3FunctionBackward"


def test_postprocess_gradients_reach_every_conv():
    """PostProcess returns x + t: without the conv path's gradient only
    the skip would carry one. Every conv gets a non-zero weight gradient,
    and the input's gradient equals the plain version's."""
    pp = init_params(PostProcess(), torch.Generator().manual_seed(0))
    x = torch.randn(2, 1, 16, 24, generator=torch.Generator().manual_seed(1))
    grads = {}
    for use_kernel in (True, False):
        pp.zero_grad()
        pp.use_kernel = use_kernel
        xx = x.clone().requires_grad_()
        (pp(xx) ** 2).sum().backward()
        grads[use_kernel] = (xx.grad, {n: p.grad.clone() for n, p in pp.named_parameters()})
    for n, g in grads[True][1].items():
        assert float(g.abs().max()) > 0, n
        assert float((g - grads[False][1][n]).abs().max()) <= 1e-4 * max(
            1.0, float(g.abs().max())), n
    assert float((grads[True][0] - grads[False][0]).abs().max()) <= 1e-5
