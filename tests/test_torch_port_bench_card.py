"""bench.py's configuration on the card: the conv3x3 kernel's bf16
instance against its bf16 plain version, and the bf16 policy's convs
against the f32 convolution of their bf16-rounded operands.

This file imports torch and the port only, so that it also runs where the
JAX package's dependencies are not installed:

    python -m pytest tests/test_torch_port_bench_card.py -m cuda -s

Without a card the tests skip.
"""

import json

import pytest
import torch
import torch.nn.functional as F

from learned_pmctf_tpu_torch.models.layers import Conv2d
from learned_pmctf_tpu_torch.ops import conv3x3 as c3

FLOOR = 1e-5  # of the largest output: the f32 sums' order, where they cancel
SHARE = 1e-3  # of the elements that may round apart


def bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def assert_bf16_close(y, ref, what):
    """One bf16 ulp of the larger magnitude, plus FLOOR of the largest
    output, on every element; at most SHARE of the elements differ."""
    y, ref = y.float(), ref.float()
    d = (y - ref).abs()
    allowed = bf16_ulp(torch.maximum(y.abs(), ref.abs())) + FLOOR * float(ref.abs().max())
    assert float((d / allowed).max()) <= 1.0, what
    assert float((d > 0).float().mean()) <= SHARE, what


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
def test_bf16_kernels_match_plain_on_card():
    """Ragged and narrow shapes of the three bf16 variants (the chip
    smoke holds the main path's own)."""
    g = _card()
    for n, c, o, h, w, act, res in [(1, 64, 64, 13, 136, "leaky_relu", True),
                                    (2, 64, 64, 16, 32, None, True),
                                    (1, 64, 1, 13, 136, "tanh", True),
                                    (2, 1, 64, 13, 130, "leaky_relu", False),
                                    (1, 64, 64, 9, 130, None, False)]:
        x = torch.randn(n, c, h, w, device="cuda", generator=g).bfloat16()
        wt = (torch.randn(o, c, 3, 3, device="cuda", generator=g) / (3 * c ** 0.5)).bfloat16()
        b = torch.randn(o, device="cuda", generator=g) * 0.1
        r = torch.randn(n, o, h, w, device="cuda", generator=g).bfloat16() if res else None
        ref = c3.conv3x3_plain(x, wt, b, act=act, residual=r)
        for name in c3.variants_for(c, o, w, torch.bfloat16):
            y1 = c3.conv3x3_variant(name, x, wt, b, act=act, residual=r)
            y2 = c3.conv3x3_variant(name, x, wt, b, act=act, residual=r)
            torch.cuda.synchronize()
            assert y1.dtype == torch.bfloat16 and torch.equal(y1, y2), name
            assert_bf16_close(y1, ref, (name, n, c, o, h, w))


@pytest.mark.cuda
def test_policy_convs_on_card():
    """The policy's convs on CUDA: below 8 channels a group the f32
    convolution of the bf16-rounded operands, rounded once (bit for bit);
    above, cuDNN's bf16 convolution within the kernels' limit of it. The
    raw cuDNN bf16 error of each shape is printed beside it."""
    g = _card()
    rows = []
    for c, o, k, hw, groups in [(1, 1, 3, 16, 1), (1, 1, 3, 32, 1), (1, 16, 3, 64, 1),
                                (16, 1, 3, 64, 1), (4, 32, 7, 64, 1), (16, 2, 7, 64, 1),
                                (64, 64, 3, 32, 64), (16, 16, 3, 64, 1),
                                (32, 64, 7, 64, 1), (112, 112, 3, 32, 1)]:
        conv = Conv2d(c, o, k, groups=groups).cuda()
        with torch.no_grad():
            conv.weight.normal_(0, 0.1, generator=g)
        x = torch.randn(1, c, hw, hw, device="cuda", generator=g)
        xb, wb = x.bfloat16(), conv.weight.detach().bfloat16()
        ref = F.conv2d(xb.float(), wb.float(), padding=k // 2, groups=groups).bfloat16()
        with torch.no_grad():
            y = conv.policy_conv(x, conv.weight, torch.bfloat16)
        cudnn = F.conv2d(xb, wb, padding=k // 2, groups=groups)
        torch.cuda.synchronize()
        raw = float((cudnn.float() - ref.float()).abs().max() / ref.float().abs().max())
        rows.append({"c": c, "o": o, "k": k, "hw": hw, "groups": groups,
                     "cudnn_bf16_max_err_of_largest": raw})
        assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
        if min(c // groups, o) < 8:
            assert torch.equal(y, ref), (c, o, k, hw)
        else:
            assert_bf16_close(y, ref, (c, o, k, hw))
    print(json.dumps({"policy_convs_on_card": rows}))
