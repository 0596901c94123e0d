"""Port parity, the bf16 instance of the conv3x3 kernel (continued): the
64->1 head against the Pallas kernel, the bf16 weight pack of the
tensor-core variant, the wrapper's dtype rules, and the activation
policy's rounding points (models/layers.py) that the module tests build
on."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from learned_pmctf_tpu_torch.models.layers import (
    Conv2d, MaskedConv2d, conv_compute_dtype, current_conv_dtype, f32_streams,
    init_params, leaky_relu, policy_scope)
from learned_pmctf_tpu_torch.ops import conv3x3 as c3
from test_torch_port_bench_kernel import EPILOGUES, assert_bf16_close, pallas_vs_port


@pytest.mark.parametrize("act,res", EPILOGUES)
def test_bf16_plain_head_matches_pallas(act, res):
    got, ref = pallas_vs_port(1, 4, 64, 1, act, res)
    assert_bf16_close(got, ref, (act, res))


def test_bf16_weight_pack_round_trips():
    """pack_weights_bf16 lays out [chunk][tap][k half][m-tile][output][8 k]
    with k the channel of the chunk (wgmma_bf16's resident A tiles); the
    pack holds every weight once and zeros for the padded outputs."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(56, 32, 3, 3, generator=g).bfloat16()
    pack = c3.pack_weights_bf16(w, 64)
    assert pack.dtype == torch.bfloat16 and pack.numel() == 64 * 32 * 9
    assert torch.equal(c3.unpack_weights_bf16(pack, 56, 32), w)
    # chunk 1, tap 4, k half 1, m-tile 2, output 3, k 5: weight
    # (8 * 2 + 3, 16 + 8 + 5, 4 // 3, 4 % 3)
    idx = ((((1 * 9 + 4) * 2 + 1) * 8 + 2) * 8 + 3) * 8 + 5
    assert pack[idx] == w[19, 29, 1, 1]
    # one (chunk, tap) A tile is 2 KB: 64 outputs x 16 channels
    tile = pack.reshape(2, 9, 2, 8, 8, 8)[1, 4].permute(1, 2, 0, 3).reshape(64, 16)
    assert torch.equal(tile[:56], w[:, 16:32, 1, 1])
    assert int((pack.reshape(2, 9, 2, 8, 8, 8)[:, :, :, 7] != 0).sum()) == 0
    with pytest.raises(ValueError):
        c3.pack_weights_bf16(torch.zeros(64, 8, 3, 3, dtype=torch.bfloat16), 64)


def test_wrapper_takes_f32_or_the_bf16_instance_only():
    x = torch.randn(1, 16, 8, 8)
    w = torch.randn(4, 16, 3, 3) * 0.1
    b = torch.randn(4)
    r = torch.randn(1, 4, 8, 8)
    y = c3.conv3x3(x.bfloat16(), w.bfloat16(), b, residual=r.bfloat16())
    assert y.dtype == torch.bfloat16
    ref = (F.conv2d(x.bfloat16().float(), w.bfloat16().float(), b, padding=1)
           + r.bfloat16().float()).bfloat16()
    assert torch.equal(y, ref)  # one rounding, after the f32 epilogue
    for bad in ((x.bfloat16(), w, b, None),                     # f32 weights
                (x.bfloat16(), w.bfloat16(), b.bfloat16(), None),  # bf16 bias
                (x.bfloat16(), w.bfloat16(), b, r),              # f32 residual
                (x, w.bfloat16(), b, None),                      # bf16 weights
                (x.half(), w.half(), b, None)):
        with pytest.raises(TypeError):
            c3.conv3x3(bad[0], bad[1], bad[2], residual=bad[3])
    # the bf16 instance is the inference policy's: no gradient
    wg = w.bfloat16().requires_grad_()
    with pytest.raises(TypeError):
        c3.conv3x3(x.bfloat16(), wg, b)
    with torch.no_grad():
        assert c3.conv3x3(x.bfloat16(), wg, b).dtype == torch.bfloat16


class _Net(torch.nn.Module):
    def __init__(self, act_bf16):
        super().__init__()
        self.act_bf16 = act_bf16
        self.conv = Conv2d(4, 8, 3)
        self.skip = Conv2d(4, 8, 3, policy_exempt=True)
        self.masked = MaskedConv2d(4, 8, 3, "B")

    @policy_scope
    def forward(self, x):
        return self.conv(x), self.skip(x), self.masked(x), current_conv_dtype()

    @f32_streams
    def stream(self, x):
        return self.forward(x)


def test_policy_rounding_points():
    """Under the policy: conv rounded to bf16, then the bias added in bf16
    (JAX's order, not autocast's); exempt convs f32; MaskedConv2d's f32
    bias promotes its bf16 conv to f32; f32_streams switches it off; the
    LeakyReLU slope is rounded to bf16 first."""
    net = init_params(_Net(True), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in (net.conv, net.skip, net.masked):
            m.bias.normal_(0, 0.5)
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(1)) * 30
    with torch.no_grad():
        y, skip, masked, cdt = net(x)
        assert cdt == torch.bfloat16 and current_conv_dtype() is None
        conv = F.conv2d(x.bfloat16().float(), net.conv.weight.bfloat16().float(),
                        padding=1).bfloat16()
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, conv + net.conv.bias.bfloat16().view(1, -1, 1, 1))
        assert skip.dtype == torch.float32
        assert torch.equal(skip, F.conv2d(x, net.skip.weight, net.skip.bias, padding=1))
        assert masked.dtype == torch.float32
        mconv = F.conv2d(x.bfloat16().float(),
                         (net.masked.weight * net.masked.mask).bfloat16().float(),
                         padding=1).bfloat16()
        assert torch.equal(masked, mconv.float() + net.masked.bias.view(1, -1, 1, 1))
        ys, _, _, cdt = net.stream(x)
        assert cdt is None and ys.dtype == torch.float32
        net.act_bf16 = False
        assert net(x)[3] is None
        with conv_compute_dtype(torch.bfloat16):
            assert net.stream(x)[3] is torch.bfloat16  # forced only by the flag
    v = torch.tensor([-1.0, -3.0, 2.0]).bfloat16()
    slope = torch.tensor(0.2).bfloat16()
    assert torch.equal(leaky_relu(v, 0.2), torch.where(v >= 0, v, v * slope))
    assert float(slope) == 0.2001953125
