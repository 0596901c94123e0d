"""The conv3x3 CUDA kernels against their plain version, on the card.

This file imports torch and the port only, so that it also runs where the
JAX package's dependencies are not installed:

    python -m pytest tests/test_torch_port_conv3x3_card.py -m cuda

Without a card the test skips.
"""

import pytest
import torch

from learned_pmctf_tpu_torch.ops import conv3x3 as c3


@pytest.mark.cuda
def test_conv3x3_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    # the last two shapes take the tensor-core variants at unit-scale
    # outputs (weights ~ 1 / sqrt(9 C)), which is what the float64 limit
    # assumes: the tensor cores' f32 adder truncates, and the error grows
    # with the outputs' scale and with C
    for n, c, o, h, w, act, res, scale in [
            (1, 64, 64, 37, 131, "leaky_relu", False, 0.1),
            (2, 1, 64, 20, 96, None, False, 0.1),
            (1, 64, 1, 33, 70, "tanh", True, 0.1),
            (3, 5, 9, 7, 13, None, True, 0.1),
            (1, 112, 112, 33, 70, "leaky_relu", True, 1 / (3 * 112 ** 0.5)),
            (2, 64, 64, 20, 96, None, True, 1 / 24)]:
        x = torch.randn(n, c, h, w, device="cuda", generator=g)
        wt = torch.randn(o, c, 3, 3, device="cuda", generator=g) * scale
        b = torch.randn(o, device="cuda", generator=g)
        r = torch.randn(n, o, h, w, device="cuda", generator=g) if res else None
        ref = c3.conv3x3_plain(x, wt, b, act=act, residual=r)
        ref64 = c3.conv3x3_plain(x.double(), wt.double(), b.double(), act=act,
                                 residual=None if r is None else r.double())
        before = c3.conv3x3.launches
        y = c3.conv3x3(x, wt, b, act=act, residual=r)
        torch.cuda.synchronize()
        assert c3.conv3x3.launches == before + 1
        assert float((y - ref).abs().max()) < 1e-4
        # one TF32 product errs by ~1.6e-3 here, the three-product split
        # and the f32 variants by a few 1e-5 at most
        assert float((y.double() - ref64).abs().max()) < 1e-4
        for name in c3.variants_for(c, o, w):
            y1 = c3.conv3x3_variant(name, x, wt, b, act=act, residual=r)
            y2 = c3.conv3x3_variant(name, x, wt, b, act=act, residual=r)
            assert torch.equal(y1, y2), name  # deterministic
            assert float((y1.double() - ref64).abs().max()) < 1e-4, name


@pytest.mark.cuda
def test_direct_c1_kernel_on_card():
    """The direct variants' C = 1 kernel (csrc/conv3x3_direct_c1.cu) runs
    the shapes of its rule, as the C layer counts its launches, and gives
    the general kernel's bits: the same values through an unaligned copy
    of x, which the general kernel runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)

    def ran_c1(name, x, wt, b, **kw):
        c3.direct_c1_launches(x.dtype, reset=True)
        y = c3.conv3x3_variant(name, x, wt, b, **kw)
        return y, c3.direct_c1_launches(x.dtype, reset=True) == 1

    for dtype, elem in ((torch.float32, 4), (torch.bfloat16, 2)):
        name = "direct_bf16" if dtype == torch.bfloat16 else "direct_f32"
        for c, o, w in ((1, 64, 1920), (1, 64, 200), (1, 64, 36), (1, 64, 33),
                        (1, 22, 136), (3, 64, 1920), (1, 65, 128)):
            # one input channel, at most 64 outputs, rows of a 16-byte multiple
            want = c == 1 and o <= 64 and w * elem % 16 == 0
            x = torch.randn(1, c, 3, w, device="cuda", generator=g).to(dtype)
            wt = torch.randn(o, c, 3, 3, device="cuda", generator=g).to(dtype)
            _, c1 = ran_c1(name, x, wt, torch.zeros(o, device="cuda"))
            assert c1 == want, (dtype, c, o, w)
    for dtype in (torch.float32, torch.bfloat16):
        name = "direct_bf16" if dtype == torch.bfloat16 else "direct_f32"
        for n, o, h, w, act, res in ((2, 64, 75, 200, "tanh", True),
                                     (1, 22, 37, 136, "leaky_relu", False),
                                     (3, 64, 20, 96, None, False)):
            x = torch.randn(n, 1, h, w, device="cuda", generator=g).to(dtype)
            wt = (torch.randn(o, 1, 3, 3, device="cuda", generator=g) / 3).to(dtype)
            b = torch.randn(o, device="cuda", generator=g) * 0.1
            r = torch.randn(n, o, h, w, device="cuda", generator=g).to(dtype) if res else None
            y, c1 = ran_c1(name, x, wt, b, act=act, residual=r)
            assert c1, (name, n, o, h, w)
            flat = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)
            xu = flat[1:].view_as(x)  # one element off 16 bytes
            xu.copy_(x)
            y_general, c1 = ran_c1(name, xu, wt, b, act=act, residual=r)
            assert not c1, (name, n, o, h, w)
            torch.cuda.synchronize()
            assert torch.equal(y, y_general), (name, n, o, h, w)
            ref = c3.conv3x3_plain(x.double(), wt.double(), b.double(), act=act,
                                   residual=None if r is None else r.double())
            # f32: the sum's rounding; bf16: half an ulp of the one rounding
            err = (y.double() - ref).abs()
            tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * ref.abs() + 1e-5
            assert bool((err <= tol).all()), (name, n, o, h, w)
