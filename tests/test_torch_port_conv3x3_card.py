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
