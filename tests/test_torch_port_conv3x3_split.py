"""Port parity, conv3x3 tensor-core variants: what of them runs on the CPU
(with test_torch_port_conv3x3_split_2.py to _4.py, which import this
file's helpers: at most eight tests a file).

The tensor-core kernels keep f32 parity by splitting every f32 operand in
two TF32 numbers and summing three products. The split (`tf32_split`), the
weight packs the kernels read (`pack_weights`), the pack cache and a plain
PyTorch emulation of the three-product sum (`conv3x3_split_plain`) are
plain tensor code: they are held here against `conv3x3_plain` and the JAX
package's oracle. The kernels themselves are held against the plain
version on the card (the `cuda` test of test_torch_port_conv3x3_card.py,
and chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import torch


from learned_pmctf_tpu_torch.ops import conv3x3 as c3


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _values(kind):
    g = np.random.default_rng(3)
    base = g.normal(0, 1, 4096).astype(np.float32)
    return torch.tensor({
        "unit": base,
        "negative": -np.abs(base),
        "large": base * np.float32(1e10),
        "tiny": base * np.float32(1e-30),  # normal numbers; so are their small parts
        "zeros": np.array([0.0, -0.0, 1.0, -1.0, 0.5, 3.0], np.float32),
        "ties": np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11,
                          2 - 2.0 ** -11], np.float32),
    }[kind])


@pytest.mark.parametrize("kind", ["unit", "negative", "large", "tiny", "zeros", "ties"])
def test_tf32_split(kind):
    t = _values(kind)
    big, small = c3.tf32_split(t)
    for part in (big, small):
        assert part.dtype == torch.float32 and part.shape == t.shape
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # |t - big| <= 2^-11 |t| and the same again for the small part
    err = (big.double() + small.double() - t.double()).abs()
    assert bool((err <= t.double().abs() * 2.0 ** -21).all())
    assert bool(((big.double() - t.double()).abs() <= t.double().abs() * 2.0 ** -11).all())
    if kind == "ties":  # ties go away from zero, as cvt.rna.tf32.f32 rounds
        assert big.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9, 2.0]
    if kind == "zeros":
        assert torch.equal(big, t) and not bool(small.any())


def _case64(seed, h=24, w=40, res=True):
    g = np.random.default_rng(seed)
    x = g.normal(0, 1, (1, 64, h, w)).astype(np.float32)
    wt = (g.normal(0, 1, (64, 64, 3, 3)) / 24).astype(np.float32)  # unit-scale outputs
    b = g.normal(0, 0.1, (64,)).astype(np.float32)
    r = g.normal(0, 1, (1, 64, h, w)).astype(np.float32) if res else None
    return x, wt, b, r


def test_split_plain_one_product_is_told_apart():
    """One TF32 product misses the limit that three products keep: the
    limits of this file and of chip_smoke.py can tell them apart."""
    x, wt, b, _ = _case64(6, res=False)
    tx, tw, tb = torch.tensor(x), torch.tensor(wt), torch.tensor(b)
    plain = c3.conv3x3_plain(tx, tw, tb)
    one = c3.conv3x3_split_plain(tx, tw, tb, products=1)
    three = c3.conv3x3_split_plain(tx, tw, tb, products=3)
    assert float((one - plain).abs().max()) > 1e-4
    assert float((three - plain).abs().max()) < 2e-5
    with pytest.raises(ValueError):
        c3.conv3x3_split_plain(tx, tw, tb, products=2)


def test_flipped_weights_cache():
    """The input gradient's weights are flipped once a weight version: a
    second call returns the same tensor (so its pack is cached too), an
    in-place update flips anew."""
    w = torch.nn.Conv2d(1, 64, 3, padding=1).weight
    first = c3.flipped_weights(w)
    assert first.shape == (1, 64, 3, 3) and not first.requires_grad
    assert torch.equal(first, w.detach().flip(2, 3).transpose(0, 1))
    assert c3.flipped_weights(w) is first
    before = c3.packed_weights.packs
    pack = c3.packed_weights(first, "direct")
    assert c3.packed_weights(c3.flipped_weights(w), "direct") is pack
    assert c3.packed_weights.packs == before + 1
    with torch.no_grad():
        w.mul_(0.5)  # an in-place update, as an optimizer step makes
    second = c3.flipped_weights(w)
    assert second is not first
    assert torch.equal(second, w.detach().flip(2, 3).transpose(0, 1))
    assert torch.equal(second, 0.5 * first)
