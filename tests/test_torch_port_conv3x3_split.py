"""Port parity, conv3x3 tensor-core variants: what of them runs on the CPU.

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
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.ops import pallas_conv as pc

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


@pytest.mark.parametrize("layout", ["mma_sync", "wgmma"])
@pytest.mark.parametrize("c,o", [(8, 8), (64, 64), (112, 112), (128, 64)])
def test_pack_weights_round_trip(layout, c, o):
    w = torch.tensor(np.random.default_rng(c + o).normal(0, 0.1, (o, c, 3, 3))
                     .astype(np.float32))
    big, small = c3.tf32_split(w)
    for o_pad in (o, o + 16):
        pack = c3.pack_weights(w, layout, o_pad)
        assert pack.dtype == torch.float32 and pack.shape == (2 * 9 * c * o_pad,)
        got_big, got_small = c3.unpack_weights(pack, layout, o, c)
        assert torch.equal(got_big, big) and torch.equal(got_small, small)


def test_pack_weights_mma_sync_order():
    """The mma.m16n8k8 B fragment: lane 4 g + t of n-tile j holds output
    8 j + g at channels t and t + 4 of the chunk, big parts then small."""
    c, o = 16, 16
    w = torch.tensor(np.random.default_rng(0).normal(0, 1, (o, c, 3, 3))
                     .astype(np.float32))
    parts = c3.tf32_split(w)
    pack = c3.pack_weights(w, "mma_sync").reshape(c // 8, 9, o // 8, 32, 4)
    for chunk, tap, j, lane in [(0, 0, 0, 0), (1, 4, 1, 13), (1, 8, 0, 31), (0, 5, 1, 6)]:
        g, t = lane >> 2, lane & 3
        want = [float(parts[e >> 1][8 * j + g, 8 * chunk + t + 4 * (e & 1), tap // 3, tap % 3])
                for e in range(4)]
        assert pack[chunk, tap, j, lane].tolist() == want


def test_pack_weights_wgmma_order():
    """K-major core matrices: [chunk][tap][part][k half][8 outputs][output][4 k]."""
    c, o = 16, 16
    w = torch.tensor(np.random.default_rng(1).normal(0, 1, (o, c, 3, 3))
                     .astype(np.float32))
    parts = c3.tf32_split(w)
    pack = c3.pack_weights(w, "wgmma").reshape(c // 8, 9, 2, 2, o // 8, 8, 4)
    for chunk, tap, part, half, j, n, k in [(0, 0, 0, 0, 0, 0, 0), (1, 7, 1, 1, 1, 5, 3),
                                            (0, 3, 1, 0, 1, 7, 2), (1, 8, 0, 1, 0, 2, 1)]:
        want = float(parts[part][8 * j + n, 8 * chunk + 4 * half + k, tap // 3, tap % 3])
        assert float(pack[chunk, tap, part, half, j, n, k]) == want


def test_pack_weights_rejects_odd_channels():
    with pytest.raises(ValueError):
        c3.pack_weights(torch.zeros(8, 5, 3, 3), "mma_sync")
    with pytest.raises(ValueError):
        c3.pack_weights(torch.zeros(16, 8, 3, 3), "wgmma", 8)


def _case64(seed, h=24, w=40, res=True):
    g = np.random.default_rng(seed)
    x = g.normal(0, 1, (1, 64, h, w)).astype(np.float32)
    wt = (g.normal(0, 1, (64, 64, 3, 3)) / 24).astype(np.float32)  # unit-scale outputs
    b = g.normal(0, 0.1, (64,)).astype(np.float32)
    r = g.normal(0, 1, (1, 64, h, w)).astype(np.float32) if res else None
    return x, wt, b, r


@pytest.mark.parametrize("act,res", [(None, False), ("leaky_relu", False), (None, True),
                                     ("tanh", True)])
def test_split_plain_matches_plain_and_oracle(act, res):
    x, wt, b, r = _case64(5, res=res)
    tx, tw, tb = torch.tensor(x), torch.tensor(wt), torch.tensor(b)
    tr = None if r is None else torch.tensor(r)
    got = c3.conv3x3_split_plain(tx, tw, tb, act=act, residual=tr)
    plain = c3.conv3x3_plain(tx, tw, tb, act=act, residual=tr)
    assert float((got - plain).abs().max()) < 2e-5
    # the JAX oracle works on (N, H, C, W)
    hcw = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))  # noqa: E731
    ref = pc.conv3x3_hcw_reference(hcw(x), jnp.asarray(wt), jnp.asarray(b), act=act,
                                   residual=None if r is None else hcw(r))
    ref = np.asarray(ref).transpose(0, 2, 1, 3)
    assert float(np.max(np.abs(got.numpy() - ref))) < 2e-5


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


@pytest.mark.parametrize("layout,o_pad", [("mma_sync", 64), ("wgmma", 64), ("direct", None)])
def test_pack_cache(layout, o_pad):
    conv = torch.nn.Conv2d(64, 64, 3, padding=1)
    w = conv.weight
    before = c3.packed_weights.packs
    first = c3.packed_weights(w, layout, o_pad)
    assert c3.packed_weights.packs == before + 1
    assert c3.packed_weights(w, layout, o_pad) is first  # a second call packs nothing
    assert c3.packed_weights.packs == before + 1
    with torch.no_grad():
        w.mul_(0.5)  # an in-place update, as an optimizer step makes
    second = c3.packed_weights(w, layout, o_pad)
    assert c3.packed_weights.packs == before + 2
    assert not torch.equal(second, first)
    conv.load_state_dict({"weight": torch.full_like(w, 0.25), "bias": conv.bias.detach()})
    third = c3.packed_weights(conv.weight, layout, o_pad)
    assert c3.packed_weights.packs == before + 3
    if layout != "direct":
        big, small = c3.unpack_weights(third, layout, 64, 64)
        assert bool((big == 0.25).all()) and not bool(small.any())
    # the OIHW layout is the tensor itself: nothing to pack
    assert c3.packed_weights(w, "oihw") is w
    assert c3.packed_weights.packs == before + 3


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
