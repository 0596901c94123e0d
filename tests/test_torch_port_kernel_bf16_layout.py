"""The conv3x3 kernel's bf16 instance on the CPU: its weight pack, and numpy
models of how ``wgmma_bf16`` (csrc/conv3x3_wgmma_bf16.cu) and
``head_bf16`` (csrc/conv3x3_head.cu) address shared memory.

The kernels themselves run only on the card (``chip_smoke.py`` phase 18,
``tests/test_torch_port_bench_card.py``). Here every byte they stage is
placed where TMA, ``cp.async`` and the shifting warps put it, and read
back where ``wgmma``'s descriptors or the FMA loop read it: a model that
misplaces a line, a swizzle, a halo or a descriptor offset does not give
``conv3x3_plain``'s sum. The sums run in float64, so the comparison is
held to 1e-9."""

import numpy as np
import pytest
import torch

from learned_pmctf_tpu_torch.ops import conv3x3 as c3

# csrc/conv3x3_wgmma_bf16.cu
TW, TH, CC = 64, 4, 16
ROWS = TH + 2
LINE = 2 * TW
COPY = ROWS * CC * LINE          # one kx window
HALO = ROWS * CC * 16            # 8 pixels a line, unswizzled
STAGE = 3 * COPY + 2 * HALO      # windows kx = 0, 1, 2, the halos of window 1
GROUP_C = 64                     # channels of resident weights
TAP_BYTES = 64 * CC * 2          # one (chunk, tap) A tile
RES_ROW = 64 * LINE              # a residual row: 64 outputs x 64 pixels
TOL = 1e-9


def swizzle128(addr):
    """TMA's and wgmma's 128-byte swizzle of a byte address in an atom
    that lies on 1024 bytes: the 16-byte chunk XOR the line mod 8."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(mem, base, t, x0, c0, y0, n, box_w, box_c, box_h):
    """A TMA load of the (box_w, box_c, box_h, 1) box at (x0, c0, y0, n)
    of an NCHW tensor `t` (uint16 bf16 bits) in (W, C, H, N) order into the
    uint16 array `mem` at byte `base`; zeros outside the tensor; the
    128-byte swizzle for boxes of 64 pixels, none for 8."""
    _, c, h, w = t.shape
    r, ch, p = np.meshgrid(np.arange(box_h), np.arange(box_c), np.arange(box_w),
                           indexing="ij")
    gy, gc, gx = y0 + r, c0 + ch, x0 + p
    inside = (gy >= 0) & (gy < h) & (gc < c) & (gx >= 0) & (gx < w)
    vals = np.where(inside, t[n, np.minimum(gc, c - 1), np.clip(gy, 0, h - 1),
                              np.clip(gx, 0, w - 1)], 0)
    off = (r * box_c + ch) * box_w * 2 + 2 * p
    if box_w == TW:
        off = swizzle128(off)
    mem[(base + off) // 2] = vals


def shift_windows(stage):
    """The three shifting warps: thread `line` writes windows 0 and 2 of
    a stage from window 1 and the halos, 16 bytes from two neighbours by a
    funnel shift of 16 bits."""
    words = stage.view(np.uint32)
    fs = lambda lo, hi: ((int(hi) << 16) | (int(lo) >> 16)) & 0xffffffff  # noqa: E731
    for line in range(ROWS * CC):
        swz = line & 7
        v = [words[(3 * COPY + line * 16) // 4:][:4]]
        v += [words[(COPY + line * LINE + ((j ^ swz) << 4)) // 4:][:4] for j in range(8)]
        v += [words[(3 * COPY + HALO + line * 16) // 4:][:4]]
        v = [np.array(a, dtype=np.uint64) for a in v]
        for j in range(8):
            a, c, d = v[j], v[j + 1], v[j + 2]
            left = [fs(a[3], c[0]), fs(c[0], c[1]), fs(c[1], c[2]), fs(c[2], c[3])]
            right = [fs(c[0], c[1]), fs(c[1], c[2]), fs(c[2], c[3]), fs(c[3], d[0])]
            off = (line * LINE + ((j ^ swz) << 4)) // 4
            words[off:off + 4] = left
            words[(2 * COPY) // 4 + off:(2 * COPY) // 4 + off + 4] = right


def stage_windows(xb, x0, c0, y0, n):
    """One chunk's stage: TMA brings window 1 and the halos, the shifting
    warps write windows 0 and 2."""
    stage = np.zeros(STAGE // 2, np.uint16)
    tma_box(stage, COPY, xb, x0, c0, y0, n, TW, CC, ROWS)
    tma_box(stage, 3 * COPY, xb, x0 - 8, c0, y0, n, 8, CC, ROWS)
    tma_box(stage, 3 * COPY + HALO, xb, x0 + TW, c0, y0, n, 8, CC, ROWS)
    shift_windows(stage)
    return stage


def read_a(mem, start):
    """wgmma's A operand (64 x 16) through a K-major unswizzled descriptor:
    LBO 1024 (the next 8 k), SBO 128 (the next 8 outputs)."""
    m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    addr = start + (k // 8) * 1024 + (m // 8) * 128 + (m % 8) * 16 + (k % 8) * 2
    return mem[addr // 2]


def read_b(mem, start):
    """wgmma's B operand (16 x 128) through a pixel-major descriptor with
    the 128-byte swizzle (imm-trans-b 1): LBO CC lines (the next 64
    pixels), SBO 1024 (the next 8 channels)."""
    k, n = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    addr = start + (n // 64) * (CC * LINE) + (k // 8) * 1024 + (k % 8) * 128 + (n % 64) * 2
    return mem[swizzle128(addr) // 2]


def bf16_bits(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def as_f64(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def act_f64(v, act):
    if act == "leaky_relu":
        return np.where(v >= 0, v, 0.2 * v)
    return np.tanh(v) if act == "tanh" else v


def wgmma_bf16_model(x, w, b, act, res):
    """y (float64, before the rounding) as the kernel computes it, tile by
    tile: windows staged and shifted, weights resident by groups of 64
    channels, products read through the descriptors of each (chunk, tap)
    and consumer warpgroup; the epilogue, part by part, reads the residual
    rows TMA placed (swizzled) and stores each thread's fragment."""
    n_, c, h, wd = x.shape
    o = w.shape[0]
    xb, rb = bf16_bits(x), None if res is None else bf16_bits(res)
    pack = bf16_bits(c3.pack_weights_bf16(w, 64))
    y = np.zeros((n_, o, h, wd))
    for n in range(n_):
        for ty in range((h + TH - 1) // TH):
            for tx in range((wd + TW - 1) // TW):
                x0 = tx * TW
                acc = [np.zeros((64, 128)) for _ in range(2)]
                for chunk in range(c // CC):
                    c0 = chunk * CC
                    g0 = c0 // GROUP_C * GROUP_C  # the resident group's first channel
                    wsm = pack[g0 * 9 * 64:(g0 + min(GROUP_C, c - g0)) * 9 * 64]
                    stage = stage_windows(xb, x0, c0, ty * TH - 1, n)
                    for wg in range(2):
                        for tap in range(9):
                            ky, kx = divmod(tap, 3)
                            a = read_a(wsm, ((chunk % (GROUP_C // CC)) * 9 + tap) * TAP_BYTES)
                            bm = read_b(stage, kx * COPY + (2 * wg + ky) * CC * LINE)
                            acc[wg] += as_f64(a) @ as_f64(bm)
                for wg in range(2):
                    for part in range(4):  # a row and 32 pixels a part
                        row = part >> 1
                        gy = ty * TH + 2 * wg + row
                        rrow = np.zeros(RES_ROW // 2, np.uint16)
                        if rb is not None:
                            tma_box(rrow, 0, rb, x0, 0, gy, n, TW, 64, 1)
                        for tid in range(128):  # a thread's fragment
                            q, g, t = tid // 32, (tid % 32) // 4, tid % 4
                            for j in range(4 * part, 4 * part + 4):
                                for hh in range(2):
                                    oc = 16 * q + g + 8 * hh
                                    x = 8 * (j & 7) + 2 * t
                                    if oc >= o or gy >= h or x0 + x >= wd:
                                        continue
                                    for e in range(2):
                                        v = acc[wg][oc, 8 * j + 2 * t + e] + float(b[oc])
                                        if rb is not None:
                                            off = oc * LINE + (((j & 7) ^ g) << 4) + 4 * t + 2 * e
                                            v += as_f64(rrow[off // 2])
                                        y[n, oc, gy, x0 + x + e] = act_f64(v, act)
    return y


def seeded(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).bfloat16()


def plain_f64(x, w, b, act, res):
    return c3.conv3x3_plain(x.double(), w.double(), b.double(), act,
                            None if res is None else res.double()).numpy()


@pytest.mark.parametrize("o,c", [(64, 16), (56, 96), (8, 32)])
def test_bf16_pack_round_trips_and_holds_2kb_tiles(o, c):
    w = seeded((o, c, 3, 3), 3)
    pack = c3.pack_weights_bf16(w, 64)
    assert pack.numel() == 64 * c * 9
    assert torch.equal(c3.unpack_weights_bf16(pack, o, c), w)
    # the A tile of (chunk 0, tap 8) through the descriptor is w[:, :16, 2, 2]
    tile = as_f64(read_a(bf16_bits(pack), 8 * TAP_BYTES))
    want = np.zeros((64, 16))
    want[:o] = w[:, :16, 2, 2].double().numpy()
    assert np.array_equal(tile, want)


@pytest.mark.parametrize("n,c,o,h,w,act,res", [
    # a height no multiple of the 4-row tile, a right edge inside a tile
    (1, 32, 64, 7, 72, "leaky_relu", True),
    # two groups of resident weights (64 + 32 channels), 56 outputs, tanh
    (2, 96, 56, 5, 8, "tanh", False),
])
def test_wgmma_bf16_addressing_gives_the_conv(n, c, o, h, w, act, res):
    x = seeded((n, c, h, w), 0)
    wt = seeded((o, c, 3, 3), 1, 1 / (3 * c ** 0.5))
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(o).astype(np.float32) * 0.1)
    r = seeded((n, o, h, w), 4) if res else None
    got = wgmma_bf16_model(x, wt, b, act, r)
    want = plain_f64(x, wt, b, act, r)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_wgmma_bf16_shifted_windows_are_the_kx_boxes():
    """Windows 0 and 2, written by the shifting warps, hold what a TMA box
    starting a pixel left or right would: the halo pixels at both ends,
    zeros beyond the image."""
    x = seeded((1, 16, 6, 72), 5)
    xb = bf16_bits(x)
    for x0 in (0, 64):
        stage = stage_windows(xb, x0, 0, -1, 0)
        for kx in (0, 2):
            got = stage[kx * COPY // 2:(kx + 1) * COPY // 2]
            want = np.zeros(COPY // 2, np.uint16)
            tma_box(want, 0, xb, x0 - 1 + kx, 0, -1, 0, TW, CC, ROWS)
            assert np.array_equal(got, want), (x0, kx)


# csrc/conv3x3_head.cu, the bf16 ring
HEAD_TW, HEAD_TH, HEAD_CC, HEAD_PIX = 128, 8, 8, 4
HEAD_STRIDE = HEAD_TW + 16   # 18 copies of 8 pixels a row
HEAD_COL = 7                 # column of pixel -1
HEAD_ROWS = HEAD_TH + 2


def test_head_bf16_window_gives_the_conv():
    """head_bf16's staging (copy v of a row holds pixels x0 - 8 + 8 v,
    zero outside) and its FMA loop's reads (row0 + r, R::kCol + col + kx)
    give the 64->1 conv at a ragged shape."""
    n_, c, h, wd = 1, 16, 11, 136
    x = seeded((n_, c, h, wd), 6)
    wt = seeded((1, c, 3, 3), 7, 1 / (3 * c ** 0.5))
    b = torch.tensor([0.25])
    xf = as_f64(bf16_bits(x))
    wf = wt.double().numpy()
    y = np.zeros((n_, 1, h, wd))
    for ty in range((h + HEAD_TH - 1) // HEAD_TH):
        for tx in range((wd + HEAD_TW - 1) // HEAD_TW):
            y0, x0 = ty * HEAD_TH, tx * HEAD_TW
            for chunk in range(c // HEAD_CC):
                win = np.zeros((HEAD_CC, HEAD_ROWS, HEAD_STRIDE))
                for cc in range(HEAD_CC):
                    for r in range(HEAD_ROWS):
                        for v in range(HEAD_STRIDE // 8):
                            gy, gx = y0 - 1 + r, x0 - 8 + 8 * v
                            if 0 <= gy < h and 0 <= gx < wd:  # W % 8 == 0: whole copies
                                win[cc, r, 8 * v:8 * v + 8] = xf[0, chunk * HEAD_CC + cc, gy,
                                                                 gx:gx + 8]
                for warp in range(8):
                    cols, row0 = (warp & 3) * 32 + np.arange(32), (warp >> 2) * HEAD_PIX
                    gx = x0 + cols
                    for cc in range(HEAD_CC):
                        wv = wf[0, chunk * HEAD_CC + cc].reshape(9)
                        for r in range(HEAD_PIX + 2):
                            p = win[cc, row0 + r][HEAD_COL + cols[:, None] + np.arange(3)]
                            for ky in range(3):
                                q = r - ky
                                gy = y0 + row0 + q
                                if 0 <= q < HEAD_PIX and gy < h:
                                    keep = gx < wd
                                    y[0, 0, gy, gx[keep]] += (p @ wv[3 * ky:3 * ky + 3])[keep]
    y += 0.25
    want = plain_f64(x, wt, b, None, None)
    assert np.abs(y - want).max() <= TOL * np.abs(want).max()
