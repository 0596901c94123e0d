"""The C = 1 kernel of ``direct_f32`` and ``direct_bf16``
(csrc/conv3x3_direct_c1.cu) on the CPU: numpy models of its persistent
walk over the output tiles, its input window with the zero halo, the
threads' reads and sums, its stores (each thread's 16-byte vectors where
they lie inside the tensor: the tiles clipped at its edges), and of the
rule that sends a shape to it rather than to the general kernel
(csrc/conv3x3.cu).

The kernel runs only on the card (``chip_smoke.py`` phases 3 and 18,
``tests/test_torch_port_conv3x3_card.py``). The sums here run in float64,
so the comparison with ``conv3x3_plain`` is held to 1e-9. Keep the
constants in step with the kernel's."""

import numpy as np
import pytest
import torch

from learned_pmctf_tpu_torch.ops import conv3x3 as c3

# csrc/conv3x3_direct_c1.cu
TH = 2                 # tile rows
VPR = 32               # 16-byte vectors a tile row: 512 bytes
BLOCK = 256            # threads
GROUP_WARPS = TH * VPR // 32
GROUPS = BLOCK // 32 // GROUP_WARPS
SMS = 132              # an H100 SXM
TOL = 1e-9


def geometry(elem_bytes):
    """(VEC, TW, STRIDE): pixels a 16-byte vector, tile width, window row
    (a vector each side of the tile)."""
    vec = 16 // elem_bytes
    return vec, VPR * vec, (VPR + 2) * vec


def direct_c1_takes(c, o, w, elem_bytes, aligned=True):
    """conv3x3_common.cuh:direct_c1_takes."""
    return c == 1 and 1 <= o <= 64 and (w * elem_bytes) % 16 == 0 and aligned


def walk(n, h, w, tw, grid):
    """Each block's tiles (n, tile row, tile column): block b takes tiles
    b, b + grid, ... (TileWalk.decode)."""
    tiles_x, tiles_y = -(-w // tw), -(-h // TH)
    total = n * tiles_x * tiles_y
    blocks = []
    for blk in range(grid):
        mine = []
        for tile in range(blk, total, grid):
            r = tile // tiles_x
            mine.append((r // tiles_y, r % tiles_y, tile % tiles_x))
        blocks.append(mine)
    return blocks, total


def threads():
    """Each thread's tile row, vector of the row and output group."""
    tid = np.arange(BLOCK)
    warp, lane = tid // 32, tid % 32
    vi = (warp % GROUP_WARPS) * 32 + lane
    return vi // VPR, vi % VPR, warp // GROUP_WARPS


def window(x, n, y0, x0, vec, stride):
    """The staged window: row r is image row y0 - 1 + r, element j pixel
    x0 - vec + j; a 16-byte copy is all inside the image or zero."""
    _, _, h, w = x.shape
    win = np.zeros((TH + 2, stride))
    for r in range(TH + 2):
        for v in range(stride // vec):
            gy, gx = y0 - 1 + r, x0 - vec + vec * v
            if 0 <= gy < h and 0 <= gx < w:
                win[r, vec * v:vec * v + vec] = x[n, 0, gy, gx:gx + vec]
    return win


def direct_c1_model(x, wt, b, act, res, elem_bytes, grid):
    """The kernel's output in float64: every block's tiles, each thread's
    nine products a pixel (kx outer, ky inner) and epilogue, and its
    16-byte vector stored where it lies inside."""
    n_, _, h, w = x.shape
    o_ = wt.shape[0]
    vec, tw, stride = geometry(elem_bytes)
    row, q, og = threads()
    wk = wt.reshape(o_, 9)
    y = np.full((n_, o_, h, w), np.nan)
    blocks, _ = walk(n_, h, w, tw, grid)
    for mine in blocks:
        for n, ty, tx in mine:
            y0, x0 = ty * TH, tx * tw
            win = window(x, n, y0, x0, vec, stride)
            gy, gx = y0 + row, x0 + vec * q
            inside = (gy < h) & (gx < w)
            # v[r][j] = window row row + r, element vec (q + 1) - 1 + j
            cols = vec * (q + 1) - 1
            for i in range(-(-o_ // GROUPS)):
                o = og + GROUPS * i
                live = o < o_
                oc = np.minimum(o, o_ - 1)
                acc = np.zeros((BLOCK, vec))
                for kx in range(3):
                    for ky in range(3):
                        v = win[row[:, None] + ky, cols[:, None] + np.arange(vec) + kx]
                        acc += v * wk[oc, ky * 3 + kx][:, None]
                val = acc + b[oc][:, None]
                if res is not None:  # 16 bytes a thread, where the vector lies inside
                    rv = res[n, oc[:, None], np.minimum(gy, h - 1)[:, None],
                             np.minimum(gx[:, None] + np.arange(vec), w - 1)]
                    val = val + np.where((inside & live)[:, None], rv, 0.0)
                if act == "tanh":
                    val = np.tanh(val)
                elif act == "leaky_relu":
                    val = np.where(val >= 0, val, 0.2 * val)
                for t in np.flatnonzero(live & inside):  # st.global.cs.v4
                    dst = y[n, oc[t], gy[t], gx[t]:gx[t] + vec]
                    assert np.all(np.isnan(dst)), "a pixel stored twice"
                    dst[:] = val[t]
    return y


# the main path's 1->64 shapes, the ragged one, the training d_x shapes
WALK_SHAPES = [(1, 1152, 1920), (2, 576, 960), (1, 37, 136), (8, 128, 128), (16, 256, 256)]


@pytest.mark.parametrize("n,h,w", WALK_SHAPES)
def test_walk_covers_every_tile_once(n, h, w):
    for elem_bytes in (4, 2):
        _, tw, _ = geometry(elem_bytes)
        for grid_cap in (SMS, 7):
            tiles = -(-w // tw) * -(-h // TH) * n
            blocks, total = walk(n, h, w, tw, min(tiles, grid_cap))
            assert total == tiles
            seen = [t for mine in blocks for t in mine]
            assert len(seen) == len(set(seen)) == total
            # every block busy, the walk balanced to one tile
            counts = [len(mine) for mine in blocks]
            assert min(counts) >= 1 and max(counts) - min(counts) <= 1
            # the tiles, clipped at the edges, cover the plane: every pixel once
            cover = np.zeros((n, h, w), np.int32)
            for nn, ty, tx in seen:
                cover[nn, ty * TH:(ty + 1) * TH, tx * tw:(tx + 1) * tw] += 1
            assert bool((cover == 1).all())


def _seeded(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_and_boxes_give_the_conv(dtype):
    """A ragged 2x1x75x200 -> 64 conv with a residual and tanh, and a
    37x136 -> 22 one with LeakyReLU on 5 blocks (each walking many tiles;
    22 outputs leave half the groups' last channel empty)."""
    elem_bytes = 2 if dtype == torch.bfloat16 else 4
    for (n, o, h, w, act, with_res, grid) in ((2, 64, 75, 200, "tanh", True, SMS),
                                              (1, 22, 37, 136, "leaky_relu", False, 5)):
        assert direct_c1_takes(1, o, w, elem_bytes)
        # the operands as the kernel reads them: bf16 values for the bf16 instance
        to = lambda a: torch.from_numpy(a).to(dtype).double()  # noqa: E731
        x = to(_seeded((n, 1, h, w), 0))
        wt = torch.from_numpy(_seeded((o, 1, 3, 3), 1, 1 / 3)).to(dtype).double()
        b = torch.from_numpy(_seeded((o,), 2, 0.1)).double()
        r = to(_seeded((n, o, h, w), 3)) if with_res else None
        got = direct_c1_model(x.numpy(), wt.numpy(), b.numpy(), act,
                              None if r is None else r.numpy(), elem_bytes, grid)
        want = c3.conv3x3_plain(x, wt, b, act, r).numpy()
        assert not np.isnan(got).any(), "a pixel never stored"
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_routing_rule():
    """The C = 1 kernel takes one input channel, at most 64 outputs and
    rows of a 16-byte multiple on 16-byte tensors; the general kernel
    keeps the rest."""
    for elem_bytes in (4, 2):
        assert direct_c1_takes(1, 64, 1920, elem_bytes)      # luma
        assert direct_c1_takes(1, 64, 960, elem_bytes)       # chroma
        assert direct_c1_takes(1, 64, 128, elem_bytes)       # training
        assert direct_c1_takes(1, 64, 200, elem_bytes)       # ragged
        assert not direct_c1_takes(1, 64, 33, elem_bytes)    # unaligned rows
        assert not direct_c1_takes(1, 64, 133, elem_bytes)
        assert not direct_c1_takes(3, 64, 1920, elem_bytes)  # C = 3
        assert not direct_c1_takes(1, 65, 1920, elem_bytes)
        assert not direct_c1_takes(1, 64, 1920, elem_bytes, aligned=False)
    # 36 f32 pixels are 144 bytes, 36 bf16 ones 72
    assert direct_c1_takes(1, 64, 36, 4) and not direct_c1_takes(1, 64, 36, 2)
