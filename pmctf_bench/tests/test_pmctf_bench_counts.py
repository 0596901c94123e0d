"""The window's arithmetic, the work counts against hand counts, the
frame generator and the weights."""

import math

import torch
import torch.nn.functional as F
from conftest import TINY_MODEL

from pmctf_bench import layers
from pmctf_bench.cells import load_family
from pmctf_bench.frames import gop_motion, smooth_moving
from pmctf_bench.harness import measure_window
from pmctf_bench.reference.model import PMCTF, Numerics, PostProcess
from pmctf_bench.weights import make_state
from pmctf_bench.work import BYTES, PEAK_BYTES, PEAK_FLOPS, Work


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_counts_all_frames_over_all_time_with_a_stall():
    clock = FakeClock()
    lengths = [2.0, 2.0, 9.0, 2.0, 2.0, 2.0]   # the third GOP stalls

    def step(i):
        clock.t += lengths[i]
    steps, seconds = measure_window(step, 10.0, clock)
    # GOPs start at 0, 2 and 4 s; the third stalls to 13 s, and no GOP
    # starts after 10 s
    assert steps == 3 and seconds == 13.0
    assert 16 * steps / seconds == 48 / 13.0   # not a median of 2 s GOPs


def test_window_runs_the_last_gop_to_its_end():
    clock = FakeClock()

    def step(i):
        clock.t += 4.0
    steps, seconds = measure_window(step, 10.0, clock)
    assert (steps, seconds) == (3, 12.0)


def test_one_conv_hand_count():
    work = Work("f32")
    x = torch.zeros(2, 64, 10, 12)
    w = torch.zeros(32, 64, 3, 3)
    y = F.conv2d(x, w, padding=1)
    work.add_conv("l", x, w, y, 1)
    ops = 2 * 64 * 32 * 9 * 10 * 12 * 2
    nbytes = 4 * (2 * 64 * 120 + 32 * 64 * 9 + 2 * 32 * 120)
    assert work.ops["l"] == ops and work.bytes["l"] == nbytes
    assert math.isclose(work.bound_s["l"], max(ops / PEAK_FLOPS["f32"], nbytes / PEAK_BYTES))
    # depthwise: groups divide the operations
    dw = Work("bf16")
    xd, wd = torch.zeros(1, 8, 6, 6), torch.zeros(8, 1, 3, 3)
    dw.add_conv("l", xd, wd, F.conv2d(xd, wd, padding=1, groups=8), 8)
    assert dw.ops["l"] == 2 * 8 * 8 * 9 * 36 // 8
    assert dw.bytes["l"] == BYTES["bf16"] * (8 * 36 + 72 + 8 * 36)


def test_postprocess_call_hand_count():
    """One PostProcess call on a (N,1,H,W) plane: a 1->64 conv, thirteen
    64->64 and one 64->1, all 3x3 at full resolution."""
    n, h, w = 2, 16, 24
    with torch.device("meta"):
        pp = PostProcess()
    pp = pp.to_empty(device="cpu")
    work = Work("f32")
    numerics = Numerics("f32", work)
    for m in pp.modules():
        if hasattr(m, "numerics"):
            m.numerics = numerics
    pp(torch.zeros(n, 1, h, w))
    px = n * h * w
    ops = 2 * 9 * px * (1 * 64 + 13 * 64 * 64 + 64 * 1)
    nbytes = 4 * (px * (1 + 64) + 9 * 64 + 13 * (px * 128 + 9 * 64 * 64) + px * 65 + 9 * 64)
    assert work.convs == 15 and work.total_ops() == ops
    assert work.bytes["other"] == nbytes


def test_layers_count_under_their_names():
    with torch.device("meta"):
        ref = PMCTF(**TINY_MODEL)
        work = Work("f32")
        num = Numerics("f32", work)
        ref.attach(num)
        out = []
        with layers.hooked(ref, num.layer.append, lambda _: num.layer.pop()):
            out.append(ref.hp_coder(torch.zeros(1, 1, 64, 64), 10.0))
    pmctf_l = load_family("pmctf_l")
    assert set(work.ops) == {pmctf_l.LIFTING, pmctf_l.LSTM, pmctf_l.PRIORS, pmctf_l.POSTPROCESS}
    assert num.layer == ["other"]


def test_frames_are_the_seeds():
    a = smooth_moving(3, 32, 48, "cpu", 2 ** 31 + 7)
    b = smooth_moving(3, 32, 48, "cpu", 2 ** 31 + 7)
    c = smooth_moving(3, 32, 48, "cpu", 2 ** 31 + 8)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)
    assert not torch.equal(a[0][0], c[0][0])
    assert a[0][0].shape == (1, 1, 32, 48) and a[1][0].shape == (2, 1, 16, 24)
    assert all(0 <= float(f.min()) and float(f.max()) <= 255 for f in a[0] + a[1])


def test_motion_is_a_few_pixels_and_follows_the_seed():
    motions = {gop_motion(s, 3) for s in range(50)}
    assert len(motions) > 10 and (0, 0) not in motions
    assert all(max(abs(dy), abs(dx)) <= 3 for dy, dx in motions)
    y = smooth_moving(2, 32, 48, "cpu", 11, noise_std=0.0)[0]
    dy, dx = gop_motion(11, 3)
    m = 3
    # frame 1 is frame 0 moved by (dy, dx) where both see the texture
    a = y[0][0, 0, max(dy, 0) + m: 32 - m, max(dx, 0) + m: 48 - m]
    b = y[1][0, 0, max(dy, 0) + m - dy: 32 - m - dy, max(dx, 0) + m - dx: 48 - m - dx]
    assert torch.allclose(a, b)


def test_weights_follow_the_seed_and_fill_every_leaf():
    with torch.device("meta"):
        ref = PMCTF(**TINY_MODEL)
    s1 = make_state(ref, 2 ** 31 + 5, "cpu")
    s2 = make_state(ref, 2 ** 31 + 5, "cpu")
    s3 = make_state(ref, 2 ** 31 + 6, "cpu")
    assert set(s1) == {n for n, _ in ref.named_parameters()}
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    w = "hp_coder.dequantModule.conv2.weight"
    assert not torch.equal(s1[w], s3[w]) and float(s1[w].abs().max()) <= 2 * 0.02 / 0.8796 + 1e-6
    assert float(s1["hp_coder.QP"][0]) == 1 / 16
