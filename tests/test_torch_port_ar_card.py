"""The AR LL coder on the card: a small ll_mode="ar" GOP-4 encoded to
streams and decoded again through PMCTFCodec (every LL plane decoded
front by front), with PostProcess on the conv3x3 CUDA kernels.

This file imports torch and the port only, so that it also runs where the
JAX package's dependencies are not installed:

    python -m pytest tests/test_torch_port_ar_card.py -m cuda

Without a card the test skips.
"""

import numpy as np
import pytest
import torch

from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.gop import stream_gop
from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
from learned_pmctf_tpu_torch.ops.conv3x3 import conv3x3

SMALL_AR = dict(decomp_levels=2, num_me_stages=2, channel_mv=8, channel_n=8,
                features=16, ar_features=16, ll_mode="ar")


def _frames(n, h=64, w=64, seed=3):
    g = np.random.default_rng(seed)
    base = g.normal(128, 40, (h + 2 * n, w + 3 * n))
    luma, chroma = [], []
    for t in range(n):
        y = base[2 * t:2 * t + h, 3 * t:3 * t + w] + g.normal(0, 2, (h, w))
        c = g.integers(0, 256, (2, 1, h // 2, w // 2))
        luma.append(np.clip(y, 0, 255)[None, None].astype(np.float32))
        chroma.append(c.astype(np.float32))
    return luma, chroma


@pytest.mark.cuda
def test_ar_stream_gop4_round_trip_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv3x3 kernels have no CPU mode")
    model = build_pmctf("cuda", seed=1, **SMALL_AR)
    luma, chroma = _frames(4)
    runs = []
    with PMCTFCodec(model) as codec:
        codec.update()
        for name in ("first", "again"):
            d = tmp_path / name
            d.mkdir()
            conv3x3.launches = 0
            codec.stats.reset()
            out = stream_gop(codec, luma, chroma, 10.0, str(d), psize=64)
            torch.cuda.synchronize()
            assert conv3x3.launches == 2 * 8 * 15, (name, conv3x3.launches)
            # LL planes of 16x16 (46 fronts) and 2x8x8 (22 fronts), 4 each
            assert codec.stats.ar_fronts == 4 * 46 + 4 * 22
            assert set(out["max_err"].values()) == {0.0}, (name, out["max_err"])
            runs.append((out, {f.name: f.read_bytes() for f in sorted(d.iterdir())}))
    assert runs[0][1] == runs[1][1] and len(runs[0][1]) == 11
    for plane in ("luma", "chroma"):
        for a, b in zip(runs[0][0][plane], runs[1][0][plane]):
            assert torch.equal(a, b) and torch.isfinite(a).all()
