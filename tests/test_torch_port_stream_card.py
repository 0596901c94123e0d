"""The real-bitstream path on the card: a small GOP-4 encoded to streams
and decoded again through PMCTFCodec, with PostProcess on the conv3x3
CUDA kernels.

This file imports torch and the port only, so that it also runs where the
JAX package's dependencies are not installed:

    python -m pytest tests/test_torch_port_stream_card.py -m cuda

Without a card the test skips.
"""

import os

import numpy as np
import pytest
import torch

from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.gop import stream_gop
from learned_pmctf_tpu_torch.models.layers import residual_convs
from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
from learned_pmctf_tpu_torch.ops.conv3x3 import conv3x3

SMALL = dict(decomp_levels=2, num_me_stages=2, channel_mv=8, channel_n=8,
             features=16, ar_features=16)


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


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.cuda
def test_stream_gop4_round_trip_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv3x3 kernels have no CPU mode")
    model = build_pmctf("cuda", seed=1, **SMALL)
    luma, chroma = _frames(4)
    with PMCTFCodec(model) as codec:
        codec.update()
        runs = {}
        for name, kw in (("sync", {}), ("again", {}),
                         ("async", {"decode_async": True})):
            d = tmp_path / name
            d.mkdir()
            conv3x3.launches, conv3x3.per_call_by_variant = 0, {}
            out = stream_gop(codec, luma, chroma, 10.0, str(d), psize=64, **kw)
            torch.cuda.synchronize()
            # 8 reconstructions a side (3 pairs' H bands, the L bands),
            # 15 PostProcess convs each, and 8 pWave calls a side, each
            # running every residual conv of the priors on the kernel; the
            # decodes launch from worker threads
            priors = sum(conv3x3.per_call_by_variant.values())
            assert priors == 2 * 8 * residual_convs(model.lp_coder), (name, priors)
            assert conv3x3.launches - priors == 2 * 8 * 15, (name, conv3x3.launches)
            assert len(out["max_err"]) == 3
            assert set(out["max_err"].values()) == {0.0}, (name, out["max_err"])
            runs[name] = out, _files(d)
    assert runs["sync"][1] == runs["again"][1] == runs["async"][1]
    for plane in ("luma", "chroma"):
        for a, b in zip(runs["sync"][0][plane], runs["async"][0][plane]):
            assert torch.equal(a, b)
            assert torch.isfinite(a).all()
