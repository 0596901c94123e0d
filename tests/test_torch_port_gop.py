"""Port parity, the whole slices: learned_pmctf_tpu_torch.gop.code_gop
(the estimate path) and gop.stream_gop (real bitstreams through
PMCTFCodec) against the JAX PMCTF driven through the same GOP ladder as
the JAX package's bench (bench.py:code_gop, without its jit and chroma
batching): warp_mode="exact", f32, small config, 64x64 luma and 32x32
chroma. One run of the JAX ladder serves both.
"""


import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from numpy.lib.stride_tricks import sliding_window_view

from learned_pmctf_tpu.models import PMCTF as JaxPMCTF

from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.gop import code_gop, gop_schedule, stream_gop
from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
from torch_port_helpers import (jax_small_model, jax_small_params,
                                    port_small_model)

Q = 10.0


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


@pytest.fixture(scope="module")
def models():
    params = jax_small_params(seed=1)
    return (jax_small_model(), jax.tree_util.tree_map(jnp.asarray, params),
            port_small_model(params))


def synthetic_frames(n, h=64, w=64, seed=21):
    """n smooth frames moving by (2, 3) px per frame: luma (1,1,H,W) and
    chroma (2,1,H/2,W/2), so the GOP exercises motion estimation."""
    g = np.random.default_rng(seed)
    base = g.normal(128, 40, (h * 2 + 4, w * 2 + 4))
    base = sliding_window_view(base, (5, 5)).mean(axis=(2, 3))
    luma, chroma = [], []
    for t in range(n):
        dy, dx = 2 * t, 3 * t
        y = base[dy:dy + h, dx:dx + w] + g.normal(0, 2, (h, w))
        c = base[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2]
        c = np.stack([c + g.normal(0, 2, c.shape),
                      255 - c + g.normal(0, 2, c.shape)])
        luma.append(np.clip(y, 0, 255)[None, None].astype(np.float32))
        chroma.append(np.clip(c, 0, 255)[:, None].astype(np.float32))
    return luma, chroma


def jax_gop(jm, jp, luma, chroma, q_index):
    """The JAX package's GOP ladder (bench.py:code_gop), run eagerly."""
    fl = [jnp.asarray(f) for f in luma]
    fc = [jnp.asarray(f) for f in chroma]
    dpb0 = {"mv_feature": None, "ref_mv_y": None}
    mvs = [None] * len(fl)
    bits = {}
    cur_stage, dpb = -1, None
    for stage, fi, step, code_lt in gop_schedule(len(fl)):
        if stage != cur_stage:
            cur_stage, dpb = stage, dpb0
        st = min(stage, jm.num_me_stages - 1)
        out = jm.apply(jp, fl[fi], fl[fi + step], jnp.float32(q_index), code_lt,
                       dpb, stage_idx=st, training=False)
        outc = jm.apply(jp, fc[fi], fc[fi + step], jnp.float32(q_index),
                        code_lt, dpb0, mv_hat=out["mv_hat"], stage_idx=st,
                        training=False)
        dpb = out["dpb"]
        fl[fi], fl[fi + step] = out["L_t"], out["H_t"]
        fc[fi], fc[fi + step] = outc["L_t"], outc["H_t"]
        mvs[fi + step] = out["mv_hat"]
        bits[fi + step] = {"bit_H": float(out["bit_H"]) + float(outc["bit_H"]),
                           "bit_ME": float(out["bit_ME"])}
        if code_lt:
            bits[fi] = {"bit_L": float(out["bit_L"]) + float(outc["bit_L"])}
    for stage, fi, step, _ in reversed(gop_schedule(len(fl))):
        st = min(stage, jm.num_me_stages - 1)
        fl[fi], fl[fi + step] = jm.apply(jp, fl[fi], fl[fi + step],
                                         mvs[fi + step], st,
                                         method=JaxPMCTF.inverse_mctf)
        fc[fi], fc[fi + step] = jm.apply(jp, fc[fi], fc[fi + step],
                                         mvs[fi + step], st, True,
                                         method=JaxPMCTF.inverse_mctf)
    return bits, [np.asarray(f) for f in fl], [np.asarray(f) for f in fc]


@pytest.fixture(scope="module")
def jax_ladders(models):
    """GOP length -> (frames, the JAX ladder's result), computed once."""
    jm, jp, _ = models
    cache = {}

    def get(gop):
        if gop not in cache:
            luma, chroma = synthetic_frames(gop)
            cache[gop] = (luma, chroma), jax_gop(jm, jp, luma, chroma, Q)
        return cache[gop]
    return get


def _check_gop(models, jax_ladders, gop):
    _, _, port = models
    (luma, chroma), (ref_bits, ref_luma, ref_chroma) = jax_ladders(gop)
    got = code_gop(port, luma, chroma, Q, device="cpu")

    assert set(got["bits"]) == set(ref_bits) == set(range(gop))
    for fi, ref in ref_bits.items():
        assert set(got["bits"][fi]) == set(ref)
        for key, r in ref.items():
            o = got["bits"][fi][key]
            assert abs(o - r) / max(abs(r), 1.0) < 1e-4, (gop, fi, key, o, r)
    _check_planes(got, ref_luma, ref_chroma, gop)


def _check_planes(got, ref_luma, ref_chroma, gop):
    for fi in range(gop):
        for name, port_f, ref_f in (("luma", got["luma"][fi], ref_luma[fi]),
                                    ("chroma", got["chroma"][fi], ref_chroma[fi])):
            assert port_f.shape == ref_f.shape
            err = float(np.max(np.abs(port_f.numpy() - ref_f)))
            assert err < 5e-2, (gop, fi, name, err)


def test_estimate_one_stage_gop4_matches_jax(models, jax_ladders):
    """PMCTFCodec.estimate_one_stage and inverse_mctf through the GOP-4
    ladder, as the JAX package's test_pmctf_flex.py drives its codec."""
    _, _, port = models
    (luma, chroma), (ref_bits, ref_luma, ref_chroma) = jax_ladders(4)
    fl = [torch.tensor(f) for f in luma]
    fc = [torch.tensor(f) for f in chroma]
    sched = gop_schedule(4)
    mvs, bits = [None] * 4, {}
    with PMCTFCodec(port, device="cpu") as codec:
        cur_stage, dpb = -1, None
        for stage, fi, step, code_lt in sched:
            if stage != cur_stage:
                cur_stage, dpb = stage, empty_dpb()
            res = codec.estimate_one_stage(
                (fl[fi], fc[fi]), (fl[fi + step], fc[fi + step]), code_lt, dpb,
                stage_idx=port.me_index(stage), q_index=Q)
            dpb = res["dpb"]
            fl[fi], fl[fi + step] = res["L_t"], res["H_t"]
            fc[fi], fc[fi + step] = res["L_tc"], res["H_tc"]
            mvs[fi + step] = res["mv_hat"]
            bits[fi + step] = {"bit_H": res["bit_H"], "bit_ME": res["bit_ME"]}
            if code_lt:
                bits[fi] = {"bit_L": res["bit_L"]}
                assert res["bit_L"] > res["bit_Lc"] > 0
            assert res["bit_H"] > res["bit_Hc"] > 0
        for stage, fi, step, _ in reversed(sched):
            me = port.me_index(stage)
            fl[fi], fl[fi + step] = codec.inverse_mctf(
                fl[fi], fl[fi + step], mvs[fi + step], stage_idx=me)
            fc[fi], fc[fi + step] = codec.inverse_mctf(
                fc[fi], fc[fi + step], mvs[fi + step], stage_idx=me,
                downscale=True)
    assert set(bits) == set(ref_bits)
    for fi, ref in ref_bits.items():
        assert set(bits[fi]) == set(ref)
        for key, r in ref.items():
            assert abs(bits[fi][key] - r) / max(abs(r), 1.0) < 1e-4, (fi, key)
    _check_planes({"luma": fl, "chroma": fc}, ref_luma, ref_chroma, 4)


def test_gop_schedule_matches_bench_ladder():
    sched = gop_schedule(8)
    assert [(s, fi, st) for s, fi, st, _ in sched] == [
        (0, 0, 1), (0, 2, 1), (0, 4, 1), (0, 6, 1),
        (1, 0, 2), (1, 4, 2), (2, 0, 4)]
    assert [lt for *_, lt in sched] == [False] * 6 + [True]
    assert len(gop_schedule(16)) == 15
    with pytest.raises(ValueError):
        gop_schedule(6)


def test_code_gop4_matches_jax(models, jax_ladders):
    _check_gop(models, jax_ladders, 4)


@pytest.mark.slow
def test_code_gop8_matches_jax(models, jax_ladders):
    _check_gop(models, jax_ladders, 8)


# Stream bits against the estimate on these weights and frames (measured,
# GOP-4 and GOP-8): the H and L bands cost 1.1x to 1.6x their estimate.
# The coder quantizes each scale down to its 256-level table and codes
# symbols beyond its +-50 range through the bypass, the seeded random
# weights predict poorly, and each file carries a 16-byte header. The
# motion streams of a 64x64 frame code a 1x1 hyper-latent and a 4x4
# latent: 25 bytes, 6 of them header, against an estimate of 33 bits.
BITS_RATIO = (1.0, 2.0)
ME_BITS_MAX = 8 * 40


def _check_stream_gop(models, jax_ladders, tmp_path, gop):
    _, _, port = models
    (luma, chroma), (ref_bits, ref_luma, ref_chroma) = jax_ladders(gop)
    with PMCTFCodec(port, device="cpu") as codec:
        codec.update()
        got = stream_gop(codec, luma, chroma, Q, str(tmp_path), psize=64,
                         device="cpu")
    assert len(got["max_err"]) == gop - 1
    assert set(got["max_err"].values()) == {0.0}  # decoded == encoder side
    assert set(got["bits"]) == set(ref_bits) == set(range(gop))
    for fi, ref in ref_bits.items():
        assert set(got["bits"][fi]) == set(ref)
        for key, r in ref.items():
            o = got["bits"][fi][key]
            if key == "bit_ME":
                assert 0 < o <= ME_BITS_MAX, (gop, fi, key, o, r)
            else:
                assert BITS_RATIO[0] <= o / r <= BITS_RATIO[1], (gop, fi, key, o, r)
    _check_planes(got, ref_luma, ref_chroma, gop)


def test_stream_gop4_matches_jax(models, jax_ladders, tmp_path):
    _check_stream_gop(models, jax_ladders, tmp_path, 4)


@pytest.mark.slow
def test_stream_gop8_matches_jax(models, jax_ladders, tmp_path):
    _check_stream_gop(models, jax_ladders, tmp_path, 8)
