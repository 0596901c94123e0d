"""Port parity, the real-bitstream path: the model sub-graphs the codecs
call against their flax counterparts (eagerly, never through the JAX
package's jitted codec), and the port's PWaveCodec and PMCTFCodec round
trips on the CPU (decoded == encoder side, bit for bit; bytes stable
across encodes). The stream GOP against the JAX package's estimate
ladder is in tests/test_torch_port_gop.py, beside the estimate GOP, so
that the two share one run of the JAX ladder.

Small config and 64x64 luma / 32x32 chroma, as tests/test_torch_port_models.py.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models import PMCTF as JaxPMCTF
from learned_pmctf_tpu.models.context import ContextFusionFourStep as JaxFourStep
from learned_pmctf_tpu.models.mv_coder import (
    four_part_prior_decode_scales as jax_decode_scales,
    four_part_prior_scatter as jax_scatter)
from learned_pmctf_tpu.models.pwave import PWave as JaxPWave
from learned_pmctf_tpu.ops.masks import checkerboard_masks as jax_masks

from learned_pmctf_tpu_torch.codec.image_codec import PWaveCodec
from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.gop import stream_gop
from learned_pmctf_tpu_torch.models.mv_coder import (
    four_part_prior_decode_scales, four_part_prior_scatter)
from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
from learned_pmctf_tpu_torch.ops.masks import checkerboard_masks
from test_torch_port_gop import synthetic_frames
from test_torch_port_models import (SMALL, assert_close, frames, jax_small_model,
                                    jax_small_params, numpy_of, port_small_model)

Q = 10.0
PSIZE = 64  # the frames are 64x64: padded to 64 already


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


@pytest.fixture(scope="module")
def codec(models):
    with PMCTFCodec(models[2], device="cpu") as c:
        c.update()
        yield c


def jax_pwave():
    return JaxPWave(decomp_levels=SMALL["decomp_levels"], features=SMALL["features"],
                    ar_features=SMALL["ar_features"])


def t(x):
    return torch.tensor(numpy_of(x))


# ---- the model sub-graphs the codecs call -----------------------------------

def test_pwave_quantize_planes_and_reconstruct(models):
    _, jp, port = models
    sub = {"params": jp["params"]["hp_coder"]}
    x = np.random.default_rng(5).normal(0, 30, (2, 1, 64, 64)).astype(np.float32)
    qp = np.float32(0.8)
    ref = jax_pwave().apply(sub, jnp.asarray(x), jnp.float32(Q), qp,
                            method=JaxPWave.quantize_planes)
    with torch.no_grad():
        got = port.hp_coder.quantize_planes(torch.tensor(x), Q, torch.tensor(qp))
    assert list(got) == list(ref)  # coding order
    for key in ref:
        assert_close(got[key], ref[key], 2e-3, f"quantize_planes[{key}]")

    g = np.random.default_rng(6)
    sb = {lvl: {band: np.round(g.normal(0, 4, (1, 1, 32 >> lvl, 32 >> lvl)))
                .astype(np.float32) for band in ("lh", "hl", "hh")}
          for lvl in range(2)}
    sb[1]["ll"] = np.round(g.normal(0, 40, (1, 1, 16, 16))).astype(np.float32)
    for qps in (None, qp):
        ref = jax_pwave().apply(
            sub, jax.tree_util.tree_map(jnp.asarray, sb), jnp.float32(Q), qps,
            method=JaxPWave.reconstruct)
        with torch.no_grad():
            got = port.hp_coder.reconstruct(
                jax.tree_util.tree_map(torch.tensor, sb), Q,
                None if qps is None else torch.tensor(qps))
        assert_close(got, ref, 2e-2, f"reconstruct[qp={qps}]")


@pytest.mark.parametrize("upsample_level", [None, 0])
def test_pwave_ctx_init_and_step(models, upsample_level):
    _, jp, port = models
    sub = {"params": jp["params"]["lp_coder"]}
    sb = np.random.default_rng(7).normal(0, 10, (1, 1, 16, 16)).astype(np.float32)
    states = jax_pwave().apply(sub, jnp.asarray(sb), method=JaxPWave.ctx_init)
    ref_ctx, ref_states = jax_pwave().apply(sub, jnp.asarray(sb), states, None,
                                            method=JaxPWave.ctx_step)
    ref_ctx, ref_states = jax_pwave().apply(sub, ref_ctx[:, :1], ref_states,
                                            upsample_level, method=JaxPWave.ctx_step)
    with torch.no_grad():
        p_states = port.lp_coder.ctx_init(torch.tensor(sb))
        for s in jax.tree_util.tree_leaves(p_states):
            assert s.shape[2:] == (16, 16) and not s.any()
        ctx, p_states = port.lp_coder.ctx_step(torch.tensor(sb), p_states)
        ctx, p_states = port.lp_coder.ctx_step(ctx[:, :1], p_states, upsample_level)
    assert_close(ctx, ref_ctx, 2e-3, "ctx_step context")
    for p, r in zip(jax.tree_util.tree_leaves(p_states),
                    jax.tree_util.tree_leaves(ref_states)):
        assert p.shape == r.shape
        assert_close(p, r, 2e-3, "ctx_step state")


@pytest.mark.parametrize("key", ["0_hl", "1_lh", "ll"])
def test_fusion_hier_and_spatial_params(models, key):
    """The four-step passes as the codec runs them, one at a time, with
    `like` standing for the missing context of the LL model."""
    _, jp, port = models
    g = np.random.default_rng(8)
    lvl, band = (1, "ll") if key == "ll" else (int(key[0]), key[2:])
    size = 16 if lvl == 1 else 32
    use_ctx = key != "ll"
    ctx = g.normal(0, 1, (2, 1, size, size)).astype(np.float32) if use_ctx else None
    prev = g.normal(0, 6, (2, 1, size // 2, size // 2)).astype(np.float32) \
        if lvl == 0 else None
    like = np.zeros((2, 1, size, size), np.float32)
    jm = JaxFourStep(in_ch=1, ctx_ch=2 if lvl == 0 else 1, use_ctx=use_ctx,
                     features=SMALL["ar_features" if key == "ll" else "features"])
    sub = {"params": jp["params"]["lp_coder"][f"context_fusion_{key}"]}
    fusion = port.lp_coder.context_fusion[lvl][band]
    opt = (lambda a, f: None if a is None else f(a))
    ref = jm.apply(sub, opt(ctx, jnp.asarray), opt(prev, jnp.asarray),
                   like=jnp.asarray(like), method=JaxFourStep.hier_params)
    with torch.no_grad():
        got = fusion.hier_params(opt(ctx, torch.tensor), opt(prev, torch.tensor),
                                 like=torch.tensor(like))
    assert (got[0] is None) == (ref[0] is None)
    for p, r, name in zip(got, ref, ("ctx_feat", "scales", "means")):
        if r is not None:
            assert_close(p, r, 2e-3, f"hier_params {name}")
    x_hat = g.normal(0, 5, (2, 1, size, size)).astype(np.float32)
    for step in range(3):
        ref_s = jm.apply(sub, jnp.asarray(x_hat), ref[0], step,
                         method=JaxFourStep.spatial_params)
        with torch.no_grad():
            got_s = fusion.spatial_params(torch.tensor(x_hat), got[0], step)
        for p, r in zip(got_s, ref_s):
            assert_close(p, r, 2e-3, f"spatial_params[{step}]")


def test_four_part_prior_decode_helpers():
    g = np.random.default_rng(9)
    scales = [g.normal(0, 1, (1, 2, 6, 10)).astype(np.float32) for _ in range(4)]
    means = [g.normal(0, 1, (1, 2, 6, 10)).astype(np.float32) for _ in range(4)]
    vals = np.round(g.normal(0, 3, (1, 2, 6, 10))).astype(np.float32)
    for step in range(4):
        ref = jax_decode_scales([jnp.asarray(s) for s in scales], jax_masks(6, 10), step)
        got = four_part_prior_decode_scales([torch.tensor(s) for s in scales],
                                            checkerboard_masks(6, 10), step)
        assert_close(got, ref, 1e-7, f"decode_scales[{step}]")
        ref = jax_scatter(jnp.asarray(vals), [jnp.asarray(m) for m in means],
                          jax_masks(6, 10), step)
        got = four_part_prior_scatter(torch.tensor(vals),
                                      [torch.tensor(m) for m in means],
                                      checkerboard_masks(6, 10), step)
        assert_close(got, ref, 1e-7, f"scatter[{step}]")


@pytest.fixture(scope="module")
def mv_runs(models):
    """The MV sub-graphs of one luma pair, JAX and port, with and without
    a DPB (stage 1: its own per-stage weights)."""
    jm, jp, port = models
    (ref_y, cur_y), _ = frames(11)
    stage = 1
    out = {}
    for name, dpb in (("first", None), ("dpb", "from first")):
        if dpb is None:
            jd, pd = {"mv_feature": None, "ref_mv_y": None}, empty_dpb()
        else:
            jd, pd = out["first"]["jax_dpb"], out["first"]["port_dpb"]
        mv_y, z = jm.apply(jp, jnp.asarray(ref_y), jnp.asarray(cur_y), jd, stage,
                           jnp.float32(Q), 1, method=JaxPMCTF.mv_latent_planes)
        with torch.no_grad():
            p_mv_y, p_z = port.mv_latent_planes(torch.tensor(ref_y),
                                                torch.tensor(cur_y), pd, stage, Q)
        # feed both sides the same rounded latent from here on
        mp = jm.apply(jp, z, jd, stage, method=JaxPMCTF.mv_prior_params)
        split = jm.apply(jp, mp, method=JaxPMCTF.mv_decode_split)
        yh = jnp.round(mv_y / split[0])
        spatial = [jm.apply(jp, yh, mp, stage, k, method=JaxPMCTF.mv_decode_spatial)
                   for k in range(3)]
        tail = jm.apply(jp, yh * split[0], stage, jnp.float32(Q), 1,
                        method=JaxPMCTF.mv_decode_tail)
        with torch.no_grad():
            p_mp = port.mv_prior_params(t(z), pd, stage)
            p_split = port.mv_decode_split(t(mp))
            p_spatial = [port.mv_decode_spatial(t(yh), t(mp), stage, k)
                         for k in range(3)]
            p_tail = port.mv_decode_tail(t(yh * split[0]), stage, Q)
        out[name] = {
            "latent": ((p_mv_y, p_z), (mv_y, z)), "prior": (p_mp, mp),
            "split": (p_split, split), "spatial": (p_spatial, spatial),
            "tail": (p_tail, tail),
            "jax_dpb": {"mv_feature": tail[1], "ref_mv_y": yh * split[0]},
            "port_dpb": {"mv_feature": t(tail[1]), "ref_mv_y": t(yh * split[0])}}
    return out


@pytest.mark.parametrize("mode", ["first", "dpb"])
def test_mv_sub_graphs(mv_runs, mode):
    run = mv_runs[mode]
    (p_mv_y, p_z), (mv_y, z) = run["latent"]
    assert_close(p_mv_y, mv_y, 5e-3, "mv_latent_planes mv_y")
    # z is rounded: where z lies within float noise of a half the two
    # frameworks may round apart, by one whole step
    d = np.abs(numpy_of(p_z) - numpy_of(z))
    assert np.all((d == 0) | (np.abs(d - 1) < 1e-6)) and d.mean() < 0.05, d.max()
    assert_close(*run["prior"], 2e-3, "mv_prior_params")
    p_split, split = run["split"]
    assert_close(p_split[0], split[0], 1e-6, "mv_decode_split q_dec")
    for part in (1, 2):
        assert len(p_split[part]) == len(split[part]) == 4
        for p, r in zip(p_split[part], split[part]):
            assert_close(p, r, 1e-6, "mv_decode_split quarters")
    for (ps, pm), (rs, rm) in zip(*run["spatial"]):
        for p, r in zip(ps + pm, rs + rm):
            assert_close(p, r, 2e-3, "mv_decode_spatial")
    (p_mv, p_feat), (mv, feat) = run["tail"]
    assert_close(p_mv, mv, 5e-3, "mv_decode_tail mv_hat")
    assert_close(p_feat, feat, 2e-3, "mv_decode_tail feature")


# ---- round trips ---------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("q_index", [0, 20])
def test_pwave_codec_round_trip(models, tmp_path, batch, q_index):
    _, _, port = models
    codec = PWaveCodec(port.hp_coder, device="cpu")
    x = torch.tensor(np.random.default_rng(12).normal(0, 25, (batch, 1, 64, 64)),
                     dtype=torch.float32)
    path = str(tmp_path / "x.bin")
    recon, stream = codec.compress(x, q_index, file_name=path,
                                   sideinfo=(1, batch, 64, 64))
    recon2, stream2 = codec.compress(x, q_index, coder=codec.make_coder())
    assert stream == stream2 and torch.equal(recon, recon2)
    decoded = codec.decompress(path, padding=PSIZE, q_index=q_index)["x_hat"]
    assert decoded.shape == x.shape
    assert torch.equal(decoded, recon)
    # the stream's reconstruction is the estimate path's
    with torch.no_grad():
        est = port.hp_coder(x, float(q_index))["x_hat"]
    assert float((est - recon).abs().max()) < 1e-3


def _bin_files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_pmctf_codec_gop4_round_trip(codec, tmp_path):
    luma, chroma = synthetic_frames(4)
    d1, d2 = tmp_path / "decode", tmp_path / "encode_only"
    d1.mkdir()
    d2.mkdir()
    dec = stream_gop(codec, luma, chroma, Q, str(d1), psize=PSIZE, device="cpu")
    enc = stream_gop(codec, luma, chroma, Q, str(d2), psize=PSIZE,
                     skip_decoding=True, device="cpu")
    assert len(dec["max_err"]) == 3 and set(dec["max_err"].values()) == {0.0}
    assert enc["max_err"] == {}
    for plane in ("luma", "chroma"):
        for a, b in zip(dec[plane], enc[plane]):
            assert torch.equal(a, b)
    files = _bin_files(d1)
    assert set(files) == {"s0_0.bin", "s0_0_C_main.bin", "s0_0_mv.bin",
                          "s0_1.bin", "s0_1_C_main.bin", "s0_1_mv.bin",
                          "s1_0.bin", "s1_0_C_main.bin", "s1_0_mv.bin",
                          "0_main.bin", "0_C_main.bin"}
    assert files == _bin_files(d2)  # bytes identical across encodes
    assert dec["bits"] == enc["bits"]
    assert dec["bits"][3]["bit_ME"] == 8 * len(files["s0_1_mv.bin"])
    assert dec["bits"][0]["bit_L"] == 8 * (len(files["0_main.bin"])
                                           + len(files["0_C_main.bin"]))


def test_pmctf_codec_decode_async(codec, tmp_path):
    luma, chroma = synthetic_frames(4)
    (tmp_path / "a").mkdir()
    (tmp_path / "s").mkdir()
    out = stream_gop(codec, luma, chroma, Q, str(tmp_path / "a"), psize=PSIZE,
                     decode_async=True, device="cpu")
    ref = stream_gop(codec, luma, chroma, Q, str(tmp_path / "s"), psize=PSIZE,
                     device="cpu")
    assert len(out["max_err"]) == 3 and set(out["max_err"].values()) == {0.0}
    assert codec._pending_decodes == []
    assert _bin_files(tmp_path / "a") == _bin_files(tmp_path / "s")
    for plane in ("luma", "chroma"):
        for a, b in zip(out[plane], ref[plane]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("check,strict", [(True, True), (True, False),
                                          (False, True)])
def test_pmctf_codec_drain_decodes_check_and_strict(codec, tmp_path, check, strict):
    """A deferred decode held against an encoder-side plane made one
    off: check=True measures it, strict=True raises on it, check=False
    measures nothing."""
    luma, chroma = synthetic_frames(2)
    f = [(torch.tensor(y), torch.tensor(c)) for y, c in zip(luma, chroma)]
    codec.encode_one_stage(f[0], f[1], True, empty_dpb(),
                           str(tmp_path / "s0_0.bin"), 64, 64, psize=PSIZE,
                           decode_async=True)
    expect = codec._pending_decodes[0]["expect"]
    expect["H_t"] = expect["H_t"] + 1.0
    if check and strict:
        with pytest.raises(ValueError, match="deferred decode mismatch"):
            codec.drain_decodes(check, strict)
        assert codec._pending_decodes == []
        return
    (got,) = codec.drain_decodes(check, strict)
    assert codec._pending_decodes == []
    assert got["name"] == str(tmp_path / "s0_0.bin")
    if check:
        assert set(got["errs"]) == {"mv_hat", "mv_y_hat", "H_t", "H_tc", "L_t",
                                    "L_tc"}
        # one off, give or take the rounding of the f32 sum
        assert got["errs"]["H_t"] == got["max_err"] > 0.5
        assert {v for k, v in got["errs"].items() if k != "H_t"} == {0.0}
    else:
        assert got["errs"] == {} and got["max_err"] == 0.0
    assert set(got["decoded"]) == {"mv", "luma", "chroma"}


def test_pmctf_codec_close_refuses_undrained_decodes(models, tmp_path):
    _, _, port = models
    luma, chroma = synthetic_frames(2)
    f = [(torch.tensor(y), torch.tensor(c)) for y, c in zip(luma, chroma)]
    codec = PMCTFCodec(port, device="cpu")
    codec.update()
    codec.encode_one_stage(f[0], f[1], True, empty_dpb(),
                           str(tmp_path / "s0_0.bin"), 64, 64, psize=PSIZE,
                           decode_async=True)
    with pytest.raises(RuntimeError, match="undrained"):
        codec.close()
    assert codec._pending_decodes == []
    codec.close()  # the pools are gone, nothing is pending: a no-op


def test_codecs_refuse_a_model_on_another_device(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="model is on cpu"):
        PMCTFCodec(models[2], device="cuda")
    with pytest.raises(ValueError, match="module is on cpu"):
        PWaveCodec(models[2].hp_coder, device="cuda")
