"""Port parity, the AR LL coder (ll_mode="ar", the reference model's):
the causal masks, MaskedConv2d and ContextFusionSubband, PWave's AR
estimate forward, one AR forward_one_stage pair, the wavefront schedule,
the partial-plane invariant the wavefront decoder rests on, the AR
encoder's symbols and indexes, and the AR codecs' round trips. (The
masks, MaskedConv2d, the wavefronts and the PWaveCodec round trip are in
test_torch_port_ar_2.py to _4.py, which import this file's helpers:
at most eight tests a file.)

Small config (decomp_levels=2, features=16, ar_features=16, channel_mv=8,
64x64 luma planes, LL planes of 16x16); the flax side runs eagerly on the
CPU. Tolerances: masks exact; modules 1e-5 abs (times the output's
largest magnitude where that exceeds 1, at unit-gain weights); PWave and the stage pair
bits rel 1e-4 and planes 5e-2 abs (the bounds of tests/test_gop_parity.py);
wavefronts exact; partial against full plane bit-equal; the encoder's
indexes and rounded means as tests/test_torch_port_entropy.py allows
(XLA's f32 log and convs differ from torch's by ulps: a value within a
few ulps of a boundary may land one step apart, rarely); round trips bit-exact.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.entropy import coder as jcoder
from learned_pmctf_tpu.models import PMCTF as JaxPMCTF
from learned_pmctf_tpu.models.context import ContextFusionSubband as JaxSubband
from learned_pmctf_tpu.models.pwave import PWave as JaxPWave

from learned_pmctf_tpu_torch.codec.image_codec import PWaveCodec, ar_wavefronts
from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.convert import params_from_jax
from learned_pmctf_tpu_torch.gop import stream_gop
from learned_pmctf_tpu_torch.models.context import ContextFusionSubband
from learned_pmctf_tpu_torch.models.pmctf import build_pmctf, empty_dpb
from test_torch_port_gop import synthetic_frames
from torch_port_helpers import SMALL, _draw, assert_close, assert_rel, frames

AR = dict(SMALL, ll_mode="ar")
Q = 10.0
LL_KEY = "context_fusion_ll"


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


def jax_ar_model():
    return JaxPMCTF(warp_mode="exact", spynet_luma=True, **AR)


@functools.lru_cache(maxsize=1)
def _ar_shapes():
    x = jnp.zeros((1, 1, 64, 64), jnp.float32)
    return jax.eval_shape(lambda: jax_ar_model().init(
        {"params": jax.random.PRNGKey(0)}, x, x, 10, empty_dpb(),
        method=JaxPMCTF.full_init_graph))


def jax_ar_params(seed=0, unit_gain=False):
    """{"params": tree} of numpy arrays for jax_ar_model(), drawn as
    test_torch_port_models draws them. unit_gain redraws both coders' AR
    nets at std 1/sqrt(fan-in) (bias std 0.5): their scales then span
    most table rows and their means reach several units, where the init's small
    weights give scales in the lowest rows and means that round to 0."""
    g = np.random.default_rng(seed)

    def draw(path, s):
        names = tuple(str(k.key) for k in path)
        if unit_gain and LL_KEY in names:
            if names[-1] == "kernel":
                return g.normal(0, 1, s.shape) / np.sqrt(np.prod(s.shape[1:]))
            return g.normal(0, 0.5, s.shape)
        return _draw(names, s.shape, g)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: draw(p, s).astype(np.float32), _ar_shapes())


def port_ar_model(params):
    model = build_pmctf(device="cpu", **AR)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


@pytest.fixture(scope="module")
def models():
    params = jax_ar_params()
    return (jax_ar_model(), jax.tree_util.tree_map(jnp.asarray, params),
            port_ar_model(params), params)


@pytest.fixture(scope="module")
def unit_models():
    params = jax_ar_params(seed=2, unit_gain=True)
    return jax.tree_util.tree_map(jnp.asarray, params), port_ar_model(params)


def jax_pwave():
    return JaxPWave(decomp_levels=AR["decomp_levels"], features=AR["features"],
                    ar_features=AR["ar_features"], ll_mode="ar")


def rounded_plane(seed, shape=(2, 1, 16, 16), scale=60.0):
    g = np.random.default_rng(seed)
    return np.round(g.normal(0, scale, shape)).astype(np.float32)


# ---- masks and modules --------------------------------------------------------


@pytest.mark.parametrize("gain", ["init", "unit"])
def test_context_fusion_subband_matches_jax(models, unit_models, gain):
    jp, port = (models[1], models[2]) if gain == "init" else unit_models
    x = rounded_plane(3)
    ref = JaxSubband(in_ch=1, features=AR["ar_features"]).apply(
        {"params": jp["params"]["hp_coder"][LL_KEY]}, jnp.asarray(x))
    fusion = port.hp_coder.context_fusion[AR["decomp_levels"] - 1]["ll"]
    assert isinstance(fusion, ContextFusionSubband)
    with torch.no_grad():
        got = fusion(torch.tensor(x))
    assert got.dtype == torch.float32
    # outputs of a few units at init, up to ~40 at unit gain
    assert_close(got, ref, 1e-5 * max(1.0, float(np.abs(ref).max())),
                 f"ContextFusionSubband ({gain})")


def test_params_from_jax_consumes_every_ar_leaf(models):
    _, _, port, params = models
    sd = params_from_jax(params)
    n_jax = len(jax.tree_util.tree_leaves(params))
    stacked = 3 * (AR["num_me_stages"] - 1)  # per-stage scales unstack
    masks = [k for k in sd if k.endswith(".mask")]
    assert len(masks) == 2 * 6  # per coder: 1 + 2 * 2 + 1 masked convs
    assert len(sd) == n_jax + stacked + len(masks) == len(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert not any(k.startswith("hp_coder.context_fusion.1.ll.y_") for k in sd)
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["params"]["hp_coder"][LL_KEY]["head_3"] = {"kernel": np.zeros(1)}
    with pytest.raises(ValueError, match="no home"):
        params_from_jax(extra)


# ---- estimate path ---------------------------------------------------------------

def test_forward_one_stage_ar_pair_matches_jax(models):
    """One luma pair with code_lt: the HP and the LP coder both run AR."""
    jm, jp, port, _ = models
    (ref_y, cur_y), _ = frames(7)
    ref = jm.apply(jp, jnp.asarray(ref_y), jnp.asarray(cur_y), jnp.float32(Q),
                   True, empty_dpb(), stage_idx=0, training=False)
    with torch.no_grad():
        got = port.forward_one_stage(torch.tensor(ref_y), torch.tensor(cur_y),
                                     Q, True, empty_dpb())
    for key in ("L_t", "H_t", "mv_hat"):
        assert_close(got[key], ref[key], 5e-2, key)
    for key in ("bpp_H", "bpp_L", "bpp_me", "bit_H", "bit_L"):
        assert_rel(got[key], ref[key], 1e-4, key, floor=1e-2)


def test_pwave_ar_forward_matches_jax(models):
    """After the stage pair, whose coders run the same shapes: the flax
    side's eager ops are compiled by then."""
    _, jp, port, _ = models
    x = np.random.default_rng(5).integers(0, 256, (1, 1, 64, 64)).astype(np.float32)
    sub = {"params": jp["params"]["hp_coder"]}
    for q in (0, 20):
        ref = jax_pwave().apply(sub, jnp.asarray(x), jnp.float32(q), training=False)
        with torch.no_grad():
            got = port.hp_coder(torch.tensor(x), float(q))
        assert_close(got["x_hat"], ref["x_hat"], 5e-2, f"x_hat[q{q}]")
        assert_rel(got["bits_total"], ref["bits_total"], 1e-4, f"bits[q{q}]")


# ---- the wavefront codec ------------------------------------------------------------


def test_partial_plane_equals_full_plane_on_every_front(unit_models):
    """What the decoder computes at front t from the partial plane (the
    fronts before t decoded, zeros after) is bit for bit what the encoder
    computes there from the whole plane."""
    _, port = unit_models
    codec = PWaveCodec(port.lp_coder, device="cpu")
    full = torch.tensor(rounded_plane(4, (2, 1, 9, 15)))
    with torch.no_grad():
        ref = codec._ar_plane(full)
        ref_raw = torch.cat(port.lp_coder.ar_params(full))
        partial = torch.zeros_like(full)
        for rows, cols in ar_wavefronts(9, 15):
            got = codec._ar_plane(partial)[:, :, :, rows, cols]
            raw = torch.cat(port.lp_coder.ar_params(partial))[:, :, rows, cols]
            assert torch.equal(got, ref[:, :, :, rows, cols])
            assert torch.equal(raw, ref_raw[:, :, rows, cols])
            partial[:, :, rows, cols] = full[:, :, rows, cols]
    assert len(torch.unique(ref[0])) > 20  # the check sees varied indexes


def test_ar_encoder_symbols_and_indexes_match_jax(unit_models):
    jp, port = unit_models
    codec = PWaveCodec(port.hp_coder, device="cpu")
    x = np.random.default_rng(6).normal(0, 40, (1, 1, 64, 64)).astype(np.float32)
    with torch.no_grad():
        planes = port.hp_coder.quantize_planes(torch.tensor(x), Q)
        _, plans = codec._code_planes(1, 64, 64, teachers=planes)
    kind, (ll_int, both) = plans[0]
    assert kind == "ar" and len(plans) == 1 + 3 * AR["decomp_levels"]
    sub = {"params": jp["params"]["hp_coder"]}
    jll = np.round(np.asarray(jax_pwave().apply(
        sub, jnp.asarray(x), jnp.float32(Q), method=JaxPWave.quantize_planes)["ll"]))
    ll = ll_int.numpy()
    # the teacher planes agree to ~1e-4: a value at a half may round apart
    assert np.abs(ll - jll).max() <= 1 and np.mean(ll != jll) < 1e-2
    scales, means = jax_pwave().apply(sub, jnp.asarray(ll), method=JaxPWave.ar_params)
    ref_idx = np.asarray(jcoder.build_indexes_from_scales(scales)).ravel()
    ref_means = np.asarray(means).ravel()
    got_idx, got_means = both[0].numpy().ravel(), both[1].numpy().ravel()
    assert len(np.unique(ref_idx)) > 20 and np.abs(ref_means).max() > 2
    allowed = max(1, 1e-3 * ref_idx.size)
    d = np.flatnonzero(got_idx != ref_idx)
    assert np.all(np.abs(got_idx[d] - ref_idx[d]) == 1) and len(d) <= allowed
    d = np.flatnonzero(got_means != np.round(ref_means))
    assert np.all(np.abs(got_means[d] - np.round(ref_means[d])) == 1)
    assert np.all(np.abs(np.abs(ref_means[d] % 1) - 0.5) < 1e-4)
    assert len(d) <= allowed
    # the symbols the encoder writes: the rounded plane minus rounded means
    sym, ref_sym = ll.ravel() - got_means, ll.ravel() - np.round(ref_means)
    assert np.count_nonzero(sym != ref_sym) == len(d)


def test_stream_gop4_ar_round_trip(unit_models, tmp_path):
    """A port-only AR stream GOP-4: every decoded plane is the encoder's,
    and a second encode writes the same bytes."""
    _, port = unit_models
    luma, chroma = synthetic_frames(4)
    runs = []
    with PMCTFCodec(port, device="cpu") as codec:
        codec.update()
        for name, kw in (("decode", {}), ("encode_only", {"skip_decoding": True})):
            d = tmp_path / name
            d.mkdir()
            codec.stats.reset()
            out = stream_gop(codec, luma, chroma, Q, str(d), psize=64,
                             device="cpu", **kw)
            runs.append((out, {f.name: f.read_bytes() for f in sorted(d.iterdir())},
                         codec.stats.ar_fronts))
    (dec, files, fronts), (enc, files2, fronts2) = runs
    assert len(dec["max_err"]) == 3 and set(dec["max_err"].values()) == {0.0}
    assert files == files2 and len(files) == 11
    # 8 pWave codings a GOP-4 (H of 3 pairs and L, luma and chroma): LL
    # planes of 16x16 (46 fronts) and 2x8x8 (22 fronts)
    assert fronts == 4 * 46 + 4 * 22 and fronts2 == 0
    for plane in ("luma", "chroma"):
        for a, b in zip(dec[plane], enc[plane]):
            assert torch.equal(a, b) and torch.isfinite(a).all()
