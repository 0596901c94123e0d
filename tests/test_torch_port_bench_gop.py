"""Port parity, the GOP ladder in bench.py's configuration and with the
fast warp: learned_pmctf_tpu_torch.gop.code_gop / stream_gop against the
JAX PMCTF driven through bench.py's ladder (test_torch_port_gop.jax_gop,
eager), small config, 64x64 luma and 32x32 chroma, GOP-4.

- warp_mode="fast", f32: the estimate to the exact-warp test's limits
  (bits rel 1e-4, reconstructions 5e-2), the stream decoded bit-exactly
  on the CPU, against one JAX fast-warp ladder;
- act_bf16=True: streams force f32 (f32_streams), so a bf16 model writes
  the f32 model's streams byte for byte and decodes them bit-exactly;
- bench.py's configuration (fast warp, act_bf16): the estimate against
  the JAX bf16 ladder under the rule of test_torch_port_bench_modules.py,
  max |port - jax_bf16| <= 0.25 max |jax_bf16 - jax_f32|, on the bits of
  all frames together and on the luma and the chroma reconstructions.
  Here JAX's PostProcess takes its plain route (64 is no multiple of
  128) and the port's its kernel, whose epilogue rounds once.
- warp_max_disp: the fast warp's clamp at 3 px against JAX's.
One JAX ladder a configuration: f32 fast-warp, bf16 fast-warp.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models import PMCTF as JaxPMCTF

from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.convert import params_from_jax
from learned_pmctf_tpu_torch.gop import code_gop, stream_gop
from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
from test_torch_port_gop import (Q, _check_gop, _check_stream_gop,
                                 jax_gop, synthetic_frames)
from torch_port_helpers import SMALL, assert_close, jax_small_params

RATIO = 0.25


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


@pytest.fixture(scope="module")
def params():
    return jax_small_params(seed=1)


def port_model(params, **kw):
    model = build_pmctf(device="cpu", **{**SMALL, **kw})
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def jax_model(**kw):
    return JaxPMCTF(ll_mode="fourstep", spynet_luma=True, **{**SMALL, **kw})


@pytest.fixture(scope="module")
def ladders(params):
    """act_bf16 -> (frames, the JAX fast-warp GOP-4 ladder), run once."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    cache = {}

    def get(bf16):
        if bf16 not in cache:
            luma, chroma = synthetic_frames(4)
            jm = jax_model(warp_mode="fast", act_bf16=bf16)
            cache[bf16] = (luma, chroma), jax_gop(jm, jp, luma, chroma, Q)
        return cache[bf16]
    return get


def test_fast_warp_estimate_gop4_matches_jax(params, ladders):
    port = port_model(params, warp_mode="fast")
    assert port.optic_flow.fast_warp and port.optic_flow.fast_warp_disp == 32
    _check_gop((None, None, port), lambda gop: ladders(False), 4)


def test_fast_warp_stream_gop4_matches_jax(params, ladders, tmp_path):
    port = port_model(params, warp_mode="fast")
    _check_stream_gop((None, None, port), lambda gop: ladders(False), tmp_path, 4)


def test_act_bf16_streams_round_trip_bit_exactly(params, tmp_path):
    """The port's counterpart of tests/test_codec_roundtrip.py's act_bf16
    case: the bf16 model's streams are the f32 model's, and decode to
    the encoder side bit for bit."""
    luma, chroma = synthetic_frames(4, seed=22)
    outs, files = {}, {}
    for bf16 in (False, True):
        d = tmp_path / f"bf16_{bf16}"
        d.mkdir()
        with PMCTFCodec(port_model(params, warp_mode="fast", act_bf16=bf16),
                        device="cpu") as codec:
            codec.update()
            outs[bf16] = stream_gop(codec, luma, chroma, Q, str(d), psize=64,
                                    device="cpu")
        assert set(outs[bf16]["max_err"].values()) == {0.0}
        files[bf16] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert files[True] == files[False] and len(files[True]) == 11
    for plane in ("luma", "chroma"):
        for a, b in zip(outs[True][plane], outs[False][plane]):
            assert a.dtype == torch.float32 and torch.equal(a, b)


def _policy_gap(port, jb, jf, what):
    p, b, f = (np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in v])
               for v in (port, jb, jf))
    d_port, d_policy = float(np.abs(p - b).max()), float(np.abs(b - f).max())
    assert d_policy > 0, (what, "jax_bf16 equals jax_f32")
    assert d_port <= RATIO * d_policy, (what, d_port, d_policy)


def test_bench_configuration_gop4_matches_jax_bf16(params, ladders):
    """bench.py's configuration (fast warp, act_bf16) through code_gop."""
    port = port_model(params, warp_mode="fast", act_bf16=True)
    assert port.act_bf16 and port.hp_coder.act_bf16 and port.lp_coder.act_bf16
    (luma, chroma), (bits_b, luma_b, chroma_b) = ladders(True)
    _, (bits_f, luma_f, chroma_f) = ladders(False)
    got = code_gop(port, luma, chroma, Q, device="cpu")
    keys = [(fi, k) for fi in sorted(bits_b) for k in sorted(bits_b[fi])]
    assert keys == [(fi, k) for fi in sorted(got["bits"]) for k in sorted(got["bits"][fi])]
    _policy_gap([[got["bits"][fi][k] for fi, k in keys]],
                [[bits_b[fi][k] for fi, k in keys]],
                [[bits_f[fi][k] for fi, k in keys]], "bits")
    for plane, pb, pf in (("luma", luma_b, luma_f), ("chroma", chroma_b, chroma_f)):
        assert all(x.dtype == torch.float32 for x in got[plane])
        _policy_gap([x.numpy() for x in got[plane]], pb, pf, plane)


def test_warp_max_disp_matches_jax(params):
    """PMCTF(warp_max_disp=3): the fast warp of the temporal lifting and of
    SpyNet's pyramid clamps the motion at 3 px, as JAX's does; with
    motion of up to 6 px the clamp changes the planes."""
    g = np.random.default_rng(7)
    ref = g.uniform(0, 255, (1, 1, 64, 64)).astype(np.float32)
    cur = g.uniform(0, 255, (1, 1, 64, 64)).astype(np.float32)
    mv = g.uniform(-6, 6, (1, 2, 64, 64)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jm = jax_model(warp_mode="fast", warp_max_disp=3)
    port = port_model(params, warp_mode="fast", warp_max_disp=3)
    assert port.optic_flow.fast_warp_disp == 3
    J = jnp.asarray
    ref_fwd = jm.apply(jp, J(ref), J(cur), J(mv), 0, method=JaxPMCTF.forward_mctf)
    ref_inv = jm.apply(jp, ref_fwd[0], ref_fwd[1], J(mv), 0,
                       method=JaxPMCTF.inverse_mctf)
    ref_flow = jm.apply(jp, J(cur / 255.0), J(ref / 255.0),
                        method=lambda m, a, b: m.optic_flow(a, b))
    T = torch.tensor
    with torch.no_grad():
        fwd = port.forward_mctf(T(ref), T(cur), T(mv), 0)
        inv = port.inverse_mctf(fwd[0], fwd[1], T(mv), 0)
        flow = port.optic_flow(T(cur / 255.0), T(ref / 255.0))
        wide = port_model(params, warp_mode="fast").forward_mctf(
            T(ref), T(cur), T(mv), 0)
    for name, p, r in (("L_t", fwd[0], ref_fwd[0]), ("H_t", fwd[1], ref_fwd[1]),
                       ("ref", inv[0], ref_inv[0]), ("cur", inv[1], ref_inv[1])):
        assert_close(p, r, 1e-3, name)
    assert_close(flow, ref_flow, 1e-4, "flow")
    assert float((wide[1] - fwd[1]).abs().max()) > 1.0
