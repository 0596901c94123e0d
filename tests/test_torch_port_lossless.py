"""Port parity, the lossless configuration (lossy=False) on the estimate
path: TemporalLifting's rounded filters, PWave (integer lifting, the
four-step priors around rounded means, clip 32767, no q scaling, no
PostProcess), one forward_one_stage pair with its inverse, and a GOP-4
ladder (whose first pair the stage test reads), each against the JAX
package with the same weights; and the
trainer's lossless pWave forward (straight-through rounding) against
JAX's. The small config of torch_port_helpers.py, integer 8-bit planes.

Tolerances: every lossless increment is rounded, so where one lies
within float noise of a half the two frameworks may round it apart: band
planes may differ by whole steps in under 1% of samples
(assert_rounding_close); bits rel 2e-3 (such a flip moves a symbol's
bits). Reconstructions equal the input frames
exactly, in the port and in JAX. One eager JAX GOP-4 ladder serves the
stage-pair and GOP tests, which are marked slow (the eager ladder takes
60 to 140 s on the CPU); the lossless stream's tests and the CLIs' hold
the same paths in tier-1.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models import PMCTF as JaxPMCTF
from learned_pmctf_tpu.models.pwave import PWave as JaxPWave
from learned_pmctf_tpu.models.wavelet import TemporalLifting as JaxTemporal

from learned_pmctf_tpu_torch.convert import params_from_jax
from learned_pmctf_tpu_torch.gop import code_gop
from learned_pmctf_tpu_torch.models.pmctf import build_pmctf, empty_dpb
from test_torch_port_gop import jax_gop, synthetic_frames
from torch_port_helpers import (SMALL, assert_rounding_close, jax_small_model,  # noqa: F401
                                jax_small_params, numerics, numpy_of)

Q = 10.0
BITS_REL = 2e-3


def lossless_frames(n):
    """synthetic_frames(n) rounded to integers: lossless coding returns
    integer planes exactly."""
    luma, chroma = synthetic_frames(n)
    return [np.round(f) for f in luma], [np.round(f) for f in chroma]


@pytest.fixture(scope="module")
def models():
    params = jax_small_params(seed=4)
    port = build_pmctf(device="cpu", lossy=False, **SMALL)
    port.load_state_dict(params_from_jax(params), strict=True)
    return (jax_small_model(lossy=False), jax.tree_util.tree_map(jnp.asarray, params),
            port)


def assert_bits(port, ref, what):
    p = float(port.detach()) if torch.is_tensor(port) else float(port)
    r = float(ref)
    assert abs(p - r) <= BITS_REL * max(abs(r), 1.0), (what, p, r)


def test_temporal_lifting_rounds_as_jax(models):
    _, jp, port = models
    x = np.round(np.random.default_rng(2).normal(0, 40, (2, 1, 32, 32))).astype(np.float32)
    tl = port.temporal_filtering[1]
    sub = {"params": jp["params"]["temporal_filtering_1"]}
    with torch.no_grad():
        for name in ("predict_filter", "update_filter"):
            ref = JaxTemporal(lossy=False).apply(sub, jnp.asarray(x),
                                                 method=getattr(JaxTemporal, name))
            got = getattr(tl, name)(torch.tensor(x))
            assert_rounding_close(got, ref, name)
            assert float((got - torch.round(got)).abs().max()) == 0.0  # integers


@pytest.mark.parametrize("training", [False, True])
def test_pwave_matches_jax_and_reconstructs_exactly(models, training):
    """The estimate forward, and the trainer's (straight-through
    rounding): bits within BITS_REL, x_hat == x on both sides, mse 0."""
    _, jp, port = models
    x = np.random.default_rng(5).integers(0, 256, (1, 1, 64, 64)).astype(np.float32)
    sub = {"params": jp["params"]["hp_coder"]}
    jm = JaxPWave(decomp_levels=2, features=16, ar_features=16, lossy=False)
    ref = jm.apply(sub, jnp.asarray(x), jnp.float32(Q), training=training)
    assert port.hp_coder.clip_value == 32767.0 and not port.hp_coder.lossy
    ctx = torch.enable_grad() if training else torch.no_grad()
    with ctx:
        got = port.hp_coder(torch.tensor(x), Q, training=training)
    np.testing.assert_array_equal(numpy_of(got["x_hat"]), x)
    np.testing.assert_array_equal(np.asarray(ref["x_hat"]), x)
    assert float(got["mse"].detach()) == 0.0 == float(ref["mse"])
    assert_bits(got["bits"][0], ref["bits"][0], "bits")
    # the same planes at another q: lossless coding ignores q
    with torch.no_grad():
        other = port.hp_coder(torch.tensor(x), 20.0)
    np.testing.assert_array_equal(numpy_of(other["bits"]), numpy_of(got["bits"]))


@pytest.fixture(scope="module")
def jax_ladder(models):
    """The eager JAX GOP-4 ladder on lossless_frames(4), once; with the
    first pair's stage outputs (stage 0, frames 0 and 1) recorded."""
    jm, jp, _ = models
    luma, chroma = lossless_frames(4)
    first = {}
    apply = jm.apply

    def recording_apply(*args, **kw):
        out = apply(*args, **kw)
        if not first and kw.get("training") is False and "mv_hat" not in kw:
            first.update(out)
        return out
    jm_rec = type("Recording", (), {"apply": staticmethod(recording_apply),
                                    "num_me_stages": jm.num_me_stages})()
    ladder = jax_gop(jm_rec, jp, luma, chroma, Q)
    return (luma, chroma), ladder, first


@pytest.mark.slow
def test_stage_pair_and_inverse_match_jax(models, jax_ladder):
    """forward_one_stage on the GOP's first luma pair: the bands within
    whole-step flips, bits within BITS_REL; inverse_mctf gives the frames
    back exactly on both sides."""
    jm, jp, port = models
    (luma, _), _, ref = jax_ladder
    ref_y, cur_y = luma[0], luma[1]
    with torch.no_grad():
        got = port.forward_one_stage(torch.tensor(ref_y), torch.tensor(cur_y), Q, False,
                                     empty_dpb())
        back = port.inverse_mctf(got["L_t"], got["H_t"], got["mv_hat"], 0)
    for key in ("L_t", "H_t"):
        assert_rounding_close(got[key], ref[key], key)
    for key in ("bit_H", "bit_ME"):
        assert_bits(got[key], ref[key], key)
    np.testing.assert_array_equal(numpy_of(back[0]), ref_y)
    np.testing.assert_array_equal(numpy_of(back[1]), cur_y)
    jback = jm.apply(jp, ref["L_t"], ref["H_t"], ref["mv_hat"], 0,
                     method=JaxPMCTF.inverse_mctf)
    np.testing.assert_array_equal(np.asarray(jback[0]), ref_y)
    np.testing.assert_array_equal(np.asarray(jback[1]), cur_y)


@pytest.mark.slow
def test_gop4_matches_jax_and_reconstructs_exactly(models, jax_ladder):
    _, _, port = models
    (luma, chroma), (ref_bits, ref_luma, ref_chroma), _ = jax_ladder
    got = code_gop(port, luma, chroma, Q, device="cpu")
    assert set(got["bits"]) == set(ref_bits) == set(range(4))
    for fi, ref in ref_bits.items():
        for key, r in ref.items():
            assert_bits(got["bits"][fi][key], r, (fi, key))
    for fi in range(4):
        np.testing.assert_array_equal(numpy_of(got["luma"][fi]), luma[fi])
        np.testing.assert_array_equal(numpy_of(got["chroma"][fi]), chroma[fi])
        np.testing.assert_array_equal(ref_luma[fi], luma[fi])
        np.testing.assert_array_equal(ref_chroma[fi], chroma[fi])
