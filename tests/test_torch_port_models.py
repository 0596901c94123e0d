"""Port parity, models: each module of the pMCTF-L estimate path in
learned_pmctf_tpu_torch against its flax counterpart, with the same
weights (carried by convert.params_from_jax) on the same numpy inputs.

The small config, its weights and the comparisons are in
torch_port_helpers.py; the lifting, context and four-step tests are in
test_torch_port_models_2.py.
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
from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
from torch_port_helpers import (SMALL, assert_close, assert_rel, frames,
                                jax_small_model, jax_small_params, port_small_model)

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
    params = jax_small_params()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return jax_small_model(), jparams, port_small_model(params), params


def test_params_from_jax_consumes_every_leaf(models):
    _, _, port, params = models
    sd = params_from_jax(params)
    n_jax = len(jax.tree_util.tree_leaves(params))
    stacked = 3 * (SMALL["num_me_stages"] - 1)  # per-stage scales unstack
    assert len(sd) == n_jax + stacked == len(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k]), k
    extra = {"params": dict(params["params"], stray={"kernel": np.zeros(1)})}
    with pytest.raises(ValueError, match="no home"):
        params_from_jax(extra)


def test_temporal_lifting(models):
    _, jp, port, _ = models
    x = np.random.default_rng(2).normal(0, 40, (2, 1, 32, 32)).astype(np.float32)
    sub = {"params": jp["params"]["temporal_filtering_1"]}
    tl = port.temporal_filtering[1]
    with torch.no_grad():
        for name in ("predict_filter", "update_filter"):
            ref = JaxTemporal().apply(sub, jnp.asarray(x),
                                      method=getattr(JaxTemporal, name))
            assert_close(getattr(tl, name)(torch.tensor(x)), ref, 2e-3, name)


def test_pwave_forward(models):
    _, jp, port, _ = models
    x = np.random.default_rng(5).integers(0, 256, (1, 1, 64, 64)).astype(np.float32)
    sub = {"params": jp["params"]["hp_coder"]}
    jm = JaxPWave(decomp_levels=2, features=16, ar_features=16)
    for q in (0, 10, 20):
        ref = jm.apply(sub, jnp.asarray(x), jnp.float32(q), training=False)
        with torch.no_grad():
            got = port.hp_coder(torch.tensor(x), float(q))
        assert_close(got["x_hat"], ref["x_hat"], 2e-3, f"x_hat[q{q}]")
        assert_rel(got["bits_total"], ref["bits_total"], 5e-3, f"bits[q{q}]")


def test_spynet(models):
    jm, jp, port, _ = models
    (ref_y, cur_y), _ = frames(6)
    flow = jm.apply(jp, jnp.asarray(cur_y) / 255.0, jnp.asarray(ref_y) / 255.0,
                    method=lambda m, a, b: m.optic_flow(a, b))
    with torch.no_grad():
        got = port.optic_flow(torch.tensor(cur_y) / 255.0,
                              torch.tensor(ref_y) / 255.0)
    assert_close(got, flow, 2e-3, "spynet flow")


@pytest.fixture(scope="module")
def stage_runs(models):
    """forward_one_stage in its three call modes, in both frameworks:
    luma with an empty DPB and code_lt; luma with that run's DPB; chroma
    (batch 2) with the halved luma MVs."""
    jm, jp, port, _ = models
    (ref_y, cur_y), (ref_c, cur_c) = frames(7)

    def run_jax(ref, cur, code_lt, dpb, mv=None):
        return jm.apply(jp, jnp.asarray(ref), jnp.asarray(cur), jnp.float32(Q),
                        code_lt, dpb, mv_hat=mv, stage_idx=0, training=False)

    def run_port(ref, cur, code_lt, dpb, mv=None):
        with torch.no_grad():
            return port.forward_one_stage(torch.tensor(ref), torch.tensor(cur),
                                          Q, code_lt, dpb, mv_hat=mv)

    j1 = run_jax(ref_y, cur_y, True, empty_dpb())
    p1 = run_port(ref_y, cur_y, True, empty_dpb())
    j2 = run_jax(ref_y, cur_y, False, j1["dpb"])
    p2 = run_port(ref_y, cur_y, False, p1["dpb"])
    j3 = run_jax(ref_c, cur_c, False, empty_dpb(), j1["mv_hat"])
    p3 = run_port(ref_c, cur_c, False, empty_dpb(), p1["mv_hat"])
    return {"luma": (p1, j1), "luma_dpb": (p2, j2), "chroma": (p3, j3)}


@pytest.mark.parametrize("mode", ["luma", "luma_dpb", "chroma"])
def test_forward_one_stage(stage_runs, mode):
    port, ref = stage_runs[mode]
    for key in ("L_t", "H_t", "mv_hat"):
        assert_close(port[key], ref[key], 5e-3, f"{mode}[{key}]")
    # the MV autoencoder's outputs, kept in the DPB for the next pair
    for key in ("mv_feature", "ref_mv_y"):
        if ref["dpb"][key] is None:
            assert port["dpb"][key] is None, (mode, key)
        else:
            assert_close(port["dpb"][key], ref["dpb"][key], 5e-3,
                         f"{mode}[dpb.{key}]")
    for key in ("bpp_H", "bpp_me", "bpp_L"):
        if ref.get(key) is None:
            assert port.get(key) is None, (mode, key)
            continue
        assert_rel(port[key], ref[key], 5e-3, f"{mode}[{key}]", floor=1e-2)
    assert_close(port["me_mse"], ref["me_mse"], 1e-2, f"{mode}[me_mse]")


def test_inverse_mctf(models, stage_runs):
    jm, jp, port, _ = models
    p1, j1 = stage_runs["luma"]
    ref = jm.apply(jp, j1["L_t"], j1["H_t"], j1["mv_hat"], 0,
                   method=JaxPMCTF.inverse_mctf)
    with torch.no_grad():
        got = port.inverse_mctf(p1["L_t"], p1["H_t"], p1["mv_hat"], 0)
    assert_close(got[0], ref[0], 1e-2, "inverse[ref]")
    assert_close(got[1], ref[1], 1e-2, "inverse[cur]")
