"""Port parity, the reference-checkpoint loader
(convert.load_reference_state_dict).

A reference-style checkpoint is made from the port's state dict of a
JAX-initialised AR model (small config, as tests/test_torch_port_ar.py):
SpyNet's conv1 widened to the reference's 8 RGB inputs (the two luma
slices in inputs 0 and 3, zeros in 1-2 and 4-5, the flow in 6-7), a
``lift_v`` alias beside every ``lift_h`` key, the keys prefixed with
"module." and wrapped in {"state_dict": ...}, saved with torch.save. The
JAX package's converter must read it back into the JAX params leaf for
leaf, and the port's loader must give exactly params_from_jax's tensors.
Two flavours: as the reference saves it (no lifting and temporal gains,
which are constants there) and as the port saves it (gains included).
A second test loads the reference model's own state dict, where the
reference tree is available.
"""

import os
import sys

import numpy as np
import pytest
import jax
import torch

from learned_pmctf_tpu.utils.checkpoint import load_torch_state_dict
from learned_pmctf_tpu.utils.torch_import import convert_pmctf_tree, merge_into_init

from learned_pmctf_tpu_torch.convert import (NOT_IN_REFERENCE,
                                             load_reference_state_dict,
                                             params_from_jax)
from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
from test_torch_parity import REF, SHIMS
from test_torch_port_ar import AR, jax_ar_params, port_ar_model

GAINS = NOT_IN_REFERENCE


def _is_gain(key):
    return key.rsplit(".", 1)[-1] in GAINS


def reference_style(port_sd, with_gains):
    """The port's state dict as a reference checkpoint holds it."""
    out = {}
    for k, v in port_sd.items():
        if _is_gain(k) and not with_gains:
            continue
        if k.startswith("optic_flow.") and k.endswith("conv1.weight"):
            w = torch.zeros(v.shape[0], 8, *v.shape[2:])
            w[:, 0], w[:, 3], w[:, 6:8] = v[:, 0], v[:, 1], v[:, 2:4]
            v = w
        out["module." + k] = v.clone()
        if ".lift_h." in k:
            out["module." + k.replace(".lift_h.", ".lift_v.")] = v.clone()
    return {"state_dict": out, "epoch": 3}


@pytest.fixture(scope="module")
def params():
    """JAX params whose gains are the constants a reference model has
    (the port's init values), so that a checkpoint without them loads to
    the same model."""
    p = jax_ar_params(seed=4)
    fresh = build_pmctf("cpu", **AR)
    consts = {k.rsplit(".", 1)[-1]: v.numpy() for k, v in fresh.state_dict().items()
              if _is_gain(k)}
    return jax.tree_util.tree_map_with_path(
        lambda path, a: consts.get(str(path[-1].key), a), p)


@pytest.mark.parametrize("with_gains", [False, True])
def test_reference_checkpoint_round_trip(params, tmp_path, with_gains):
    expected = params_from_jax(params)
    port_sd = port_ar_model(params).state_dict()
    path = str(tmp_path / "ckpt.pth.tar")
    torch.save(reference_style(port_sd, with_gains), path)

    # the JAX package's converter reads it back into the JAX params
    sd = load_torch_state_dict(path)
    tree, unused = convert_pmctf_tree(sd, num_me_stages=AR["num_me_stages"],
                                      decomp_levels=AR["decomp_levels"],
                                      spynet_luma=True)
    # the JAX converter reports the gains it does not read (lift_v aliases
    # are dropped unreported)
    assert sorted(unused) == sorted(k for k in sd if _is_gain(k) and ".lift_v." not in k)
    init = jax.tree_util.tree_map_with_path(
        lambda p, a, b: a if str(p[-1].key) in GAINS else np.zeros_like(b),
        params, jax_ar_params(seed=9))
    merged, unmatched = merge_into_init(init, tree)
    assert not unmatched
    flat_p, flat_m = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (params, merged))
    assert [k for k, _ in flat_p] == [k for k, _ in flat_m]
    for (k, a), (_, b) in zip(flat_p, flat_m):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(k))

    # the port's loader gives params_from_jax's tensors exactly
    model = load_reference_state_dict(path, build_pmctf("cpu", seed=5, **AR))
    got = model.state_dict()
    assert set(got) == set(expected)
    for k, v in expected.items():
        assert torch.equal(got[k], v), k


def test_loader_takes_a_port_state_dict_and_refuses_misfits(params):
    port = port_ar_model(params)
    own = port.state_dict()
    got = load_reference_state_dict(own, build_pmctf("cpu", seed=6, **AR)).state_dict()
    for k, v in own.items():
        assert torch.equal(got[k], v), k

    # each misfit raises before anything is loaded
    ref = reference_style(own, with_gains=False)["state_dict"]
    target = build_pmctf("cpu", seed=6, **AR)
    before = {k: v.clone() for k, v in target.state_dict().items()}
    with pytest.raises(ValueError, match="keys the port lacks"):
        load_reference_state_dict({**ref, "module.stray.weight": torch.zeros(1)},
                                  target)
    missing = dict(ref)
    del missing["module.hp_coder.context_fusion.1.ll.convs.2.bias"]
    with pytest.raises(ValueError, match="port keys missing"):
        load_reference_state_dict(missing, target)
    k = next(k for k in ref if ".lift_v." in k)
    with pytest.raises(ValueError, match="lift_h"):
        load_reference_state_dict({**ref, k: ref[k] + 1}, target)
    k = "module.lp_coder.context_fusion.1.ll.maskedConv1.mask"
    with pytest.raises(ValueError, match="causal mask"):
        load_reference_state_dict({**ref, k: torch.ones_like(ref[k])}, target)
    for k, v in target.state_dict().items():
        assert torch.equal(v, before[k]), k
    fourstep = build_pmctf("cpu", **dict(AR, ll_mode="fourstep"))
    with pytest.raises(ValueError, match="does not fit"):
        load_reference_state_dict(ref, fourstep)


def test_reference_model_state_dict_loads(tmp_path):
    """The reference pMCTF's own state dict (random init) through the
    loader: strict, and its AR LL net and image coder compute what the
    reference's do."""
    if not os.path.isdir(REF):
        pytest.skip("reference tree not available")
    for p in (SHIMS, REF):
        if p not in sys.path:
            sys.path.insert(0, p)
    torch.manual_seed(0)
    from pMCTF.models.video.pMCTF_L import pMCTF as TorchPMCTF
    tm = TorchPMCTF(decomp_levels=4, num_me_stages=2).eval()
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": tm.state_dict()}, path)
    port = load_reference_state_dict(
        path, build_pmctf("cpu", decomp_levels=4, num_me_stages=2, ll_mode="ar"))
    g = np.random.default_rng(5)
    x = torch.tensor(np.round(g.normal(0, 3, (1, 1, 16, 16))).astype(np.float32))
    img = torch.tensor(g.integers(0, 256, (1, 1, 64, 64)).astype(np.float32))
    with torch.no_grad():
        ref = tm.hp_coder.context_fusion["3"]["ll"](x)
        got = port.hp_coder.context_fusion[3]["ll"](x)
        assert float((got - ref).abs().max()) <= 2e-4
        ref = tm.hp_coder(img, 10)
        got = port.hp_coder(img, 10.0)
    assert float((got["x_hat"] - ref["x_hat"]).abs().max()) <= 2e-3
    r = float(ref["bits_total"])
    assert abs(float(got["bits_total"]) - r) <= 2e-3 * max(r, 1.0)
