"""Port parity, the pMCTF training path at the small test config
(test_torch_port_models.SMALL): compute_and_code_motion(training=True)
and its gradients, the MV rate terms' noise, pmctf_gop_loss at GOP-2,
and the curriculum's part predicates, ME-stage cloning and I-frame
transplant on the small model's parameters, against the JAX package on
the CPU.

The JAX side runs without noise (rng=None: straight-through rounding in
the rate terms), since flax draws its noise from keys a test cannot hand
to the port; the port's noise path is checked on its own. Batch 2: the
MV rate is each sample's bits per pixel, then the batch's mean. The JAX
functions run under jax.jit (one compile: several times faster on the
CPU than their eager ops here).

At most eight tests run in tier-1 here, so that pytest-xdist's --dist
loadfile starts test_parallel.py before this file (see
test_torch_port_train.py).

Tolerances: outputs 5e-3 absolute (the estimate tests' pair-level
bound), rates, loss and log entries rel 1e-4; each gradient the larger
of 2e-3 of the largest gradient magnitude in its module group and 3
times the port's own f32 error on it against the port in float64, capped
at the larger of a tenth of its own largest magnitude and that 3 times
its own error (see test_torch_port_train_pwave.py for why).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models import PMCTF as JaxPMCTF
from learned_pmctf_tpu.training import curriculum as jax_curriculum
from learned_pmctf_tpu.training.optim import trainable_mask as jax_trainable_mask
from learned_pmctf_tpu.training.steps import StageGates as JaxGates
from learned_pmctf_tpu.training.steps import pmctf_gop_loss as jax_gop_loss

from learned_pmctf_tpu_torch.convert import (jax_paths, params_from_jax,
                                             pwave_params_from_jax)
from learned_pmctf_tpu_torch.entropy.distributions import laplace_bits
from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
from learned_pmctf_tpu_torch.training import curriculum
from learned_pmctf_tpu_torch.training.optim import make_optimizer, trainable_mask
from learned_pmctf_tpu_torch.training.steps import (StageGates, draw_pair_noise,
                                                    pmctf_gop_loss)
from test_torch_port_gop import synthetic_frames
from torch_port_helpers import (assert_close, jax_small_model,
                                    jax_small_params, port_small_model)
from test_torch_port_train_pwave import grad_tol

Q, LMBDA = 10.0, 0.05
REL = 1e-4
GRAD_REL = 2e-3
OUT_KEYS = ("mv_hat", "mv_feature", "mv_y_hat")


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
    return (jax_small_model(), jax.tree_util.tree_map(jnp.asarray, params),
            params)


def gop_frames(n, batch=2):
    """n (batch,1,64,64) luma frames: smooth motion, one clip a sample."""
    clips = [synthetic_frames(n, seed=21 + b)[0] for b in range(batch)]
    return [np.concatenate([c[t] for c in clips]) for t in range(n)]


def _group(name):
    parts = name.split(".")
    return ".".join(parts[:2])


def check_grads(model, model64, ref_grads, params, what):
    """Every parameter's gradient against JAX's (a missing one is zero)."""
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(ref_grads["params"])[0]}
    paths = jax_paths(params)
    named64 = dict(model64.named_parameters())

    def grad(p):
        return (p.grad.double().numpy() if p.grad is not None
                else np.zeros(tuple(p.shape)))

    group_max = {}
    for name, p in model.named_parameters():
        g = _group(name)
        group_max[g] = max(group_max.get(g, 0.0), float(np.max(np.abs(grad(p)))))
    reached, worst, loose = 0, (0.0, None), []
    for name, p in model.named_parameters():
        got = grad(p)
        want = flat[paths[name]]
        # the port's per-ME-stage scales read one row of a stacked leaf
        if want.shape != got.shape:
            want = want[int(name.rsplit(".", 1)[1])]
        own = float(np.max(np.abs(got - grad(named64[name]))))
        err = float(np.max(np.abs(got - want)))
        tol = grad_tol(GRAD_REL * group_max[_group(name)], own, want)
        assert err <= tol, (what, name, err, tol)
        reached += bool(np.any(want != 0))
        worst = max(worst, (err / max(tol, 1e-30), name), key=lambda t: t[0])
        if np.any(want != 0) and tol >= float(np.max(np.abs(want))):
            loose.append(name)
    print(f"{what}: {reached} gradients reached, worst err/tol {worst}; "
          f"{len(loose)} reached ones held to a tolerance at or above their own "
          f"largest magnitude (the port's own f32 error): {loose}")
    return reached


def test_compute_and_code_motion_training_matches_jax(models):
    """Outputs and every parameter's gradient of a scalar of all outputs
    (both rates and random projections of mv_hat, mv_feature, mv_y_hat)."""
    jm, jp, params = models
    ref_y, cur_y = (f for f in gop_frames(2))
    g = np.random.default_rng(4)

    def project(outs, xp):
        total = outs[2] + outs[3]
        for k, v in zip(OUT_KEYS, (outs[0], outs[1]["mv_feature"],
                                   outs[1]["mv_y_hat"])):
            total = total + xp.sum(v * cts[k]) / v.size
        return total

    with torch.no_grad():
        shapes = port_small_model(params).compute_and_code_motion(
            torch.tensor(ref_y), torch.tensor(cur_y), Q, empty_dpb(), 0,
            training=True)
    cts = {k: g.normal(size=tuple(v.shape)).astype(np.float32)
           for k, v in zip(OUT_KEYS, (shapes[0], shapes[1]["mv_feature"],
                                      shapes[1]["mv_y_hat"]))}

    def jax_loss(p):
        outs = jm.apply(p, jnp.asarray(ref_y), jnp.asarray(cur_y), jnp.float32(Q),
                        empty_dpb(), 0, training=True,
                        method=JaxPMCTF.compute_and_code_motion)
        return project(outs, jnp), outs

    (ref_loss, ref_outs), ref_grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(jp)

    runs = {}
    for dtype in (torch.float32, torch.float64):
        model = port_small_model(params).to(dtype)
        cts_t = {k: torch.tensor(v, dtype=dtype) for k, v in cts.items()}
        outs = model.compute_and_code_motion(
            torch.tensor(ref_y, dtype=dtype), torch.tensor(cur_y, dtype=dtype),
            Q, empty_dpb(), 0, training=True)
        total = outs[2] + outs[3]
        for k, v in zip(OUT_KEYS, (outs[0], outs[1]["mv_feature"],
                                   outs[1]["mv_y_hat"])):
            total = total + (v * cts_t[k]).sum() / v.numel()
        total.backward()
        runs[dtype] = (model, outs, total)
    model, outs, total = runs[torch.float32]
    for k, a, b in zip(OUT_KEYS, (outs[0], outs[1]["mv_feature"], outs[1]["mv_y_hat"]),
                       (ref_outs[0], ref_outs[1]["mv_feature"], ref_outs[1]["mv_y_hat"])):
        assert_close(a, b, 5e-3, k)
    for what, a, b in (("bpp_mv_y", outs[2], ref_outs[2]),
                       ("bpp_mv_z", outs[3], ref_outs[3]), ("loss", total, ref_loss)):
        assert abs(float(a) - float(b)) <= REL * abs(float(b)), (what, float(a), float(b))
    reached = check_grads(model, runs[torch.float64][0], ref_grads, params, "motion")
    assert reached > 100


def test_motion_noise_replaces_rounding_in_the_rates(models):
    """Port only: with noise (n_y, n_z) the rates are the Laplace bits of
    mv_y_res + n_y and the bit estimator's of mv_z + n_z, batch-averaged;
    no gradient flows into the noise; mv_hat is the noiseless one."""
    _, _, params = models
    model = port_small_model(params)
    ref_y, cur_y = (torch.tensor(f) for f in gop_frames(2))
    shapes = model.mv_noise_shapes(2, 64, 64)
    gen = torch.Generator().manual_seed(0)
    noise = [(torch.rand(s, generator=gen) - 0.5).requires_grad_() for s in shapes]
    captured = {}
    prior = model.mv_y_spatial_prior[0]
    hook = model.mv_bit_est[0].register_forward_pre_hook(
        lambda m, a: captured.setdefault("z", a[0]))
    try:
        mv_hat, _, bpp_y, bpp_z = model.compute_and_code_motion(
            ref_y, cur_y, Q, empty_dpb(), 0, training=True, noise=noise)
    finally:
        hook.remove()
    mv_y, mv_z = model._mv_latents(ref_y, cur_y, empty_dpb(), 0, Q)
    from learned_pmctf_tpu_torch.models.mv_coder import four_part_prior_forward
    from learned_pmctf_tpu_torch.ops.quant import ste_round
    params_ = model.mv_prior_param_decoder(ste_round(mv_z), empty_dpb(), 0)
    y_res, _, _, scales = four_part_prior_forward(
        mv_y, params_, model._adaptors(0), prior, training=True)
    want_y = (laplace_bits(y_res + noise[0], scales).sum((1, 2, 3)) / 4096).mean()
    want_z = (model.mv_bit_est[0].get_z_bits(mv_z + noise[1]).sum((1, 2, 3))
              / 4096).mean()
    assert abs(float(bpp_y) - float(want_y)) <= 1e-6 * float(want_y)
    assert abs(float(bpp_z) - float(want_z)) <= 1e-6 * max(float(want_z), 1e-3)
    clean = model.compute_and_code_motion(ref_y, cur_y, Q, empty_dpb(), 0,
                                          training=True)
    assert torch.equal(mv_hat, clean[0])
    assert float(bpp_y) != float(clean[2])
    (bpp_y + bpp_z).backward()
    assert noise[0].grad is None and noise[1].grad is None


# ---- curriculum on the small model ------------------------------------------

def _flat_jax(tree):
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree["params"])[0]:
        out["/".join(str(k.key) for k in path)] = v
    return out


def test_part_predicates_freeze_what_jax_freezes(models):
    """For each part (Inter, MCTF, All): trainable in JAX (its predicate on
    flax paths) if and only if requires_grad in the port (the port's
    predicate on its own names), parameter by parameter through the
    converter's name map."""
    _, jparams, params = models
    model = port_small_model(params)
    paths = jax_paths(jparams)
    for part in ("Inter", "MCTF", "All"):
        jmask = _flat_jax(jax_trainable_mask(jparams,
                                             jax_curriculum.PART_PREDICATES[part]))
        make_optimizer(model, 1e-4, trainable=trainable_mask(
            model, curriculum.PART_PREDICATES[part]))
        seen = {p.requires_grad for p in model.parameters()}
        for name, p in model.named_parameters():
            assert p.requires_grad == bool(jmask[paths[name]]), (part, name)
        assert seen == {True, False}


def _state_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_clone_me_stage_commutes_with_params_from_jax(models):
    _, jparams, _ = models
    want = params_from_jax(jax_curriculum.clone_me_stage(jparams, 1, 0, 2))
    model = port_small_model(jax.tree_util.tree_map(np.asarray, jparams))
    before = model.hp_q_scale[1].detach().clone()
    curriculum.clone_me_stage(model, 1, 0, 2)
    _state_equal(model.state_dict(), want)
    assert torch.equal(model.hp_q_scale[1], before)
    assert not torch.equal(model.mv_encoder[1].enc_2.conv1.weight,
                           port_small_model(jax.tree_util.tree_map(
                               np.asarray, jparams)).mv_encoder[1].enc_2.conv1.weight)


def test_load_from_iframe_commutes_with_params_from_jax(models):
    _, jparams, _ = models
    # another pWave's weights: the highpass coder's, scaled and shifted
    iframe = jax.tree_util.tree_map(lambda v: v * 1.25 + 0.01,
                                    jparams["params"]["hp_coder"])
    want = params_from_jax(jax_curriculum.load_from_iframe(jparams, {"params": iframe}))
    model = port_small_model(jax.tree_util.tree_map(np.asarray, jparams))
    curriculum.load_from_iframe(model, pwave_params_from_jax(iframe))
    _state_equal(model.state_dict(), want)


@pytest.fixture(scope="module")
def gop2(models):
    jm, jp, params = models
    frames = gop_frames(2)
    gates = StageGates.for_stage(5)
    ref = jax.jit(lambda p: jax_gop_loss(
        jm, p, [jnp.asarray(f) for f in frames], jnp.float32(Q),
        jnp.float32(LMBDA), JaxGates.for_stage(5), me_base=0, rng=None,
        remat=False))(jp)
    return frames, gates, ref


def test_gop2_loss_and_log_match_jax(models, gop2):
    _, _, params = models
    frames, gates, (ref_loss, ref_log) = gop2
    model = port_small_model(params)
    with torch.no_grad():
        loss, log = pmctf_gop_loss(model, [torch.tensor(f) for f in frames], Q,
                                   LMBDA, gates, remat=False)
    assert set(log) == set(ref_log)
    for k, v in log.items():
        assert abs(float(v) - float(ref_log[k])) <= REL * max(abs(float(ref_log[k])), 1e-2), (
            k, float(v), float(ref_log[k]))
    assert abs(float(loss) - float(ref_loss)) <= REL * abs(float(ref_loss))


def test_gop_gradients_with_and_without_checkpoint_are_equal(models):
    """Port only: a GOP-4 with noise, per-pair recomputation on and off."""
    _, _, params = models
    model = port_small_model(params)
    frames = [torch.tensor(f) for f in gop_frames(4, batch=1)]
    noise = draw_pair_noise(model, frames, torch.Generator().manual_seed(2))
    grads, losses = [], []
    for remat in (True, False):
        model.zero_grad()
        loss, _ = pmctf_gop_loss(model, frames, Q, LMBDA, StageGates.for_stage(5),
                                 noise=noise, remat=remat)
        loss.backward()
        losses.append(float(loss))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert losses[0] == losses[1]
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 1000
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


@pytest.mark.slow
def test_gop2_gradients_match_jax(models, gop2):
    """Every parameter's gradient of the GOP-2 loss against
    jax.value_and_grad of the JAX package's pmctf_gop_loss (its
    per-pair jax.checkpoint on); marked slow: the JAX side alone takes
    minutes on the CPU."""
    jm, jp, params = models
    frames, gates, (ref_loss, _) = gop2

    def jax_loss(p):
        return jax_gop_loss(jm, p, [jnp.asarray(f) for f in frames], jnp.float32(Q),
                            jnp.float32(LMBDA), JaxGates.for_stage(5), me_base=0,
                            rng=None, remat=True)

    (loss_ref, _), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jp)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        model = port_small_model(params).to(dtype)
        if dtype == torch.float64:
            for m in (model.lp_coder, model.hp_coder):
                m.dequantModule.use_kernel = False
        loss, _ = pmctf_gop_loss(model, [torch.tensor(f, dtype=dtype) for f in frames],
                                 Q, LMBDA, gates)
        loss.backward()
        runs[dtype] = (model, loss)
    model, loss = runs[torch.float32]
    assert abs(float(loss) - float(loss_ref)) <= REL * abs(float(loss_ref))
    # 694 of the 1772 parameters have a non-zero gradient in JAX (the
    # second ME stage, the DPB adaptors and the zero-input priors do not)
    reached = check_grads(model, runs[torch.float64][0], ref_grads, params, "gop2")
    assert reached > 600
