"""Port parity, training machinery: the weight packs after an optimizer
step, AdamW against the JAX package's optax chain, the curriculum's
config and gates, the schedules and a checkpoint round trip.

Tolerances: the optimizer 1e-6 (three Adam steps of size <= 3e-2); the
rest exact.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn as nn

from learned_pmctf_tpu.training import curriculum as jax_curriculum
from learned_pmctf_tpu.training.optim import make_optimizer as jax_make_optimizer
from learned_pmctf_tpu.training.optim import trainable_mask as jax_trainable_mask
from learned_pmctf_tpu.utils import schedules as jax_schedules

from learned_pmctf_tpu_torch.models.layers import init_params
from learned_pmctf_tpu_torch.models.pwave import PWave
from learned_pmctf_tpu_torch.ops import conv3x3 as c3
from learned_pmctf_tpu_torch.training import curriculum
from learned_pmctf_tpu_torch.training.optim import (decay_mask, make_optimizer,
                                                    trainable_mask)
from learned_pmctf_tpu_torch.training.steps import StageGates
from learned_pmctf_tpu_torch.utils import schedules
from learned_pmctf_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


@pytest.mark.parametrize("layout", ["wgmma", "mma_sync"])
def test_weight_packs_follow_an_optimizer_step(layout):
    """packed_weights keys its cache on the weight's version: the fused
    AdamW step leaves it as it was, TrainOptimizer.step bumps it, so the
    next pack is of the new weights, not last step's."""
    conv = nn.Conv2d(8, 8, 3)
    opt = make_optimizer(conv, 1e-2, clip_norm=None)
    before = c3.packed_weights(conv.weight, layout).clone()
    conv.weight.grad = torch.ones_like(conv.weight)
    conv.bias.grad = torch.ones_like(conv.bias)
    opt.step()
    after = c3.packed_weights(conv.weight, layout)
    assert not torch.equal(before, after)
    assert torch.equal(after, c3.pack_weights(conv.weight.detach(), layout))



# ---- optimizer ---------------------------------------------------------------

class _Toy(nn.Module):
    def __init__(self, g):
        super().__init__()
        self.conv = nn.Conv2d(2, 3, 3)
        self.frozen = nn.Linear(4, 4)
        self.scale = nn.Parameter(torch.randn(1, generator=g))
        self.QP = nn.Parameter(torch.randn(2, 1, 1, 1, generator=g))
        with torch.no_grad():
            for p in (*self.conv.parameters(), *self.frozen.parameters()):
                p.copy_(torch.randn(p.shape, generator=g))


def test_make_optimizer_matches_optax_chain():
    """Three steps of the port's AdamW (a frozen part, the decay mask,
    clipping that bites in the first step and not in the second, a
    learning-rate schedule) against the JAX package's optax chain on the
    same gradients, 1e-6."""
    g = torch.Generator().manual_seed(0)
    model = _Toy(g)
    params = {"params": {
        "conv": {"weight": model.conv.weight.detach().numpy().copy(),
                 "bias": model.conv.bias.detach().numpy().copy()},
        "frozen": {"weight": model.frozen.weight.detach().numpy().copy(),
                   "bias": model.frozen.bias.detach().numpy().copy()},
        "scale": model.scale.detach().numpy().copy(),
        "QP": model.QP.detach().numpy().copy()}}
    names = {"conv.weight": ("conv", "weight"), "conv.bias": ("conv", "bias"),
             "frozen.weight": ("frozen", "weight"), "frozen.bias": ("frozen", "bias"),
             "scale": ("scale",), "QP": ("QP",)}

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def lr(step):
        return 1e-2 * (step + 1)

    pred = lambda p: not p.startswith("frozen")  # noqa: E731
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_make_optimizer(jparams, lr, weight_decay=0.05, clip_norm=2.0,
                            trainable=jax_trainable_mask(jparams, pred))
    state = tx.init(jparams)
    opt = make_optimizer(model, lr, weight_decay=0.05, clip_norm=2.0,
                         trainable=trainable_mask(model, pred))
    assert decay_mask(model) == {"conv.weight": True, "conv.bias": False,
                                 "frozen.weight": True, "frozen.bias": False,
                                 "scale": False, "QP": True}
    assert not model.frozen.weight.requires_grad and model.conv.weight.requires_grad
    rng = np.random.default_rng(1)
    for scale in (10.0, 0.01, 1.0):
        grads = {k: (rng.normal(size=leaf(params["params"], p).shape) * scale)
                 .astype(np.float32) for k, p in names.items()}
        gtree = jax.tree_util.tree_map(lambda v: v, params)
        for k, p in names.items():
            leaf(gtree["params"], p[:-1])[p[-1]] = jnp.asarray(grads[k])
        updates, state = tx.update(gtree, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for k, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.tensor(grads[k])
        opt.step()
    for k, p in model.named_parameters():
        want = np.asarray(leaf(jparams["params"], names[k]))
        err = float(np.max(np.abs(p.detach().numpy() - want)))
        assert err <= 1e-6, (k, err)
    assert torch.equal(model.frozen.weight, torch.tensor(params["params"]["frozen"]["weight"]))
    assert len(opt.adamw.state) == 4  # frozen parameters hold no state


# ---- curriculum --------------------------------------------------------------

def _state_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_curriculum_config_and_gates():
    for name in ("train_mctf_gop16.json", "train_mctf_smoke.json"):
        path = os.path.join(ROOT, "configs", name)
        assert vars(curriculum.CurriculumConfig.from_json(path)) == vars(
            jax_curriculum.CurriculumConfig.from_json(path))
    from learned_pmctf_tpu.training.steps import StageGates as JaxGates
    for s in range(8):
        assert tuple(StageGates.for_stage(s)) == tuple(JaxGates.for_stage(s))


# ---- schedules, checkpoints --------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(warmup_epochs=1),
                                dict(warmup_steps=5, start_warmup_value=1e-6)])
def test_schedules_match_jax(kw):
    args = (1e-4, 1e-6, 4, 7)
    np.testing.assert_array_equal(schedules.cosine_scheduler(*args, **kw),
                                  jax_schedules.cosine_scheduler(*args, **kw))
    for lam in ([1, 35], [1, 27]):
        for q in (0, 3.5, 20):
            assert schedules.get_cur_lambda(lam, q, 21) == \
                jax_schedules.get_cur_lambda(lam, q, 21)


def test_checkpoint_round_trip(tmp_path):
    model = init_params(PWave(decomp_levels=2, features=8, ar_features=8),
                        torch.Generator().manual_seed(0))
    opt = make_optimizer(model, 1e-3)
    x = torch.rand(1, 1, 32, 32) * 255
    out = model(x, 10.0, training=True)
    (out["mse"] + out["bpp_total"]).backward()
    opt.step()
    save_checkpoint(str(tmp_path / "ck"), model, opt, 3,
                    {"stage_num": 5, "quant_stage": True})
    fresh = init_params(PWave(decomp_levels=2, features=8, ar_features=8),
                        torch.Generator().manual_seed(1))
    fresh_opt = make_optimizer(fresh, 1e-3)
    params, opt_state, meta = load_checkpoint(str(tmp_path / "ck"), fresh, fresh_opt)
    assert meta == {"epoch": 3, "stage_num": 5, "quant_stage": True}
    _state_equal(fresh.state_dict(), model.state_dict())
    _state_equal(params, model.state_dict())
    assert fresh_opt.count == 1 and opt_state["count"] == 1
    for (a, b) in zip(fresh_opt.adamw.state.values(), opt.adamw.state.values()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a[k], b[k])
