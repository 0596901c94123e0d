"""Port parity, data parallelism (learned_pmctf_tpu_torch/parallel,
training/steps.py's ``group``): the rank helpers, and one GOP-2 train
step on 2 gloo ranks of 4 rows each against one process on the same
batch of 8, at tests/dp_equiv_script.py's configuration
(decomp_levels=1, widths 8, spynet_levels=2, batch 8, 64x128, stage
gates of curriculum stage 3), the MV rate terms' noise on.

Tolerances (dp_equiv_script.py:91's, as JAX holds its sharded step to
its single-device one): loss rel 1e-5; parameters after the AdamW step
rtol 5e-4, atol 1.5e-4; the reduced gradients to 1e-5 of the largest
magnitude in each top-level module group. The ranks run in a
subprocess (this file run as a script), two threads each, under a
timeout. The step against the JAX package's single-device step on the
same weights and batch (its jitted step takes a minute on the CPU) is
marked slow; tests/test_torch_port_train_gop.py holds the single-process
loss against JAX in tier-1.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from learned_pmctf_tpu_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(decomp_levels=1, num_me_stages=1, channel_mv=8, channel_n=8,
              features=8, ar_features=8, spynet_levels=2)
BATCH, RANKS, STAGE, Q, LMBDA = 8, 2, 2, 10.0, 0.05
LOSS_RTOL, P_RTOL, P_ATOL, GRAD_REL = 1e-5, 5e-4, 1.5e-4, 1e-5


def frames():
    return np.random.default_rng(0).integers(0, 256, (2, BATCH, 1, 64, 128)).astype(
        np.float32)


def one_step(model, batch, group=None, noise=True):
    """(log, params, grads) after one GOP-2 step of `model` on `batch`
    (this rank's rows), lr 1e-4 as dp_equiv_script.py's optimizer."""
    from learned_pmctf_tpu_torch.training.optim import make_optimizer
    from learned_pmctf_tpu_torch.training.steps import StageGates, make_pmctf_train_step
    opt = make_optimizer(model, 1e-4)
    step = make_pmctf_train_step(model, opt, 2, StageGates.for_stage(STAGE), group=group)
    gen = torch.Generator().manual_seed(3) if noise else None
    log = step(torch.from_numpy(batch), Q, LMBDA, gen)
    return ({k: float(v) for k, v in log.items()},
            {k: p.detach().clone() for k, p in model.named_parameters()},
            {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None})


def port_model(state=None):
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    model = build_pmctf("cpu", seed=1, **CONFIG).train()
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model


def _rank(out, state_path, noise):
    """One rank: its rows of the global batch through the grouped step;
    rank 0 saves what it ends with."""
    import torch.distributed as dist
    torch.set_num_threads(2)
    dp = mesh.make_mesh(device="cpu")
    state = torch.load(state_path) if state_path else None
    rows = mesh.data_rows(BATCH, dp.rank, dp.world)
    log, params, grads = one_step(port_model(state), frames()[:, rows],
                                  dist.group.WORLD, noise)
    if dp.rank == 0:
        torch.save({"log": log, "params": params, "grads": grads}, out)


def start_ranks(tmp_path, state=None, noise=True):
    """The grouped step on RANKS gloo ranks, in a subprocess (this file
    as a script); finish_ranks waits for it."""
    out = tmp_path / "dp.pt"
    state_path = ""
    if state is not None:
        state_path = str(tmp_path / "state.pt")
        torch.save(state, state_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
               OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(out), state_path,
                             str(int(noise))], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish_ranks(started, timeout=600):
    proc, out = started
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, text[-5000:]
    return torch.load(out)


def group_of(name):
    return name.split(".")[0]


def assert_same_step(dp, single):
    log, params, grads = single
    for k, v in log.items():
        assert abs(dp["log"][k] - v) <= LOSS_RTOL * max(abs(v), 1e-6), (k, dp["log"][k], v)
    assert set(dp["grads"]) == set(grads)
    largest = {}
    for k, g in grads.items():
        largest[group_of(k)] = max(largest.get(group_of(k), 0.0), float(g.abs().max()))
    for k, g in grads.items():
        err = float((dp["grads"][k] - g).abs().max())
        assert err <= GRAD_REL * largest[group_of(k)], (k, err, largest[group_of(k)])
    for k, p in params.items():
        np.testing.assert_allclose(dp["params"][k].numpy(), p.numpy(), rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=k)


def test_rows_and_rank_helpers(monkeypatch):
    """data_rows splits axis 0 as P("data"): contiguous blocks in rank
    order, a batch that does not divide raises; one process outside a
    group is rank 0 of 1 on its device; the launcher's environment is
    recognized; a spatial axis that does not divide the group raises."""
    assert [mesh.data_rows(8, r, 4) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert mesh.data_rows(6, 0, 1) == slice(0, 6)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.data_rows(9, 0, 2)
    x = np.arange(8)
    assert np.array_equal(np.concatenate([x[mesh.data_rows(8, r, 2)] for r in range(2)]), x)
    one = mesh.make_mesh(device="cpu")
    assert (one.rank, one.world, one.device) == (0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="1 ranks does not divide over a spatial axis of 2"):
        mesh.make_mesh(spatial=2, device="cpu")
    assert mesh.backend_for("cpu") == "gloo" and mesh.backend_for("cuda:0") == "nccl"
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert not mesh.launched_by_torchrun()
    for key, val in (("RANK", "1"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "127.0.0.1"),
                     ("MASTER_PORT", "29500")):
        monkeypatch.setenv(key, val)
    assert mesh.launched_by_torchrun()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.rank_device("cuda")


def test_noise_of_a_rank_is_its_rows_of_the_global_draw():
    """draw_pair_noise on a rank's rows: the global batch's draw, its
    rows, every rank drawing alike."""
    from learned_pmctf_tpu_torch.training.steps import draw_pair_noise
    model = port_model()
    full = [torch.zeros(BATCH, 1, 64, 128)] * 4
    want = draw_pair_noise(model, full, torch.Generator().manual_seed(3))
    for r in range(RANKS):
        rows = mesh.data_rows(BATCH, r, RANKS)
        got = draw_pair_noise(model, [f[rows] for f in full], torch.Generator().manual_seed(3),
                              r, RANKS)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert torch.equal(a, b[rows])


def test_dp_gop2_step_matches_single_process(tmp_path):
    """2 gloo ranks of 4 rows against one process on the batch of 8: the
    logged loss and terms, the reduced (and clipped) gradients and the
    parameters after the step."""
    torch.set_num_threads(2)
    started = start_ranks(tmp_path)
    single = one_step(port_model(), frames())  # while the ranks run
    dp = finish_ranks(started)
    assert_same_step(dp, single)
    # the step moved the weights, and not by the same amount everywhere
    moved = [float((dp["params"][k] - p.detach()).abs().max())
             for k, p in port_model().named_parameters()]
    assert max(moved) > 5e-5


@pytest.mark.slow  # the JAX package's jitted GOP-2 step: about a minute on the CPU
def test_dp_step_matches_jax_single_device_step(tmp_path):
    """The 2-rank step against the JAX package's make_pmctf_train_step on
    one device, the same weights (convert.params_from_jax) and batch,
    straight-through rounding in the rate terms on both sides (flax draws
    its noise from keys the port cannot take): loss, and the parameters
    after the step."""
    import jax
    import jax.numpy as jnp
    from learned_pmctf_tpu.training.optim import make_optimizer as jax_optimizer
    from learned_pmctf_tpu.training.steps import StageGates as JaxGates
    from learned_pmctf_tpu.training.steps import make_pmctf_train_step as jax_step
    from learned_pmctf_tpu_torch.convert import params_from_jax
    from torch_port_helpers import jax_small_model, jax_small_params
    torch.set_num_threads(2)
    params = jax_small_params(seed=4, **CONFIG)
    started = start_ranks(tmp_path, state=params_from_jax(params), noise=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_optimizer(jparams, learning_rate=1e-4)
    step = jax_step(jax_small_model(**CONFIG), tx, num_frames=2,
                    gates=JaxGates.for_stage(STAGE))
    with jax.default_matmul_precision("highest"):
        p_ref, _, m_ref = step(jparams, tx.init(jparams), jnp.asarray(frames()),
                               jnp.float32(Q), jnp.float32(LMBDA), None)
    dp = finish_ranks(started)
    want = float(m_ref["rd_loss"])
    assert abs(dp["log"]["rd_loss"] - want) <= LOSS_RTOL * abs(want), (dp["log"], want)
    for k, p in params_from_jax(jax.device_get(p_ref)).items():
        np.testing.assert_allclose(dp["params"][k].numpy(), p.numpy(), rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=k)


if __name__ == "__main__":
    # the ranks of run_ranks: out path, initial state ("" for the seeded
    # one), noise on (1) or off (0)
    mesh.spawn(_rank, RANKS, (sys.argv[1], sys.argv[2], sys.argv[3] == "1"), device="cpu")
