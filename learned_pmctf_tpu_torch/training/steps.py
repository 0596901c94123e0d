"""Training steps for pWave (image) and pMCTF (video).

Counterpart of learned_pmctf_tpu/training/steps.py. The pMCTF GOP loss
runs the hierarchical schedule: forward MCTF analysis over
log2(num_frames) temporal stages, inverse synthesis, then a per-frame
rate-distortion loss with stage-gated terms; the whole GOP is
differentiated end to end. Where the JAX package wraps each pair in
``jax.checkpoint``, every analysis pair and every synthesis pair runs
under ``torch.utils.checkpoint`` (recomputed in backward), so a GOP-16
at batch 8 keeps one pair's activations at a time. Python loops take
the place of ``lax.scan`` and ``vmap``.

The MV rate terms' uniform noise is drawn before each checkpointed pair
and passed in as tensors: a draw inside the pair would draw again on
recompute, and the gradient would not belong to the forward pass.

Data parallelism (``group``): each rank codes its block of the global
batch's rows, draws the noise at the global batch's shape and keeps its
rows, and the gradients are averaged over the ranks as one flat bucket
between ``backward`` and the optimizer (which clips the reduced
gradients by their global norm, where JAX clips). Every term of the loss
is a mean over the batch, so W ranks of B/W rows give the update one
process gives on B rows, as JAX's sharded step does. No DDP wrapper: the
loss never calls ``model.forward``, and a stage's gates leave whole
sub-nets without gradients.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..models.pmctf import empty_dpb
from ..parallel.mesh import data_rows, mean_over_ranks_


class StageGates(NamedTuple):
    """Loss-term gating of a curriculum stage."""

    d_me: float = 0.0      # motion-estimation distortion (stages < 2)
    d_rec: float = 1.0     # reconstruction distortion (stages >= 2)
    r_mv: float = 1.0      # MV rate (stages >= 1)
    r_latent: float = 1.0  # latent rate (stages >= 2)

    @staticmethod
    def for_stage(stage_num: int) -> "StageGates":
        return StageGates(
            d_me=1.0 if stage_num < 2 else 0.0,
            d_rec=1.0 if stage_num >= 2 else 0.0,
            r_mv=1.0 if stage_num >= 1 else 0.0,
            r_latent=1.0 if stage_num >= 2 else 0.0,
        )


def make_pwave_train_step(model, optimizer):
    """step(x, q_index, lmbda) -> metrics: one forward, backward and
    optimizer update of `model` (a PWave) in place. The loss is
    lmbda * mse + the batch's bits over B*H*W."""

    def step(x, q_index, lmbda):
        optimizer.zero_grad()
        out = model(x, q_index, training=True)
        n, _, h, w = x.shape
        bpp = out["bits"].sum() / (n * h * w)
        loss = lmbda * out["mse"] + bpp
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "mse": out["mse"].detach(),
                "bpp": bpp.detach()}

    return step


def draw_pair_noise(model, frames, generator, rank: int = 0, world: int = 1):
    """The MV rate terms' noise of every analysis pair of a GOP, in the
    order pmctf_gop_loss codes the pairs: a list of (n_y, n_z), uniform in
    [-0.5, 0.5), drawn from `generator` on its device. With `world` ranks
    the frames are `rank`'s rows of the global batch: the noise is drawn
    at the global batch's shape and the rank's rows kept, so every rank
    draws alike and one process on the global batch draws the same."""
    b, _, h, w = frames[0].shape
    shapes = model.mv_noise_shapes(b * world, h, w)
    rows = data_rows(b * world, rank, world)
    return [tuple((torch.rand(s, generator=generator, device=generator.device) - 0.5)[rows]
                  for s in shapes)
            for _ in range(len(frames) - 1)]


def _run(fn, remat, *args):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def pmctf_gop_loss(model, frames, q_index, lmbda, gates: StageGates,
                   me_base: int = 0, noise=None, remat: bool = True):
    """End-to-end GOP rate-distortion loss.

    frames: a sequence of (B,1,H,W) tensors (or a (T,B,1,H,W) tensor), T a
    power of two. noise: None (straight-through rounding in the rate
    terms), a torch.Generator to draw it from (``draw_pair_noise``), or
    the list ``draw_pair_noise`` returns, on any device. remat: recompute
    each pair in backward. Returns (loss, log)."""
    frames = list(frames)
    num_frames = len(frames)
    num_stages = max(1, int(math.log2(num_frames)))
    if 2 ** num_stages != num_frames:
        raise ValueError(f"GOP length {num_frames} is not a power of two")
    if isinstance(noise, torch.Generator):
        noise = draw_pair_noise(model, frames, noise)
    device = frames[0].device
    pair_noise = iter(noise) if noise is not None else None

    def code_pair(ref, cur, mv_feature, ref_mv_y, code_lt, stage, n_y, n_z):
        dpb = {"mv_feature": mv_feature, "ref_mv_y": ref_mv_y}
        return model.forward_one_stage(
            ref, cur, q_index, code_lt, dpb, stage_idx=stage, training=True,
            noise=None if n_y is None else (n_y, n_z))

    def inv_pair(l_t, h_t, mv, stage):
        return model.inverse_mctf(l_t, h_t, mv, stage)

    frames_coded = list(frames)
    mvs = [None] * num_frames
    results = [None] * num_frames
    num_pairs = num_frames // 2
    for stage_idx in range(num_stages):
        group_step = 2 ** stage_idx
        code_lt = (stage_idx + 1) == num_stages
        stage = me_base + stage_idx
        dpb = empty_dpb()
        for g in range(num_pairs):
            f = g * 2 * group_step
            n_y = n_z = None
            if pair_noise is not None:
                n_y, n_z = (t.to(device) for t in next(pair_noise))
            out = _run(code_pair, remat, frames_coded[f],
                       frames_coded[f + group_step], dpb["mv_feature"],
                       dpb["ref_mv_y"], code_lt, stage, n_y, n_z)
            dpb = out["dpb"]
            frames_coded[f] = out["L_t"]
            frames_coded[f + group_step] = out["H_t"]
            mvs[f + group_step] = out["mv_hat"]
            results[f + group_step] = {k: out[k] for k in
                                       ("bpp_H", "bpp_me", "me_mse", "bpp")}
            if code_lt:
                results[f] = {"bpp_L": out["bpp_L"],
                              "me_mse_inv": out["me_mse_inv"]}
        num_pairs //= 2

    num_pairs = 1
    for stage_idx in reversed(range(num_stages)):
        group_step = 2 ** stage_idx
        for g in range(num_pairs):
            f = g * 2 * group_step
            ref, cur = _run(inv_pair, remat, frames_coded[f],
                            frames_coded[f + group_step], mvs[f + group_step],
                            me_base + stage_idx)
            frames_coded[f] = ref
            frames_coded[f + group_step] = cur
        num_pairs *= 2

    rd_loss = 0.0
    log = {"bpp_L": 0.0, "bpp_H": 0.0, "bpp_mv": 0.0, "mse": 0.0,
           "me_mse": 0.0}
    for fidx in range(num_frames):
        d_latent = torch.mean((frames_coded[fidx] - frames[fidx]) ** 2)
        rb = results[fidx]
        if fidx == 0:
            rate_latent = rb["bpp_L"]
            rate_mv = 0.0
            d_me = 0.0
            log["bpp_L"] += rb["bpp_L"]
        else:
            rate_latent = rb["bpp_H"]
            rate_mv = rb["bpp_me"]
            d_me = rb["me_mse"]
            log["bpp_H"] += rb["bpp_H"] / (num_frames - 1)
            log["bpp_mv"] += rb["bpp_me"] / (num_frames - 1)
            log["me_mse"] += rb["me_mse"] / (num_frames - 1)
        log["mse"] += d_latent / num_frames
        rate = gates.r_latent * rate_latent + gates.r_mv * rate_mv
        dist = gates.d_rec * d_latent + gates.d_me * d_me
        rd_loss = rd_loss + lmbda * dist + rate

    log["rd_loss"] = rd_loss
    return rd_loss, {k: v.detach() for k, v in log.items()}


def make_pmctf_train_step(model, optimizer, num_frames: int,
                          gates: StageGates, me_base: int = 0,
                          remat: bool = True, group=None):
    """step(frames, q_index, lmbda, noise=None) -> log: one GOP forward,
    backward and optimizer update of `model` (a PMCTF) in place. frames:
    (num_frames, B, 1, H, W). group: a torch.distributed group (or
    torch.distributed.group.WORLD) whose ranks each pass their rows of
    the global batch and the same generator; the gradients and the log
    are then the means over the ranks."""
    rank, world = 0, 1
    if group is not None:
        import torch.distributed as dist
        rank, world = dist.get_rank(group), dist.get_world_size(group)

    def step(frames, q_index, lmbda, noise: Optional[object] = None):
        if len(frames) != num_frames:
            raise ValueError(f"expected {num_frames} frames, got {len(frames)}")
        if isinstance(noise, torch.Generator):
            noise = draw_pair_noise(model, list(frames), noise, rank, world)
        optimizer.zero_grad()
        loss, log = pmctf_gop_loss(model, frames, q_index, lmbda, gates,
                                   me_base, noise, remat)
        loss.backward()
        if group is not None:
            reduce_over_ranks(optimizer.params, log, group)
        optimizer.step()
        return log

    return step


def reduce_over_ranks(params, log, group):
    """Average the gradients of `params` (zeros where a step reached none,
    as the optimizer's step would give them) and the entries of `log` over
    the group's ranks, in place."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    keys = sorted(log)
    vals = torch.stack([torch.as_tensor(log[k], dtype=torch.float32,
                                        device=params[0].device) for k in keys])
    mean_over_ranks_([p.grad for p in params] + [vals], group)
    for k, v in zip(keys, vals):
        log[k] = v
