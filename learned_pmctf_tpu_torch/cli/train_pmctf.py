"""pMCTF-L staged-curriculum training CLI: the JAX package's
train_pmctf.py on PyTorch (the same flags, defaults, stage logic, logs
and checkpoints), on CUDA unless --device cpu.

The 8-stage JSON curriculum (GOP 4->4->2->2->2->4->8->16, parts
Inter/All/MCTF, per-stage lr and frame interval, loss-term gating):
freezing is requires_grad (training/optim.py), ME-stage cloning copies
weights in place, and the temporal-layer quality scaling switches on
from stage 6 of an "All" part. Every GOP is differentiated end to end
with per-pair recomputation (training/steps.py).

    python -m learned_pmctf_tpu_torch.cli.train_pmctf -d <vimeo root> \\
        --config configs/train_mctf_gop16.json

Data parallelism (--data_parallel N, the JAX trainer's flag: 0 means
every visible card when there is more than one): N ranks, one a card
over NCCL (gloo ranks on the CPU with --device cpu), each coding its
B/N rows of every global batch of the same seeded loader, with the
gradients averaged over the ranks before the optimizer step
(training/steps.py). The trainer starts the ranks itself, or joins the
group of a launcher:

    torchrun --nproc_per_node 4 -m learned_pmctf_tpu_torch.cli.train_pmctf \\
        -d <vimeo root> --data_parallel 4

Rank 0 alone writes the log and the checkpoints; the logged metrics are
the means over the ranks.
"""

from __future__ import annotations

import argparse
import math
import os
import os.path as osp
import sys
import time

import logging

import numpy as np
import torch

def parse_args(argv):
    p = argparse.ArgumentParser(description="pMCTF-L training (PyTorch)")
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("--iframe_path", type=str, default=None,
                   help="a pWave checkpoint of train_pwave to initialize "
                        "the lp/hp coders")
    p.add_argument("--spynet_path", type=str, default=None,
                   help="pretrained SpyNet torch checkpoint (reference or "
                        "sniklaus names)")
    p.add_argument("--config", type=str, default="configs/train_mctf_gop16.json")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--start_stage", type=int, default=-1)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--patchsize", type=int, nargs=2, default=(128, 128))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--exp_postfix", default="", type=str)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--lossless", action="store_true",
                   help="the lossless pMCTF-L (rounded lifting and warps, no "
                        "PostProcess) on YCoCg training frames")
    p.add_argument("--num_me_stages", default=2, type=int)
    p.add_argument("--ll_mode", default="fourstep", choices=("fourstep", "ar"))
    p.add_argument("--warp_mode", default="fast", choices=("exact", "fast"),
                   help="'fast' trains a self-consistent separable-warp "
                        "model; use 'exact' for reference-semantics parity")
    p.add_argument("--steps_per_epoch", type=int, default=-1)
    p.add_argument("--fix_interval", type=int, default=0,
                   help="pin the frame interval (and thus the ME-stage "
                        "selection)")
    p.add_argument("--fix_q", type=int, default=-1,
                   help="pin the per-step q_index (default: random per step)")
    p.add_argument("--log_every", type=int, default=100,
                   help="log train metrics every N global steps")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split each batch over this many ranks, one a card "
                        "(0 = every visible card if more than one, else one "
                        "process); with --device cpu, gloo ranks on the CPU")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def data_parallel_ranks(args) -> int:
    """The number of ranks --data_parallel asks for on args.device (1: no
    group). Never more than the visible cards."""
    visible = 1
    if args.device.startswith("cuda"):
        visible = torch.cuda.device_count()
    n = args.data_parallel or (visible if visible > 1 else 1)
    if args.device.startswith("cuda") and n > visible:
        raise ValueError(f"--data_parallel {n} asks for more ranks than the "
                         f"{visible} visible cards")
    return n


def resume_point(cfg, args, meta):
    """(start_epoch, stage_num, epochs already done in that stage)."""
    if args.start_stage > 0:
        start_epoch = sum(cfg.num_epochs[:args.start_stage - 1])
    else:
        start_epoch = meta.get("epoch", -1) + 1
    acc = 0
    for sn, dur in enumerate(cfg.num_epochs):
        acc += dur
        if acc > start_epoch:
            return start_epoch, sn, start_epoch - (acc - dur)
    return start_epoch, 0, 0


def main(argv):
    args = parse_args(argv)
    from ..parallel import mesh
    if mesh.launched_by_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        if args.data_parallel not in (0, world):
            raise ValueError(f"--data_parallel {args.data_parallel} under a "
                             f"launcher of {world} ranks")
        mesh.init_process_group(args.device)
        try:
            train(args, grouped=True)
        finally:
            torch.distributed.destroy_process_group()
        return
    if args.device.startswith("cuda"):
        from ..runtime import resolve_device
        resolve_device(args.device)
    n = data_parallel_ranks(args)
    if n > 1:
        mesh.data_rows(args.batch_size, 0, n)  # the batch must divide, as JAX asserts
        mesh.spawn(train, n, (args, True), device=args.device)
    else:
        train(args, grouped=False)


def train(args, grouped: bool):
    """The curriculum on this process: one rank of the joined group if
    `grouped`, else the whole batch."""
    from ..convert import load_reference_spynet
    from ..data.loader import DataLoader
    from ..data.vimeo import VideoYCbCr
    from ..models.pmctf import build_pmctf
    from ..models.pwave import QP_NUM
    from ..parallel import mesh
    from ..runtime import resolve_device
    from ..training.curriculum import (
        CurriculumConfig, PART_PREDICATES, clone_me_stage, load_from_iframe)
    from ..training.optim import make_optimizer, trainable_mask
    from ..training.steps import StageGates, make_pmctf_train_step
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from ..utils.logger import get_env_info, get_root_logger
    from ..utils.schedules import get_cur_lambda

    if grouped:
        dp = mesh.make_mesh(device=args.device)
        group = torch.distributed.group.WORLD
    else:
        dp = mesh.DataMesh(0, 1, resolve_device(args.device))
        group = None
    device, lead = dp.device, dp.rank == 0
    rows = mesh.data_rows(args.batch_size, dp.rank, dp.world)
    cfg = CurriculumConfig.from_json(args.config)
    rng = np.random.default_rng(args.seed)

    exp_path = osp.join("experiments", f"pmctf_BS{args.batch_size}{args.exp_postfix}")
    if lead:
        os.makedirs(exp_path, exist_ok=True)
        logger = get_root_logger(
            log_file=osp.join(exp_path, f"train_{time.strftime('%Y%m%d_%H%M%S')}.log"))
        logger.info(get_env_info())
        if group is not None:
            logger.info(f"data parallel: {dp.world} ranks of {rows.stop - rows.start} "
                        f"rows ({torch.distributed.get_backend()})")
    else:  # the other ranks write nothing
        logger = get_root_logger(f"pmctf_torch_rank{dp.rank}", log_level=logging.WARNING)

    # build_pmctf turns TF32 off: the trainer is f32, as the JAX one
    model = build_pmctf(device, seed=args.seed, lossy=not args.lossless,
                        num_me_stages=args.num_me_stages,
                        ll_mode=args.ll_mode, quant_stage=False,
                        warp_mode=args.warp_mode).train()
    n_params = sum(p.numel() for p in model.parameters())
    n_mctf = sum(p.numel() for k, p in model.named_parameters()
                 if k.startswith(("optic_flow", "temporal_filtering", "mv")))
    logger.info(f"parameters total {n_params/1e6:.3f}M, MCTF {n_mctf/1e6:.3f}M")

    if args.iframe_path:
        iframe, _, _ = load_checkpoint(args.iframe_path)
        load_from_iframe(model, iframe)
        logger.info(f"loaded I-frame model from {args.iframe_path}")
    if args.spynet_path:
        load_reference_spynet(args.spynet_path, model.optic_flow)
        logger.info(f"loaded SpyNet from {args.spynet_path}")

    dataset = VideoYCbCr(args.dataset, split="train",
                         num_frames=cfg.num_frames[0],
                         patch_size=tuple(args.patchsize),
                         lossless=args.lossless, seed=args.seed)
    loader = DataLoader(dataset, args.batch_size,
                        num_workers=args.num_workers, seed=args.seed)

    stage_num = 0
    epochs_cur_stage = 0
    start_epoch = 0
    quant_stage_enabled = False

    if args.checkpoint:
        _, _, meta = load_checkpoint(args.checkpoint, model)
        if args.resume:
            start_epoch, stage_num, epochs_cur_stage = resume_point(cfg, args, meta)
            logger.info(f"resume at epoch {start_epoch}, stage {stage_num+1}")

    def configure_stage(stage_num):
        """The stage's dataset settings, weights and optimizer, and one
        train step per ME-stage offset."""
        nonlocal quant_stage_enabled
        part = cfg.parts[stage_num]
        num_frames = cfg.num_frames[stage_num]
        dataset.update_num_frames(num_frames, logger)
        if cfg.frame_interval[stage_num] > 1:
            dataset.update_interval(cfg.frame_interval[stage_num], logger)
        if stage_num >= 4 and part == "All":
            dataset.use_random_interval()
        # >= so a resume that jumps past stage 6 still switches it on
        if stage_num >= 5 and part == "All" and not quant_stage_enabled:
            logger.info("ENABLE TEMPORAL LAYER ADAPTIVE QUALITY SCALING")
            model.quant_stage = True
            quant_stage_enabled = True
        if num_frames > 8 and num_frames != cfg.num_frames[stage_num - 1]:
            me_stage = int(math.log2(num_frames))
            start_idx = min(me_stage - 1, args.num_me_stages - 1)
            copy_idx = min(me_stage - 2, args.num_me_stages - 2)
            if start_idx > copy_idx >= 0:
                logger.info(f"cloning ME stage {copy_idx} -> {start_idx}+")
                clone_me_stage(model, start_idx, copy_idx, args.num_me_stages)
        if group is not None:
            # every rank built, loaded and cloned alike; rank 0's weights
            # make sure of it
            mesh.broadcast_from_rank0_(list(model.parameters()) + list(model.buffers()))
        mask = trainable_mask(model, PART_PREDICATES[part])
        optimizer = make_optimizer(model, cfg.lr[stage_num], weight_decay=0.0,
                                   clip_norm=5.0, trainable=mask)
        gates = StageGates.for_stage(stage_num)
        # one step per me_base (the frame-interval-dependent ME-stage offset)
        step_fn = {mb: make_pmctf_train_step(model, optimizer, num_frames,
                                             gates, me_base=mb, group=group)
                   for mb in range(args.num_me_stages)}
        logger.info(f"STAGE {stage_num+1}: part={part} frames={num_frames} "
                    f"lr={cfg.lr[stage_num]} gates={gates}")
        return optimizer, step_fn

    optimizer, step_fn = configure_stage(stage_num)

    noise = torch.Generator(device=device).manual_seed(args.seed + 7)
    global_step = 0
    for epoch in range(start_epoch, cfg.total_epochs):
        if epochs_cur_stage == cfg.num_epochs[stage_num]:
            epochs_cur_stage = 0
            stage_num += 1
            optimizer, step_fn = configure_stage(stage_num)

        max_interval = cfg.frame_interval[stage_num]
        random_interval = stage_num >= 3
        if args.fix_interval > 0:
            random_interval = False
            max_interval = args.fix_interval

        steps = len(loader)
        if args.steps_per_epoch > 0:
            steps = min(steps, args.steps_per_epoch)
        t0 = time.time()
        if random_interval:
            dataset.use_random_interval()
            current_interval = dataset.set_current_interval()
        else:
            current_interval = max_interval
        for it, batch in enumerate(loader):
            if it >= steps:
                break
            global_step += 1
            # frames arrive as a tuple of (B,3,ph,pw); train on Y only,
            # this rank's rows
            frames = torch.stack([torch.from_numpy(f[rows, 0:1]) for f in batch]
                                 ).to(device)
            q_index = args.fix_q if args.fix_q >= 0 \
                else int(rng.integers(0, QP_NUM))
            lmbda = get_cur_lambda(cfg.train_lambda, q_index, QP_NUM)
            if random_interval:
                me_num = 0 if current_interval == 1 else \
                    current_interval // max(args.num_me_stages - 1, 1)
            else:
                me_num = min(args.num_me_stages - 1, max_interval - 1)
            me_num = min(me_num, args.num_me_stages - 1)
            metrics = step_fn[me_num](frames, float(q_index), lmbda, noise)
            if global_step % args.log_every == 0:
                logger.info(
                    f"epoch {epoch} [{it}/{steps}] "
                    f"rd {float(metrics['rd_loss']):.4f} "
                    f"mse {float(metrics['mse']):.2f} "
                    f"bppH {float(metrics['bpp_H']):.4f} "
                    f"bppMV {float(metrics['bpp_mv']):.4f} q {q_index}")
            if random_interval:
                current_interval = dataset.set_current_interval()

        epochs_cur_stage += 1
        if lead:
            save_checkpoint(osp.join(exp_path, f"state_epoch{epoch}"),
                            model, optimizer, epoch,
                            {"stage_num": stage_num,
                             "quant_stage": quant_stage_enabled})
            logger.info(f"epoch {epoch} done in {time.time()-t0:.0f}s; saved")


if __name__ == "__main__":
    main(sys.argv[1:])
