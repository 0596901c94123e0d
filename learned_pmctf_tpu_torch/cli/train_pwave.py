"""pWave++ image-coder training CLI: the JAX package's train_pwave.py on
PyTorch (the same flags, defaults, logs and checkpoints), on CUDA unless
--device cpu.

Variable-rate training with a random q_index per step (lambda
log-interpolated from [1, 35] * 0.003), AdamW with a cosine learning-rate
schedule and warm-up, gradient clipping, validation at the highest rate
point and best-loss checkpointing. Each epoch's first validation
picture, its subbands and its reconstruction go to <exp>/web/images/
with an index.html gallery (utils/visualizer.py), as the JAX trainer
draws them.

    python -m learned_pmctf_tpu_torch.cli.train_pwave -d <vimeo root>
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

def parse_args(argv):
    p = argparse.ArgumentParser(description="pWave++ training (PyTorch)")
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("-e", "--epochs", default=31, type=int)
    p.add_argument("--save-freq", type=int, default=1)
    p.add_argument("-lr", "--learning-rate", default=1e-4, type=float)
    p.add_argument("--min_lr", default=1e-6, type=float)
    p.add_argument("-n", "--num-workers", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--test-batch-size", type=int, default=16)
    p.add_argument("--patch-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--clip_max_norm", default=1.0, type=float)
    p.add_argument("--experiments_root", default="experiments", type=str)
    p.add_argument("--exp_postfix", default="", type=str)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--lossless", action="store_true",
                   help="the lossless pWave (integer lifting, no PostProcess); "
                        "the training batches are rounded")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--ll_mode", default="fourstep", choices=("fourstep", "ar"))
    p.add_argument("--features", type=int, default=112)
    p.add_argument("--steps_per_epoch", type=int, default=-1,
                   help="cap steps per epoch (smoke testing)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


LAMBDA_LIST = [1, 35]


def main(argv):
    args = parse_args(argv)

    from ..data.loader import DataLoader
    from ..data.vimeo import VideoFolder
    from ..models.layers import init_params
    from ..models.pwave import PWave, QP_NUM
    from ..runtime import disable_tf32, resolve_device
    from ..training.optim import make_optimizer
    from ..training.steps import make_pwave_train_step
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from ..utils.logger import get_env_info, get_root_logger
    from ..utils.schedules import cosine_scheduler, get_cur_lambda
    from ..utils.visualizer import Visualizer, pwave_visuals

    device = resolve_device(args.device)
    disable_tf32()
    seed = args.seed if args.seed is not None else 0
    rng = np.random.default_rng(seed)

    exp_name = f"pwave_BS{args.batch_size}_LR{args.learning_rate}{args.exp_postfix}"
    exp_path = osp.join(args.experiments_root, exp_name)
    os.makedirs(exp_path, exist_ok=True)
    logger = get_root_logger(
        log_file=osp.join(exp_path, f"train_{time.strftime('%Y%m%d_%H%M%S')}.log"))
    logger.info(get_env_info())
    visualizer = Visualizer(exp_path)

    train_ds = VideoFolder(args.dataset, split="train",
                           patch_size=tuple(args.patch_size), seed=seed)
    valid_ds = VideoFolder(args.dataset, split="valid",
                           patch_size=tuple(args.patch_size), seed=seed)
    train_loader = DataLoader(train_ds, args.batch_size,
                              num_workers=args.num_workers, seed=seed)
    valid_loader = DataLoader(valid_ds, min(args.test_batch_size, len(valid_ds)),
                              shuffle=False, num_workers=args.num_workers,
                              drop_last=False)

    steps_per_epoch = len(train_loader)
    if args.steps_per_epoch > 0:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)

    model = init_params(PWave(lossy=not args.lossless, ll_mode=args.ll_mode,
                              features=args.features),
                        torch.Generator().manual_seed(seed)).to(device).train()
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"parameters: {n_params / 1e6:.3f}M")

    warmup_epochs = int(args.epochs * 0.055)
    lr_sched = cosine_scheduler(args.learning_rate, args.min_lr, args.epochs,
                                steps_per_epoch, warmup_epochs=warmup_epochs)
    optimizer = make_optimizer(
        model, lambda step: lr_sched[min(step, len(lr_sched) - 1)],
        weight_decay=args.weight_decay, clip_norm=args.clip_max_norm)
    step_fn = make_pwave_train_step(model, optimizer)

    start_epoch = 0
    if args.checkpoint:
        _, _, meta = load_checkpoint(args.checkpoint, model, optimizer)
        start_epoch = meta.get("epoch", -1) + 1
        logger.info(f"resumed from {args.checkpoint} at epoch {start_epoch}")

    best_loss = float("inf")
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        log_freq = max(1, steps_per_epoch // 50)
        for it, batch in enumerate(train_loader):
            if it >= steps_per_epoch:
                break
            q_index = int(rng.integers(0, QP_NUM))
            lmbda = get_cur_lambda(LAMBDA_LIST, q_index, QP_NUM)
            x = torch.from_numpy(batch).to(device)
            if args.lossless:
                x = torch.round(x)
            metrics = step_fn(x, float(q_index), lmbda)
            if it % log_freq == 0:
                logger.info(
                    f"epoch {epoch} [{it}/{steps_per_epoch}] "
                    f"loss {float(metrics['loss']):.4f} "
                    f"mse {float(metrics['mse']):.3f} "
                    f"bpp {float(metrics['bpp']):.4f} q {q_index}")

        # validation at the highest rate point
        val_losses = []
        q_index = QP_NUM - 1
        lmbda = get_cur_lambda(LAMBDA_LIST, q_index, QP_NUM)
        with torch.no_grad():
            for i, batch in enumerate(valid_loader):
                x = torch.from_numpy(batch).to(device)
                out = model(x, float(q_index))
                n, _, h, w = batch.shape
                bpp = float(out["bits"].sum()) / (n * h * w)
                val_losses.append(lmbda * float(out["mse"]) + bpp)
                if i == 0:
                    visualizer.display_current_results(
                        pwave_visuals(model, x[:1], out["x_hat"][:1]), epoch,
                        is_eval=True)
        loss = float(np.mean(val_losses)) if val_losses else float("inf")
        logger.info(f"epoch {epoch} valid loss {loss:.4f} "
                    f"({time.time() - t0:.0f}s)")

        is_best = loss < best_loss
        best_loss = min(best_loss, loss)
        if epoch % args.save_freq == 0 or epoch == args.epochs - 1 or is_best:
            name = "checkpoint_best_loss" if is_best else f"state_epoch{epoch}"
            save_checkpoint(osp.join(exp_path, name), model, optimizer,
                            epoch, {"loss": loss})
            logger.info(f"saved {name}")


if __name__ == "__main__":
    main(sys.argv[1:])
