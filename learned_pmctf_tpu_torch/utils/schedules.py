"""Training schedules: per-step cosine learning rate with warm-up, and
the log-interpolated RD lambda of a q index.

A copy of learned_pmctf_tpu/utils/schedules.py (numpy only).
"""

from __future__ import annotations

import math

import numpy as np


def cosine_scheduler(base_value: float, final_value: float, epochs: int,
                     niter_per_ep: int, warmup_epochs: int = 0,
                     start_warmup_value: float = 0.0, warmup_steps: int = -1):
    """Per-iteration cosine schedule with optional linear warmup."""
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    warmup = np.linspace(start_warmup_value, base_value, warmup_iters) \
        if warmup_iters > 0 else np.array([])

    n = epochs * niter_per_ep - warmup_iters
    iters = np.arange(n)
    sched = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(math.pi * iters / max(n, 1)))
    schedule = np.concatenate([warmup, sched])
    if len(schedule) != epochs * niter_per_ep:
        raise ValueError(f"schedule has {len(schedule)} steps, expected "
                         f"{epochs * niter_per_ep}")
    return schedule


def get_cur_lambda(lambda_list, q_index: float, qp_num: int,
                   scale: float = 0.003) -> float:
    """Log-interpolate the RD lambda for a given q_index.

    lambda_list = [min, max]; image training uses [1, 35], video [1, 27]."""
    min_l, max_l = lambda_list[0], lambda_list[-1]
    step = (math.log(max_l) - math.log(min_l)) / (qp_num - 1)
    return math.exp(math.log(min_l) + step * q_index) * scale
