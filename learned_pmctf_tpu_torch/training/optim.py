"""Optimizer: AdamW with decay/no-decay groups, global-norm clipping and
frozen parameters.

Counterpart of learned_pmctf_tpu/training/optim.py, whose optax chain
is: frozen gradients set to zero, clip by global norm, Adam, decoupled
weight decay on the decay mask, times -lr, frozen updates set to zero.
Here frozen parameters get ``requires_grad=False``: they receive no
gradient, hold no Adam state and stay out of the norm, as the masks do
there. Every trainable parameter steps every time, with a zero gradient
where the step did not reach it, as optax updates every leaf.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch


def decay_mask(model) -> Dict[str, bool]:
    """True where weight decay applies: >= 2-D parameters, not biases."""
    return {name: p.dim() >= 2 and not name.endswith("bias")
            for name, p in model.named_parameters()}


def trainable_mask(model, predicate: Callable[[str], bool]) -> Dict[str, bool]:
    """predicate over the parameters' state_dict names."""
    return {name: bool(predicate(name)) for name, _ in model.named_parameters()}


class TrainOptimizer:
    """torch.optim.AdamW over two parameter groups (decayed and not), the
    learning rate from a schedule of the step count, and
    ``clip_grad_norm_`` before every step. The AdamW is the fused one (one
    launch a step on the card, where the train step is host-bound); it
    updates the parameters in place without bumping their version
    counters, on which the conv3x3 weight packs key, so ``step`` bumps
    them."""

    def __init__(self, model, learning_rate: Union[float, Callable[[int], float]],
                 weight_decay: float = 0.05, clip_norm: Optional[float] = 1.0,
                 trainable: Optional[Dict[str, bool]] = None):
        decay = decay_mask(model)
        self.params = []
        groups = {True: [], False: []}
        for name, p in model.named_parameters():
            live = True if trainable is None else trainable[name]
            p.requires_grad_(live)
            if live:
                self.params.append(p)
                groups[bool(weight_decay) and decay[name]].append(p)
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda step: learning_rate))
        self.clip_norm = clip_norm
        self.count = 0
        self.adamw = torch.optim.AdamW(
            [g for g in ({"params": groups[True], "weight_decay": weight_decay},
                         {"params": groups[False], "weight_decay": 0.0})
             if g["params"]],
            lr=float(self.schedule(0)), betas=(0.9, 0.999), eps=1e-8,
            fused=True)

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_norm is not None and self.clip_norm > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        lr = float(self.schedule(self.count))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        for p in self.params:
            torch.autograd.graph.increment_version(p)
        self.count += 1

    def state_dict(self):
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.adamw.load_state_dict(state["adamw"])
        self.count = state["count"]


def make_optimizer(model, learning_rate, weight_decay: float = 0.05,
                   clip_norm: Optional[float] = 1.0,
                   trainable: Optional[Dict[str, bool]] = None) -> TrainOptimizer:
    """AdamW with selective weight decay, clipping and freezing.

    learning_rate: a float or a function of the step count (0 first).
    trainable: name -> bool (``trainable_mask``); frozen parameters get
    requires_grad=False and exactly no update."""
    return TrainOptimizer(model, learning_rate, weight_decay, clip_norm,
                          trainable)
