"""Training checkpoints: a directory holding the model's state dict, the
optimizer's, and the metadata a staged resume needs.

Counterpart of learned_pmctf_tpu/utils/checkpoint.py (orbax there): the
same signatures and ``meta`` keys (``epoch``, and the trainers' extras:
``stage_num`` and ``quant_stage``, or ``loss``), here as ``torch.save``
files:

    <path>/params.pt     model state_dict
    <path>/opt_state.pt  optimizer state_dict (if one was given)
    <path>/meta.json
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import torch


def save_checkpoint(path: str, model, optimizer=None, epoch: int = 0,
                    extra: Optional[Dict[str, Any]] = None):
    """Save `model`'s state dict (+ `optimizer`'s) and the metadata."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    state = model.state_dict() if hasattr(model, "state_dict") else model
    torch.save({k: v.detach().cpu() for k, v in state.items()},
               path / "params.pt")
    if optimizer is not None:
        torch.save(optimizer.state_dict(), path / "opt_state.pt")
    meta = {"epoch": epoch}
    if extra:
        meta.update(extra)
    (path / "meta.json").write_text(json.dumps(meta))


def load_checkpoint(path: str, model=None, optimizer=None):
    """Load a checkpoint saved by save_checkpoint; load its state into
    `model` (strict) and `optimizer` where given.

    Returns (params state dict, optimizer state dict or None, meta)."""
    path = Path(path).absolute()
    params = torch.load(path / "params.pt", map_location="cpu",
                        weights_only=True)
    if model is not None:
        model.load_state_dict(params, strict=True)
    opt_state = None
    if (path / "opt_state.pt").exists() and optimizer is not None:
        opt_state = torch.load(path / "opt_state.pt", map_location="cpu",
                               weights_only=True)
        optimizer.load_state_dict(opt_state)
    meta = {}
    if (path / "meta.json").exists():
        meta = json.loads((path / "meta.json").read_text())
    return params, opt_state, meta
