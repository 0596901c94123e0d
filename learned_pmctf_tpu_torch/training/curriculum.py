"""Staged MCTF training curriculum.

Counterpart of learned_pmctf_tpu/training/curriculum.py: the JSON
config, the trainable-part predicates (over the port's names, which are
the reference model's state_dict keys), ME-stage cloning and the I-frame
transplant, both in place on a PMCTF.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List

import torch


@dataclass
class CurriculumConfig:
    total_epochs: int = 29
    train_lambda: List[float] = field(default_factory=lambda: [1, 27])
    num_stages: int = 10
    lr: List[float] = field(default_factory=list)
    parts: List[str] = field(default_factory=list)
    num_frames: List[int] = field(default_factory=list)
    frame_interval: List[int] = field(default_factory=list)
    num_epochs: List[int] = field(default_factory=list)

    @staticmethod
    def from_json(path: str) -> "CurriculumConfig":
        with open(path) as f:
            cfg = json.load(f)
        return CurriculumConfig(
            total_epochs=cfg.get("total_epochs", 29),
            train_lambda=cfg.get("train_lambda", [1, 27]),
            num_stages=cfg.get("num_stages", 10),
            lr=cfg.get("lr", []),
            parts=cfg.get("parts", []),
            num_frames=cfg.get("num_frames", []),
            frame_interval=cfg.get("frame_interval", []),
            num_epochs=cfg.get("num_epochs", []),
        )


def inter_predicate(name: str) -> bool:
    """Motion side only: the MV coder, its scales and the temporal filters."""
    return name.startswith(("temporal_filtering", "mv"))


def mctf_predicate(name: str) -> bool:
    return name.startswith(("mv_", "temporal_filtering", "mv"))


def all_predicate(name: str) -> bool:
    """Everything except the pretrained optical flow."""
    return not name.startswith("optic_flow")


PART_PREDICATES = {
    "Inter": inter_predicate,
    "MCTF": mctf_predicate,
    "All": all_predicate,
}

# the per-ME-stage ModuleLists and ParameterLists a clone copies
_CLONE_LISTS = (
    "mv_encoder", "mv_decoder", "mv_hyper_prior_encoder",
    "mv_hyper_prior_decoder", "mv_y_prior_fusion_adaptor_0",
    "mv_y_prior_fusion_adaptor_1", "mv_y_prior_fusion", "mv_y_spatial_prior",
    "mv_bit_est", "temporal_filtering", "mv_y_spatial_prior_adaptor_1",
    "mv_y_spatial_prior_adaptor_2", "mv_y_spatial_prior_adaptor_3",
    "mv_y_q_scale_enc", "mv_y_q_scale_dec",
)


@torch.no_grad()
def clone_me_stage(model, start_idx: int, copy_idx: int, num_me_stages: int):
    """Initialize ME stages [start_idx, num_me_stages) of `model` from
    stage copy_idx, in place (the highpass scales hp_q_scale stay).
    Returns `model`."""
    for i in range(start_idx, num_me_stages):
        for name in _CLONE_LISTS:
            stages = getattr(model, name)
            src, dst = stages[copy_idx], stages[i]
            if isinstance(src, torch.Tensor):
                dst.copy_(src)
            else:
                src_state = src.state_dict(keep_vars=True)
                for key, t in dst.state_dict(keep_vars=True).items():
                    t.copy_(src_state[key])
    return model


@torch.no_grad()
def load_from_iframe(model, iframe_state):
    """Transplant a trained pWave (its state dict) into both the lowpass
    and the highpass coder of `model`, in place. Returns `model`."""
    model.lp_coder.load_state_dict(iframe_state, strict=True)
    model.hp_coder.load_state_dict(iframe_state, strict=True)
    return model
