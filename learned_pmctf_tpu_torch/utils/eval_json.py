"""Evaluation JSON aggregation and helpers (json and numpy only).

Counterpart of learned_pmctf_tpu/utils/eval_json.py: the per-sequence
log of the eval CLI (i/p/b-frame averages) and its fixed-precision dump,
with the same keys and numbers.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"boolean value expected, got {v!r}")


def interpolate_log(min_val: float, max_val: float, num: int,
                    descending: bool = True):
    if not max_val > min_val > 0:
        raise ValueError(f"need max_val > min_val > 0, got {min_val}, {max_val}")
    lo, hi = np.log(min_val), np.log(max_val)
    vals = np.linspace(hi, lo, num) if descending else np.linspace(lo, hi, num)
    return np.exp(vals)


def create_folder(path: str, print_if_create: bool = False):
    if not os.path.exists(path):
        os.makedirs(path)
        if print_if_create:
            print(f"created folder: {path}")


class _FloatRound(json.JSONEncoder):
    def __init__(self, *args, float_digits: int = -1, **kwargs):
        super().__init__(*args, **kwargs)
        self.float_digits = float_digits

    def iterencode(self, o, _one_shot=False):
        if self.float_digits >= 0:
            o = _round_floats(o, self.float_digits)
        return super().iterencode(o, _one_shot)


def _round_floats(o, digits: int):
    if isinstance(o, float):
        return round(o, digits)
    if isinstance(o, dict):
        return {k: _round_floats(v, digits) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_round_floats(v, digits) for v in o]
    if isinstance(o, (np.floating,)):
        return round(float(o), digits)
    if isinstance(o, (np.integer,)):
        return int(o)
    return o


def dump_json(obj, fid, float_digits: int = -1, **kwargs):
    json.dump(_round_floats(obj, float_digits) if float_digits >= 0 else obj,
              fid, **kwargs)


def generate_log_json(frame_num: int, frame_types: Sequence[int],
                      bits: Sequence[float], bpp_mv: Sequence[float],
                      psnrs: Sequence[float], rgb_psnrs: Sequence[float],
                      ssims: Sequence[float], frame_pixel_num: int,
                      test_time: float, gop_choice=None, ds_choice=None,
                      tested_opts=None):
    """Aggregate per-frame metrics into i/p/b-frame averages."""
    acc = {t: {"bit": 0.0, "psnr": 0.0, "psnr_rgb": 0.0, "msssim": 0.0,
               "bpp_mv": 0.0, "n": 0} for t in (0, 1, 2)}
    for idx in range(frame_num):
        t = frame_types[idx] if frame_types[idx] in (0, 1) else 2
        acc[t]["bit"] += bits[idx]
        acc[t]["psnr"] += psnrs[idx]
        acc[t]["psnr_rgb"] += rgb_psnrs[idx]
        acc[t]["msssim"] += ssims[idx]
        acc[t]["bpp_mv"] += bpp_mv[idx] or 0.0
        acc[t]["n"] += 1

    log = {
        "frame_pixel_num": frame_pixel_num,
        "i_frame_num": acc[0]["n"],
        "p_frame_num": acc[1]["n"],
        "b_frame_num": acc[2]["n"],
        "frame_bpp": [b / frame_pixel_num for b in bits],
        "frame_bpp_mv": list(bpp_mv),
        "frame_psnr": list(psnrs),
        "frame_psnr_rgb": list(rgb_psnrs),
        "frame_msssim": list(ssims),
        "frame_type": list(frame_types),
        "test_time": test_time,
    }
    if gop_choice is not None and ds_choice is not None:
        log["gop_choice"] = gop_choice
        log["ds_choice"] = ds_choice
        log["tested_opts"] = tested_opts

    if acc[0]["n"]:
        n = acc[0]["n"]
        log["ave_i_frame_bpp"] = acc[0]["bit"] / n / frame_pixel_num
        log["ave_i_frame_psnr"] = acc[0]["psnr"] / n
        log["ave_i_frame_psnr_rgb"] = acc[0]["psnr_rgb"] / n
        log["ave_i_frame_msssim"] = acc[0]["msssim"] / n
    for t, name in ((1, "p"), (2, "b")):
        n = acc[t]["n"]
        if n:
            log[f"ave_{name}_frame_bpp"] = acc[t]["bit"] / (n * frame_pixel_num)
            log[f"ave_{name}_frame_psnr"] = acc[t]["psnr"] / n
            log[f"ave_{name}_frame_psnr_rgb"] = acc[t]["psnr_rgb"] / n
            log[f"ave_{name}_frame_msssim"] = acc[t]["msssim"] / n
            log[f"ave_{name}_frame_bpp_mv"] = acc[t]["bpp_mv"] / n
        elif t == 1:
            log["ave_p_frame_bpp"] = 0
            log["ave_p_frame_psnr"] = 0
            log["ave_p_frame_psnr_rgb"] = 0
            log["ave_p_frame_msssim"] = 0

    total_bit = sum(a["bit"] for a in acc.values())
    pb_n = acc[1]["n"] + acc[2]["n"]
    log["ave_all_frame_bpp"] = total_bit / (frame_num * frame_pixel_num)
    log["ave_all_frame_bpp_mv"] = (
        (acc[1]["bpp_mv"] + acc[2]["bpp_mv"]) / pb_n if pb_n else 0.0)
    log["ave_all_frame_psnr"] = sum(a["psnr"] for a in acc.values()) / frame_num
    log["ave_all_frame_psnr_rgb"] = sum(
        a["psnr_rgb"] for a in acc.values()) / frame_num
    log["ave_all_frame_msssim"] = sum(
        a["msssim"] for a in acc.values()) / frame_num
    if tested_opts is not None:
        log["ave_tested_opts"] = sum(tested_opts) / len(tested_opts)
    return log
