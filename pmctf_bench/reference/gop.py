"""The plain reference of a GOP's estimate: hierarchical MCTF over 2**k
frames, as the port's ``gop.code_gop`` orders it (a frozen copy).

Stage by stage each pair codes its luma (motion estimated and coded, the
DPB threaded across the stage's pairs), then its chroma with the halved
luma MVs; the last stage also codes the temporal lowpass; then the
inverse ladder. Returns the decoded planes and each frame's rates.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .model import PMCTF, f32_math, halve_mv, interp_q_scale


def gop_schedule(gop: int):
    """Forward pairs in coding order: (stage, first frame, step, code_lt)."""
    stages = int(math.log2(gop))
    if 2 ** stages != gop or gop < 2:
        raise ValueError(f"GOP size must be a power of two >= 2, got {gop}")
    out, pairs = [], gop // 2
    for stage in range(stages):
        step = 2 ** stage
        out += [(stage, gi * 2 * step, step, stage == stages - 1) for gi in range(pairs)]
        pairs //= 2
    return out


@torch.no_grad()
def code_gop(model: PMCTF, luma: List[torch.Tensor], chroma: List[torch.Tensor],
             q_index: float) -> Dict:
    """{"bits": {frame: {"bit_H"/"bit_ME"/"bit_L": float}}, "luma", "chroma"},
    with TF32 off whatever the process had set (``f32_math``)."""
    with f32_math():
        return _code_gop(model, luma, chroma, q_index)


def _code_gop(model, luma, chroma, q_index) -> Dict:
    fl, fc = list(luma), list(chroma)
    sched = gop_schedule(len(fl))
    mvs, bits = [None] * len(fl), {}
    cur_stage, dpb = -1, None
    for stage, fi, step, code_lt in sched:
        if stage != cur_stage:
            cur_stage, dpb = stage, {"mv_feature": None, "ref_mv_y": None}
        me = min(model.num_me_stages - 1, stage)
        hp_scale = interp_q_scale(model.hp_q_scale[me], q_index)
        mv_hat, dpb, bit_me = model.code_motion(fl[fi], fl[fi + step], q_index, dpb, me)
        mv_c = halve_mv(mv_hat)
        l_y, h_y = model.forward_mctf(fl[fi], fl[fi + step], mv_hat, me)
        l_c, h_c = model.forward_mctf(fc[fi], fc[fi + step], mv_c, me)
        res_y = model.hp_coder(h_y, q_index, hp_scale)
        res_c = model.hp_coder(h_c, q_index, hp_scale)
        fl[fi + step], fc[fi + step] = res_y["x_hat"], res_c["x_hat"]
        bits[fi + step] = {"bit_H": res_y["bits"] + res_c["bits"], "bit_ME": bit_me}
        if code_lt:
            lo_y, lo_c = model.lp_coder(l_y, q_index), model.lp_coder(l_c, q_index)
            fl[fi], fc[fi] = lo_y["x_hat"], lo_c["x_hat"]
            bits[fi] = {"bit_L": lo_y["bits"] + lo_c["bits"]}
        else:
            fl[fi], fc[fi] = l_y, l_c
        mvs[fi + step] = mv_hat
    for stage, fi, step, _ in reversed(sched):
        me = min(model.num_me_stages - 1, stage)
        fl[fi], fl[fi + step] = model.inverse_mctf(fl[fi], fl[fi + step], mvs[fi + step], me)
        fc[fi], fc[fi + step] = model.inverse_mctf(fc[fi], fc[fi + step],
                                                   halve_mv(mvs[fi + step]), me)
    return {"bits": {fi: {k: float(v) for k, v in b.items()} for fi, b in sorted(bits.items())},
            "luma": fl, "chroma": fc}

