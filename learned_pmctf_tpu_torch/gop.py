"""The GOP coding ladder: the port's entry points.

Both follow the JAX package's GOP loop: hierarchical MCTF over a GOP of
2**k frames. Stage by stage, each frame pair codes its luma (motion
estimated and coded, DPB threaded across the stage's pairs), then its
chroma with the halved luma MVs; the last stage also codes the temporal
lowpass. Then the inverse ladder undoes the temporal transform stage by
stage.

- ``code_gop`` is the estimate path (bench.py:code_gop): rates are
  entropy estimates on the device, no bitstream.
- ``stream_gop`` is the real-bitstream path
  (benchmarks/bench_stream.py): every pair is encoded to rANS streams in
  a directory through ``PMCTFCodec`` and decoded from them again; the
  rates are the files' sizes.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence

import torch

from .codec.video_codec import PMCTFCodec
from .models.pmctf import PMCTF, empty_dpb
from .runtime import disable_tf32, resolve_device


def gop_schedule(gop: int):
    """Forward pairs in coding order: (stage, first frame, step, code_lt)."""
    num_stages = int(math.log2(gop))
    if 2 ** num_stages != gop or gop < 2:
        raise ValueError(f"GOP size must be a power of two >= 2, got {gop}")
    out = []
    pairs = gop // 2
    for stage in range(num_stages):
        step = 2 ** stage
        for gi in range(pairs):
            out.append((stage, gi * 2 * step, step, stage == num_stages - 1))
        pairs //= 2
    return out


@torch.no_grad()
def code_gop(model: PMCTF, luma: Sequence, chroma: Sequence, q_index,
             device="cuda") -> Dict:
    """Code one GOP and decode it again.

    luma: frames of shape (1,1,H,W); chroma: frames of shape (2,1,H/2,W/2)
    (U and V planes on the batch axis); 8-bit sample values as float.
    Returns {"bits": {frame: {"bit_H"/"bit_ME"/"bit_L": float}},
    "luma": [(1,1,H,W)], "chroma": [(2,1,H/2,W/2)]} with the decoded
    planes on `device`.
    """
    dev = resolve_device(device)
    disable_tf32()
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, code_gop asked for {dev}")
    if len(luma) != len(chroma):
        raise ValueError("luma and chroma GOPs differ in length")
    fl: List[torch.Tensor] = [torch.as_tensor(f, dtype=torch.float32,
                                              device=model_dev) for f in luma]
    fc: List[torch.Tensor] = [torch.as_tensor(f, dtype=torch.float32,
                                              device=model_dev) for f in chroma]
    sched = gop_schedule(len(fl))
    mvs = [None] * len(fl)
    bits: Dict[int, Dict[str, torch.Tensor]] = {}

    cur_stage, dpb = -1, None
    for stage, fi, step, code_lt in sched:
        if stage != cur_stage:
            cur_stage, dpb = stage, empty_dpb()
        me = model.me_index(stage)
        out = model.forward_one_stage(fl[fi], fl[fi + step], q_index, code_lt,
                                      dpb, stage_idx=me)
        outc = model.forward_one_stage(fc[fi], fc[fi + step], q_index, code_lt,
                                       empty_dpb(), mv_hat=out["mv_hat"],
                                       stage_idx=me)
        dpb = out["dpb"]
        fl[fi], fl[fi + step] = out["L_t"], out["H_t"]
        fc[fi], fc[fi + step] = outc["L_t"], outc["H_t"]
        mvs[fi + step] = out["mv_hat"]
        bits[fi + step] = {"bit_H": out["bit_H"] + outc["bit_H"],
                           "bit_ME": out["bit_ME"]}
        if code_lt:
            bits[fi] = {"bit_L": out["bit_L"] + outc["bit_L"]}

    for stage, fi, step, _ in reversed(sched):
        me = model.me_index(stage)
        fl[fi], fl[fi + step] = model.inverse_mctf(
            fl[fi], fl[fi + step], mvs[fi + step], stage_idx=me)
        fc[fi], fc[fi + step] = model.inverse_mctf(
            fc[fi], fc[fi + step], mvs[fi + step], stage_idx=me, downscale=True)

    return {"bits": {fi: {k: float(v) for k, v in b.items()}
                     for fi, b in sorted(bits.items())},
            "luma": fl, "chroma": fc}


@torch.no_grad()
def stream_gop(codec: PMCTFCodec, luma: Sequence, chroma: Sequence, q_index,
               out_dir: str, psize: int = 128, skip_decoding: bool = False,
               decode_async: bool = False, device="cuda") -> Dict:
    """Code one GOP to real bitstreams in `out_dir` and decode it again.

    luma and chroma as for ``code_gop``, with H and W multiples of
    `psize` (the padding the decoder assumes). Each pair is written as
    ``s{stage}_{pair}.bin`` (luma H band), ``..._C_main.bin`` (chroma H)
    and ``..._mv.bin`` (motion); the last stage's lowpass bands are
    ``0_main.bin`` and ``0_C_main.bin``. Unless skip_decoding, the
    returned planes come from the decoded streams; with decode_async the
    decodes overlap later pairs and are drained (strictly: a mismatch
    raises) before the inverse ladder.

    Returns {"bits": {frame: {"bit_H"/"bit_ME"/"bit_L": bits from the
    file sizes}}, "luma", "chroma" (decoded planes on the device),
    "max_err": {pair stream: the largest difference of any decoded band
    or mv_hat from the encoder side} (empty with skip_decoding)}.
    """
    dev = resolve_device(device)
    if codec.device.type != dev.type:
        raise ValueError(f"codec is on {codec.device}, stream_gop asked for {dev}")
    if len(luma) != len(chroma):
        raise ValueError("luma and chroma GOPs differ in length")
    fl: List[torch.Tensor] = [torch.as_tensor(f, dtype=torch.float32,
                                              device=codec.device) for f in luma]
    fc: List[torch.Tensor] = [torch.as_tensor(f, dtype=torch.float32,
                                              device=codec.device) for f in chroma]
    h, w = fl[0].shape[2], fl[0].shape[3]
    if h % psize or w % psize:
        raise ValueError(f"frames of {h}x{w} are not padded to {psize}")
    sched = gop_schedule(len(fl))
    mvs = [None] * len(fl)
    bits: Dict[int, Dict[str, float]] = {}
    max_err: Dict[str, float] = {}

    cur_stage, dpb, pair = -1, None, 0
    for stage, fi, step, code_lt in sched:
        if stage != cur_stage:
            cur_stage, dpb, pair = stage, empty_dpb(), 0
        path = os.path.join(out_dir, f"s{stage}_{pair}.bin")
        out = codec.encode_one_stage(
            (fl[fi], fc[fi]), (fl[fi + step], fc[fi + step]), code_lt, dpb,
            path, pic_width=w, pic_height=h, psize=psize,
            skip_decoding=skip_decoding, stage_idx=stage, q_index=q_index,
            decode_async=decode_async)
        if not (skip_decoding or decode_async):
            max_err[path] = _max_diff(codec, out, code_lt)
        dpb = out["dpb"]
        fl[fi], fl[fi + step] = out["L_t"], out["H_t"]
        fc[fi], fc[fi + step] = out["L_tc"], out["H_tc"]
        mvs[fi + step] = out["mv_hat"]
        bits[fi + step] = {"bit_H": out["bit_H"], "bit_ME": out["bit_ME"]}
        if code_lt:
            bits[fi] = {"bit_L": out["bit_L"]}
        pair += 1
    if decode_async:
        for d in codec.drain_decodes(check=True, strict=True):
            max_err[d["name"]] = d["max_err"]

    for stage, fi, step, _ in reversed(sched):
        fl[fi], fl[fi + step] = codec.inverse_mctf(
            fl[fi], fl[fi + step], mvs[fi + step], stage_idx=stage)
        fc[fi], fc[fi + step] = codec.inverse_mctf(
            fc[fi], fc[fi + step], mvs[fi + step], stage_idx=stage, downscale=True)
    return {"bits": dict(sorted(bits.items())), "luma": fl, "chroma": fc,
            "max_err": max_err}


def _max_diff(codec: PMCTFCodec, out: Dict, code_lt: bool) -> float:
    """Largest difference of a pair's decoded planes from the encoder side."""
    enc = out["encoder_side"]
    keys = ["H_t", "H_tc"] + (["L_t", "L_tc"] if code_lt else [])
    diffs = [(out[k] - enc[k]).abs().max() for k in keys]
    diffs.append((out["mv_hat"] - enc["mv_hat"]).abs().max())
    return float(codec.stats.to_host(torch.stack(diffs).max()))
