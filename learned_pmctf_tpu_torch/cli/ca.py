"""Content-adaptive evaluation CLI for pMCTF-L: for each chunk of
--force_intra_period frames, a greedy search over GOP sizes {gop, gop/2,
..., 4} and motion-estimation downsampling factors {1, 2, 4, 8}, keeping
the (GOP, factor) with the least RD = sum(bpp) + lambda * sum(mse) and
stopping as soon as RD rises. The port of the JAX package's
test_pmctf_ca.py: the same flags (plus --device), the same search, the
same JSON (gop_choice, ds_choice, tested_opts a chunk). Runs on CUDA
unless --device cpu.

    python -m learned_pmctf_tpu_torch.cli.ca --synthetic 16 \\
        --synthetic_size 256x256 --force_intra_period 16 --device cpu

With --write_stream every trial is coded to rANS streams and decoded
again; each decoded plane must equal the encoder side bit for bit, or
the run stops with an error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..gop import gop_schedule
from ..utils.eval_json import create_folder, dump_json, generate_log_json, str2bool
from ..utils.metrics import psnr
from ..utils.stream import get_padding_size
from ..utils.yuv import YUVReader
from .flex import PSIZE, build_codec

# the 6-level SpyNet pyramid needs this many pixels after ME downsampling
ME_MIN_SIZE = 64


def parse_args(argv):
    p = argparse.ArgumentParser(description="pMCTF content-adaptive eval (PyTorch)")
    p.add_argument("--force_frame_num", type=int, default=-1)
    p.add_argument("--last_frames", action="store_true")
    p.add_argument("--force_intra_period", type=int, default=16)
    p.add_argument("--model_path", type=str, default=None,
                   help="a reference torch checkpoint, as cli/flex.py takes it")
    p.add_argument("--test_config", type=str, default=None)
    p.add_argument("--force_root_path", type=str, default=None)
    p.add_argument("--write_stream", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--stream_path", type=str, default="out_bin")
    p.add_argument("--output_path", type=str, default="output_ca.json")
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--seq_num", type=int, default=-1)
    p.add_argument("--ds_name", type=str, default=None)
    p.add_argument("--lossless", action="store_true")
    p.add_argument("--skip_decoding", action="store_true")
    p.add_argument("--num_me_stages", default=1, type=int)
    p.add_argument("--q_index", default=0, type=int)
    p.add_argument("--ll_mode", default="fourstep", choices=("fourstep", "ar"))
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--synthetic_size", type=str, default="256x256")
    p.add_argument("--features", type=int, default=112)
    p.add_argument("--ar_features", type=int, default=128)
    p.add_argument("--channel_mv", type=int, default=64)
    p.add_argument("--decomp_levels", type=int, default=4)
    p.add_argument("--warp_mode", default="exact", choices=("exact", "fast"))
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def get_cur_lamda(q_index: int, qp_num: int):
    """The search's RD lambda: log-interpolated over 1..27, times 0.003."""
    lam_min, lam_max = 1.0, 27.0
    step = (math.log(lam_max) - math.log(lam_min)) / (qp_num - 1)
    return math.exp(math.log(lam_min) + step * q_index) * 0.003


def psnr_to_mse(p):
    return (255.0 ** 2) / (10 ** (p / 10.0))


def _check_decoded(result, where: str):
    """The decoded planes of a pair against the encoder side: bit-equal."""
    side = result["encoder_side"]
    for key in ("H_t", "H_tc") + (("L_t", "L_tc") if result["bit_L"] is not None else ()):
        if not torch.equal(result[key], side[key]):
            err = float((result[key] - side[key]).abs().max())
            raise ValueError(f"{where}: decoded {key} differs from the encoder "
                             f"side by {err}")


@torch.no_grad()
def code_one_gop(codec, frames_orig, padded, pads, args, gop_size: int,
                 me_downsample: int, q_index: int, bin_folder=None):
    """Code one (sub-)GOP at one ME downsampling factor; per-frame logs."""
    pl, pr, pt, pb = pads
    sched = gop_schedule(gop_size)
    frames = list(padded)
    mvs = [None] * gop_size
    bits = [0.0] * gop_size
    bpp_mv = [0.0] * gop_size
    frame_types = [None] * gop_size
    enc_time = dec_time = 0.0
    p_frames = 0
    pixel_num = args["src_height"] * args["src_width"]
    me_stages = codec.model.num_me_stages

    cur_stage, dpb = -1, None
    for stage, fi, step, code_lt in sched:
        if stage != cur_stage:
            cur_stage, dpb = stage, {"mv_feature": None, "ref_mv_y": None}
        me_num = min(me_stages - 1, stage)
        if bin_folder is not None:
            result = codec.encode_one_stage(
                frames[fi], frames[fi + step], code_lt, dpb,
                output_path=os.path.join(bin_folder, f"{fi + step}.bin"),
                pic_width=args["src_width"], pic_height=args["src_height"],
                psize=PSIZE, skip_decoding=args.get("skip_decoding", False),
                stage_idx=me_num, q_index=q_index, me_downsample=me_downsample)
            if not args.get("skip_decoding", False):
                _check_decoded(result, f"gop {gop_size} ds {me_downsample} "
                                       f"pair {fi}-{fi + step}")
                args["decode_checks"] = args.get("decode_checks", 0) + 1
        else:
            result = codec.estimate_one_stage(
                frames[fi], frames[fi + step], code_lt, dpb, stage_idx=me_num,
                q_index=q_index, me_downsample=me_downsample)
        dpb = result["dpb"]
        frames[fi] = (result["L_t"], result["L_tc"])
        frames[fi + step] = (result["H_t"], result["H_tc"])
        mvs[fi + step] = result["mv_hat"]
        frame_types[fi + step] = 1
        p_frames += 1
        enc_time += result["encoding_time"]
        dec_time += result["decoding_time"]
        bits[fi + step] = float(result["bit_H"]) + float(result["bit_ME"])
        bpp_mv[fi + step] = float(result["bit_ME"]) / pixel_num
        if code_lt:
            frame_types[fi] = 0
            bits[fi] = float(result["bit_L"])

    for stage, fi, step, _ in reversed(sched):
        me_num = min(me_stages - 1, stage)
        (l_y, l_c), (h_y, h_c) = frames[fi], frames[fi + step]
        ry, cy = codec.inverse_mctf(l_y, h_y, mvs[fi + step], stage_idx=me_num)
        rc, cc = codec.inverse_mctf(l_c, h_c, mvs[fi + step], stage_idx=me_num,
                                    downscale=True)
        frames[fi], frames[fi + step] = (ry, rc), (cy, cc)

    psnrs, bpps = [], []
    for i in range(gop_size):
        y_rec, c_rec = frames[i]
        y_org, c_org = frames_orig[i]
        y_rec = torch.round(torch.clamp(y_rec, 0, 255))
        c_rec = torch.round(torch.clamp(c_rec, 0, 255))
        y_hat = y_rec[:, :, pt:y_rec.shape[2] - pb, pl:y_rec.shape[3] - pr]
        c_hat = c_rec[:, :, pt // 2:c_rec.shape[2] - pb // 2,
                      pl // 2:c_rec.shape[3] - pr // 2]
        vals = torch.stack([psnr(y_hat, y_org), psnr(c_hat[0:1], c_org[0:1]),
                            psnr(c_hat[1:2], c_org[1:2])]).cpu()
        y_psnr, cb_psnr, cr_psnr = (float(v) for v in vals)
        psnrs.append((6.0 * y_psnr + cb_psnr + cr_psnr) / 8.0)
        bpps.append(bits[i] / pixel_num)

    return {"psnrs": psnrs, "bpps": bpps, "bits": bits, "bpp_mv": bpp_mv,
            "frame_types": frame_types, "p_frame_number": p_frames,
            "overall_p_encoding_time": enc_time,
            "overall_p_decoding_time": dec_time}


@torch.no_grad()
def run_test(codec, args):
    """Code one sequence with the content-adaptive search; its log (the
    eval JSON's keys plus gop_choice, ds_choice and tested_opts)."""
    dev = codec.device
    frame_num_eval = args["frame_num"]
    gop_size = args["gop_size"]
    frame_num = frame_num_eval
    if frame_num_eval % gop_size:
        frame_num += gop_size - frame_num_eval % gop_size
    gop_num = frame_num // gop_size
    q_index = args["q_idx"]
    lam = get_cur_lamda(q_index, codec.model.get_qp_num())
    h, w = args["src_height"], args["src_width"]

    if args.get("synthetic", 0):
        rng = np.random.default_rng(0)

        def read_frame():
            return (rng.integers(0, 256, (h, w)).astype(np.uint8),
                    rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
                    rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
    else:
        start = (args["frame_num_seq"] - frame_num) if args.get("last_frames") else 0
        read_frame = YUVReader(args["vid_path"], w, h, start_index=start).read_one_frame

    pads = get_padding_size(h, w, p=PSIZE)
    pl, pr, pt, pb = pads
    test_gops = [gop_size]
    while test_gops[-1] // 2 >= 4:
        test_gops.append(test_gops[-1] // 2)
    ds_factors = [d for d in (1, 2, 4, 8)
                  if min(h + pt + pb, w + pl + pr) // d >= ME_MIN_SIZE]

    logs = {k: [0.0] * frame_num for k in ("psnrs", "bpps", "bits", "bpp_mv")}
    logs["frame_types"] = [None] * frame_num
    logs["gop_choice"], logs["ds_choice"], logs["tested_opts"] = [], [], []
    p_frames = 0
    enc_time = dec_time = 0.0

    start_time = time.time()
    for gop_idx in range(gop_num):
        frames_orig, padded = [], []
        for _ in range(gop_size):
            y, cb, cr = read_frame()
            y = torch.from_numpy(y.astype(np.float32)).to(dev)[None, None]
            chroma = torch.from_numpy(np.stack([cb, cr]).astype(np.float32)).to(dev)[:, None]
            frames_orig.append((y, chroma))
            padded.append((F.pad(y, (pl, pr, pt, pb)),
                           F.pad(chroma, (pl // 2, pr // 2, pt // 2, pb // 2))))

        # the greedy (GOP, factor) search with early exit
        all_res = {g: {} for g in test_gops}
        best_gop, best_ds, tested, stop = -1, None, 0, False
        for ds_idx, ds in enumerate(ds_factors):
            cur_gop_idx = 0
            for cur_gop_idx, g in enumerate(test_gops):
                if best_gop >= 0 and cur_gop_idx != best_gop:
                    continue
                tested += 1
                rd, merged = 0.0, None
                for sub in range(gop_size // g):
                    res = code_one_gop(codec, frames_orig[sub * g:(sub + 1) * g],
                                       padded[sub * g:(sub + 1) * g], pads, args,
                                       g, ds, q_index, bin_folder=args.get("bin_folder"))
                    rd += sum(res["bpps"]) + lam * sum(psnr_to_mse(p) for p in res["psnrs"])
                    if merged is None:
                        merged = {k: (list(v) if isinstance(v, list) else v)
                                  for k, v in res.items()}
                    else:
                        for k, v in res.items():
                            if isinstance(v, list):
                                merged[k].extend(v)
                            else:
                                merged[k] += v
                merged["rd"] = rd
                all_res[g][ds] = merged
                if (best_gop == -1 and cur_gop_idx > 0
                        and all_res[test_gops[cur_gop_idx - 1]][ds]["rd"] < rd):
                    best_gop = cur_gop_idx - 1
                    break
                if (best_gop >= 0 and ds_idx > 0
                        and all_res[test_gops[best_gop]][ds_factors[ds_idx - 1]]["rd"] < rd):
                    best_ds, stop = ds_factors[ds_idx - 1], True
                    break
            if best_gop == -1:
                best_gop = cur_gop_idx
            if stop:
                break
            if (ds_idx > 0
                    and all_res[test_gops[best_gop]][ds_factors[ds_idx - 1]]["rd"]
                    < all_res[test_gops[best_gop]][ds]["rd"]):
                best_ds = ds_factors[ds_idx - 1]
                break
        if best_ds is None:
            best_ds = max(all_res[test_gops[best_gop]])

        best = all_res[test_gops[best_gop]][best_ds]
        logs["gop_choice"].append(test_gops[best_gop])
        logs["ds_choice"].append(best_ds)
        logs["tested_opts"].append(tested)
        fi = gop_idx * gop_size
        for k in ("psnrs", "bpps", "bits", "bpp_mv", "frame_types"):
            logs[k][fi:fi + gop_size] = best[k]
        p_frames += best["p_frame_number"]
        enc_time += best["overall_p_encoding_time"]
        dec_time += best["overall_p_decoding_time"]
        if args.get("verbose", 0) >= 1:
            print(f"GOP {gop_idx}: best gop={test_gops[best_gop]} "
                  f"ds={best_ds} tested={tested}")

    test_time = time.time() - start_time
    if args.get("decode_checks"):
        print(f"decoded pairs bit-exact: {args['decode_checks']}")
    pad_n = frame_num - frame_num_eval
    for k in ("psnrs", "bpps", "bits", "bpp_mv", "frame_types"):
        logs[k] = logs[k][pad_n:]
    zero = [0.0] * len(logs["bits"])
    log = generate_log_json(
        frame_num_eval, logs["frame_types"], logs["bits"], logs["bpp_mv"],
        logs["psnrs"], zero, zero, h * w, test_time,
        gop_choice=logs["gop_choice"], ds_choice=logs["ds_choice"],
        tested_opts=logs["tested_opts"])
    if p_frames:
        log["avg_p_encoding_time_ms"] = enc_time / p_frames * 1000
        log["avg_p_decoding_time_ms"] = dec_time / p_frames * 1000
    return log


def main(argv):
    args = parse_args(argv)
    with build_codec(args) as codec:
        if args.synthetic:
            hw = args.synthetic_size.split("x")
            config = {"synthetic_ds": {"test": 1, "base_path": ".",
                                       "src_type": "yuv420", "sequences": {
                "synthetic": {"height": int(hw[0]), "width": int(hw[1]),
                              "frames": args.synthetic,
                              "gop": args.force_intra_period}}}}
            root_path = "."
        else:
            with open(args.test_config) as f:
                cfg = json.load(f)
            root_path = args.force_root_path or cfg["root_path"]
            config = cfg["test_classes"]
            if args.ds_name is not None:
                config = {args.ds_name: config[args.ds_name]}
                if args.seq_num >= 0:
                    k, v = list(config[args.ds_name]["sequences"].items())[args.seq_num]
                    config[args.ds_name]["sequences"] = {k: v}

        log_result = {}
        for ds_name, ds in config.items():
            if ds["test"] == 0:
                continue
            log_result[ds_name] = {}
            for seq_name, seq in ds["sequences"].items():
                cur = {
                    "q_idx": args.q_index,
                    "src_height": seq["height"],
                    "src_width": seq["width"],
                    "gop_size": args.force_intra_period,
                    "frame_num": args.force_frame_num
                    if args.force_frame_num > 0 else seq["frames"],
                    "frame_num_seq": seq["frames"],
                    "skip_decoding": args.skip_decoding,
                    "last_frames": args.last_frames,
                    "verbose": args.verbose,
                    "synthetic": args.synthetic,
                    "vid_path": os.path.join(root_path, ds["base_path"],
                                             seq_name + ".yuv"),
                }
                if args.write_stream:
                    bin_folder = os.path.join(args.stream_path, seq_name,
                                              f"q{args.q_index}_ca")
                    create_folder(bin_folder, True)
                    cur["bin_folder"] = bin_folder
                print(f"CA CODING {seq_name} q_index={args.q_index}")
                res = run_test(codec, cur)
                res["ds_name"] = ds_name
                res["video_path"] = seq_name
                log_result[ds_name][seq_name] = res

    out_dir = os.path.dirname(args.output_path)
    if out_dir:
        create_folder(out_dir, True)
    with open(args.output_path, "w") as fp:
        dump_json(log_result, fp, float_digits=6, indent=2)
    print(f"wrote {args.output_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
