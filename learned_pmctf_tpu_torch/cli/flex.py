"""Fixed-GOP evaluation CLI for pMCTF-L: a q-index sweep with YUV-PSNR
(6-1-1), RGB-PSNR, MS-SSIM and bits per frame, written as the JAX
package's test_pmctf_flex.py writes them (the same file names and keys).

Per GOP: the forward MCTF ladder pair by pair, each pair entropy-estimated
(PMCTFCodec.estimate_one_stage) or, with --write_stream, encoded to rANS
streams and decoded again (PMCTFCodec.encode_one_stage); then the inverse
ladder and the frame metrics. With --q_batch (and more than one q index)
or --seq_batch the estimate path codes every rate point, and up to
--seq_batch sequences of one geometry, as one batch
(PMCTFCodec.estimate_one_stage_multi), reading each sequence once.
--lossless codes with the lossless model (PSNR then reads inf, as the
JAX CLI writes it). Runs on CUDA unless --device cpu. --shard_q (with
--q_batch) splits the batch's elements over ranks: each codes its
contiguous block of sequence x rate-point elements, and rank 0 gathers
their metrics and writes the JSON the unsharded --q_batch writes. Off
the batched path (--write_stream, or no q batch) the shard is unused, as
in the JAX CLI: rank 0 codes and says so.

    python -m learned_pmctf_tpu_torch.cli.flex --model_path ckpt.pth \\
        --test_config configs/dataset_config.json --force_intra_period 16 \\
        --force_frame_num 96 --q_index_num 6 --write_stream 1

    python -m learned_pmctf_tpu_torch.cli.flex --synthetic 4 \\
        --synthetic_size 256x256 --force_intra_period 4 --device cpu

    torchrun --nproc_per_node 2 -m learned_pmctf_tpu_torch.cli.flex \\
        --synthetic 4 --q_index_num 4 --q_batch --shard_q --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..codec.video_codec import PMCTFCodec
from ..convert import load_reference_state_dict
from ..gop import gop_schedule
from ..models.pmctf import build_pmctf, empty_dpb
from ..ops.color import ycbcr_to_rgb, yuv420_to_444
from ..parallel import mesh
from ..runtime import resolve_device
from ..utils.eval_json import create_folder, dump_json, generate_log_json, str2bool
from ..utils.metrics import ms_ssim, psnr
from ..utils.stream import get_padding_size
from ..utils.yuv import YUVReader, YUVWriter

TORCH_CKPT = (".pth", ".pt", ".pth.tar", ".ckpt")
PSIZE = 128  # frames are padded to multiples of this
Q_INDEX_NUM_TOTAL = 21

def parse_args(argv):
    p = argparse.ArgumentParser(description="pMCTF fixed-GOP evaluation (PyTorch)")
    p.add_argument("--force_intra", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--force_frame_num", type=int, default=-1)
    p.add_argument("--last_frames", action="store_true")
    p.add_argument("--force_intra_period", type=int, default=-1)
    p.add_argument("--model_path", type=str, default=None,
                   help="a reference torch checkpoint (.pth/.pt/.pth.tar/.ckpt; "
                        "forces --ll_mode ar) or a state dict the port saved. "
                        "An orbax directory of the JAX package is not read: the "
                        "port imports nothing of JAX. Without a checkpoint the "
                        "model is seeded (torch.Generator, seed 0) with QP and "
                        "QP_ll spread to [0.02, 0.5] as the JAX CLI does; JAX's "
                        "PRNG init cannot be reproduced without JAX, so its "
                        "numbers are not the JAX CLI's")
    p.add_argument("--test_config", type=str, default=None)
    p.add_argument("--force_root_path", type=str, default=None)
    p.add_argument("--write_stream", type=str2bool, nargs="?", const=True,
                   default=False)
    p.add_argument("--stream_path", type=str, default="out_bin")
    p.add_argument("--save_decoded_frame", type=str2bool, default=False)
    p.add_argument("--decoded_frame_path", type=str, default="decoded_frames")
    p.add_argument("--output_path", type=str, default="output.json")
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--seq_num", type=int, default=-1)
    p.add_argument("--ds_name", type=str, default=None)
    p.add_argument("--lossless", action="store_true")
    p.add_argument("--two_stage_me", action="store_true",
                   help="forces num_me_stages >= 2")
    p.add_argument("--skip_decoding", action="store_true")
    p.add_argument("--decode_async", type=str2bool, default=False,
                   help="overlap pair decodes on worker threads (checked "
                        "bit-exact after each GOP)")
    p.add_argument("--num_me_stages", default=1, type=int)
    p.add_argument("--q_index_num", default=1, type=int)
    p.add_argument("--q_index", default=-1, type=int)
    p.add_argument("--ll_mode", default="fourstep", choices=("fourstep", "ar"))
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N random frames instead of reading YUV")
    p.add_argument("--synthetic_size", type=str, default="256x256",
                   help="HxW for --synthetic")
    p.add_argument("--features", type=int, default=112)
    p.add_argument("--ar_features", type=int, default=128)
    p.add_argument("--channel_mv", type=int, default=64)
    p.add_argument("--decomp_levels", type=int, default=4)
    p.add_argument("--warp_mode", default="exact", choices=("exact", "fast"),
                   help="temporal-lifting warp: 'exact' = reference bilinear "
                        "semantics, 'fast' = the separable warp (throughput)")
    p.add_argument("--q_batch", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="code all q indexes as one batch (estimate path "
                        "only): the sequence is read and coded once")
    p.add_argument("--shard_q", type=str2bool, nargs="?", const=True,
                   default=False,
                   help="with --q_batch: split the batch's elements over "
                        "ranks (one a visible card, or those of a torchrun "
                        "launcher), each coding its own rate points; "
                        "unused (rank 0 codes) off the batched path")
    p.add_argument("--seq_batch", type=int, default=0,
                   help="estimate path only: code up to N sequences of one "
                        "geometry together in the q batch")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    if args.two_stage_me and args.num_me_stages < 2:
        args.num_me_stages = 2
    return args


def build_codec(args) -> PMCTFCodec:
    """The model (from a checkpoint, or seeded) and its codec, on
    args.device."""
    device = resolve_device(args.device)
    path = args.model_path
    is_torch_ckpt = bool(path) and path.endswith(TORCH_CKPT)
    if is_torch_ckpt and args.ll_mode != "ar":
        print("NOTE: reference torch checkpoints use the AR LL model; "
              "forcing --ll_mode ar for parity")
        args.ll_mode = "ar"
    model = build_pmctf(
        device, seed=0, decomp_levels=args.decomp_levels,
        lossy=not args.lossless, num_me_stages=args.num_me_stages,
        ll_mode=args.ll_mode, features=args.features,
        ar_features=args.ar_features, channel_mv=args.channel_mv,
        channel_n=args.channel_mv, warp_mode=args.warp_mode)
    if path and os.path.exists(path):
        if os.path.isdir(path):
            raise ValueError(f"{path} is a directory: an orbax checkpoint of "
                             "the JAX package, which the port does not read")
        load_reference_state_dict(path, model)
        print(f"loaded checkpoint: {path}")
    else:
        # spread the QP endpoints so that the rate sweep means something
        # for an untrained model, as the JAX CLI does
        with torch.no_grad():
            for coder in (model.lp_coder, model.hp_coder):
                for qp in (coder.QP, coder.QP_ll):
                    qp.copy_(torch.tensor([0.02, 0.5]).reshape(2, 1, 1, 1))
        print("WARNING: no checkpoint; using a seeded random model")
    codec = PMCTFCodec(model, device=device)
    if args.write_stream:
        codec.update(force=True)
    return codec


def frame_metrics(y_rec, c_rec, y_org, c_org, pads, do_msssim: bool):
    """[yuv-psnr (6-1-1), rgb-psnr, ms-ssim] of one frame: the padded
    reconstruction is clipped, rounded and cropped; MS-SSIM is 0 when
    do_msssim is false. One copy to the host."""
    pl, pr, pt, pb = pads
    y_rec = torch.round(torch.clamp(y_rec, 0, 255))
    c_rec = torch.round(torch.clamp(c_rec, 0, 255))
    y_hat = y_rec[:, :, pt:y_rec.shape[2] - pb, pl:y_rec.shape[3] - pr]
    c_hat = c_rec[:, :, pt // 2:c_rec.shape[2] - pb // 2,
                  pl // 2:c_rec.shape[3] - pr // 2]
    y_psnr = psnr(y_hat, y_org)
    cb_psnr = psnr(c_hat[0:1], c_org[0:1])
    cr_psnr = psnr(c_hat[1:2], c_org[1:2])
    rec_rgb = torch.round(ycbcr_to_rgb(yuv420_to_444(y_hat, c_hat[0:1], c_hat[1:2])))
    org_rgb = torch.round(ycbcr_to_rgb(yuv420_to_444(y_org, c_org[0:1], c_org[1:2])))
    ms = ms_ssim(rec_rgb, org_rgb) if do_msssim else torch.zeros_like(y_psnr)
    vals = torch.stack([(6.0 * y_psnr + cb_psnr + cr_psnr) / 8.0,
                        psnr(rec_rgb, org_rgb), ms])
    return [float(v) for v in vals.cpu()]


@torch.no_grad()
def run_test(codec: PMCTFCodec, args, logger=print):
    """Code one sequence at one q index (args: the per-sequence dict that
    main builds) and return its log (utils.eval_json.generate_log_json,
    plus the average encoding and decoding ms of a P frame pair)."""
    dev = codec.device
    frame_num_eval = args["frame_num"]
    gop_size = args["gop_size"]
    sched = gop_schedule(gop_size)
    frame_num = frame_num_eval
    if frame_num_eval % gop_size:
        frame_num += gop_size - frame_num_eval % gop_size
    gop_num = frame_num // gop_size
    write_stream = args.get("write_stream", False)
    skip_decoding = args.get("skip_decoding", False)
    decode_async = args.get("decode_async", False)
    q_index = args["q_idx"]
    height, width = args["src_height"], args["src_width"]

    if args.get("synthetic", 0):
        rng = np.random.default_rng(0)

        def read_frame():
            y = rng.integers(0, 256, (height, width)).astype(np.uint8)
            cb = rng.integers(0, 256, (height // 2, width // 2)).astype(np.uint8)
            cr = rng.integers(0, 256, (height // 2, width // 2)).astype(np.uint8)
            return y, cb, cr
    else:
        start_frame = (args["frame_num_seq"] - frame_num) \
            if args.get("last_frames") else 0
        reader = YUVReader(args["vid_path"], width, height, start_index=start_frame)
        read_frame = reader.read_one_frame

    frame_types = [None] * frame_num
    psnrs = [0.0] * frame_num
    msssims = [0.0] * frame_num
    rgb_psnrs = [0.0] * frame_num
    bits = [0.0] * frame_num
    bpp_mv = [0.0] * frame_num
    frame_pixel_num = height * width
    pads = get_padding_size(height, width, p=PSIZE)
    pl, pr, pt, pb = pads
    dec_writer = None
    if args.get("decoded_frame_folder"):
        dec_writer = YUVWriter(os.path.join(args["decoded_frame_folder"],
                                            "decoded.yuv"))
    start_time = time.time()
    p_frames = 0
    enc_time = dec_time = dec_wait_time = 0.0
    me_stages = codec.model.num_me_stages

    for gop_idx in range(gop_num):
        frames, frames_orig, mvs = [None] * gop_size, [None] * gop_size, [None] * gop_size
        for i in range(gop_size):
            y, cb, cr = read_frame()
            y = torch.from_numpy(y.astype(np.float32)).to(dev)[None, None]
            chroma = torch.from_numpy(np.stack([cb, cr]).astype(np.float32)).to(dev)[:, None]
            frames_orig[i] = (y, chroma)
            frames[i] = (F.pad(y, (pl, pr, pt, pb)),
                         F.pad(chroma, (pl // 2, pr // 2, pt // 2, pb // 2)))

        cur_stage, dpb = -1, None
        for stage, fi, step, code_lt in sched:
            if stage != cur_stage:
                cur_stage, dpb = stage, empty_dpb()
            me_num = min(me_stages - 1, stage)
            frame_idx = gop_idx * gop_size + fi
            if write_stream:
                result = codec.encode_one_stage(
                    frames[fi], frames[fi + step], code_lt, dpb,
                    output_path=os.path.join(args["bin_folder"], f"{fi + step}.bin"),
                    pic_width=width, pic_height=height, psize=PSIZE,
                    skip_decoding=skip_decoding, stage_idx=me_num,
                    q_index=q_index, decode_async=decode_async)
            else:
                result = codec.estimate_one_stage(
                    frames[fi], frames[fi + step], code_lt, dpb,
                    stage_idx=me_num, q_index=q_index)
            dpb = result["dpb"]
            frames[fi] = (result["L_t"], result["L_tc"])
            frames[fi + step] = (result["H_t"], result["H_tc"])
            mvs[fi + step] = result["mv_hat"]
            frame_types[frame_idx + step] = 1
            p_frames += 1
            enc_time += result["encoding_time"]
            dec_time += result["decoding_time"]
            bits[frame_idx + step] = float(result["bit_H"]) + float(result["bit_ME"])
            bpp_mv[frame_idx + step] = float(result["bit_ME"]) / frame_pixel_num
            if code_lt:
                frame_types[frame_idx] = 0
                bits[frame_idx] = float(result["bit_L"])
                bpp_mv[frame_idx] = 0.0

        if write_stream and not skip_decoding and decode_async:
            # drain_decodes raises if a decoded plane differs from the
            # encoder-side reconstruction the ladder went on with
            t0 = time.time()
            codec.drain_decodes()
            dec_wait_time += time.time() - t0

        for stage, fi, step, _ in reversed(sched):
            me_num = min(me_stages - 1, stage)
            (l_y, l_c), (h_y, h_c) = frames[fi], frames[fi + step]
            mv = mvs[fi + step]
            ry, cy = codec.inverse_mctf(l_y, h_y, mv, stage_idx=me_num)
            rc, cc = codec.inverse_mctf(l_c, h_c, mv, stage_idx=me_num,
                                        downscale=True)
            frames[fi], frames[fi + step] = (ry, rc), (cy, cc)

        for i in range(gop_size):
            frame_idx = gop_idx * gop_size + i
            y_rec, c_rec = frames[i]
            y_org, c_org = frames_orig[i]
            do_ms = y_org.shape[2] > 160 and y_org.shape[3] > 160
            psnrs[frame_idx], rgb_psnrs[frame_idx], msssims[frame_idx] = \
                frame_metrics(y_rec, c_rec, y_org, c_org, pads, do_ms)
            if args.get("verbose", 0) >= 2:
                logger(f"frame {frame_idx}: bpp "
                       f"{bits[frame_idx] / frame_pixel_num:.4f} "
                       f"yuv-psnr {psnrs[frame_idx]:.3f} "
                       f"rgb-psnr {rgb_psnrs[frame_idx]:.3f}")
            if dec_writer is not None:
                y_np = torch.clamp(torch.round(y_rec[0, 0]), 0, 255).to(torch.uint8)
                c_np = torch.clamp(torch.round(c_rec[:, 0]), 0, 255).to(torch.uint8)
                y_np = y_np[pt:y_np.shape[0] - pb, pl:y_np.shape[1] - pr].cpu().numpy()
                c_np = c_np[:, pt // 2:c_np.shape[1] - pb // 2,
                            pl // 2:c_np.shape[2] - pr // 2].cpu().numpy()
                dec_writer.write_one_frame(y_np, c_np[0], c_np[1])

    test_time = time.time() - start_time
    pad = frame_num - frame_num_eval
    if pad > 0:
        frame_types, bits, bpp_mv = frame_types[pad:], bits[pad:], bpp_mv[pad:]
        psnrs, rgb_psnrs, msssims = psnrs[pad:], rgb_psnrs[pad:], msssims[pad:]
    log = generate_log_json(frame_num_eval, frame_types, bits, bpp_mv,
                            psnrs, rgb_psnrs, msssims, frame_pixel_num,
                            test_time)
    if p_frames:
        log["avg_p_encoding_time_ms"] = enc_time / p_frames * 1000
        log["avg_p_decoding_time_ms"] = dec_time / p_frames * 1000
        if decode_async:
            # overlapped decodes: a pair's decoding_time is 0, and only
            # the wait for the drain is seen
            log["decode_overlapped"] = True
            log["avg_p_decode_wait_ms"] = dec_wait_time / p_frames * 1000
    return log


def shard_block(n: int, shard):
    """(first, end, ranks): the elements [first, end) of a batch of `n`
    that this rank codes, and the number of ranks coding: as JAX shards
    the batch axis, the largest rank count at or below the group's size
    that divides n; the ranks past it code nothing."""
    if shard is None:
        return 0, n, 1
    nd = shard.world
    while nd > 1 and n % nd:
        nd -= 1
    if shard.rank >= nd:
        return 0, 0, nd
    rows = mesh.data_rows(n, shard.rank, nd)
    return rows.start, rows.stop, nd


@torch.no_grad()
def run_test_qbatch(codec: PMCTFCodec, seq_args, q_list, logger=print, shard=None):
    """The estimate path for sequences x q indexes as one batch: element
    e = s * Q + qi codes sequence s at q_list[qi]. seq_args: the
    per-sequence dicts of run_test, of one geometry. Returns one
    {q_idx: log} a sequence, as run_test would give them one by one,
    reading and coding every sequence once.

    shard (a parallel.DataMesh of a group): this rank codes its block of
    the elements (shard_block) and rank 0 gathers every element's
    metrics; rank 0 returns the logs, the other ranks None. The gather of
    host floats is the only collective, so the group may be gloo on any
    device, and ranks may share a card."""
    dev = codec.device
    args = seq_args[0]
    n_seq, n_q = len(seq_args), len(q_list)
    n = n_seq * n_q
    for other in seq_args[1:]:
        if ((other["src_height"], other["src_width"], other["gop_size"],
             other["frame_num"]) != (args["src_height"], args["src_width"],
                                     args["gop_size"], args["frame_num"])):
            raise ValueError("seq_batch groups must share their geometry")
    first, end, nd = shard_block(n, shard)
    if shard is not None and shard.rank == 0:
        if nd > 1:
            logger(f"q_batch sharded: {n_seq} seqs x {n_q} rate points over {nd} ranks")
        else:
            logger(f"q_batch not sharded: {n} elements do not divide over more than "
                   f"one of {shard.world} ranks; rank 0 codes them as --q_batch")
    q_vec = [q for _ in range(n_seq) for q in q_list][first:end]
    frame_num_eval = args["frame_num"]
    gop_size = args["gop_size"]
    sched = gop_schedule(gop_size)
    frame_num = frame_num_eval
    if frame_num_eval % gop_size:
        frame_num += gop_size - frame_num_eval % gop_size
    gop_num = frame_num // gop_size
    height, width = args["src_height"], args["src_width"]

    readers = []
    for s, sa in enumerate(seq_args):
        if sa.get("synthetic", 0):
            rng = np.random.default_rng(s)

            def read_frame(rng=rng):
                return (rng.integers(0, 256, (height, width)).astype(np.uint8),
                        rng.integers(0, 256, (height // 2, width // 2)).astype(np.uint8),
                        rng.integers(0, 256, (height // 2, width // 2)).astype(np.uint8))
            readers.append(read_frame)
        else:
            start = (sa["frame_num_seq"] - frame_num) if sa.get("last_frames") else 0
            readers.append(YUVReader(sa["vid_path"], width, height,
                                     start_index=start).read_one_frame)

    frame_types = [None] * frame_num
    # this rank's elements' metrics, by element
    per_e = {e: {k: [0.0] * frame_num for k in ("psnrs", "rgb", "msssim", "bits", "bpp_mv")}
             for e in range(first, end)}
    frame_pixel_num = height * width
    pads = get_padding_size(height, width, p=PSIZE)
    pl, pr, pt, pb = pads
    me_stages = codec.model.num_me_stages
    start_time = time.time()
    for gop_idx in range(gop_num if end > first else 0):
        frames, frames_orig, mvs = [None] * gop_size, [None] * gop_size, [None] * gop_size
        for i in range(gop_size):
            ys, cbs, crs = zip(*(read() for read in readers))
            y = torch.from_numpy(np.stack(ys).astype(np.float32)).to(dev)[:, None, None]
            chroma = torch.from_numpy(np.stack([np.stack(cbs), np.stack(crs)], 1)
                                      .astype(np.float32)).to(dev)[:, :, None]
            frames_orig[i] = (y, chroma)   # (S, 1, 1, H, W), (S, 2, 1, h, w)
            # each sequence repeated once a rate point; this rank's block
            frames[i] = (F.pad(y, (pl, pr, pt, pb)).repeat_interleave(n_q, 0)[first:end],
                         F.pad(chroma, (pl // 2, pr // 2, pt // 2, pb // 2))
                         .repeat_interleave(n_q, 0)[first:end])

        cur_stage, dpb = -1, None
        for stage, fi, step, code_lt in sched:
            if stage != cur_stage:
                cur_stage, dpb = stage, empty_dpb()
            frame_idx = gop_idx * gop_size + fi
            result = codec.estimate_one_stage_multi(
                frames[fi], frames[fi + step], code_lt, dpb, q_vec,
                stage_idx=min(me_stages - 1, stage))
            dpb = result["dpb"]
            frames[fi] = (result["L_t"], result["L_tc"])
            frames[fi + step] = (result["H_t"], result["H_tc"])
            mvs[fi + step] = result["mv_hat"]
            frame_types[frame_idx + step] = 1
            for e, st in per_e.items():
                st["bits"][frame_idx + step] = (float(result["bit_H"][e - first])
                                                + float(result["bit_ME"][e - first]))
                st["bpp_mv"][frame_idx + step] = (float(result["bit_ME"][e - first])
                                                  / frame_pixel_num)
                if code_lt:
                    st["bits"][frame_idx] = float(result["bit_L"][e - first])
            if code_lt:
                frame_types[frame_idx] = 0

        for stage, fi, step, _ in reversed(sched):
            me_num = min(me_stages - 1, stage)
            (l_y, l_c), (h_y, h_c) = frames[fi], frames[fi + step]
            mv = mvs[fi + step]
            ry, cy = codec.inverse_mctf_multi(l_y, h_y, mv, stage_idx=me_num)
            rc, cc = codec.inverse_mctf_multi(l_c, h_c, mv, stage_idx=me_num,
                                              downscale=True)
            frames[fi], frames[fi + step] = (ry, rc), (cy, cc)

        for i in range(gop_size):
            frame_idx = gop_idx * gop_size + i
            y_org, c_org = frames_orig[i]
            do_ms = y_org.shape[3] > 160 and y_org.shape[4] > 160
            for e, st in per_e.items():
                st["psnrs"][frame_idx], st["rgb"][frame_idx], st["msssim"][frame_idx] = \
                    frame_metrics(frames[i][0][e - first], frames[i][1][e - first],
                                  y_org[e // n_q], c_org[e // n_q], pads, do_ms)

    if shard is not None and shard.world > 1:
        gathered = mesh.gather_to_rank0(per_e)
        if gathered is None:
            return None
        per_e = {e: st for part in gathered for e, st in part.items()}
    test_time = time.time() - start_time
    pad = frame_num - frame_num_eval
    ft = frame_types[pad:] if pad > 0 else frame_types
    logs = []
    for s in range(n_seq):
        logs.append({})
        for qi, q in enumerate(q_list):
            st = {k: v[pad:] for k, v in per_e[s * n_q + qi].items()}
            logs[s][q] = generate_log_json(
                frame_num_eval, ft, st["bits"], st["bpp_mv"], st["psnrs"],
                st["rgb"], st["msssim"], frame_pixel_num, test_time / n)
    return logs


def q_indexes(args):
    if args.q_index >= 0:
        return [args.q_index]
    n = args.q_index_num
    q_max = Q_INDEX_NUM_TOTAL - 1
    step = int(q_max / n) + 1
    if (n - 1) * step > q_max:
        step -= 1
    q_list = [x * step for x in range(n)]
    q_list[-1] = q_max
    return q_list


def main(argv):
    args = parse_args(argv)
    if not args.shard_q:
        return run(args)
    if mesh.launched_by_torchrun():
        mesh.init_process_group(args.device, backend="gloo")
        try:
            return shard_rank(args)
        finally:
            torch.distributed.destroy_process_group()
    ranks = torch.cuda.device_count() if args.device.startswith("cuda") else 1
    if ranks > 1:
        # the gather of host floats is the one collective: gloo
        mesh.spawn(shard_rank, ranks, (args,), device=args.device, backend="gloo")
        return None
    return run(args, mesh.DataMesh(0, 1, torch.device(args.device)))


def shard_rank(args):
    """One rank of --shard_q in a joined group, on its card (ranks beyond
    the cards share them) or the CPU."""
    shard = mesh.make_mesh(device=args.device, share=True)
    args.device = str(shard.device)
    return run(args, shard)


def run(args, shard=None):
    """The sweep of q indexes over the configured sequences; with `shard`
    (--shard_q) rank 0 alone prints and writes."""
    begin = time.time()
    lead = shard is None or shard.rank == 0
    say = print if lead else (lambda *a, **k: None)
    q_list = q_indexes(args)
    say(f"Testing q_index list: {q_list}")

    with build_codec(args) as codec:
        if args.synthetic:
            hw = args.synthetic_size.split("x")
            seqs = {"synthetic": {
                "height": int(hw[0]), "width": int(hw[1]),
                "frames": args.synthetic, "gop": args.force_intra_period
                if args.force_intra_period > 0 else 4}}
            config = {"synthetic_ds": {"test": 1, "base_path": ".",
                                       "src_type": "yuv420", "sequences": seqs}}
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

        use_qbatch = not args.write_stream and (
            (args.q_batch and len(q_list) > 1) or args.seq_batch > 0)
        if shard is not None and not use_qbatch:
            why = ("--write_stream codes one rate point at a time" if args.write_stream
                   else "no q batch (--q_batch with more than one q index, or --seq_batch)")
            say(f"shard_q unused: {why}; rank 0 codes as without --shard_q")
        qbatch_cache = {}

        def geom(seq):
            return (seq["height"], seq["width"],
                    args.force_intra_period if args.force_intra_period > 0
                    else seq["gop"],
                    args.force_frame_num if args.force_frame_num > 0
                    else seq["frames"])

        res_summary = {"bpp": [], "psnr-rgb": [], "psnr-yuv": [], "quality": [],
                       "ms-ssim-rgb": [], "bpp_mv": []}
        for q_idx in q_list:
            log_result = {}
            for ds_name, ds in config.items():
                if ds["test"] == 0:
                    continue
                log_result[ds_name] = {}
                for seq_name, seq in ds["sequences"].items():
                    cur = {
                        "q_idx": q_idx,
                        "src_height": seq["height"],
                        "src_width": seq["width"],
                        "gop_size": args.force_intra_period
                        if args.force_intra_period > 0 else seq["gop"],
                        "frame_num": args.force_frame_num
                        if args.force_frame_num > 0 else seq["frames"],
                        "frame_num_seq": seq["frames"],
                        "write_stream": args.write_stream,
                        "skip_decoding": args.skip_decoding,
                        "decode_async": args.decode_async,
                        "last_frames": args.last_frames,
                        "verbose": args.verbose,
                        "synthetic": args.synthetic,
                        "vid_path": os.path.join(root_path, ds["base_path"],
                                                 seq_name + ".yuv"),
                    }
                    if args.write_stream and lead:
                        bin_folder = os.path.join(args.stream_path, seq_name,
                                                  f"q{q_idx}")
                        create_folder(bin_folder, True)
                        cur["bin_folder"] = bin_folder
                    if args.save_decoded_frame and lead:
                        dec_folder = os.path.join(args.decoded_frame_path,
                                                  seq_name, f"q{q_idx}")
                        create_folder(dec_folder, True)
                        cur["decoded_frame_folder"] = dec_folder
                    say(f"CODING {seq_name} q_index={q_idx}")
                    if use_qbatch:
                        key = (ds_name, seq_name)
                        if key not in qbatch_cache:
                            members = [(seq_name, seq)]
                            for nm, sq in ds["sequences"].items():
                                if (len(members) < args.seq_batch and nm != seq_name
                                        and (ds_name, nm) not in qbatch_cache
                                        and geom(sq) == geom(seq)):
                                    members.append((nm, sq))
                            if len(members) > 1:
                                say(f"seq_batch: coding {len(members)} sequences "
                                      f"together: {[m[0] for m in members]}")
                            curs = [dict(cur, vid_path=os.path.join(
                                root_path, ds["base_path"], nm + ".yuv"),
                                frame_num_seq=sq["frames"]) for nm, sq in members]
                            logs = run_test_qbatch(codec, curs, q_list, say, shard)
                            for i, (nm, _) in enumerate(members):
                                qbatch_cache[(ds_name, nm)] = logs and logs[i]
                        if not lead:
                            continue
                        res = qbatch_cache[key][q_idx]
                    elif not lead:  # nothing batched to share out
                        continue
                    else:
                        res = run_test(codec, cur)
                    res["ds_name"] = ds_name
                    res["video_path"] = seq_name
                    log_result[ds_name][seq_name] = res
                if not lead:
                    continue

                ave = {k: [] for k in (
                    "test_time", "ave_p_frame_bpp", "ave_p_frame_psnr",
                    "ave_p_frame_psnr_rgb", "ave_p_frame_msssim",
                    "ave_all_frame_bpp", "ave_all_frame_bpp_mv",
                    "ave_all_frame_psnr", "ave_all_frame_psnr_rgb",
                    "ave_all_frame_msssim")}
                for seq_name in ds["sequences"]:
                    for k in ave:
                        ave[k].append(log_result[ds_name][seq_name].get(k, 0.0))
                log_result[ds_name]["AVERAGE"] = {
                    k: float(np.mean(v)) for k, v in ave.items()}
                avg = log_result[ds_name]["AVERAGE"]
                res_summary["bpp"].append(avg["ave_all_frame_bpp"])
                res_summary["bpp_mv"].append(avg["ave_all_frame_bpp_mv"])
                res_summary["psnr-rgb"].append(avg["ave_all_frame_psnr_rgb"])
                res_summary["psnr-yuv"].append(avg["ave_all_frame_psnr"])
                res_summary["ms-ssim-rgb"].append(avg["ave_all_frame_msssim"])
                res_summary["quality"].append(str(q_idx))

            if not lead:
                continue
            out_path = args.output_path.replace(".json", f"_qidx{q_idx}.json")
            out_dir = os.path.dirname(out_path)
            if out_dir:
                create_folder(out_dir, True)
            with open(out_path, "w") as fp:
                dump_json(log_result, fp, float_digits=6, indent=2)
            print(f"wrote {out_path}")

    if lead:
        with open(args.output_path.replace(".json", "_summary.json"), "w") as fp:
            dump_json(res_summary, fp, float_digits=6, indent=2)
    say(f"Total elapsed time: {(time.time() - begin) / 60:.1f} min")


if __name__ == "__main__":
    main(sys.argv[1:])
