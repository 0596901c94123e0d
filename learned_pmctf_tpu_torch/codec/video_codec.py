"""Host bitstream codec for the pMCTF-L video coder.

Counterpart of learned_pmctf_tpu/codec/video_codec.py:PMCTFCodec: MV
coding (a factorized hyper-latent plus the quad four-part prior) and the
temporal L/H bands of each stage through two PWaveCodec instances.
Encode replays the decoder's own module calls with teacher-forced
symbols (bit-exact by construction, one copy to the host before the
host's rANS); decode alternates the parameter nets on the device with 4
rANS round trips a pass set.

Streams go port to port on devices of one kind (see image_codec.py).
"""

from __future__ import annotations

import copy
import os
import os.path as osp
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..entropy.coder import (FactorizedCoder, GaussianEncoder,
                             build_bit_estimator_tables,
                             build_indexes_from_scales)
from ..models.layers import f32_streams
from ..models.mv_coder import (MASK_SCHEDULE, four_part_prior_decode_scales,
                               four_part_prior_scatter)
from ..models.pmctf import PMCTF, empty_dpb
from ..ops.masks import checkerboard_masks
from ..ops.resample import bilinear_downsample
from ..runtime import resolve_device
from ..utils.stream import decode_p, encode_p, get_downsampled_shape
from .image_codec import HostStats, PWaveCodec, bulk_fetch_int32


# threads that decode independent units (MV, luma, chroma; across pairs
# with decode_async) while other units wait on the host's rANS
DECODE_WORKERS = 4


def _lt_name(file_name: str, ischroma: bool) -> str:
    """The stream of a stage's temporal lowpass band, beside `file_name`."""
    return osp.join(osp.dirname(file_name),
                    "0_C_main.bin" if ischroma else "0_main.bin")


class PMCTFCodec:
    """Real bitstream encode/decode of a PMCTF model, on CUDA unless the
    caller passes device="cpu" (with the model there).

    Construction (through its two PWaveCodecs) turns TF32 off and makes
    cuDNN deterministic (algorithm by shape, no benchmark) for the
    process: encoder and decoder must run bit-identical convs. Use as a
    context manager, or call ``close``."""

    def __init__(self, model: PMCTF, device="cuda"):
        dev = resolve_device(device)
        if next(model.parameters()).device.type != dev.type:
            raise ValueError(f"model is on {next(model.parameters()).device}, "
                             f"the codec asked for {dev}")
        self.model = model
        self.coder = PWaveCodec.make_coder()
        # one set of Laplace tables, read-only, for the MV streams and both
        # band codecs
        self.em = GaussianEncoder()
        self.em.update()
        self.stats = HostStats()
        self._mv_coders = {}
        self._decode_pool = None
        self._encode_pool = None
        self._pending_decodes = []
        self.hp_codec = PWaveCodec(model.hp_coder, self.stats, self.em, device)
        self.lp_codec = PWaveCodec(model.lp_coder, self.stats, self.em, device)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _pool(self):
        if self._decode_pool is None:
            self._decode_pool = ThreadPoolExecutor(
                max_workers=DECODE_WORKERS, thread_name_prefix="pmctf-dec")
        return self._decode_pool

    def _enc_pool(self):
        # its own pool: encode_one_stage waits on its two compresses, which
        # must not queue behind deferred pair decodes
        if self._encode_pool is None:
            self._encode_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="pmctf-enc")
        return self._encode_pool

    @f32_streams
    def update(self, force: bool = False):
        """Build every CDF table, on the host: the Laplace tables (shared
        with both band codecs) and, per ME stage, the MV hyper-latent's
        factorized tables (its bit estimator evaluated on a CPU copy)."""
        self.em.update(force=force)
        for stage in range(self.model.num_me_stages):
            if force or stage not in self._mv_coders:
                est = copy.deepcopy(self.model.mv_bit_est[stage]).cpu()

                def cdf_fn(x, est=est):
                    with torch.no_grad():
                        return est.get_cdf(torch.from_numpy(x)).numpy()
                channels = self.model.channel_mv
                tables = build_bit_estimator_tables(cdf_fn, channels)
                self._mv_coders[stage] = FactorizedCoder(*tables, channels)

    # ---- motion streams ----------------------------------------------------

    def _mv_code(self, stage: int, mv_params, q_index, me_downsample: int,
                 teacher_y=None, coder=None):
        """Code the MV latent through the quad four-part prior.

        teacher_y=None decodes (4 rANS calls); otherwise the same calls
        replay with teacher symbols, the dense per-pass planes of the
        estimate path's masked quantization (each spatial phase carries
        exactly one channel quarter under MASK_SCHEDULE), and the 4
        (symbols, indexes) device pairs come back as the plan."""
        model = self.model
        h, w = mv_params.shape[2], mv_params.shape[3]
        masks = checkerboard_masks(h, w, torch.float32, mv_params.device)
        coder = coder or self.coder

        def vals_fn(qd, mq, k):
            ys = (teacher_y * (1.0 / qd)).chunk(4, dim=1)
            out = 0.0
            for i in range(4):
                m = masks[MASK_SCHEDULE[k][i]]
                out = out + torch.round((ys[i] - mq[i] * m) * m)
            return out

        q_dec, scales_q, means_q = model.mv_decode_split(mv_params)
        plan = None if teacher_y is None else []
        y_hat = None
        for step in range(4):
            idx = build_indexes_from_scales(
                four_part_prior_decode_scales(scales_q, masks, step))
            if teacher_y is None:
                idx_host = self.stats.to_host(idx)
                t0 = time.perf_counter()
                vals = coder.decode_stream(idx_host, *self.em.tables())
                self.stats.add_rans("decode", time.perf_counter() - t0)
                vals = torch.from_numpy(vals.reshape(idx_host.shape)).to(
                    mv_params.device, torch.float32)
            else:
                vals = vals_fn(q_dec, means_q, step)
                plan.append((vals, idx))
            y_hat_curr = four_part_prior_scatter(vals, means_q, masks, step)
            y_hat = y_hat_curr if y_hat is None else y_hat + y_hat_curr
            if step < 3:
                scales_q, means_q = model.mv_decode_spatial(
                    y_hat, mv_params, stage, step)

        mv_y_hat = y_hat * q_dec
        mv_hat, mv_feature = model.mv_decode_tail(mv_y_hat, stage, q_index,
                                                  me_downsample)
        return {"mv_hat": mv_hat, "mv_feature": mv_feature,
                "mv_y_hat": mv_y_hat, "plan": plan}

    @torch.no_grad()
    @f32_streams
    def compress_mv(self, ref_y, cur_y, dpb, stage_idx: int = 0, q_index=0,
                    me_downsample: int = 1, coder=None):
        """Encode the motion of one luma pair; the stream is one factorized
        call for z, then one call a pass."""
        stage = self.model.me_index(stage_idx)
        mv_y, mv_z_hat = self.model.mv_latent_planes(
            ref_y, cur_y, dpb, stage, q_index, me_downsample)
        mv_params = self.model.mv_prior_params(mv_z_hat, dpb, stage)
        out = self._mv_code(stage, mv_params, q_index, me_downsample,
                            teacher_y=mv_y)
        plan = out.pop("plan")
        fetched = bulk_fetch_int32([mv_z_hat] + [t for pair in plan for t in pair],
                                   self.stats)
        coder = coder or self.coder
        t0 = time.perf_counter()
        coder.reset()
        self._mv_coders[stage].encode(coder, fetched[0])
        it = iter(fetched[1:])
        for _ in plan:
            vals, idx = next(it), next(it)
            coder.encode_with_indexes(vals, idx, *self.em.tables())
        coder.flush()
        out["bit_stream"] = coder.get_encoded_stream()
        self.stats.add_rans("encode", time.perf_counter() - t0)
        return out

    @torch.no_grad()
    @f32_streams
    def decompress_mv(self, stream: bytes, height: int, width: int, dpb,
                      stage_idx: int = 0, q_index=0, me_downsample: int = 1,
                      coder=None):
        stage = self.model.me_index(stage_idx)
        coder = coder or self.coder
        coder.set_stream(stream)
        # the hyper-latent of the plane motion was estimated on: with
        # me_downsample, the downsampled one
        zh, zw = get_downsampled_shape(int(height) // me_downsample,
                                       int(width) // me_downsample, 64)
        t0 = time.perf_counter()
        z = self._mv_coders[stage].decode_stream(coder, (zh, zw))
        self.stats.add_rans("decode", time.perf_counter() - t0)
        mv_z_hat = torch.from_numpy(z).to(self.device)
        mv_params = self.model.mv_prior_params(mv_z_hat, dpb, stage)
        out = self._mv_code(stage, mv_params, q_index, me_downsample, coder=coder)
        out.pop("plan")
        return out

    # ---- one temporal stage -------------------------------------------------

    def _forward_mctf(self, ref, cur, mv_hat, stage_idx, halve_mv: bool):
        if halve_mv:
            mv_hat = bilinear_downsample(mv_hat) / 2.0
        return self.model.forward_mctf(ref, cur, mv_hat, stage_idx)

    @torch.no_grad()
    @f32_streams
    def compress_one_stage(self, ref_frame, cur_frame, code_lt: bool, mv_hat,
                           ischroma: bool, sideinfo=None, file_name=None,
                           stage_idx: int = 0, q_index=0,
                           own_coders: bool = False):
        """Temporal lifting of one pair and its H (and, with code_lt, L)
        band streams. own_coders=True gives each stream a fresh
        EntropyCoder, so that luma and chroma compress on two threads."""
        l_t, h_t, _, _ = self._forward_mctf(ref_frame, cur_frame, mv_hat,
                                            stage_idx, halve_mv=ischroma)
        # the stage's highpass q scale stays on the device (no copy to the
        # host): encoder and decoder compute it alike
        h_t_hat, _ = self.hp_codec.compress(
            h_t, q_index, qp_scale=self.model.hp_qp_scale(q_index, stage_idx),
            file_name=file_name, sideinfo=sideinfo,
            coder=self.hp_codec.make_coder() if own_coders else None)
        l_t_hat = None
        if code_lt:
            l_t_hat, _ = self.lp_codec.compress(
                l_t, q_index, file_name=_lt_name(file_name, ischroma),
                sideinfo=sideinfo,
                coder=self.lp_codec.make_coder() if own_coders else None)
        return {"L_t": l_t, "H_t": h_t, "H_t_hat": h_t_hat, "L_t_hat": l_t_hat}

    @torch.no_grad()
    @f32_streams
    def decompress_one_stage(self, file_name: str, code_lt: bool,
                             ischroma: bool, psize: int = 128, q_index=0,
                             stage_idx: int = 0, own_coders: bool = False):
        """Decode one pair's H (and L) band streams; own_coders=True lets
        the call run on a worker thread."""
        pad = psize // 2 if ischroma else psize
        h_t = self.hp_codec.decompress(
            file_name, padding=pad, q_index=q_index,
            qp_scale=self.model.hp_qp_scale(q_index, stage_idx),
            coder=self.hp_codec.make_coder() if own_coders else None)
        l_t = None
        if code_lt:
            l_t = self.lp_codec.decompress(
                _lt_name(file_name, ischroma), padding=pad, q_index=q_index,
                coder=self.lp_codec.make_coder() if own_coders else None)
        return {"L_t": l_t, "H_t": h_t}

    def _submit_pair_decode(self, mv_out, output_path, file_name_c, code_lt,
                            dpb, yshape, psize, stage_idx, q_index,
                            me_downsample):
        """Queue the three independent decode units of one coded pair (MV,
        luma bands, chroma bands) on the worker pool; returns their
        futures. The MV unit reads the DPB the encoder kept, which the
        replay makes bit-identical to a decoder's own."""
        _, string = decode_p(mv_out)
        pool = self._pool()
        return (
            pool.submit(self.decompress_mv, string, yshape[0], yshape[1], dpb,
                        stage_idx=stage_idx, q_index=q_index,
                        me_downsample=me_downsample,
                        coder=PWaveCodec.make_coder()),
            pool.submit(self.decompress_one_stage, output_path, code_lt,
                        ischroma=False, psize=psize, q_index=q_index,
                        stage_idx=stage_idx, own_coders=True),
            pool.submit(self.decompress_one_stage, file_name_c, code_lt,
                        ischroma=True, psize=psize, q_index=q_index,
                        stage_idx=stage_idx, own_coders=True))

    def _errors(self, decoded, dec_l, dec_c, expect, code_lt):
        """Max abs difference of each decoded plane from the encoder side."""
        pairs = {"mv_hat": (decoded["mv_hat"], expect["mv_hat"]),
                 "mv_y_hat": (decoded["mv_y_hat"], expect["mv_y_hat"]),
                 "H_t": (dec_l["H_t"]["x_hat"], expect["H_t"]),
                 "H_tc": (dec_c["H_t"]["x_hat"], expect["H_tc"])}
        if code_lt:
            pairs["L_t"] = (dec_l["L_t"]["x_hat"], expect["L_t"])
            pairs["L_tc"] = (dec_c["L_t"]["x_hat"], expect["L_tc"])
        return {k: float(self.stats.to_host((a - b).abs().max()))
                for k, (a, b) in pairs.items()}

    def drain_decodes(self, check: bool = True, strict: bool = True):
        """Wait for every deferred pair decode (decode_async=True).

        check=True also holds the decoded planes against the encoder-side
        reconstructions that encode_one_stage returned; strict=True raises
        ValueError on any nonzero difference. Call it once a GOP, before
        the stream folder is used again: the deferred decodes read the
        lowpass streams 0_main.bin / 0_C_main.bin by name. Returns one
        dict a pair {"name", "errs", "max_err", "decoded"} and clears the
        queue."""
        out = []
        pend, self._pending_decodes = self._pending_decodes, []
        for item in pend:
            decoded, dec_l, dec_c = (f.result() for f in item["futures"])
            errs = (self._errors(decoded, dec_l, dec_c, item["expect"],
                                 item["code_lt"]) if check else {})
            max_err = max(errs.values()) if errs else 0.0
            if strict and max_err != 0.0:
                raise ValueError(
                    f"deferred decode mismatch in {item['name']}: {errs} (the "
                    "decoded planes differ from the encoder-side reconstruction)")
            out.append({"name": item["name"], "errs": errs, "max_err": max_err,
                        "decoded": {"mv": decoded, "luma": dec_l,
                                    "chroma": dec_c}})
        return out

    def close(self):
        """Shut the worker pools down; raises on undrained deferred decodes
        (their stream files may already be stale)."""
        pend = self._pending_decodes
        self._pending_decodes = []
        for pool in (self._decode_pool, self._encode_pool):
            if pool is not None:
                pool.shutdown(wait=True)
        self._decode_pool = self._encode_pool = None
        if pend:
            raise RuntimeError(
                f"PMCTFCodec.close() with {len(pend)} undrained deferred "
                "decodes: call drain_decodes() after each GOP")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        """close(); its RuntimeError about undrained decodes only when the
        block ended without an exception, which would otherwise be
        replaced by it."""
        try:
            self.close()
        except RuntimeError:
            if exc_type is None:
                raise
        return False

    @torch.no_grad()
    @f32_streams
    def encode_one_stage(self, ref_frame, cur_frame, code_lt: bool, dpb,
                         output_path: str, pic_width: int, pic_height: int,
                         psize: int = 128, skip_decoding: bool = False,
                         stage_idx: int = 0, q_index=0,
                         me_downsample: int = 1, decode_async: bool = False):
        """Encode one frame pair (luma and chroma) to streams beside
        `output_path`, then decode them again unless skip_decoding.

        The decode runs its three independent units (MV, luma, chroma) on
        the worker pool. decode_async=True only queues them: the returned
        planes are then the encoder-side reconstructions (which the
        replay makes bit-identical to the decoded ones), and the caller
        must call drain_decodes() once a GOP, which checks them."""
        ref_y, ref_chroma = ref_frame
        cur_y, cur_chroma = cur_frame

        start = time.perf_counter()
        mv_out = output_path.replace(".bin", "_mv.bin")
        out_enc = self.compress_mv(ref_y, cur_y, dpb, stage_idx, q_index,
                                   me_downsample)
        encode_p(out_enc["bit_stream"], 0, mv_out)
        mv_hat = out_enc["mv_hat"]
        mv_feature = out_enc["mv_feature"]
        mv_y_hat = out_enc["mv_y_hat"]

        # luma and chroma are independent given mv_hat: one thread each,
        # each with its own coders
        file_name_c = output_path.replace(".bin", "_C_main.bin")
        f_l = self._enc_pool().submit(
            self.compress_one_stage, ref_y, cur_y, code_lt, mv_hat,
            ischroma=False, sideinfo=[1, 1, pic_height, pic_width],
            file_name=output_path, stage_idx=stage_idx, q_index=q_index,
            own_coders=True)
        f_c = self._enc_pool().submit(
            self.compress_one_stage, ref_chroma, cur_chroma, code_lt, mv_hat,
            ischroma=True, sideinfo=[1, 2, pic_height // 2, pic_width // 2],
            file_name=file_name_c, stage_idx=stage_idx, q_index=q_index,
            own_coders=True)
        out_l, out_c = f_l.result(), f_c.result()
        encoding_time = time.perf_counter() - start

        def bits(path):
            return os.path.getsize(path) * 8.0

        bits_h, bits_me, bits_h_c = bits(output_path), bits(mv_out), bits(file_name_c)
        bits_l = bits(_lt_name(output_path, False)) if code_lt else None
        bits_l_c = bits(_lt_name(output_path, True)) if code_lt else None

        expect = {"mv_hat": mv_hat, "mv_y_hat": mv_y_hat,
                  "H_t": out_l["H_t_hat"], "L_t": out_l["L_t_hat"],
                  "H_tc": out_c["H_t_hat"], "L_tc": out_c["L_t_hat"]}
        l_t_rec = out_l["L_t_hat"] if code_lt else out_l["L_t"]
        l_tc_rec = out_c["L_t_hat"] if code_lt else out_c["L_t"]
        h_t_rec, h_tc_rec = out_l["H_t_hat"], out_c["H_t_hat"]
        decoding_time = 0.0
        if not skip_decoding:
            futures = self._submit_pair_decode(
                mv_out, output_path, file_name_c, code_lt, dict(dpb),
                (ref_y.shape[2], ref_y.shape[3]), psize, stage_idx, q_index,
                me_downsample)
            if decode_async:
                self._pending_decodes.append(
                    {"name": output_path, "code_lt": code_lt,
                     "futures": futures, "expect": expect})
            else:
                start = time.perf_counter()
                decoded, out_dec, out_dec_c = (f.result() for f in futures)
                decoding_time = time.perf_counter() - start
                mv_hat = decoded["mv_hat"]
                mv_feature = decoded["mv_feature"]
                if code_lt:
                    l_t_rec = out_dec["L_t"]["x_hat"]
                    l_tc_rec = out_dec_c["L_t"]["x_hat"]
                h_t_rec = out_dec["H_t"]["x_hat"]
                h_tc_rec = out_dec_c["H_t"]["x_hat"]

        return {
            "L_t": l_t_rec, "H_t": h_t_rec, "L_tc": l_tc_rec, "H_tc": h_tc_rec,
            "bit_H": bits_h + bits_h_c,
            "bit_L": (bits_l + bits_l_c) if code_lt else None,
            "bit_Lc": bits_l_c, "bit_Hc": bits_h_c, "bit_ME": bits_me,
            "mv_hat": mv_hat,
            "dpb": {"mv_feature": mv_feature, "ref_mv_y": mv_y_hat},
            "encoder_side": expect,
            "decoding_time": decoding_time, "encoding_time": encoding_time,
        }

    @torch.no_grad()
    def estimate_one_stage(self, ref_frame, cur_frame, code_lt: bool, dpb,
                           stage_idx: int = 0, q_index=0,
                           me_downsample: int = 1):
        """Entropy-estimated stage coding (no bitstream), with the output
        keys of encode_one_stage."""
        ref_y, ref_chroma = ref_frame
        cur_y, cur_chroma = cur_frame
        res = self.model.forward_one_stage(ref_y, cur_y, q_index, code_lt, dpb,
                                           stage_idx=stage_idx,
                                           me_downsample=me_downsample)
        res_c = self.model.forward_one_stage(ref_chroma, cur_chroma, q_index,
                                             code_lt, empty_dpb(),
                                             mv_hat=res["mv_hat"],
                                             stage_idx=stage_idx)
        return {
            "L_t": res["L_t"], "H_t": res["H_t"],
            "L_tc": res_c["L_t"], "H_tc": res_c["H_t"],
            "bit_L": float(res["bit_L"] + res_c["bit_L"]) if code_lt else None,
            "bit_H": float(res["bit_H"] + res_c["bit_H"]),
            "bit_Lc": float(res_c["bit_L"]) if code_lt else None,
            "bit_Hc": float(res_c["bit_H"]),
            "bit_ME": float(res["bit_ME"]),
            "mv_hat": res["mv_hat"], "dpb": res["dpb"],
            "decoding_time": 0.0, "encoding_time": 0.0,
        }

    @torch.no_grad()
    @f32_streams
    def inverse_mctf(self, l_t, h_t, mv_hat, stage_idx: int = 0,
                     downscale: bool = False):
        return self.model.inverse_mctf(l_t, h_t, mv_hat, stage_idx, downscale)

    # ---- the q-batched estimate path -----------------------------------------
    #
    # Q rate points (or sequences x rate points) in one batch: a leading
    # element axis E on every plane, flattened into the model's batch, so
    # that each layer runs once for all of them. An element's luma planes
    # are (B, 1, H, W) and its chroma planes (P, 1, h, w), P = reps * B;
    # the model tiles the luma MVs over the chroma batch copy by copy, so
    # chroma is flattened copy-major: (reps, E, B).

    @staticmethod
    def _to_batch(t, reps: int = 1):
        e, p = t.shape[:2]
        b = p // reps
        return (t.reshape(e, reps, b, *t.shape[2:]).transpose(0, 1)
                .reshape(e * p, *t.shape[2:]))

    @staticmethod
    def _from_batch(t, e: int, reps: int = 1):
        b = t.shape[0] // (e * reps)
        return (t.reshape(reps, e, b, *t.shape[1:]).transpose(0, 1)
                .reshape(e, reps * b, *t.shape[1:]))

    @staticmethod
    def _per_element(bits, e: int, reps: int = 1):
        """Per-sample rates (reps * E * B,) summed per element: (E,)."""
        return bits.reshape(reps, e, -1).sum(dim=(0, 2))

    @torch.no_grad()
    def estimate_one_stage_multi(self, ref_frame, cur_frame, code_lt: bool,
                                 dpb, q_indices, stage_idx: int = 0):
        """estimate_one_stage over a batch of rate points.

        ref_frame/cur_frame: (y, chroma) with a leading element axis E,
        ((E, B, 1, H, W), (E, P, 1, h, w)); dpb leaves (E, ...) or None;
        q_indices: E q indexes. Returns estimate_one_stage's planes with
        the leading axis, and (E,) numpy arrays of bits."""
        ref_y, ref_c = ref_frame
        cur_y, cur_c = cur_frame
        e, b = ref_y.shape[:2]
        reps = ref_c.shape[1] // b
        q = torch.as_tensor(q_indices, dtype=torch.float32,
                            device=ref_y.device).repeat_interleave(b)
        flat = {k: None if v is None else self._to_batch(v) for k, v in dpb.items()}
        res = self.model.forward_one_stage(
            self._to_batch(ref_y), self._to_batch(cur_y), q, code_lt, flat,
            stage_idx=stage_idx, per_sample=True)
        res_c = self.model.forward_one_stage(
            self._to_batch(ref_c, reps), self._to_batch(cur_c, reps),
            q.repeat(reps), code_lt, empty_dpb(), mv_hat=res["mv_hat"],
            stage_idx=stage_idx, per_sample=True)

        def bits(key):
            total = (self._per_element(res[key], e)
                     + self._per_element(res_c[key], e, reps))
            return total.cpu().numpy()

        return {
            "L_t": self._from_batch(res["L_t"], e),
            "H_t": self._from_batch(res["H_t"], e),
            "L_tc": self._from_batch(res_c["L_t"], e, reps),
            "H_tc": self._from_batch(res_c["H_t"], e, reps),
            "bit_L": bits("bit_L") if code_lt else None,
            "bit_H": bits("bit_H"),
            "bit_ME": self._per_element(res["bit_ME"], e).cpu().numpy(),
            "mv_hat": self._from_batch(res["mv_hat"], e),
            "dpb": {k: None if v is None else self._from_batch(v, e)
                    for k, v in res["dpb"].items()},
        }

    @torch.no_grad()
    @f32_streams
    def inverse_mctf_multi(self, l_t, h_t, mv_hat, stage_idx: int = 0,
                           downscale: bool = False):
        """inverse_mctf with a leading element axis on every input: l_t,
        h_t (E, P, 1, h, w), mv_hat (E, B, 2, H, W)."""
        e, reps = l_t.shape[0], l_t.shape[1] // mv_hat.shape[1]
        ref, cur = self.model.inverse_mctf(
            self._to_batch(l_t, reps), self._to_batch(h_t, reps),
            self._to_batch(mv_hat), stage_idx, downscale)
        return self._from_batch(ref, e, reps), self._from_batch(cur, e, reps)
