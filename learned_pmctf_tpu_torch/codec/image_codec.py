"""Host bitstream codec for the pWave image coder.

Counterpart of learned_pmctf_tpu/codec/image_codec.py:PWaveCodec, for
both LL coders (``ll_mode="fourstep"`` and the reference's ``"ar"``).

- compress is *decode with teacher-forced symbols*: it replays the
  decompress loop (the same module calls on the same shapes in the same
  order) but takes each pass's symbols from the quantized subband,
  round((y - means)[phase]), instead of from rANS. The parameter nets
  therefore run the same device arithmetic on both sides, and encoder and
  decoder stay bit-identical; a separate fused encode would differ at
  the ulp level and, at 1080p symbol counts, flip a round or a table
  index somewhere and desync the range coder. Encode has no dependency
  on rANS, so the whole replay queues on the device and ends in ONE
  copy of every symbol and index plane to the host.
- decompress: each four-step subband needs 4 rANS round trips (each
  pass's symbols are inputs of the next pass's parameters); between
  them the fusion module's parameter nets run on the device. The AR LL
  subband decodes by anti-diagonal wavefronts (``ar_wavefronts``): one
  evaluation of the AR net on the partial plane, one copy to the host and
  one rANS call a front, 2(h-1)+w fronts for an h x w plane. The encoder
  evaluates the same net once on the whole teacher plane; the net is
  strictly causal and its masked taps are exactly zero, so at each front
  both sides compute the same bits.

Streams go port to port on devices of one kind: the CDF-table indexes
are computed with the device's ``log`` (entropy/coder.py).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import telemetry
from ..entropy.coder import (EntropyCoder, GaussianEncoder,
                             build_indexes_from_scales)
from ..models.layers import f32_streams
from ..models.pwave import BANDS, PWave
from ..ops.masks import PHASES
from ..runtime import deterministic_cudnn, disable_tf32, resolve_device
from ..utils.stream import decode_image, encode_image


# the entropy coder's settings: a multithreaded encoder writing 2
# interleaved substreams. STREAM_PART fixes the stream format: a decoder
# must use the encoder's value.
EC_THREAD = True
STREAM_PART = 2


class HostStats:
    """What the host does for a codec, summed over its threads: copies
    from the device (each one waits for the device's queue to drain),
    seconds spent in rANS calls, the AR LL decoder's fronts and seconds
    (threads overlap, so the sums may exceed the wall time), and the
    largest |symbol| of the band streams written. The copies and the rANS
    calls are also telemetry's ``d2h`` and ``rans encode``/``rans
    decode`` spans."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.syncs = 0
            self.rans_encode_s = 0.0
            self.rans_decode_s = 0.0
            self.ar_fronts = 0
            self.ar_decode_s = 0.0
            self.symbol_peak = 0

    def add_symbols(self, symbols: np.ndarray):
        """Track the largest |symbol| the encoder writes (the coder clips
        at entropy.coder.SYMBOL_CLIP)."""
        peak = int(np.abs(symbols).max()) if symbols.size else 0
        with self._lock:
            self.symbol_peak = max(self.symbol_peak, peak)

    def to_host(self, t: torch.Tensor) -> np.ndarray:
        with self._lock:
            self.syncs += 1
        with telemetry.span("d2h"):
            return t.cpu().numpy()

    @contextlib.contextmanager
    def rans(self, kind: str):
        """Around one rANS call (`kind` "encode" or "decode"): its
        seconds into rans_<kind>_s, inside a ``rans <kind>`` span."""
        with telemetry.span(f"rans {kind}"):
            t0 = time.perf_counter()
            yield
            seconds = time.perf_counter() - t0
        with self._lock:
            name = f"rans_{kind}_s"
            setattr(self, name, getattr(self, name) + seconds)

    def add_ar_decode(self, fronts: int, seconds: float):
        with self._lock:
            self.ar_fronts += fronts
            self.ar_decode_s += seconds


def bulk_fetch_int32(tensors, stats: HostStats):
    """Integer-valued device tensors to the host in ONE copy: one
    ``torch.cat`` of their int32 values, one ``.cpu()``. The values are
    exact integers (rounded symbols, table indexes)."""
    if not tensors:
        return []
    flat = stats.to_host(torch.cat([t.reshape(-1).to(torch.int32)
                                    for t in tensors]))
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


def ar_wavefronts(h: int, w: int):
    """Anti-diagonal wavefronts t = 2*row + col of the AR LL model.

    The masked-conv stack's dependency cone is (row, col) <- {(row, <col),
    (row-k, <= col+k)}: each causal 3x3 layer (models.context.
    AR_MASKED_KERNEL) that crosses a row up can shift one column right. Every position on front t therefore depends
    only on positions with t' < t, so a whole front decodes from one
    evaluation of the net and one rANS call. Returns (rows, cols) index
    arrays, one pair a non-empty front, ordered by t, then by row."""
    fronts = []
    for t in range(2 * (h - 1) + w):
        rows = []
        cols = []
        for r in range(min(h - 1, t // 2), -1, -1):
            c = t - 2 * r
            if 0 <= c < w:
                rows.append(r)
                cols.append(c)
        if rows:
            order = np.argsort(rows)
            fronts.append((np.asarray(rows)[order], np.asarray(cols)[order]))
    return fronts


class PWaveCodec:
    """Host wrapper: a PWave module -> real bitstreams and back. It runs
    on CUDA unless the caller passes device="cpu" (with the module there).
    Construction turns TF32 off and makes cuDNN deterministic for the
    process, as PMCTFCodec does.

    em: the Laplace tables to code with, built here when not given
    (PMCTFCodec shares one set between its two PWaveCodecs)."""

    def __init__(self, module: PWave, stats: Optional[HostStats] = None,
                 em: Optional[GaussianEncoder] = None, device="cuda"):
        dev = resolve_device(device)
        if next(module.parameters()).device.type != dev.type:
            raise ValueError(f"module is on {next(module.parameters()).device}, "
                             f"the codec asked for {dev}")
        disable_tf32()
        deterministic_cudnn()
        self.module = module
        self.coder = self.make_coder()
        if em is None:
            em = GaussianEncoder()
            em.update()
        self.em = em
        self.stats = stats if stats is not None else HostStats()

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @staticmethod
    def make_coder() -> EntropyCoder:
        """A fresh EntropyCoder (its own native state), so that streams
        can be coded from several threads at once; the tables are shared
        and read-only."""
        return EntropyCoder(EC_THREAD, STREAM_PART)

    def update(self, force: bool = False):
        self.em.update(force=force)

    # ---- subband coding, shared by compress and decompress ---------------

    def _code_fourstep(self, key: str, shape, context, prev_subband,
                       teacher=None, coder=None):
        """Code one four-step subband; returns (subband_hat, plan).

        teacher=None decodes: 4 rANS calls, each after one copy of the
        pass's indexes to the host; plan is None. teacher=<quantized
        subband> encodes: the same calls with teacher-forced symbols and
        no host copy; plan is the 4 (symbols, indexes) device pairs in
        stream order."""
        module = self.module
        coder = coder or self.coder
        zeros = torch.zeros(shape, device=self.device)
        ctx_feat, scales, means = module.fusion_hier(key, context, prev_subband,
                                                     zeros)
        plan = None if teacher is None else []
        x_hat = zeros
        for step, (my, mx) in enumerate(PHASES):
            idx = build_indexes_from_scales(scales[:, :, my::2, mx::2])
            m = means[:, :, my::2, mx::2]
            if not module.lossy:
                # the estimate path codes around the rounded means in
                # lossless mode (models/context.py:process_with_mask), so
                # that integer subbands come back exactly
                m = torch.round(m)
            if teacher is None:
                idx_host = self.stats.to_host(idx)
                with self.stats.rans("decode"):
                    vals = coder.decode_stream(idx_host, *self.em.tables())
                vals = torch.from_numpy(vals.reshape(idx_host.shape)).to(
                    self.device, torch.float32)
            else:
                vals = torch.round(teacher[:, :, my::2, mx::2] - m)
                plan.append((vals, idx))
            x_hat = x_hat.clone()
            x_hat[:, :, my::2, mx::2] = vals + m
            if step < 3:
                scales, means = module.fusion_spatial(key, x_hat, ctx_feat, step)
        return x_hat, plan

    def _ar_plane(self, partial):
        """The AR net's table indexes and rounded means on a (partial)
        LL plane, stacked as one int32 tensor (2, B, C, H, W).

        The decoder calls it on the partial plane once a front, the
        encoder once on the whole teacher plane: strict causality and
        masked taps that are exactly zero make the outputs at each front
        the same bits on both sides. Both planes are integers, so one
        copy a front takes them to the host."""
        scales, means = self.module.ar_params(partial)
        return torch.stack([build_indexes_from_scales(scales),
                            torch.round(means).to(torch.int32)])

    def _decode_ar_ll(self, shape, coder=None):
        """Decode the AR LL plane front by front (see ar_wavefronts): an
        evaluation of the net, one copy to the host and one rANS call a
        front. Symbols are in (n, b, c) order: front positions major,
        batch times channel minor, as the encoder writes them."""
        coder = coder or self.coder
        t_start = time.perf_counter()
        _, _, h, w = shape
        partial = torch.zeros(shape, device=self.device)
        fronts = ar_wavefronts(h, w)
        for rows, cols in fronts:
            both = self.stats.to_host(self._ar_plane(partial))
            idx = both[0][:, :, rows, cols].transpose(2, 0, 1)
            with self.stats.rans("decode"):
                vals = coder.decode_stream(idx, *self.em.tables())
            vals = (vals.reshape(idx.shape).astype(np.int32)
                    + both[1][:, :, rows, cols].transpose(2, 0, 1))
            partial[:, :, torch.from_numpy(rows), torch.from_numpy(cols)] = (
                torch.from_numpy(vals.transpose(1, 2, 0)).to(self.device,
                                                              torch.float32))
        self.stats.add_ar_decode(len(fronts), time.perf_counter() - t_start)
        return partial

    def _encode_ar(self, coder, ll_int, both):
        """The AR LL symbols into `coder`, one call a front in the
        decoder's order: the multi-part encoder splits each call's
        symbols across its substreams, so the two sides must chunk the
        sequence alike."""
        syms = ll_int - both[1]
        self.stats.add_symbols(syms)
        for rows, cols in ar_wavefronts(*syms.shape[2:]):
            coder.encode_with_indexes(syms[:, :, rows, cols].transpose(2, 0, 1),
                                      both[0][:, :, rows, cols].transpose(2, 0, 1),
                                      *self.em.tables())

    def _code_planes(self, batch: int, new_h: int, new_w: int, teachers=None,
                     coder=None):
        """The coding-order loop of compress and decompress.

        teachers=None decodes from `coder`; teachers=<quantize_planes
        output> replays it teacher-forced and returns the plans in stream
        order, one (kind, device tensors) a subband: ("fs", [symbols,
        indexes] of the 4 passes) or, for the AR LL, ("ar", [rounded
        plane, _ar_plane of it]). Returns (subbands_hat, plans)."""
        module = self.module
        L = module.decomp_levels
        subbands_hat = {lvl: {} for lvl in range(L)}
        plans = None if teachers is None else []

        def code(key, shape, ctx, prev):
            teacher = None if teachers is None else teachers[key]
            s_hat, plan = self._code_fourstep(key, shape, ctx, prev, teacher, coder)
            if plans is not None:
                plans.append(("fs", [t for pair in plan for t in pair]))
            return s_hat

        ll_shape = (batch, 1, new_h >> L, new_w >> L)
        if module.ll_mode != "ar":
            ll_hat = code("ll", ll_shape, None, None)
        elif teachers is None:
            ll_hat = self._decode_ar_ll(ll_shape, coder)
        else:
            ll_hat = torch.round(teachers["ll"])
            plans.append(("ar", [ll_hat, self._ar_plane(ll_hat)]))
        subbands_hat[L - 1]["ll"] = ll_hat
        context, states = module.ctx_step(ll_hat, module.ctx_init(ll_hat))
        for lvl in range(L - 1, -1, -1):
            shape = (batch, 1, new_h >> (lvl + 1), new_w >> (lvl + 1))
            for sidx, band in enumerate(BANDS):
                prev = subbands_hat[lvl + 1][band] if lvl < L - 1 else None
                s_hat = code(f"{lvl}_{band}", shape,
                             context.chunk(3, dim=1)[sidx], prev)
                subbands_hat[lvl][band] = s_hat
                up = lvl - 1 if (band == "hh" and lvl > 0) else None
                context, states = module.ctx_step(s_hat, states, up)
        return subbands_hat, plans

    # ---- compression -------------------------------------------------------

    @torch.no_grad()
    @f32_streams
    def compress(self, x, q_index, qp_scale=None,
                 file_name: Optional[str] = None, sideinfo=None, coder=None):
        """Encode padded planes x (B,1,H,W); returns (encoder-side
        reconstruction, stream bytes).

        sideinfo = (batch, num_channels, true_height, true_width) for the
        container header. coder: an EntropyCoder of the caller's, so that
        independent compresses can run on several threads."""
        planes = self.module.quantize_planes(x, q_index, qp_scale)
        b, _, h, w = x.shape
        subbands_hat, plans = self._code_planes(b, h, w, teachers=planes)
        fetched = iter(bulk_fetch_int32(
            [t for _, tensors in plans for t in tensors], self.stats))
        # queued before the host's rANS work, which it does not need
        x_hat = self.module.reconstruct(subbands_hat, q_index, qp_scale)

        coder = coder or self.coder
        with self.stats.rans("encode"):
            coder.reset()
            for kind, tensors in plans:
                got = [next(fetched) for _ in tensors]
                if kind == "ar":
                    self._encode_ar(coder, *got)
                    continue
                for vals, idx in zip(got[::2], got[1::2]):
                    self.stats.add_symbols(vals)
                    coder.encode_with_indexes(vals, idx, *self.em.tables())
            coder.flush()
            bit_stream = coder.get_encoded_stream()
        if file_name is not None:
            _, num_channels, height, width = sideinfo
            with telemetry.span("file write"):
                encode_image(height, width, num_channels, bit_stream, file_name)
        return x_hat, bit_stream

    # ---- decompression -----------------------------------------------------

    @torch.no_grad()
    @f32_streams
    def decompress(self, file_name: Optional[str] = None, stream: bytes = None,
                   shape=None, padding: int = 128, q_index=0, qp_scale=None,
                   coder=None):
        """Decode a stream (from `file_name`, or `stream` with `shape` =
        (height, width, num_channels)) back to planes {"x_hat": ...}."""
        if file_name is not None:
            height, width, num_channels, stream = decode_image(file_name)
        else:
            height, width, num_channels = shape
        coder = coder or self.coder
        coder.set_stream(stream)
        p = padding
        new_h = (height + p - 1) // p * p
        new_w = (width + p - 1) // p * p
        subbands_hat, _ = self._code_planes(num_channels, new_h, new_w,
                                            coder=coder)
        return {"x_hat": self.module.reconstruct(subbands_hat, q_index, qp_scale)}
