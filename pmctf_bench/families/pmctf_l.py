"""pMCTF-L, the video coder (arXiv 2410.15873): the family of every
configuration that names none.

An input is one GOP, ``(luma, chroma)`` frame lists drawn by the mix's
``frames`` generator (frames.py); the port runs it through the path the
mix names (``estimate``: ``gop.code_gop``; ``stream``: ``.bin`` files
through ``PMCTFCodec``), the plain reference through
``reference/gop.py:code_gop``. The layer table, the six layers of the
port's telemetry by the modules that open them, serves the spans around
the port's layers and the work the reference counts.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn as nn

from pmctf_bench import frames as frame_gen
from pmctf_bench.reference.gop import code_gop as reference_gop
from pmctf_bench.reference.model import PMCTF as ReferencePMCTF

PATHS = ("estimate", "stream")

MOTION = "motion"
TEMPORAL = "temporal lifting"
LIFTING = "spatial lifting"
LSTM = "lstm context"
PRIORS = "four-step priors"
POSTPROCESS = "postprocess"

_MV = ("mv_encoder", "mv_decoder", "mv_hyper_prior_encoder", "mv_hyper_prior_decoder",
       "mv_y_prior_fusion_adaptor_0", "mv_y_prior_fusion_adaptor_1", "mv_y_prior_fusion",
       "mv_y_spatial_prior", "mv_y_spatial_prior_adaptor_1",
       "mv_y_spatial_prior_adaptor_2", "mv_y_spatial_prior_adaptor_3")


def reference_model(config: Dict) -> nn.Module:
    """The plain reference, built where the caller's device context says."""
    return ReferencePMCTF(**config["model"])


def attach(reference: nn.Module, numerics) -> nn.Module:
    """The reference's convolutions on `numerics`."""
    return reference.attach(numerics)


def port_model(config: Dict) -> nn.Module:
    """The port's model, built where the caller's device context says."""
    from learned_pmctf_tpu_torch.models.pmctf import PMCTF
    return PMCTF(**config["model"])


def inputs(mix: Dict, seed: int, device) -> List[Tuple]:
    """The run's distinct GOPs, each drawn from its own seed."""
    gen = dict(mix["frames"])
    generator = getattr(frame_gen, gen.pop("generator"))
    return [generator(mix["gop"], mix["height"], mix["width"], device,
                      frame_gen.input_seed(seed, d), **gen)
            for d in range(mix["distinct_gops"])]


def frames(mix: Dict) -> int:
    """Frames one input codes."""
    return mix["gop"]


def reference_output(reference: nn.Module, inp: Tuple, mix: Dict) -> Dict:
    """The reference's estimate of one GOP (check.py's shape)."""
    return reference_gop(reference, *inp, mix["q_index"])


def layer_modules(model: nn.Module) -> List[Tuple[nn.Module, str]]:
    """(module, layer) for the modules that open a layer; the names are
    the port's and the reference's alike. The methods the ladder calls
    (``forward_lift_2d``, ``step``, ``predict_filter``) are reached
    through the nets they run."""
    out = [(model.optic_flow, MOTION)]
    out += [(m, MOTION) for name in _MV for m in getattr(model, name)]
    for tf in model.temporal_filtering:
        out += [(tf.P_t, TEMPORAL), (tf.U_t, TEMPORAL)]
    for coder in (model.lp_coder, model.hp_coder):
        lift = coder.wavelet_transform.lift_h
        out += [(getattr(lift, n), LIFTING) for n in
                ("P_1", "U_1", "P_2", "U_2", "conv_P1", "conv_U1", "conv_P2", "conv_U2")]
        ctx = coder.context_prediction
        out += [(m, LSTM) for m in (ctx.LSTM1, ctx.LSTM2, ctx.LSTM3)]
        out += [(m, LSTM) for j in (1, 2, 3) for k in ("h", "c")
                for m in getattr(ctx, f"deconv_{k}{j}")]
        out += [(m, PRIORS) for bands in coder.context_fusion for m in bands.values()]
        out.append((coder.dequantModule, POSTPROCESS))
    return out


# ---- planted faults (faults.py) --------------------------------------------

def unchanged(model):
    """The inverse temporal step returns its state unchanged."""
    model.inverse_mctf = lambda l_t, h_t, *a, **k: (l_t, h_t)


def half_batch(model):
    """Half of the batch (chroma's V plane) left out: the step runs on the
    rest and stands it in for the whole."""
    inverse = model.inverse_mctf

    def broken(l_t, h_t, *a, **k):
        if l_t.shape[0] < 2:
            return inverse(l_t, h_t, *a, **k)
        half = l_t.shape[0] // 2
        ref, cur = inverse(l_t[:half], h_t[:half], *a, **k)
        return ref.repeat(2, 1, 1, 1), cur.repeat(2, 1, 1, 1)
    model.inverse_mctf = broken


def altered(model):
    """One decoded plane altered where it is produced: a 16x16 block of
    the first frame pair's luma off by two levels, once a GOP-4's inverse
    ladder."""
    inverse, calls = model.inverse_mctf, []

    def broken(l_t, h_t, *a, **k):
        ref, cur = inverse(l_t, h_t, *a, **k)
        calls.append(1)
        if len(calls) % 4 == 0:
            cur = cur.clone()
            cur[..., :16, :16] += 2.0
        return ref, cur
    model.inverse_mctf = broken


@contextlib.contextmanager
def doubled_payload() -> Iterator[None]:
    """Every stream file carries its payload twice, as from a writer that
    flushes twice: the header's length counts one copy and decoding reads
    only that, so every plane still decodes equal to the encoder side,
    and the written files grow."""
    from learned_pmctf_tpu_torch.codec import image_codec, video_codec
    write_image, write_p = image_codec.encode_image, video_codec.encode_p

    def doubled_image(height, width, num_channels, bit_stream, output):
        write_image(height, width, num_channels, bit_stream, output)
        with open(output, "ab") as f:
            f.write(bit_stream)

    def doubled_p(string, mv_y_q_index, output):
        write_p(string, mv_y_q_index, output)
        with open(output, "ab") as f:
            f.write(string)
    image_codec.encode_image, video_codec.encode_p = doubled_image, doubled_p
    try:
        yield
    finally:
        image_codec.encode_image, video_codec.encode_p = write_image, write_p


@contextlib.contextmanager
def tf32() -> Iterator[None]:
    """The port leaves TF32 on: its calls that turn it off turn it on."""
    from learned_pmctf_tpu_torch import gop
    from learned_pmctf_tpu_torch.codec import image_codec
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    before = [f.allow_tf32 for f in flags]
    calls = (gop.disable_tf32, image_codec.disable_tf32)

    def tf32_on():
        for f in flags:
            f.allow_tf32 = True
    gop.disable_tf32 = image_codec.disable_tf32 = tf32_on
    tf32_on()
    try:
        yield
    finally:
        gop.disable_tf32, image_codec.disable_tf32 = calls
        for f, b in zip(flags, before):
            f.allow_tf32 = b


MODEL_FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
GLOBAL_FAULTS = {"doubled_payload": doubled_payload, "tf32": tf32}
