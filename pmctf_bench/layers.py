"""The layers of pMCTF-L by module, and hooks that mark them.

``layer_modules`` finds the modules of each layer by their attribute
names, which the port's model and the reference share, so one table
serves the spans around the port's layers (trace.py) and the work the
reference counts (work.py). A module is hooked where the GOP calls it;
the methods the ladder calls (``forward_lift_2d``, ``step``,
``predict_filter``) are reached through the nets they run.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, List, Tuple

import torch.nn as nn

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


def layer_modules(model: nn.Module) -> List[Tuple[nn.Module, str]]:
    """(module, layer) for the modules that open a layer."""
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


@contextmanager
def hooked(model: nn.Module, enter: Callable[[str], object], leave: Callable[[object], None]):
    """Call enter(layer) before and leave(token) after each call of a
    layer's module, while the context is open."""
    tokens = {}   # by thread and module: the stream codec runs modules on its threads
    handles = []

    def pre(m, args, layer):
        tokens.setdefault((threading.get_ident(), m), []).append(enter(layer))

    def post(m, args, out):
        leave(tokens[threading.get_ident(), m].pop())

    for m, layer in layer_modules(model):
        handles.append(m.register_forward_pre_hook(lambda m, a, layer=layer: pre(m, a, layer)))
        handles.append(m.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
