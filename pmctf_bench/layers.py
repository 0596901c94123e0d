"""Hooks that mark a model's layers.

A family's ``layer_modules`` (families/<family>.py) names the modules
that open each layer by their attribute names, which the port's model
and the family's reference share, so one table serves the spans around
the port's layers (trace.py) and the work the reference counts
(work.py). A module is hooked where the run calls it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from types import ModuleType
from typing import Callable, List, Optional, Tuple

import torch.nn as nn

from .cells import DEFAULT_FAMILY, load_family


def layer_modules(model: nn.Module, family: Optional[ModuleType] = None
                  ) -> List[Tuple[nn.Module, str]]:
    """(module, layer) for the modules that open a layer of `model`, by
    the table of its family (a module of families/; the default family's
    if None)."""
    return (family or load_family(DEFAULT_FAMILY)).layer_modules(model)


@contextmanager
def hooked(model: nn.Module, enter: Callable[[str], object], leave: Callable[[object], None],
           family: Optional[ModuleType] = None):
    """Call enter(layer) before and leave(token) after each call of a
    layer's module, while the context is open."""
    tokens = {}   # by thread and module: the stream codec runs modules on its threads
    handles = []

    def pre(m, args, layer):
        tokens.setdefault((threading.get_ident(), m), []).append(enter(layer))

    def post(m, args, out):
        leave(tokens[threading.get_ident(), m].pop())

    for m, layer in layer_modules(model, family):
        handles.append(m.register_forward_pre_hook(lambda m, a, layer=layer: pre(m, a, layer)))
        handles.append(m.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
