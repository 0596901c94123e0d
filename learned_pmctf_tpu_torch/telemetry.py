"""The port's spans and counters, on the profiler's clock.

One module holds every span and counter the port records; nothing is
written out, readers take ``snapshot()``.

- ``span(name, **attrs)`` is a context manager. While telemetry is off
  it is one check and the shared ``nullcontext``: no ``record_function``,
  no clock read, no list append. While on it opens a ``record_function``
  range of `name` (a user annotation in the profiler's events, on the
  timeline of the device's kernels and idle gaps) and keeps a record
  in memory: name, start and end in ns of ``time.time_ns()`` (the clock
  the profiler stamps its events on; the range's own stamps fall between
  them), thread, the id of its parent span,
  the id of its GOP (the enclosing ``gop`` span) and `attrs`.
- Telemetry is on while a ``torch.profiler`` profile runs. The check
  reads the profiler's process-wide flag
  (``torch.autograd.profiler._is_profiler_enabled``), which the codec's
  worker threads see too; ``torch.autograd._profiler_enabled()`` is the
  calling thread's own and reads false on them.
- A span's parent is the innermost span open on its thread. A unit that
  runs on a pool's thread takes the span that submitted it as parent:
  submit ``carry(fn)`` instead of ``fn``.
- A span inside a span of its own name, on one thread, adds nothing: a
  layer's method called from the layer's own module is one span.
- ``count(name, n)`` adds to a counter while on, for events too many to
  span (the activation policy's casts).

The profiler records user annotations of the thread that started it
(and of threads that inherit its state, such as autograd's); a pool's
threads are recorded only with the profiler's ``profile_all_threads``.
Their spans are in ``snapshot()`` either way.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
import types
from contextlib import nullcontext
from typing import Callable, Dict, List

from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

GOP = "gop"

# the layers, named as the benchmark names them (pmctf_bench/layers.py)
MOTION = "motion"
TEMPORAL = "temporal lifting"
LIFTING = "spatial lifting"
LSTM = "lstm context"
PRIORS = "four-step priors"
POSTPROCESS = "postprocess"
LAYERS = (MOTION, TEMPORAL, LIFTING, LSTM, PRIORS, POSTPROCESS)

_OFF = nullcontext()
_spans: List["_Span"] = []
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def on() -> bool:
    """Whether spans and counters are recorded now."""
    return _profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "gop", "thread", "start_ns",
                 "end_ns", "_range")

    def __init__(self, name: str, attrs: Dict, parent):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.gop = self.id if name == GOP else (None if parent is None else parent.gop)
        self.thread = threading.get_ident()

    # the stamps lie outside the profiler's range, whose own stamps fall
    # between them (a few us apart)
    def __enter__(self):
        self.start_ns = time.time_ns()
        _stack().append(self)
        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self._range = None
        _stack().pop()
        self.end_ns = time.time_ns()
        _spans.append(self)
        return False

    def record(self) -> Dict:
        return {"name": self.name, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "thread": self.thread, "id": self.id, "parent": self.parent,
                "gop": self.gop, "attrs": self.attrs}


def span(name: str, **attrs):
    """A span of `name` around a block."""
    if not on():
        return _OFF
    stack = _stack()
    parent = stack[-1] if stack else None
    if parent is not None and parent.name == name:
        return _OFF
    return _Span(name, attrs, parent)


def spanned(name: str) -> Callable:
    """Decorator: each call of the function in a span of `name`."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not on():
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return wrapped
    return decorate


def _spanned_forward(self, *args, **kwargs):
    forward = type(self).forward
    if not on():
        return forward(self, *args, **kwargs)
    with span(self.span_name):
        return forward(self, *args, **kwargs)


def span_calls(module, name: str):
    """Each call of `module` (an nn.Module) in a span of `name`: this
    instance's forward becomes its class's forward inside the span. A
    copy of the module keeps it (the bound method follows the copy)."""
    module.span_name = name
    module.forward = types.MethodType(_spanned_forward, module)
    return module


def carry(fn: Callable) -> Callable:
    """`fn`, to be run on another thread as a unit the current span
    caused: its spans take that span as parent (and its GOP). `fn` itself
    while off or outside every span."""
    if not on():
        return fn
    stack = _stack()
    if not stack:
        return fn
    parent = stack[-1]

    @functools.wraps(fn)
    def unit(*args, **kwargs):
        own = _stack()
        own.append(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            own.pop()
    return unit


def count(name: str, n: int = 1):
    """Add `n` to counter `name` while on."""
    if not on():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> Dict:
    """{"spans": the finished spans' records, "counters": {name: total}},
    without clearing them."""
    with _lock:
        return {"spans": [s.record() for s in list(_spans)], "counters": dict(_counters)}


def clear():
    """Drop every recorded span and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()
