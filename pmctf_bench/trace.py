"""The traced input: spans around the port's layers, and their reduction.

A traced input runs under ``torch.profiler`` (CUPTI) with a span
(``record_function``) around each call of a layer's module (layers.py,
by the family's table) and around the path's steps (``span_methods``). The reduction reads
the profiler's raw events, not a chrome trace:

- a kernel (or copy, or fill) belongs to the innermost layer span open on
  the host when the runtime call that launched it ran, whatever launched
  it: the conv3x3 kernels, launched through ctypes, fall in PostProcess's
  span by the time of their launch, not by their name;
- the device is busy where the union of its activities' intervals lies,
  within the traced window; an idle gap is named by the innermost span
  open on the host at its middle ("no span" outside every span).

``reduce`` returns summaries only: seconds by layer, busy and window
seconds, and the ten largest device operations and idle gaps by name.
"""

from __future__ import annotations

import contextlib
import functools
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

from . import layers

NO_SPAN = "no span"
DEVICE, SPAN, LAUNCH, OTHER = "device", "span", "launch", "other"


def kind(ev) -> str:
    """What a raw profiler event is: an activity of the device (a kernel,
    copy or fill), a span on the host, a runtime or driver call that
    launched device work (CUPTI gives it the id of what it launched), or
    anything else. Newer torch names kineto's activity type; torch 2.11's
    events are told apart by device, annotation and name."""
    if hasattr(ev, "activity_type"):
        t = ev.activity_type()
        return {"kernel": DEVICE, "gpu_memcpy": DEVICE, "gpu_memset": DEVICE,
                "user_annotation": SPAN, "cuda_runtime": LAUNCH,
                "cuda_driver": LAUNCH}.get(t, OTHER)
    on_device = str(ev.device_type()).rsplit(".", 1)[-1] == "CUDA"
    if ev.is_user_annotation():
        return OTHER if on_device else SPAN
    if on_device:
        return DEVICE
    return LAUNCH if ev.name().startswith("cu") else OTHER


def span_methods(obj, names: Iterable[str], record_function):
    """Wrap `obj`'s methods `names` in spans of their names (instance
    attributes over the class's methods); returns an undo function."""
    saved = []
    for name in names:
        fn = getattr(obj, name)

        @functools.wraps(fn)
        def wrapped(*a, _fn=fn, _name=name, **kw):
            with record_function(_name):
                return _fn(*a, **kw)
        setattr(obj, name, wrapped)
        saved.append(name)

    def undo():
        for name in saved:
            delattr(obj, name)
    return undo


@contextlib.contextmanager
def layer_spans(model, record_function, family):
    """A span around each call of a layer's module (`family`'s table)."""
    def enter(layer):
        rf = record_function(layer)
        rf.__enter__()
        return rf

    with layers.hooked(model, enter, lambda rf: rf.__exit__(None, None, None), family):
        yield


def _innermost(spans: List[Tuple[int, int, str]], points: List[int]) -> List[str]:
    """For each point (ns, sorted), the name of the innermost span
    [start, end) holding it; spans nest."""
    marks = sorted([(s, 1, i) for i, (s, e, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (s, e, _) in enumerate(spans)])
    out, stack, j = [], [], 0
    for p in points:
        while j < len(marks) and marks[j][0] <= p:
            t, opening, i = marks[j]
            if opening:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            j += 1
        out.append(spans[stack[-1]][2] if stack else NO_SPAN)
    return out


def _thread(ev) -> int:
    return ev.start_thread_id() if hasattr(ev, "start_thread_id") else 0


def reduce(events, window: Tuple[int, int], layer_names: Iterable[str]) -> Dict:
    """Summaries of a traced window [start, end) (ns, the profiler's
    clock) from the profiler's raw events. Spans nest within a thread (the
    stream codec runs modules on its own threads): a launch is matched to
    its own thread's spans, and an idle gap is named by the spans of the
    thread that opened the window."""
    start, end = window
    layer_names = set(layer_names)
    spans, launches, device = defaultdict(list), {}, []
    main = None
    for ev in events:
        k = kind(ev)
        if k == DEVICE:
            if ev.end_ns() > start and ev.start_ns() < end:
                device.append(ev)
        elif k == SPAN:
            spans[_thread(ev)].append((ev.start_ns(), ev.end_ns(), ev.name()))
            if (ev.start_ns(), ev.end_ns()) == (start, end):
                main = _thread(ev)
        elif k == LAUNCH:
            launches[ev.correlation_id()] = (ev.start_ns(), _thread(ev))
    span_names = {name for th in spans.values() for _, _, name in th}
    device = [ev for ev in device if ev.name() not in span_names]  # spans mirrored on the device
    # each device activity's launch on the host, by thread
    by_thread, unmatched = defaultdict(list), 0
    for ev in device:
        t, th = launches.get(ev.correlation_id(), (None, main))
        if t is None:
            unmatched += 1
            t = ev.start_ns()
        by_thread[th].append((t, ev))
    by_layer: Dict[str, float] = defaultdict(float)
    by_op: Dict[str, float] = defaultdict(float)
    intervals = []
    for th, keyed in by_thread.items():
        keyed.sort(key=lambda k: k[0])
        layer_spans_ = [s for s in spans.get(th, []) if s[2] in layer_names]
        owners = _innermost(layer_spans_, [t for t, _ in keyed])
        for (t, ev), owner in zip(keyed, owners):
            s, e = max(ev.start_ns(), start), min(ev.end_ns(), end)
            by_layer[owner if owner != NO_SPAN else "other"] += (e - s) / 1e9
            by_op[ev.name()[:100]] += (e - s) / 1e9
            intervals.append((s, e))
    busy, gaps = _union(intervals, start, end)
    gap_names = _innermost(spans.get(main, []), [(a + b) // 2 for a, b in gaps])
    by_gap: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps, gap_names):
        by_gap[name] += (b - a) / 1e9
    return {"window_s": (end - start) / 1e9, "busy_s": busy / 1e9,
            "layer_device_s": dict(by_layer), "device_activities": len(device),
            "unmatched_launches": unmatched,
            "device_ops": _top(by_op), "idle_gaps": _top(by_gap)}


def _union(intervals, start, end):
    """(busy ns, idle gaps) of intervals within [start, end)."""
    busy, gaps, cursor = 0, [], start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if end > cursor:
        gaps.append((cursor, end))
    return busy, gaps


def _top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def window_of(events, name: str) -> Tuple[int, int]:
    """The [start, end) of the user span `name`."""
    for ev in events:
        if kind(ev) == SPAN and ev.name() == name:
            return ev.start_ns(), ev.end_ns()
    raise RuntimeError(f"the profiler recorded no span {name!r}")

