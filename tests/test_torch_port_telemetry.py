"""learned_pmctf_tpu_torch/telemetry.py: the port's spans and counters.

Off, it records nothing and calls neither ``record_function`` nor a
clock; under ``torch.profiler`` each span is a user annotation whose
in-memory start and end lie on the profiler's clock; the layer spans sit
on the modules the benchmark names as layers (pmctf_bench/layers.py);
the stream codec's spans agree with its HostStats and leave the
bitstreams as they are; the policy's cast counter agrees with a count
made outside the policy code; the benchmark's four readers of the
telemetry read it. This file imports neither JAX nor the JAX package, so
that it runs on the card too (``python -m pytest --noconftest
tests/test_torch_port_telemetry.py``), where the clock test's ``cuda``
case runs.
"""

import os
import statistics
import sys
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from learned_pmctf_tpu_torch import telemetry
from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.gop import code_gop, gop_schedule, stream_gop
from learned_pmctf_tpu_torch.models.layers import (CASTS, CAST_BYTES, Conv2d,
                                                   MaskedConv2d, PredictUpdate,
                                                   policy_scope)
from learned_pmctf_tpu_torch.models.pmctf import build_pmctf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pmctf_bench import layers  # noqa: E402
from pmctf_bench.cells import metric_reader  # noqa: E402

SMALL = dict(decomp_levels=2, num_me_stages=2, channel_mv=8, channel_n=8,
             features=16, ar_features=16)
CLOCK_NS = 50_000   # an in-memory stamp from its profiler event's, at most
SPAN_COST_NS = 200_000   # a span's own bookkeeping under a profiler, at most on average


@pytest.fixture(autouse=True)
def _fresh():
    """Two torch threads; telemetry empty before and after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    telemetry.clear()
    yield
    telemetry.clear()
    torch.set_num_threads(threads)


def _on():
    """Telemetry on, as in the benchmark's traced GOP: a profiler session
    (the CPU's)."""
    return profile(activities=[ProfilerActivity.CPU])


def _frames(n=2, h=64, w=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    luma = [torch.rand(1, 1, h, w, generator=g) * 255 for _ in range(n)]
    chroma = [torch.rand(2, 1, h // 2, w // 2, generator=g) * 255 for _ in range(n)]
    return luma, chroma


class _Raise:
    def __init__(self, *args, **kwargs):
        raise AssertionError("called while telemetry is off")


def test_off_is_one_check(monkeypatch):
    """Off: no record_function, no clock read, nothing recorded, by every
    entry point and by the port's own calls (a policy conv, a layer
    module, a pool unit)."""
    monkeypatch.setattr(telemetry, "record_function", _Raise)
    monkeypatch.setattr(telemetry.time, "time_ns", _Raise)
    assert not telemetry.on()
    assert telemetry.span("pair", stage=0) is telemetry.span("d2h")
    with telemetry.span("d2h") as s:
        assert s is None
    telemetry.count(CASTS, 7)

    def fn():
        return threading.get_ident()
    assert telemetry.carry(fn) is fn
    assert telemetry.spanned("gop")(fn)() == threading.get_ident()

    net = PredictUpdate(1)
    telemetry.span_calls(net, telemetry.LIFTING)
    net.act_bf16 = True
    policy_scope(lambda self, x: self(x))(net, torch.ones(1, 1, 8, 8))
    with ThreadPoolExecutor(1) as pool:
        pool.submit(telemetry.carry(fn)).result()
    assert telemetry.snapshot() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_spans_on_the_profilers_clock(device):
    """Under torch.profiler (CUPTI on the card) telemetry is on, on a
    pool's thread too; each span of the profiling thread is a user
    annotation of its name whose start and end lie between its in-memory
    record's (within CLOCK_NS), CLOCK_NS from them at most at the median;
    a pool unit's span is in memory, under the span
    that submitted it."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    x = torch.ones(256, 256, device=device)
    seen_on = []

    def unit():
        seen_on.append(telemetry.on())
        with telemetry.span("rans decode"):
            return float((x @ x).sum())

    with ThreadPoolExecutor(1) as pool, profile(activities=activities) as prof:
        with telemetry.span("warm-up"):   # the profiler's first range is slow to open
            pass
        with telemetry.span("gop"):
            for i in range(3):
                with telemetry.span("pair", pair=i):
                    with telemetry.span("d2h"):
                        (x @ x).cpu()
                    pool.submit(telemetry.carry(unit)).result()
    assert not telemetry.on() and seen_on == [True] * 3
    spans = telemetry.snapshot()["spans"]
    main = threading.get_ident()
    mine = sorted((s for s in spans if s["thread"] == main and s["name"] != "warm-up"),
                  key=lambda s: s["start_ns"])
    events = sorted(((e.start_ns(), e.end_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.is_user_annotation() and e.name() in ("gop", "pair", "d2h")
                     and str(e.device_type()).endswith("CPU")))
    assert [s["name"] for s in mine] == [n for _, _, n in events] == \
        ["gop"] + ["pair", "d2h"] * 3
    # one clock: the profiler's range lies inside the span's stamps, a few
    # us from each at the median (a thread switched out between a stamp
    # and the range widens one span, it moves no median)
    for s, (start, end, _) in zip(mine, events):
        assert s["start_ns"] - CLOCK_NS <= start <= end <= s["end_ns"] + CLOCK_NS
    assert statistics.median(abs(s["start_ns"] - e[0]) for s, e in zip(mine, events)) < CLOCK_NS
    assert statistics.median(abs(s["end_ns"] - e[1]) for s, e in zip(mine, events)) < CLOCK_NS
    pairs = {s["id"] for s in mine if s["name"] == "pair"}
    units = [s for s in spans if s["name"] == "rans decode"]
    assert len(units) == 3 and all(s["parent"] in pairs and s["thread"] != main
                                   for s in units)


def test_parents_gops_and_attrs():
    """Parents from the thread's stack, carried into pool units; a GOP id
    from the enclosing ``gop``; a span inside its own name adds nothing;
    spanned methods and span_calls modules; snapshot keeps, clear drops."""
    conv = telemetry.span_calls(Conv2d(1, 1, 3), telemetry.LIFTING)

    @telemetry.spanned(telemetry.LIFTING)
    def lifted(x):
        return conv(x)

    def unit():
        telemetry.count("units")
        with telemetry.span("d2h"):
            pass
    with ThreadPoolExecutor(2) as pool, _on():
        for g in range(2):
            with telemetry.span("gop", frames=2):
                with telemetry.span("pair", stage=0, pair=g):
                    lifted(torch.ones(1, 1, 4, 4))
                    pool.submit(telemetry.carry(unit)).result()
    snap = telemetry.snapshot()
    assert snap == telemetry.snapshot()
    spans = {s["id"]: s for s in snap["spans"]}
    assert Counter(s["name"] for s in spans.values()) == {
        "gop": 2, "pair": 2, telemetry.LIFTING: 2, "d2h": 2}
    for s in spans.values():
        if s["name"] == "gop":
            assert s["parent"] is None and s["gop"] == s["id"] and s["attrs"] == {"frames": 2}
            continue
        parent = spans[s["parent"]]
        assert parent["name"] == {"pair": "gop"}.get(s["name"], "pair")
        assert s["gop"] == parent["gop"]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    assert sorted(s["attrs"]["pair"] for s in spans.values() if s["name"] == "pair") == [0, 1]
    assert snap["counters"] == {"units": 2}
    telemetry.clear()
    assert telemetry.snapshot() == {"spans": [], "counters": {}}


def test_counters_lose_no_update_across_threads():
    """count() from more threads than cores, switching often: no lost
    update."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, n = 4 * (os.cpu_count() or 4), 2000

    def hammer():
        for _ in range(n):
            telemetry.count(CASTS)
            telemetry.count(CAST_BYTES, 3)
    try:
        with _on():
            workers = [threading.Thread(target=hammer) for _ in range(n_threads)]
            for t in workers:
                t.start()
            for t in workers:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(old)
    assert telemetry.snapshot()["counters"] == {CASTS: n_threads * n,
                                                CAST_BYTES: 3 * n_threads * n}


def test_layer_spans_sit_on_the_benchmarks_layer_modules():
    """The port's layer spans are on exactly the modules the benchmark's
    layers.py names, under the same names (for both LL coders); a GOP's
    spans: one ``gop``, a ``pair`` a schedule entry with its attrs, one
    ``inverse ladder``, and layer spans only under pairs and the ladder."""
    for ll_mode in ("fourstep", "ar"):
        model = build_pmctf("cpu", seed=0, ll_mode=ll_mode, **SMALL)
        marked = {id(m): m.span_name for m in model.modules() if "span_name" in vars(m)}
        assert marked == {id(m): layer for m, layer in layers.layer_modules(model)}
    luma, chroma = _frames(4)
    with _on():
        code_gop(model, luma, chroma, 10.0, device="cpu")
    spans = {s["id"]: s for s in telemetry.snapshot()["spans"]}
    names = Counter(s["name"] for s in spans.values())
    assert names["gop"] == 1 and names["inverse ladder"] == 1
    pairs = [s["attrs"] for s in sorted(spans.values(), key=lambda s: s["start_ns"])
             if s["name"] == "pair"]
    assert pairs == [{"stage": st, "pair": fi // (2 * step), "code_lt": lt}
                     for st, fi, step, lt in gop_schedule(4)]
    assert set(names) - {"gop", "pair", "inverse ladder"} == set(telemetry.LAYERS)
    for s in spans.values():
        if s["name"] in telemetry.LAYERS:
            top = s
            while top["name"] in telemetry.LAYERS:
                top = spans[top["parent"]]
            assert top["name"] in ("pair", "inverse ladder")
            assert spans[s["parent"]]["name"] != s["name"]


def test_stream_gop_spans_feed_host_stats(tmp_path):
    """A tiny stream GOP with telemetry on and off: the same bytes; on, a
    ``d2h`` span a HostStats sync, ``rans *`` span seconds that are
    HostStats' rANS seconds and the spans' own cost, pool units under the ``pair`` that submitted
    them, both waits on the GOP's thread; the benchmark's two stream
    readers read the snapshot."""
    model = build_pmctf("cpu", seed=0, **SMALL)
    luma, chroma = _frames(2)
    files, stats = {}, {}
    with PMCTFCodec(model, device="cpu") as codec:
        codec.update()
        for on in (False, True):
            out_dir = tmp_path / str(on)
            out_dir.mkdir()
            codec.stats.reset()
            with _on() if on else nullcontext():
                out = stream_gop(codec, luma, chroma, 10.0, str(out_dir), psize=64,
                                 device="cpu")
            assert set(out["max_err"].values()) == {0.0}
            files[on] = {p.name: p.read_bytes() for p in sorted(out_dir.iterdir())}
            stats[on] = (codec.stats.syncs, codec.stats.rans_encode_s + codec.stats.rans_decode_s)
    assert files[True] == files[False] and len(files[True]) == 5
    assert stats[True][0] == stats[False][0]
    spans = {s["id"]: s for s in telemetry.snapshot()["spans"]}
    by_name = Counter(s["name"] for s in spans.values())
    assert by_name["d2h"] == stats[True][0]
    rans = [s["end_ns"] - s["start_ns"] for s in spans.values()
            if s["name"] in ("rans encode", "rans decode")]
    # a span holds HostStats' perf_counter interval and its own bookkeeping
    # (its profiler range: about 40 us under the CPU's profiler)
    gap = sum(rans) / 1e9 - stats[True][1]
    assert 0 <= gap <= len(rans) * SPAN_COST_NS / 1e9
    assert by_name["file write"] == 5 and by_name["wait encode units"] == 1 \
        and by_name["wait decode units"] == 1
    gop = next(s for s in spans.values() if s["name"] == "gop")
    units = [s for s in spans.values() if s["thread"] != gop["thread"]]
    assert units and all(s["gop"] == gop["id"] for s in units)
    assert {spans[s["parent"]]["name"] for s in units if spans[s["parent"]]["thread"]
            == gop["thread"]} == {"pair"}
    for s in spans.values():
        if s["name"].startswith("wait "):
            assert s["thread"] == gop["thread"] and spans[s["parent"]]["name"] == "pair"
    rec = {"traced": {"frames_traced": 2}}
    d2h_ms = sum(s["end_ns"] - s["start_ns"] for s in spans.values() if s["name"] == "d2h") / 1e6
    assert metric_reader("d2h_wait_ms_per_frame.stream")(rec) == pytest.approx(d2h_ms / 2)
    assert metric_reader("unit_wait_ms_per_frame.stream")(rec) > 0


class _PolicyNet(torch.nn.Module):
    """Convs of every kind the policy casts for: an f32 input, a bf16
    input, no bias, a masked conv, an exempt conv, and a self-contained
    net that returns through net_boundary."""

    act_bf16 = True

    def __init__(self):
        super().__init__()
        self.a = Conv2d(1, 8, 3)
        self.b = Conv2d(8, 8, 1, bias=False)
        self.c = MaskedConv2d(8, 8, 3, "B")
        self.skip = Conv2d(8, 8, (3, 1), padding=(1, 0), groups=8, policy_exempt=True)
        self.d = PredictUpdate(8)

    @policy_scope
    def forward(self, x):
        return self.d(self.skip(self.c(self.b(self.a(x)))))


def test_policy_casts_count():
    """``policy casts`` and ``policy cast bytes`` against a count made by
    forward hooks: a non-exempt conv on the CPU casts its input if it is
    not bf16, its weight to bf16, both to f32 for the f32 conv, the
    result to bf16 and, unless it is masked, its bias to bf16; the
    PredictUpdate net casts its bf16 result to f32. The benchmark's two
    policy readers read the counters."""
    torch.manual_seed(0)
    net = _PolicyNet()
    want = Counter()

    def cast(numel, src, dst):
        want["casts"] += 1
        want["bytes"] += numel * (src.itemsize + dst.itemsize)

    bf16, f32 = torch.bfloat16, torch.float32

    def conv_hook(m, args, out):
        x, w = args[0], m.weight
        if x.dtype != bf16:
            cast(x.numel(), x.dtype, bf16)
        cast(w.numel(), f32, bf16)
        cast(x.numel(), bf16, f32)
        cast(w.numel(), bf16, f32)
        cast(out.numel(), f32, bf16)
        if m.bias is not None and not isinstance(m, MaskedConv2d):
            cast(m.bias.numel(), f32, bf16)

    for m in net.modules():
        if isinstance(m, Conv2d) and not m.policy_exempt:
            m.register_forward_hook(conv_hook)
    net.d.register_forward_hook(lambda m, args, out: cast(out.numel(), bf16, f32))
    x = torch.randn(2, 1, 16, 16)
    want.clear()
    with _on():
        y = net(x)
    assert y.dtype == torch.float32
    counters = telemetry.snapshot()["counters"]
    assert want["casts"] > 20
    assert counters == {CASTS: want["casts"], CAST_BYTES: want["bytes"]}
    rec = {"traced": {"frames_traced": 2}}
    assert metric_reader("policy_casts_per_frame.estimate_4k")(rec) == want["casts"] / 2
    assert metric_reader("policy_cast_mib_per_frame.estimate_4k")(rec) == \
        want["bytes"] / 2 ** 20 / 2
