"""Host ms a frame the GOP's own thread waits for the codec's pool
units (the port's ``wait encode units`` and ``wait decode units`` spans
on the thread of its ``gop`` span), in the traced GOP: the port's
telemetry, which records only while the profiler runs. None for a port
without it."""

WAITS = ("wait encode units", "wait decode units")


def read(rec):
    try:
        from learned_pmctf_tpu_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.snapshot()["spans"]
    gop_threads = {s["thread"] for s in spans if s["name"] == "gop"}
    waits = [s for s in spans if s["name"] in WAITS and s["thread"] in gop_threads]
    if not waits:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in waits)
    return ns / 1e6 / rec["traced"]["frames_traced"]
