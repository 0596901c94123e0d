"""Host ms a frame in the port's ``d2h`` spans (each a copy from the
device that waits for the device's queue to drain), summed over the
codec's threads, in the traced GOP: the port's telemetry, which records
only while the profiler runs. None for a port without it."""


def read(rec):
    try:
        from learned_pmctf_tpu_torch import telemetry
    except ImportError:
        return None
    spans = [s for s in telemetry.snapshot()["spans"] if s["name"] == "d2h"]
    if not spans:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in spans)
    return ns / 1e6 / rec["traced"]["frames_traced"]
