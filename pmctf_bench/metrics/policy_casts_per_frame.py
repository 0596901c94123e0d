"""The bf16 activation policy's casts a frame (each a dtype change, so a
kernel: the port's ``policy casts`` counter), in the traced GOP: the
port's telemetry, which counts only while the profiler runs. None for a
port without it."""


def read(rec):
    try:
        from learned_pmctf_tpu_torch import telemetry
    except ImportError:
        return None
    casts = telemetry.snapshot()["counters"].get("policy casts")
    return casts / rec["traced"]["frames_traced"] if casts else None
