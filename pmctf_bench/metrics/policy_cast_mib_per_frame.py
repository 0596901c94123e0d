"""MiB a frame that the bf16 activation policy's casts read and write
(the port's ``policy cast bytes`` counter over 2**20), in the traced
GOP: the port's telemetry, which counts only while the profiler runs.
None for a port without it."""


def read(rec):
    try:
        from learned_pmctf_tpu_torch import telemetry
    except ImportError:
        return None
    nbytes = telemetry.snapshot()["counters"].get("policy cast bytes")
    return nbytes / 2 ** 20 / rec["traced"]["frames_traced"] if nbytes else None
