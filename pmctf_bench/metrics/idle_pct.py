"""The device's idle share of the traced GOP, in %."""


def read(rec):
    t = rec["traced"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
