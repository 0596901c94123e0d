"""Device ms a frame of the four-step priors (the kernels launched
inside their spans), in the traced GOP."""


def read(rec):
    t = rec["traced"]
    ms = t["layer_device_s"].get("four-step priors")
    return 1e3 * ms / t["frames_traced"] if ms else None
