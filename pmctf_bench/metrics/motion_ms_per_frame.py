"""Device ms a frame of SpyNet and the MV coder (the kernels launched
inside their spans), in the traced GOP."""


def read(rec):
    t = rec["traced"]
    ms = t["layer_device_s"].get("motion")
    return 1e3 * ms / t["frames_traced"] if ms else None
