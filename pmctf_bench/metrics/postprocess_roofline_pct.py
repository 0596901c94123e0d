"""PostProcess's share of its roofline (its 15 convs a call run the
conv3x3 kernel): the least time the peaks allow for its counted convs
over their device time in the traced GOP, in %. Only the estimate path's
work is counted."""


def read(rec):
    device_s = rec["traced"]["layer_device_s"].get("postprocess")
    bound_s = rec["work"]["bound_s"].get("postprocess")
    if rec["path"] != "estimate" or not device_s or not bound_s:
        return None
    return 100.0 * bound_s / device_s
