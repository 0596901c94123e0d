"""The four-step priors' share of their roofline: the least time the
peaks allow for their counted convs (each conv the larger of operations
over the peak and bytes over the memory rate), over their device time in
the traced GOP, in %. Only the estimate path's work is counted."""


def read(rec):
    device_s = rec["traced"]["layer_device_s"].get("four-step priors")
    bound_s = rec["work"]["bound_s"].get("four-step priors")
    if rec["path"] != "estimate" or not device_s or not bound_s:
        return None
    return 100.0 * bound_s / device_s
