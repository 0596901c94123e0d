"""The whole step's share of the chip's peak: the least time the peak of
the configuration's precision allows for the counted operations of the
window's GOPs, over the window's time (the host's clock), in %. Only the
estimate path's work is counted."""


def read(rec):
    if rec["path"] != "estimate":
        return None
    win = rec["window"]
    return 100.0 * rec["work"]["ops_s"] * win["gops"] / win["seconds"]
