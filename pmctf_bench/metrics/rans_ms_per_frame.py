"""Host ms a frame in the rANS coder, encode and decode, summed over the
codec's threads (its HostStats), over the window's GOPs."""


def read(rec):
    win = rec["window"]
    if "rans_s" not in win["counters"]:
        return None
    return 1e3 * win["counters"]["rans_s"] / win["frames"]
