"""Copies from the device to the host a frame (the codec's HostStats
syncs, each a wait for the device's queue), over the window's GOPs."""


def read(rec):
    win = rec["window"]
    if "syncs" not in win["counters"]:
        return None
    return win["counters"]["syncs"] / win["frames"]
