"""Reads answered in the window over the window's time, host clock."""


def read(rec):
    reads = rec.outcome.get("reads")
    return None if reads is None else reads / rec.window_s
