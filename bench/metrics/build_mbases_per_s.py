"""Genome bases indexed in the window (whole archive passes) over the
window's time, host clock, in millions a second."""


def read(rec):
    bases = rec.outcome.get("bases")
    return None if bases is None else bases / 1e6 / rec.window_s
