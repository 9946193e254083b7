"""Transposed copies of RAMBO's words that the window built
(``index.transposed_copies{engine=rambo}``): the query probes a
``(m/32, R·B)`` copy made once a words tensor, in set-up, so a copy in
the window is 5 GiB of device traffic the query should not pay. None
where the program counts no copy (no RAMBO index, or a program without
the counter)."""


def read(rec):
    series = rec.obs["counters"].get("index.transposed_copies", {})
    if not any("engine=rambo" in lk.split(",") for lk in series):
        return None
    return rec.counter("index.transposed_copies", engine="rambo")
