"""Share of the window's flat-filter probes that the hand-written
``probe_planned_bits`` kernel served (``index.bit_probes{path=kernel}``)
and not its plain version (``{path=plain}``), in percent. None where the
program counts no such probe (a program without the counter)."""


def read(rec):
    kernel = rec.counter("index.bit_probes", path="kernel")
    total = kernel + rec.counter("index.bit_probes", path="plain")
    return 100.0 * kernel / total if total else None
