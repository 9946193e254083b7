"""Share of the window's compact probe plans whose counters the
hand-written ``probe_plan_counts`` kernel computed
(``index.probe_plans{path=kernel}``) and not the plain version
(``{path=plain}``), in percent. None where the program counts no plan (a
program without the counter)."""


def read(rec):
    kernel = rec.counter("index.probe_plans", path="kernel")
    total = kernel + rec.counter("index.probe_plans", path="plain")
    return 100.0 * kernel / total if total else None
