"""Mean host ms the archive builder spends a batch cutting sequences into
windows and stacking them: ``planner.stage_ms{op=build}``'s ``window``
and ``batch`` stages, over the ``insert`` count."""


def read(rec):
    inserts, _ = rec.hist("planner.stage_ms", op="build", stage="insert")
    _, window = rec.hist("planner.stage_ms", op="build", stage="window")
    _, batch = rec.hist("planner.stage_ms", op="build", stage="batch")
    return (window + batch) / inserts if inserts else None
