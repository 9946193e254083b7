"""Mean host ms a query batch spends in RAMBO's R-fold merge, its R
gathers and R - 1 ANDs enqueued with no wait
(``planner.stage_ms{op=query,stage=merge}``)."""


def read(rec):
    count, total = rec.hist("planner.stage_ms", op="query", stage="merge")
    return total / count if count else None
