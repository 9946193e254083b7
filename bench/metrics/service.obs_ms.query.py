"""Mean host ms a query batch spends on the program's own
observability: its counters, stage observations and request spans
(``serving.stage_ms{stage=obs}``)."""


def read(rec):
    count, total = rec.hist("serving.stage_ms", stage="obs")
    return total / count if count else None
