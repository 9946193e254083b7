"""Mean host ms a query batch spends in ``_finalize``'s copy back: the
host waiting for the device, and the copy
(``serving.stage_ms{stage=wait}``)."""


def read(rec):
    count, total = rec.hist("serving.stage_ms", stage="wait")
    return total / count if count else None
