"""Mean host ms a query batch spends filling: from its bucket's queue
going non-empty to the flush, the host's admission of the batch's reads
(``serving.stage_ms{stage=admit}``)."""


def read(rec):
    count, total = rec.hist("serving.stage_ms", stage="admit")
    return total / count if count else None
