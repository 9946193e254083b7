"""Mean host ms a query batch spends decoding its verdicts, from the
copy's return to the results stored
(``serving.stage_ms{stage=decode}``)."""


def read(rec):
    count, total = rec.hist("serving.stage_ms", stage="decode")
    return total / count if count else None
