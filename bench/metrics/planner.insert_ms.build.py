"""Mean host ms the archive builder spends in an ``insert_batch`` call
(``planner.stage_ms{op=build,stage=insert}``)."""


def read(rec):
    count, total = rec.hist("planner.stage_ms", op="build", stage="insert")
    return total / count if count else None
