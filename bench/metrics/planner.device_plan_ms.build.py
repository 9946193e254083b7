"""Mean host ms an insert batch spends in the planner's ``device_plan``
stage (``planner.stage_ms{op=insert,stage=device_plan}``)."""


def read(rec):
    count, total = rec.hist("planner.stage_ms", op="insert",
                            stage="device_plan")
    return total / count if count else None
