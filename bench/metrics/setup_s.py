"""Set-up time: process start to the first timed operation (archive,
index, kernel builds and loads, warm-up), host clock."""


def read(rec):
    return rec.setup_s
