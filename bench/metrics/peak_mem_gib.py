"""The program's peak device memory over set-up and window
(``torch.cuda.max_memory_allocated``, reset before set-up, read before the
reference runs), in GiB."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
