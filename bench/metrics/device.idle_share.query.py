"""1 - (the union of the device's kernel, copy and set intervals over the
profiled window), from torch.profiler, in %."""


def read(rec):
    if rec.device is None or not rec.device.events:
        return None
    return 100.0 * (1.0 - rec.device.busy_s / rec.device.window_s)
