"""The flat filter's bit probe's share of its roofline: the least time its
batches need (the yardstick's bytes, from the reference's locations of
exactly the profiled batches, at 3.35 TB/s) over the device time of the
kernel named here in the profiled window, in %."""

from harness import counts

KERNEL = "probe_bits_kernel"


def read(rec):
    if rec.device is None:
        return None
    seconds, launches = rec.device.seconds_of(KERNEL)
    nbytes = rec.work_value("probe_bytes")
    if not launches or nbytes is None:
        return None
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / seconds
