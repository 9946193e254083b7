"""The insert's share of its roofline: the least time its batches need
(each 32-byte sector their bits land in, read and written once, from the
reference's locations, at 3.35 TB/s) over the device time of the kernels
named here in the profiled window, in %."""

from harness import counts

KERNEL = "insert_planned_kernel"


def read(rec):
    if rec.device is None:
        return None
    seconds, launches = rec.device.seconds_of(KERNEL)
    nbytes = rec.work_value("insert_bytes")
    if not launches or nbytes is None:
        return None
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / seconds
