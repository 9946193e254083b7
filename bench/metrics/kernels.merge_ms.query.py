"""Device ms a query batch spends in RAMBO's R-fold merge: the R
advanced-index gathers ``grid[:, :, r, assign[r]]`` of
``RamboIndex.query_batch``, over the profiled window's batches.

Each gather is one launch of ATen's ``index_elementwise_kernel`` over 1-byte
(bool) elements, ``gpu_index_kernel<index_kernel_impl<OpaqueType<1> >>``;
KERNEL is that part of its name. Evidence, a traced 51 s run of
``rambo-idl.query`` on an H100 (torch 2.11.0+cu128): 48,000 launches in
4,800 batches, 10 a batch (R), 2.42 ms a batch; no other operation of the
cell's path (the plan, the probe ``gather_and_kernel<int4, true>``,
``member_coverage``'s sum, the decode's copies) holds either fragment. The
build's index gathers are over 8-byte elements (``OpaqueType<8>``). The
R - 1 ANDs (``BitwiseAndFunctor<bool>``) are not counted."""

KERNEL = "index_kernel_impl<at::native::OpaqueType<1> >"


def read(rec):
    if rec.device is None:
        return None
    seconds, launches = rec.device.seconds_of(KERNEL)
    batches = rec.outcome.get("batches")
    if not launches or not batches:
        return None
    return 1e3 * seconds / batches
