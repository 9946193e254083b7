"""Wrapper of the CUDA kernel ``csrc/gather_planned_rows.cu``.

Replaces the Pallas kernel ``repro/kernels/idl_probe/kernel.py::probe_rows``
and its ``gather_index`` realignment. A CPU tensor takes the plain version
(:mod:`.ref`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.idl_probe import ref

NAME = "gather_planned_rows"
SOURCE = "src/repro_torch/csrc/gather_planned_rows.cu"
REPLACES = "src/repro/kernels/idl_probe/kernel.py:99"

# Kernel launches so far (reset and read by callers that must show the
# kernel ran); counts launches only, never the plain version.
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def gather_planned_rows(
    matrix: torch.Tensor,
    block_ids: torch.Tensor,
    offsets: torch.Tensor,
    probe_index: torch.Tensor,
    *,
    rows_per_block: int,
    n_probes: int,
) -> torch.Tensor:
    """(n_probes, W) int32 rows of ``matrix`` in probe order.

    ``matrix`` (n_rows, W) int32; ``block_ids`` (R,), ``offsets`` and
    ``probe_index`` (R, C) int32, as a ``ProbePlan`` lays them out: in each
    run the -1 pad lanes trail the valid ones (the kernel stops a run at
    its first pad lane).
    """
    if matrix.device.type == "cpu":
        return ref.gather_planned_rows_ref(
            matrix, block_ids, offsets, probe_index,
            rows_per_block=rows_per_block, n_probes=n_probes)
    build.check_operands(NAME, matrix=matrix, block_ids=block_ids,
                         offsets=offsets, probe_index=probe_index)
    n_runs, c = offsets.shape
    if matrix.dim() != 2 or block_ids.shape != (n_runs,) or \
            probe_index.shape != (n_runs, c):
        raise ValueError(
            f"{NAME}: bad shapes matrix {tuple(matrix.shape)}, block_ids "
            f"{tuple(block_ids.shape)}, offsets {tuple(offsets.shape)}, "
            f"probe_index {tuple(probe_index.shape)}")
    out = torch.empty((n_probes, matrix.shape[1]), dtype=torch.int32,
                      device=matrix.device)
    if n_runs == 0:
        return out
    fn = getattr(build.library(NAME, _ARGTYPES), NAME)
    with torch.cuda.device(matrix.device):
        err = fn(matrix.data_ptr(), block_ids.data_ptr(), offsets.data_ptr(),
                 probe_index.data_ptr(), out.data_ptr(), n_runs, c,
                 rows_per_block, matrix.shape[1],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out
