"""Wrapper of the CUDA kernel ``csrc/insert_planned.cu``.

Replaces the Pallas kernel ``repro/kernels/idl_insert/kernel.py::insert_runs``
and its tile write-back. A CPU tensor takes the plain version (:mod:`.ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.idl_insert import ref

NAME = "insert_planned"
SOURCE = "src/repro_torch/csrc/insert_planned.cu"
REPLACES = "src/repro/kernels/idl_insert/kernel.py:129"

# Kernel launches so far (reset and read by callers that must show the
# kernel ran); counts launches only, never the plain version.
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
    ctypes.c_longlong, ctypes.c_void_p]


def insert_planned(
    matrix: torch.Tensor,
    block_ids: torch.Tensor,
    offsets: torch.Tensor,
    *,
    rows_per_block: int,
) -> torch.Tensor:
    """OR the plan's bits into the (n_rows, W) int32 ``matrix`` in place.

    ``block_ids`` (R,) and ``offsets`` (R, C) int32 as an ``InsertRunPlan``
    lays them out (offsets are tile bit offsets; in each run the -1 pad
    lanes trail the valid ones, and the kernel stops a run at its first pad
    lane). Returns ``matrix``.
    """
    if matrix.device.type == "cpu":
        return ref.insert_planned_ref(matrix, block_ids, offsets,
                                      rows_per_block=rows_per_block)
    build.check_operands(NAME, matrix=matrix, block_ids=block_ids,
                         offsets=offsets)
    n_runs, c = offsets.shape
    if matrix.dim() != 2 or block_ids.shape != (n_runs,):
        raise ValueError(
            f"{NAME}: bad shapes matrix {tuple(matrix.shape)}, block_ids "
            f"{tuple(block_ids.shape)}, offsets {tuple(offsets.shape)}")
    if n_runs == 0:
        return matrix
    fn = getattr(build.library(NAME, _ARGTYPES), NAME)
    with torch.cuda.device(matrix.device):
        err = fn(matrix.data_ptr(), block_ids.data_ptr(), offsets.data_ptr(),
                 n_runs, c, rows_per_block * matrix.shape[1],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    global launches
    launches += 1
    return matrix
