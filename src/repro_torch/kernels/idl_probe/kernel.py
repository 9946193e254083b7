"""Wrappers of the CUDA kernels ``csrc/gather_planned_rows.cu`` and
``csrc/probe_planned_bits.cu``.

``gather_planned_rows`` replaces the Pallas kernel
``repro/kernels/idl_probe/kernel.py::probe_rows`` and its ``gather_index``
realignment; ``probe_planned_bits`` replaces the flat-filter Pallas kernel
``probe_runs`` and the probe-order scatter of ``ops.scatter_and_reduce``.
A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.idl_probe import ref

NAME = "gather_planned_rows"
SOURCE = "src/repro_torch/csrc/gather_planned_rows.cu"
REPLACES = "src/repro/kernels/idl_probe/kernel.py:99"

BITS_NAME = "probe_planned_bits"
BITS_SOURCE = "src/repro_torch/csrc/probe_planned_bits.cu"
BITS_REPLACES = "src/repro/kernels/idl_probe/kernel.py:149"

# Kernel launches so far, one counter per kernel (reset and read by callers
# that must show the kernel ran); they count launches only, never the plain
# versions.
launches = 0        # gather_planned_rows
bits_launches = 0   # probe_planned_bits

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BITS_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
    ctypes.c_longlong, ctypes.c_void_p]


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
    build.launch(NAME, _ARGTYPES, matrix.device, matrix.data_ptr(),
                 block_ids.data_ptr(), offsets.data_ptr(),
                 probe_index.data_ptr(), out.data_ptr(), n_runs, c,
                 rows_per_block, matrix.shape[1])
    global launches
    launches += 1
    return out


def probe_planned_bits(
    bf_words: torch.Tensor,
    block_ids: torch.Tensor,
    offsets: torch.Tensor,
    probe_index: torch.Tensor,
    *,
    block_words: int,
    n_probes: int,
) -> torch.Tensor:
    """(n_probes,) int32 bits of the packed flat filter in probe order.

    ``bf_words`` (n_words,) int32; ``block_ids`` (R,), ``offsets`` (bit
    offsets in a ``32 * block_words``-bit block) and ``probe_index`` (R, C)
    int32, as a ``ProbePlan`` over bit locations lays them out: in each run
    the -1 pad lanes trail the valid ones (the kernel stops a run at its
    first pad lane), and every probe index lies in exactly one valid lane.
    """
    if bf_words.device.type == "cpu":
        return ref.probe_planned_bits_ref(
            bf_words, block_ids, offsets, probe_index,
            block_words=block_words, n_probes=n_probes)
    build.check_operands(BITS_NAME, bf_words=bf_words, block_ids=block_ids,
                         offsets=offsets, probe_index=probe_index)
    n_runs, c = offsets.shape
    if bf_words.dim() != 1 or block_ids.shape != (n_runs,) or \
            probe_index.shape != (n_runs, c):
        raise ValueError(
            f"{BITS_NAME}: bad shapes bf_words {tuple(bf_words.shape)}, "
            f"block_ids {tuple(block_ids.shape)}, offsets "
            f"{tuple(offsets.shape)}, probe_index {tuple(probe_index.shape)}")
    out = torch.empty((n_probes,), dtype=torch.int32, device=bf_words.device)
    if n_runs == 0:
        return out
    build.launch(BITS_NAME, _BITS_ARGTYPES, bf_words.device,
                 bf_words.data_ptr(), block_ids.data_ptr(),
                 offsets.data_ptr(), probe_index.data_ptr(), out.data_ptr(),
                 n_runs, c, block_words)
    global bits_launches
    bits_launches += 1
    return out
