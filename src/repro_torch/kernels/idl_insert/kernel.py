"""Wrappers of the CUDA kernel ``csrc/insert_planned.cu``.

The one kernel replaces two Pallas kernels, each with its own wrapper and
launch counter: :func:`insert_planned` replaces ``insert_runs`` and its tile
write-back (``ref.apply_tiles_to_matrix``); :func:`insert_rounds` replaces
the flat filter's ``insert_round`` and its write-back
(``ref.apply_insert_to_words``). A CPU tensor takes the plain version
(:mod:`.ref`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.idl_insert import ref

NAME = "insert_planned"
SOURCE = "src/repro_torch/csrc/insert_planned.cu"
REPLACES = "src/repro/kernels/idl_insert/kernel.py:129"

ROUNDS_NAME = "insert_with_plan"
ROUNDS_REPLACES = "src/repro/kernels/idl_insert/kernel.py:46"

# Kernel launches so far, one counter per wrapper (reset and read by callers
# that must show the kernel ran); they count launches only, never the plain
# versions.
launches = 0         # insert_planned
round_launches = 0   # insert_rounds (the flat filter's insert_with_plan)

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
    _launch(matrix, block_ids, offsets, rows_per_block * matrix.shape[1])
    global launches
    launches += 1
    return matrix


def _launch(words: torch.Tensor, block_ids: torch.Tensor,
            offsets: torch.Tensor, block_words: int) -> None:
    n_runs, c = offsets.shape
    fn = getattr(build.library(NAME, _ARGTYPES), NAME)
    with torch.cuda.device(words.device):
        err = fn(words.data_ptr(), block_ids.data_ptr(), offsets.data_ptr(),
                 n_runs, c, block_words,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")


def insert_rounds(
    bf_words: torch.Tensor,
    block_ids: torch.Tensor,
    offsets: torch.Tensor,
    *,
    block_words: int,
    round_starts: tuple[int, ...],
) -> torch.Tensor:
    """OR the rounds' bits into the packed (n_words,) int32 flat filter in
    place; returns ``bf_words``.

    ``block_ids`` (R,) and ``offsets`` (R, C) int32 are the rounds of a
    legacy ``InsertPlan`` concatenated (round ``i`` starts at run
    ``round_starts[i]``); offsets are bit offsets in a ``32 *
    block_words``-bit block, -1 padded, each run filled from lane 0. The
    plain version applies the rounds one by one (block ids are unique
    within a round); the kernel ORs every run in one launch with atomics,
    which need no rounds.
    """
    if bf_words.device.type == "cpu":
        bounds = list(round_starts) + [offsets.shape[0]]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            tiles = ref.insert_round_ref(
                bf_words, block_ids[lo:hi], offsets[lo:hi],
                block_words=block_words, inserts_per_round=offsets.shape[1])
            ref.apply_insert_to_words(bf_words, block_ids[lo:hi], tiles,
                                      block_words)
        return bf_words
    build.check_operands(ROUNDS_NAME, bf_words=bf_words, block_ids=block_ids,
                         offsets=offsets)
    if bf_words.dim() != 1 or block_ids.shape != offsets.shape[:1]:
        raise ValueError(
            f"{ROUNDS_NAME}: bad shapes bf_words {tuple(bf_words.shape)}, "
            f"block_ids {tuple(block_ids.shape)}, offsets "
            f"{tuple(offsets.shape)}")
    if offsets.shape[0] == 0:
        return bf_words
    _launch(bf_words, block_ids, offsets, block_words)
    global round_launches
    round_launches += 1
    return bf_words
