"""Wrappers of the CUDA kernel ``csrc/insert_planned.cu`` and its operand.

The one kernel, a scatter-OR of flat bit positions, replaces two Pallas
kernels, each with its own wrapper and launch counter:
:func:`insert_planned` replaces ``insert_runs`` and its tile write-back
(``ref.apply_tiles_to_matrix``); :func:`insert_rounds` replaces the flat
filter's ``insert_round`` and its write-back (``ref.apply_insert_to_words``)
and flattens the rounds plan's valid lanes into positions on the device
(:func:`lane_positions`). The main path's operand is a
:class:`CompactInsertPlan`: its positions are sorted, so its largest one is
on the host; any other operand's largest position is read from the device.
A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
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

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p]


@dataclasses.dataclass
class CompactInsertPlan:
    """A batch's sorted unique bit positions on the device, with the
    reference planner's counters (built by ``ops.compact_insert_plan``)."""

    positions: torch.Tensor     # (n_locs,) int64, sorted unique, >= 0
    block_counts: torch.Tensor  # (n_tiles,) int64 positions per touched
                                # row block, in block order
    n_locs: int                 # deduplicated insert count
    n_runs: int                 # runs of <= C inserts (the planner's)
    n_tiles: int                # touched row blocks
    max_position: int           # positions[-1], on the host
    block_bits: int
    inserts_per_run: int

    @property
    def dma_bytes(self) -> int:
        # one tile read + one tile write per touched block, as the planner's
        return 2 * self.n_tiles * (self.block_bits // 8)

    def run_lengths(self) -> np.ndarray:
        """(n_runs,) int32 inserts per run in the planner's run order: each
        block's positions in runs of C, then the remainder. Built on demand
        (a device pass and a copy to the host), for the parity tests; the
        insert path does not call it."""
        c = self.inserts_per_run
        counts = self.block_counts
        runs = (counts + c - 1) // c
        lengths = torch.full((self.n_runs,), c, dtype=torch.int64,
                             device=counts.device)
        lengths[torch.cumsum(runs, 0) - 1] = counts - c * (runs - 1)
        return lengths.to(torch.int32).cpu().numpy()


def lane_positions(block_ids: torch.Tensor, offsets: torch.Tensor,
                   block_bits: int) -> torch.Tensor:
    """The flat int64 positions of a run plan's valid lanes, in lane order,
    on their device: ``block_ids[r] * block_bits + offsets[r, l]`` for every
    ``offsets[r, l] >= 0`` (pad lanes are -1). On a CUDA tensor the host
    waits for the count of valid lanes."""
    keep = offsets >= 0
    return (block_ids.to(torch.int64)[:, None] * block_bits + offsets)[keep]


def insert_planned(
    words: torch.Tensor,
    operand: torch.Tensor | CompactInsertPlan,
) -> torch.Tensor:
    """OR bit ``p & 31`` of word ``p >> 5`` of the int32 ``words`` (any
    shape, contiguous, viewed flat) in place, for every position ``p >= 0``
    of the operand; returns ``words``.

    The operand is a :class:`CompactInsertPlan` (the main path's: sorted
    unique positions, one atomic per touched word, the largest position on
    the host) or a 1-D int64 tensor of positions in any order, duplicates
    and negatives (skipped) allowed, whose largest position is read from
    the device. A position past the words raises before anything is
    written.
    """
    if isinstance(operand, CompactInsertPlan):
        positions, top = operand.positions, operand.max_position
    else:
        positions, top = operand, None
    _check_bound(NAME, words, positions, top)
    if words.device.type == "cpu":
        return ref.insert_planned_ref(words, positions)
    if _launch(NAME, words, positions):
        global launches
        launches += 1
    return words


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
    block_words``-bit block, -1 padded. The plain version applies the
    rounds one by one (block ids are unique within a round); on the card
    the rounds' valid lanes become flat positions (:func:`lane_positions`)
    and the scatter-OR kernel sets them all in one launch, with atomics,
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
    if bf_words.dim() != 1 or offsets.dim() != 2 or \
            block_ids.shape != offsets.shape[:1]:
        raise ValueError(
            f"{ROUNDS_NAME}: bad shapes bf_words {tuple(bf_words.shape)}, "
            f"block_ids {tuple(block_ids.shape)}, offsets "
            f"{tuple(offsets.shape)}")
    positions = lane_positions(block_ids, offsets, 32 * block_words)
    _check_bound(ROUNDS_NAME, bf_words, positions, None)
    if _launch(ROUNDS_NAME, bf_words, positions):
        global round_launches
        round_launches += 1
    return bf_words


def _check_bound(name: str, words: torch.Tensor, positions: torch.Tensor,
                 top: int | None) -> None:
    """Raise unless ``positions`` is 1-D and its largest element (``top``
    when the caller holds it, else read from the device) lies inside the
    words."""
    if positions.dim() != 1:
        raise ValueError(f"{name}: positions must be 1-D, got shape "
                         f"{tuple(positions.shape)}")
    if positions.shape[0] == 0:
        return
    if top is None:
        top = int(positions.max())
    if top >= 32 * words.numel():
        raise ValueError(f"{name}: position {top} lies past the "
                         f"{words.numel()} words")


def _launch(name: str, words: torch.Tensor, positions: torch.Tensor) -> bool:
    """Launch the kernel over ``positions`` (bounds already checked) on the
    words' current stream; False when there is nothing to launch. Reads
    nothing from the device, so a CUDA graph can capture it."""
    build.check_operands(name, words=words)
    if positions.device != words.device or positions.dtype != torch.int64 \
            or not positions.is_contiguous():
        raise ValueError(
            f"{name}: positions must be contiguous int64 on {words.device}, "
            f"got {positions.dtype} on {positions.device} "
            f"(contiguous={positions.is_contiguous()})")
    n = positions.shape[0]
    if n:
        build.launch(NAME, _ARGTYPES, words.device, words.data_ptr(),
                     positions.data_ptr(), n)
    return n > 0
