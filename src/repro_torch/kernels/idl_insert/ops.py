"""Insert planners, the card's compact plan, and executors of the
``insert_planned`` kernel.

The kernel's operand is compact: a 1-D int64 tensor of flat bit positions
(``(row * W + word) * 32 + bit``) into the packed words, viewed flat. No
run plan, pad lane or tile reaches the kernel.

* :func:`compact_insert_plan` — the ingest path's plan, built on the
  matrix's device with torch ops alone: the batch's positions sorted and
  deduplicated (``torch.unique``), then counted per row block
  (``torch.unique_consecutive``). Its counters (``n_locs``, ``n_runs``,
  ``n_tiles``, ``dma_bytes``; :meth:`CompactInsertPlan.run_lengths` on
  demand, for the parity tests) equal the reference planner's, so the
  ``locality.*`` counters stay the reference's; its sorted positions are
  the kernel's operand.
* :func:`plan_insert_runs` and :func:`plan_insert_rounds` — the reference's
  two numpy planners, verbatim and held by their parity tests. The run plan
  (TPU layout: 128 lanes per run, -1 padded, pow2 pad runs) and the legacy
  rounds plan of the flat filter (block ids unique per round, one TPU
  launch per round) are no longer on the ingest path.
  :func:`insert_planned` and :func:`insert_with_plan` execute them all the
  same, in one launch of the same kernel: their valid lanes become flat
  positions on the device (``kernel.lane_positions``; the kernel's atomics
  need no rounds).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.idl_insert import kernel
from repro_torch.kernels.idl_insert.kernel import CompactInsertPlan


@dataclasses.dataclass
class InsertPlan:
    """The legacy rounds plan of the flat filter."""

    rounds: list[tuple[np.ndarray, np.ndarray]]  # [(block_ids (R,), offsets (R, C))]
    block_bits: int
    inserts_per_round: int
    n_locs: int

    @property
    def n_tiles(self) -> int:
        return sum(int(b.shape[0]) for b, _ in self.rounds)

    @property
    def dma_bytes(self) -> int:
        # read + write one tile per scheduled block
        return 2 * self.n_tiles * (self.block_bits // 8)


def plan_insert_rounds(
    locs: np.ndarray, block_bits: int, inserts_per_round: int = 128
) -> InsertPlan:
    flat = np.asarray(locs, dtype=np.int64).reshape(-1)
    c = inserts_per_round
    blocks = flat // block_bits
    offsets = (flat % block_bits).astype(np.int32)
    order = np.argsort(blocks, kind="stable")
    blocks_s = blocks[order]
    offsets_s = offsets[order]
    # segment boundaries per block
    uniq, starts = np.unique(blocks_s, return_index=True)
    ends = np.append(starts[1:], len(blocks_s))
    counts = ends - starts
    max_rounds = int(np.ceil(counts.max() / c)) if len(counts) else 0
    rounds = []
    for r in range(max_rounds):
        sel = counts > r * c
        bids = uniq[sel].astype(np.int32)
        offs = np.full((len(bids), c), -1, dtype=np.int32)
        for i, (s, e) in enumerate(zip(starts[sel], ends[sel])):
            lo = s + r * c
            hi = min(e, lo + c)
            offs[i, : hi - lo] = offsets_s[lo:hi]
        rounds.append((bids, offs))
    return InsertPlan(
        rounds=rounds, block_bits=block_bits,
        inserts_per_round=c, n_locs=len(flat),
    )


def insert_with_plan(bf_words: torch.Tensor, plan: InsertPlan
                     ) -> torch.Tensor:
    """OR a rounds plan's bits into the packed (n_words,) int32 flat filter
    in place; returns ``bf_words``. The rounds go to the device together:
    one kernel launch on a CUDA filter, the plain version round by round on
    a CPU one."""
    if not plan.rounds:
        return bf_words
    block_words = plan.block_bits // 32
    if bf_words.shape[0] % block_words:
        raise ValueError("bf length must be a multiple of block_words")
    bids = np.concatenate([b for b, _ in plan.rounds])
    if int(bids.max()) >= bf_words.shape[0] // block_words or bids.min() < 0:
        raise ValueError("plan names a block outside the filter")
    offs = np.concatenate([o for _, o in plan.rounds])
    starts = np.cumsum([0] + [b.shape[0] for b, _ in plan.rounds[:-1]])
    dev = bf_words.device
    return kernel.insert_rounds(
        bf_words, torch.as_tensor(bids, device=dev),
        torch.as_tensor(offs, device=dev), block_words=block_words,
        round_starts=tuple(int(s) for s in starts))


_PAD_BLOCK = np.int32(np.iinfo(np.int32).max)  # never a real block id


@dataclasses.dataclass
class InsertRunPlan:
    """One-launch, sorted-run plan over a flattened (rows*W*32)-bit space."""

    block_ids: np.ndarray    # (R_pad,) int32 row-block per run, nondecreasing
    slot_ids: np.ndarray     # (R_pad,) int32 output tile slot, nondecreasing
    offsets: np.ndarray      # (R_pad, C) int32 tile bit offsets, -1 padded
    run_lengths: np.ndarray  # (n_runs,) int32 inserts per true run
                             # (precomputed at plan time so telemetry never
                             # re-reduces the (R_pad, C) offset matrix)
    uniq_blocks: np.ndarray  # (S_pad,) int32 touched blocks, sorted unique,
                             # padded with _PAD_BLOCK (dropped at write-back)
    n_locs: int              # deduplicated insert count
    n_runs: int              # true run count (before pow2 padding)
    n_tiles: int             # true touched-block count (before pow2 padding)
    block_bits: int          # bits per tile (rows_per_block * W * 32)
    inserts_per_run: int

    @property
    def n_slots(self) -> int:
        """Pow2-padded output tile count (the executor's static shape)."""
        return int(self.uniq_blocks.shape[0])

    @property
    def dma_bytes(self) -> int:
        # one tile read + one tile write per touched block, for the batch
        return 2 * self.n_tiles * (self.block_bits // 8)


def plan_insert_runs(
    flat_bits: np.ndarray, block_bits: int, inserts_per_run: int = 128
) -> InsertRunPlan | None:
    """Sort + dedup flat bit positions, run-length encode by block.

    ``flat_bits``: any-shape int array of global bit positions within the
    flattened matrix (``(row * W + word) * 32 + bit``); int64 on the host,
    so arbitrarily large matrices are fine. Negative positions are dropped
    (masked inserts). Returns None when nothing survives.

    Both data-dependent sizes are padded to powers of two so the
    executor's compile cache stays small: the run count (pad runs are
    all-pad lanes of the last block/slot — bit-exact no-ops) and the
    output tile count (pad slots carry the ``_PAD_BLOCK`` sentinel and
    are dropped by the write-back scatter).
    """
    flat = np.asarray(flat_bits, dtype=np.int64).reshape(-1)
    flat = np.unique(flat[flat >= 0])        # sorted + deduplicated
    n = int(flat.shape[0])
    if n == 0:
        return None
    c = inserts_per_run
    blocks = flat // block_bits
    idx = np.arange(n, dtype=np.int64)
    start = np.empty(n, dtype=bool)
    start[0] = True
    np.not_equal(blocks[1:], blocks[:-1], out=start[1:])
    pos_in_block = idx - np.maximum.accumulate(np.where(start, idx, 0))
    # new run at a block start or every C inserts (split long runs); block
    # keys are nondecreasing so a cumsum numbers runs and slots directly
    run = np.cumsum(start | (pos_in_block % c == 0)) - 1
    slot = np.cumsum(start) - 1
    n_runs = int(run[-1]) + 1
    r_pad = 1 << max(n_runs - 1, 1).bit_length()
    pos = pos_in_block % c

    offs = np.full((r_pad, c), -1, dtype=np.int32)
    offs[run, pos] = (flat % block_bits).astype(np.int32)
    uniq = blocks[start].astype(np.int32)
    bids = np.full(r_pad, uniq[-1], dtype=np.int32)
    bids[run] = blocks.astype(np.int32)
    sids = np.full(r_pad, len(uniq) - 1, dtype=np.int32)
    sids[run] = slot.astype(np.int32)
    n_tiles = len(uniq)
    s_pad = 1 << max(n_tiles - 1, 1).bit_length()
    uniq = np.concatenate(
        [uniq, np.full(s_pad - n_tiles, _PAD_BLOCK, dtype=np.int32)])

    return InsertRunPlan(
        block_ids=bids, slot_ids=sids, offsets=offs, uniq_blocks=uniq,
        run_lengths=np.bincount(run, minlength=n_runs).astype(np.int32),
        n_locs=n, n_runs=n_runs, n_tiles=n_tiles,
        block_bits=block_bits, inserts_per_run=c,
    )


def compact_insert_plan(
    flat_bits: torch.Tensor, block_bits: int, inserts_per_run: int = 128
) -> CompactInsertPlan | None:
    """The compact plan of a batch's flat bit positions, on their device.

    ``flat_bits``: any-shape int64 tensor of positions in the flattened
    matrix, where ``InsertPlan.targets`` leaves them; negative positions are
    dropped (masked inserts). Returns None when nothing survives, as
    :func:`plan_insert_runs` does. On a CUDA tensor the host waits for the
    device three times: at the mask, at ``torch.unique`` and at
    ``torch.unique_consecutive`` (each learns an output size), and once more
    for the run count and the last position, read together.
    """
    flat = flat_bits.reshape(-1).to(torch.int64)
    positions = torch.unique(flat[flat >= 0])       # sorted + deduplicated
    n = int(positions.shape[0])
    if n == 0:
        return None
    _, counts = torch.unique_consecutive(positions // block_bits,
                                         return_counts=True)
    c = inserts_per_run
    n_runs, top = torch.stack(
        [((counts + c - 1) // c).sum(), positions[-1]]).tolist()
    return CompactInsertPlan(
        positions=positions, block_counts=counts, n_locs=n, n_runs=n_runs,
        n_tiles=int(counts.shape[0]), max_position=top,
        block_bits=block_bits, inserts_per_run=c,
    )


def insert_planned(matrix: torch.Tensor,
                   plan: CompactInsertPlan | InsertRunPlan | None
                   ) -> torch.Tensor:
    """OR a plan's bits into the packed (n_rows, W) ``matrix`` in place
    (one kernel launch on a CUDA matrix); returns ``matrix``. ``matrix`` may
    be 1-D when ``W == 1``. A run plan's true runs (its pow2 pad runs are
    all pad lanes) go to the matrix's device, where their valid lanes
    become flat positions."""
    if plan is None:
        return matrix
    if isinstance(plan, CompactInsertPlan):
        return kernel.insert_planned(matrix, plan)
    r = plan.n_runs
    block_ids, offsets = (torch.as_tensor(a[:r], device=matrix.device)
                          for a in (plan.block_ids, plan.offsets))
    return kernel.insert_planned(
        matrix, kernel.lane_positions(block_ids, offsets, plan.block_bits))
