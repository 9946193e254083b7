"""Probe planners and executors of the ``gather_planned_rows`` and
``probe_planned_bits`` kernels.

Both kernels take the probe stream in probe order and AND over η
themselves, so no run plan reaches the card.

* :func:`compact_probe_plan` — the serve path's plan, built on the
  matrix's device: the stream itself (the kernels' operand) and the
  reference planner's counters (``n_runs``, ``n_probes``;
  :meth:`CompactProbePlan.run_lengths` on demand, for the parity tests),
  so the ``locality.*`` counters stay the reference's; on a CUDA stream
  one ``probe_plan_counts`` launch and one host wait.
* :func:`plan_probe_runs` — the reference's numpy planner, verbatim and
  held by its parity tests; off the serve path. :func:`gather_planned_rows`
  and :func:`probe_membership` execute its plans all the same: their valid
  lanes go back into probe order on the device (:func:`probe_order`) and
  one kernel launch follows.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels.idl_probe import kernel, ref
from repro_torch.kernels.idl_probe.kernel import CompactProbePlan


@dataclasses.dataclass
class ProbePlan:
    block_ids: np.ndarray    # (R,) int32
    offsets: np.ndarray      # (R, C) int32, -1 padded
    run_lengths: np.ndarray  # (R,) int32 probes per run (== row-wise count
                             # of valid offsets, precomputed at plan time
                             # so telemetry never re-reduces the (R, C)
                             # offset matrix)
    probe_index: np.ndarray  # (R, C) int32 position in flattened (η·n) stream
    gather_index: np.ndarray # (n_probes,) int32 flat (run, lane) per probe —
                             # the inverse of probe_index, so executors can
                             # realign with a cheap gather instead of a
                             # scatter over padded lanes
    n_probes: int
    eta: int
    n_keys: int
    block_bits: int
    probes_per_run: int

    @property
    def n_runs(self) -> int:
        return int(self.block_ids.shape[0])
    # NOTE: per-run DMA bytes depend on the probed matrix's row width,
    # which the plan does not know — see QueryPlan.run_dma_bytes.


def plan_probe_runs(
    locs: np.ndarray, block_bits: int, probes_per_run: int = 128
) -> ProbePlan:
    """Run-length-encode (P, n) probe streams into block-resident runs.

    ``locs`` may be bit locations (``block_bits`` = bits per block, the
    original flat-BF use) or matrix row indices (``block_bits`` = rows per
    block — the generalized ``probe_rows`` path); the arithmetic is
    identical. Leading rows (hash repetitions, or batch × η streams) are
    planned independently and concatenated, so a run never crosses streams.
    Runs longer than C are split.
    """
    locs = np.asarray(locs, dtype=np.int64)
    if locs.ndim == 1:
        locs = locs[None, :]
    p, n = locs.shape
    c = probes_per_run

    # Vectorized over ALL streams at once (no per-stream Python loop): the
    # whole (P, n) probe stream is planned in a handful of cumsum passes,
    # which is what lets a (B·η, n_kmers) batch plan in ~ms on the host.
    flat = locs.reshape(-1)
    blocks = flat // block_bits
    idx = np.arange(p * n, dtype=np.int64)
    start = np.empty(p * n, dtype=bool)
    start[0] = True
    np.not_equal(blocks[1:], blocks[:-1], out=start[1:])
    start[:: n] = True                       # a run never crosses streams
    pos_in_run = idx - np.maximum.accumulate(np.where(start, idx, 0))
    # new segment at a run start or every C probes (split long runs); run
    # keys are nondecreasing along the stream so a cumsum IS the inverse
    # np.unique used to compute
    seg = np.cumsum(start | (pos_in_run % c == 0)) - 1
    n_runs = int(seg[-1]) + 1
    pos = pos_in_run % c

    offs = np.full((n_runs, c), -1, dtype=np.int32)
    pidx = np.full((n_runs, c), -1, dtype=np.int32)
    offs[seg, pos] = (flat % block_bits).astype(np.int32)
    pidx[seg, pos] = idx.astype(np.int32)
    bids = np.zeros(n_runs, dtype=np.int32)
    bids[seg] = blocks.astype(np.int32)

    return ProbePlan(
        block_ids=bids,
        offsets=offs,
        run_lengths=np.bincount(seg, minlength=n_runs).astype(np.int32),
        probe_index=pidx,
        gather_index=(seg * c + pos).astype(np.int32),
        n_probes=p * n,
        eta=p,
        n_keys=n,
        block_bits=block_bits,
        probes_per_run=c,
    )


def compact_probe_plan(
    rows: torch.Tensor, block_bits: int, probes_per_run: int = 128
) -> CompactProbePlan:
    """The compact plan of a (..., n) int64 probe stream, on its device.

    ``rows`` holds row indices (``block_bits`` = rows per block) or bit
    locations (``block_bits`` = bits per block); leading dims are streams,
    planned independently as :func:`plan_probe_runs` plans them, so the
    run count and run lengths equal its own. The stream is never copied to
    the host: on a CUDA tensor one ``probe_plan_counts`` launch computes
    the run count and the smallest and largest element, and the host waits
    once, to read them. Each plan counts in ``index.probe_plans{path=
    kernel}`` (a CUDA stream) or ``{path=plain}`` (a CPU one).
    """
    rows = rows.to(torch.int64)
    if rows.dim() == 1:
        rows = rows[None]
    rows = rows.contiguous()
    n_runs, lo, hi = 0, None, None
    if rows.numel():
        n_runs, lo, hi = kernel.plan_counts(
            rows, block_bits, probes_per_run).tolist()
    kernel.count("index.probe_plans",
                 "plain" if rows.device.type == "cpu" else "kernel")
    return CompactProbePlan(
        rows=rows, n_probes=rows.numel(), n_runs=n_runs,
        eta=math.prod(rows.shape[:-1]), n_keys=rows.shape[-1], min_row=lo,
        max_row=hi, block_bits=block_bits, probes_per_run=probes_per_run)


def probe_order(plan: ProbePlan, n_blocks: int, device) -> torch.Tensor:
    """The (eta, n_keys) int64 probe stream a run plan encodes, on
    ``device``: ``block_ids[r] * block_bits + offsets[r, c]`` at
    ``probe_index[r, c]`` for every valid lane (pad lanes are -1); raises
    if a run names a block past the last of ``n_blocks``."""
    if plan.n_runs and int(plan.block_ids.max()) >= n_blocks:
        raise ValueError("plan names a block outside the matrix")
    bids, offs, pidx = (torch.as_tensor(a, device=device) for a in
                        (plan.block_ids, plan.offsets, plan.probe_index))
    valid = offs >= 0
    stream = torch.empty((plan.n_probes,), dtype=torch.int64, device=device)
    stream[pidx[valid].to(torch.int64)] = \
        (bids.to(torch.int64)[:, None] * plan.block_bits + offs)[valid]
    return stream.view(plan.eta, plan.n_keys)


def gather_planned_rows(matrix: torch.Tensor, plan: ProbePlan) -> torch.Tensor:
    """Execute a row plan; return (n_probes, W) int32 rows in probe order.

    ``plan.block_bits`` is read as rows-per-block. ``matrix`` may be 1-D
    when ``W == 1``. The plan's rows go back into probe order and the row
    kernel gathers them as keys of one repetition each (one launch on a
    CUDA matrix; the plain version on a CPU one).
    """
    w = int(matrix.shape[-1]) if matrix.dim() > 1 else 1
    matrix = matrix.reshape(-1, w)
    rpb = plan.block_bits
    if matrix.shape[0] % rpb:
        raise ValueError(
            f"rows_per_block={rpb} must divide n_rows={matrix.shape[0]}")
    rows = probe_order(plan, matrix.shape[0] // rpb, matrix.device)
    return kernel.gather_planned_rows(matrix, rows.reshape(1, -1))


def probe_membership(bf_words: torch.Tensor,
                     plan: ProbePlan | CompactProbePlan) -> torch.Tensor:
    """Probe the packed (n_words,) int32 flat filter at a plan's bit
    locations; return (n_keys,) bool membership (AND over η). A run plan's
    lanes go back into probe order first; a compact plan is the stream
    itself. One kernel launch on a CUDA filter; the plain version on a CPU
    one."""
    if isinstance(plan, ProbePlan):
        block_words = plan.block_bits // 32
        if bf_words.shape[0] % block_words:
            raise ValueError("bf length must be a multiple of block_words")
        plan = probe_order(plan, bf_words.shape[0] // block_words,
                           bf_words.device)
    return kernel.probe_planned_bits(bf_words, plan) == 1


def scatter_and_reduce(bits: torch.Tensor, plan: ProbePlan) -> torch.Tensor:
    """(R, C) run bits -> (n_keys,) membership via the plan's probe_index
    (pad lanes are dropped)."""
    flat = ref.scatter_probe_order(
        bits, torch.as_tensor(plan.probe_index, device=bits.device),
        plan.n_probes)
    return (flat.view(plan.eta, plan.n_keys) == 1).all(dim=0)
