"""The shared query-execution layer: one planned probe path.

Port of :mod:`repro.index.query` (row and bit probes, the plain and the
planned backend, and the coverage reductions). Every query is a row gather
over a packed ``(n_rows, W)`` int32 bit-matrix followed by an AND over the
η hash repetitions. A :class:`QueryPlan` holds everything static and is
built once per geometry through an LRU cache (:func:`plan_query`).
Executing a plan picks one of two backends:

* ``"torch"``     — the plain gather (the port of the reference's ``"jnp"``);
* ``"idl_probe"`` — the compact plan built on the matrix's device (the
  batch's probe stream and the reference planner's counters) + one CUDA
  kernel launch that gathers and ANDs over η: ``gather_planned_rows`` for
  row probes, ``probe_planned_bits`` for bit probes (on a CPU matrix, the
  kernel's plain version). The reference's numpy run planner stays as
  :meth:`QueryPlan.plan_runs`, off this path.

Both backends are bit-identical to each other and to the reference
(``tests/test_torch_index.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import idl as idl_mod
from repro_torch.core.hashing import to_int32_bits
from repro_torch.index import packed
from repro_torch.kernels.idl_probe import kernel as probe_kernel
from repro_torch.kernels.idl_probe import ops as probe_ops
from repro_torch.kernels.idl_probe.ref import and_reduce
from repro_torch.obs import metrics as obs_metrics

BACKENDS = ("torch", "idl_probe")


def record_locality(*, scheme: str, op: str, tile_bytes: int, n_runs: int,
                    n_probes: int, run_lengths) -> None:
    """Feed one executed probe/insert plan into the process registry:
    planned tile bytes (the quantity IDL minimizes), run/probe totals, and
    the per-run length histogram. Called once per executed batch on the
    planned backends (``idl_probe`` / ``idl_insert``).

    The scalar counters are exact on every batch; the run-length histogram
    is fed from every :data:`_HIST_SAMPLE`-th batch per (scheme, op).
    ``run_lengths`` is an array, or a callable that returns one, called
    only on those batches (the compact insert plan builds it on demand)."""
    reg = obs_metrics.DEFAULT
    if not reg.enabled:
        return
    handles = _LOCALITY_HANDLES.get((scheme, op))
    if handles is None:
        labels = {"tier": "planner", "scheme": scheme, "op": op}
        handles = _LOCALITY_HANDLES[(scheme, op)] = (
            reg.counter("locality.planned_tile_bytes", **labels),
            reg.counter("locality.probe_runs", **labels),
            reg.counter("locality.probes", **labels),
            reg.counter("locality.batches", **labels),
            reg.histogram("locality.run_length", **labels),
        )
    c_bytes, c_runs, c_probes, c_batches, h_runs = handles
    c_bytes.inc(tile_bytes)
    c_runs.inc(n_runs)
    c_probes.inc(n_probes)
    c_batches.inc()
    if int(c_batches.value) % _HIST_SAMPLE == 1 or _HIST_SAMPLE == 1:
        h_runs.observe_array(run_lengths() if callable(run_lengths)
                             else run_lengths)


_LOCALITY_HANDLES: dict = {}


def record_stage(op: str, stage: str, t0: float) -> float:
    """Add the host milliseconds since ``t0`` (a ``time.perf_counter()``
    reading) to the ``planner.stage_ms`` histogram of (op, stage); returns
    the current reading, the next stage's ``t0``.

    The planned backends time three stages of every batch, a query's and
    an insert's of the same names: ``locations`` (the hashing enqueued on
    the device; no wait), ``device_plan`` (the compact plan's counters on
    the matrix's device; the host waits for the hashing and the plan: once
    for a query, for its run count and bounds read together, four times
    for an insert's sort and counts) and ``launch`` (the kernel's launch,
    with no wait; the kernel itself runs on asynchronously)."""
    now = time.perf_counter()
    reg = obs_metrics.DEFAULT
    if reg.enabled:
        hist = _STAGE_HANDLES.get((op, stage))
        if hist is None:
            hist = _STAGE_HANDLES[(op, stage)] = reg.histogram(
                "planner.stage_ms", tier="planner", op=op, stage=stage)
        hist.observe(1e3 * (now - t0))
    return now


_STAGE_HANDLES: dict = {}

# Feed the run-length histogram from every Nth batch (1 = every batch).
_HIST_SAMPLE = 4


def as_reads(reads, device) -> torch.Tensor:
    """(B, read_len) uint8 reads on ``device`` from a tensor or array-like
    (a single 1-D read becomes a batch of one)."""
    if isinstance(reads, torch.Tensor):
        reads = reads.to(device=device, dtype=torch.uint8)
    else:
        reads = torch.as_tensor(np.asarray(reads, dtype=np.uint8),
                                device=device)
    return reads[None] if reads.dim() == 1 else reads


# ---------------------------------------------------------------------------
# The plan.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Static query recipe for one (cfg, scheme, read_shape, matrix) tuple.

    ``bit_probe=True``: locations are flat bit offsets — the probed row is
    ``loc >> 5`` and the answer is bit ``loc & 31`` of every word in that
    row. ``bit_probe=False``: locations are row indices and the answer is
    the whole W-word row (bit-sliced layouts).
    """

    cfg: idl_mod.IDLConfig
    scheme: str
    read_shape: tuple[int, int]       # (B, read_len)
    matrix_shape: tuple[int, int]     # (n_rows, W)
    bit_probe: bool
    lane32: bool
    rows_per_block: int               # run-coalescing tile height
    probes_per_run: int

    @property
    def row_words(self) -> int:
        return self.matrix_shape[1]

    @property
    def block_bytes(self) -> int:
        """Bytes of one run's row block — the quantity IDL minimizes."""
        return self.rows_per_block * self.row_words * 4

    # -- probe streams ------------------------------------------------------
    def locations(self, reads: torch.Tensor) -> torch.Tensor:
        """(B, η, n_kmers) int64 hash locations."""
        return packed.batch_locations(self.cfg, reads, self.scheme,
                                      lane32=self.lane32)

    def row_indices(self, locs: torch.Tensor) -> torch.Tensor:
        """Matrix row probed by each location."""
        return (locs >> 5) if self.bit_probe else locs

    def plan_runs(self, reads: torch.Tensor):
        """The reference's host-side run-length plan for the whole batch
        (numpy; kept for parity, off the serve path).

        Returns ``(ProbePlan, locs)``: locs is the (B, η, n_kmers) location
        tensor the plan was built from, on the reads' device.
        """
        locs = self.locations(reads)
        rows = self.row_indices(locs).cpu().numpy()
        b, eta, n_k = rows.shape
        rplan = probe_ops.plan_probe_runs(
            rows.reshape(b * eta, n_k),
            block_bits=self.rows_per_block,
            probes_per_run=self.probes_per_run,
        )
        return rplan, locs

    def compact_plan(self, reads: torch.Tensor):
        """The compact plan of the batch on the reads' device (what
        ``idl_probe`` executes); times its ``locations`` and
        ``device_plan`` stages. Its stream is the (B, η, n_kmers) row
        indices, or the bit locations of a bit probe (then planned in
        blocks of ``32 * rows_per_block`` bits: the same blocks, so the
        same runs)."""
        t0 = time.perf_counter()
        locs = self.locations(reads)
        t0 = record_stage("query", "locations", t0)
        cplan = probe_ops.compact_probe_plan(
            locs, block_bits=self.rows_per_block * (32 if self.bit_probe
                                                    else 1),
            probes_per_run=self.probes_per_run)
        record_stage("query", "device_plan", t0)
        return cplan

    def run_dma_bytes(self, rplan) -> int:
        """Total row-block bytes the plan covers (n_runs × block_bytes)."""
        return rplan.n_runs * self.block_bytes

    # -- execution ----------------------------------------------------------
    def execute(self, matrix: torch.Tensor, reads, *,
                backend: str = "torch") -> torch.Tensor:
        """(B, n_kmers, W) int32: AND over η of per-probe row values.

        ``bit_probe`` plans extract the probed bit first, so values are
        {0, 1} per word slot; row plans return full AND-ed word masks.
        ``matrix`` may be 1-D when ``W == 1``.
        """
        reads = as_reads(reads, matrix.device)
        matrix = matrix.reshape(self.matrix_shape)
        if backend == "torch":
            locs = self.locations(reads)
            rows = matrix[self.row_indices(locs)]
            return _finish_probe(rows, locs, bit_probe=self.bit_probe)
        if backend == "idl_probe":
            return self._execute_idl_probe(matrix, reads)
        raise ValueError(
            f"unknown query backend {backend!r} (want one of {BACKENDS})")

    def _execute_idl_probe(self, matrix, reads):
        cplan = self.compact_plan(reads)
        record_locality(
            scheme=self.scheme, op="query",
            tile_bytes=self.run_dma_bytes(cplan), n_runs=cplan.n_runs,
            n_probes=cplan.n_probes, run_lengths=cplan.run_lengths)
        t0 = time.perf_counter()
        if self.bit_probe:
            out = probe_kernel.probe_planned_bits(matrix, cplan)
        else:
            out = probe_kernel.gather_planned_rows(matrix, cplan)
        record_stage("query", "launch", t0)
        return out


def _pow2_block(n_rows: int, target: int) -> int:
    """Largest power of two <= target that divides n_rows (floor 1)."""
    blk = 1 << max(int(target).bit_length() - 1, 0)
    while blk > 1 and n_rows % blk:
        blk //= 2
    return max(blk, 1)


# Bounded: a long-lived server planning many geometries must not grow
# this without bound; plans are frozen value objects, so eviction is cheap.
PLAN_CACHE_SIZE = 512


@functools.lru_cache(maxsize=PLAN_CACHE_SIZE)
def plan_query(
    cfg: idl_mod.IDLConfig,
    scheme: str,
    read_shape: tuple[int, int],
    matrix_shape: tuple[int, int],
    *,
    bit_probe: bool,
    lane32: bool = False,
    rows_per_block: Optional[int] = None,
    probes_per_run: Optional[int] = None,
    device="cuda",
) -> QueryPlan:
    """Build (or fetch) the cached plan for one query geometry.

    Defaults are the reference's: ``rows_per_block`` is the IDL window
    ``cfg.L`` in matrix rows (``L/32`` words for bit probes), clamped to a
    power of two that divides ``n_rows`` (at most 512 rows at W = 32);
    ``probes_per_run`` is 128 on an accelerator and 32 on a CPU, read from
    the type of ``device`` (the matrix's device).
    """
    n_rows, row_words = matrix_shape
    if probes_per_run is None:
        probes_per_run = 32 if torch.device(device).type == "cpu" else 128
    if rows_per_block is None:
        if bit_probe:
            target = max(cfg.L // 32, 1)
        else:
            target = max(8, min(cfg.L, (1 << 21) // max(row_words * 128, 1)))
        rows_per_block = _pow2_block(n_rows, target)
    if n_rows % rows_per_block:
        raise ValueError(
            f"rows_per_block={rows_per_block} must divide n_rows={n_rows}")
    return QueryPlan(
        cfg=cfg, scheme=scheme,
        read_shape=tuple(read_shape), matrix_shape=tuple(matrix_shape),
        bit_probe=bit_probe, lane32=lane32,
        rows_per_block=rows_per_block, probes_per_run=probes_per_run,
    )


def _finish_probe(rows: torch.Tensor, locs: torch.Tensor, *,
                  bit_probe: bool) -> torch.Tensor:
    """(B, η, n_k, W) gathered rows -> (B, n_k, W) AND-over-η values."""
    if bit_probe:
        rows = ((rows >> (locs & 31)[..., None].to(torch.int32)) & 1)
    return and_reduce(rows, dim=1)


# ---------------------------------------------------------------------------
# Shared coverage reductions (MSMT postludes).
# ---------------------------------------------------------------------------

def coverage_need(theta: float, n_kmers: int) -> int:
    """Integer hit threshold for kmer-coverage >= theta (exact at 1.0)."""
    return int(np.ceil(theta * n_kmers - 1e-9))


def _need_threshold(theta, n_kmers: int, need, lead_ndim: int, device):
    """``need=None``: the scalar :func:`coverage_need` of the full kmer
    axis; else (B,) per-row thresholds shaped to broadcast over
    ``lead_ndim`` trailing hit dimensions."""
    if need is None:
        return coverage_need(theta, n_kmers)
    need = torch.as_tensor(need, dtype=torch.int64, device=device)
    return need.reshape(need.shape + (1,) * lead_ndim)


def member_coverage(member: torch.Tensor, theta: float = 1.0, *,
                    valid: Optional[torch.Tensor] = None,
                    need=None) -> torch.Tensor:
    """(B, n_kmers[, ...]) bool kmer hits -> (B[, ...]) bool coverage >= θ.

    ``valid`` (B, n_kmers) bool excludes padding kmers from the hit count;
    ``need`` (B,) int gives per-row hit thresholds overriding theta.
    """
    hits = member.to(torch.int64)
    if valid is not None:
        v = torch.as_tensor(valid, device=member.device).to(torch.int64)
        hits = hits * v.reshape(v.shape + (1,) * (member.dim() - 2))
    hits = hits.sum(dim=1)
    return hits >= _need_threshold(theta, member.shape[1], need,
                                   hits.dim() - 1, member.device)


def file_match_mask(per_kmer: torch.Tensor, theta: float = 1.0, *,
                    valid: Optional[torch.Tensor] = None,
                    need=None) -> torch.Tensor:
    """(B, n_kmers, W) int32 kmer file-masks -> (B, W) int32 match mask.

    theta=1: an AND over kmers. theta<1 (or per-row ``need``): per-file
    popcount against the exact integer threshold, the match bits ORed back
    into words. ``valid`` (B, n_kmers) bool neutralizes pad kmers (all-ones
    under AND, zero hits under popcount).
    """
    if valid is not None:
        valid = torch.as_tensor(valid, device=per_kmer.device)
    if theta >= 1.0 and need is None:
        if valid is not None:
            per_kmer = torch.where(valid[..., None], per_kmer, -1)
        return and_reduce(per_kmer, dim=1)
    shifts = torch.arange(32, dtype=torch.int32, device=per_kmer.device)
    bits = (per_kmer[..., None] >> shifts) & 1               # (B, n_k, W, 32)
    if valid is not None:
        bits = bits * valid[..., None, None].to(torch.int32)
    hits = bits.sum(dim=1)                                   # (B, W, 32)
    match = hits >= _need_threshold(theta, per_kmer.shape[1], need,
                                    hits.dim() - 1, per_kmer.device)
    mask = torch.zeros(match.shape[:-1], dtype=torch.int64,
                       device=per_kmer.device)
    for s in range(32):
        mask |= match[..., s].to(torch.int64) << s
    return to_int32_bits(mask)
