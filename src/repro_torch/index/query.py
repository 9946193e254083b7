"""The shared query-execution layer: one planned probe path.

Port of :mod:`repro.index.query` (row and bit probes, the plain and the
planned backend, the probe dedup path, and the coverage reductions). Every
query is a row gather over a packed ``(n_rows, W)`` int32 bit-matrix
followed by an AND over the η hash repetitions:

======================  ==========================  =====================
Engine                  Probed matrix               Probe kind
======================  ==========================  =====================
``PackedBloomIndex``    ``(m/32, 1)`` word column   bit  (row = loc>>5)
``RamboIndex``          ``(m/32, R·B)`` transpose   bit  (row = loc>>5)
``CobsIndex`` group     ``(m_g, ⌈F_g/32⌉)``         row  (row = loc)
``BitSlicedIndex``      ``(m, ⌈F/32⌉)``             row  (row = loc)
======================  ==========================  =====================

A :class:`QueryPlan` holds everything static and is built once per
geometry through an LRU cache (:func:`plan_query`). Executing a plan picks
one of three backends:

* ``"torch"``     — the plain gather (the port of the reference's ``"jnp"``);
* ``"idl_probe"`` — the compact plan built on the matrix's device (the
  batch's probe stream and the reference planner's counters) + one CUDA
  kernel launch that gathers and ANDs over η: ``gather_planned_rows`` for
  row probes, ``probe_planned_bits`` for bit probes of rows of at most
  :data:`PROBE_BITS_MAX_WORDS` words (the flat filter) and the gather's
  bit mode ``gather_planned_bits`` for bit probes of wider rows (RAMBO);
  on a CPU matrix, the kernel's plain version. The reference's numpy run
  planner stays as :meth:`QueryPlan.plan_runs`, off this path;
* ``"sharded"``   — the reference's ``shard_map`` executor over a 1-D mesh,
  here a tuple of ``torch.device`` objects (:func:`default_mesh`: every visible
  CUDA device for a CUDA matrix, ``(cpu,)`` for a CPU one). Each shard's
  body runs on its own device as a plain gather: bit probes split the
  rows and sum their per-shard miss counts on the mesh's first device (the
  reference's ``psum``), row probes split the file words and concatenate.

``execute(..., dedup=True)`` probes each distinct kmer of the batch once,
in the reference's order (see :meth:`QueryPlan._execute_dedup`), and
gathers the answers back: the same answers, and the same ``locality.*``
counters as the reference's dedup path.

All backends are bit-identical to each other and to the reference
(``tests/test_torch_index.py``, ``tests/test_torch_engines.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import idl as idl_mod
from repro_torch.core.hashing import to_int32_bits
from repro_torch.index import packed
from repro_torch.kernels.idl_probe import kernel as probe_kernel
from repro_torch.kernels.idl_probe import ops as probe_ops
from repro_torch.kernels.idl_probe.ref import and_reduce
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

BACKENDS = ("torch", "idl_probe", "sharded")


def record_locality(*, scheme: str, op: str, tile_bytes: int, n_runs: int,
                    n_probes: int) -> None:
    """Feed one executed probe/insert plan into the process registry:
    planned tile bytes (the quantity IDL minimizes) and the run, probe and
    batch totals. Called once per executed batch on the planned backends
    (``idl_probe`` / ``idl_insert``)."""
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
        )
    c_bytes, c_runs, c_probes, c_batches = handles
    c_bytes.inc(tile_bytes)
    c_runs.inc(n_runs)
    c_probes.inc(n_probes)
    c_batches.inc()


_LOCALITY_HANDLES: dict = {}


def record_stage(op: str, stage: str, t0: float) -> float:
    """Add the host milliseconds since ``t0`` (an ``obs.trace.now()``
    reading) to the ``planner.stage_ms`` histogram of (op, stage); returns
    the current reading, the next stage's ``t0``.

    The planned backends time three stages of every batch, a query's and
    an insert's of the same names: ``locations`` (the hashing enqueued on
    the device; no wait), ``device_plan`` (the compact plan's counters on
    the matrix's device; the host waits for the hashing and the plan: once
    for a query, for its run count and bounds read together, four times
    for an insert's sort and counts) and ``launch`` (the kernel's launch,
    with no wait; the kernel itself runs on asynchronously). The archive
    builder times its own under ``op="build"`` (``ingest.build_archive``).
    """
    timer = _STAGE_TIMERS.get(op)
    if timer is None:
        timer = _STAGE_TIMERS[op] = obs_metrics.StageTimer(
            "planner.stage_ms", tier="planner", op=op)
    return timer.lap(stage, t0)


_STAGE_TIMERS: dict = {}


def as_reads(reads, device) -> torch.Tensor:
    """(B, read_len) uint8 reads on ``device`` from a tensor or array-like
    (a single 1-D read becomes a batch of one)."""
    if isinstance(reads, torch.Tensor):
        reads = reads.to(device=device, dtype=torch.uint8)
    else:
        reads = torch.as_tensor(np.asarray(reads, dtype=np.uint8),
                                device=device)
    return reads[None] if reads.dim() == 1 else reads


def batch_locations(reads: torch.Tensor, *, cfg: idl_mod.IDLConfig,
                    scheme: str, lane32: bool) -> torch.Tensor:
    """(B, η, n_kmers) int64 locations of a read batch: the one location
    body the insert path (:mod:`repro_torch.index.packed`) uses too."""
    return packed.batch_locations(cfg, reads, scheme, lane32=lane32)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def read_kmers(reads: np.ndarray, k: int) -> np.ndarray:
    """(B, read_len) uint8 reads -> (B·n_kmers, k) stride-1 kmer rows (the
    host key of every dedup and cache path)."""
    arr = np.asarray(reads, dtype=np.uint8)
    if arr.ndim == 1:
        arr = arr[None]
    kms = np.lib.stride_tricks.sliding_window_view(arr, k, axis=1)
    return np.ascontiguousarray(kms.reshape(-1, k))


def factor_unique_kmers(
    reads, k: int
) -> tuple[np.ndarray, np.ndarray, tuple[int, int]]:
    """Factor a read batch into its distinct kmers (numpy, on the host).

    Returns ``(uniq, inverse, (b, n_kmers))``: ``uniq`` is ``(U, k)`` uint8
    in lexicographic order and ``inverse`` maps each of the ``b·n_kmers``
    batch kmers to its row in ``uniq``.
    """
    arr = np.asarray(reads, dtype=np.uint8)
    if arr.ndim == 1:
        arr = arr[None]
    b, read_len = arr.shape
    n_k = read_len - k + 1
    flat = read_kmers(arr, k)
    # unique rows via a void byte view: one memcmp sort
    view = flat.view(np.dtype((np.void, k))).ravel()
    _, first, inverse = np.unique(view, return_index=True,
                                  return_inverse=True)
    return flat[first], inverse.reshape(-1), (b, n_k)


def factor_unique_kmers_device(reads: torch.Tensor, k: int):
    """:func:`factor_unique_kmers` on the reads' device: ``(uniq, inverse,
    (b, n_kmers))`` as tensors there. ``torch.unique(dim=0)`` sorts the
    uint8 kmer rows lexicographically, the memcmp order of the reference's
    void-bytes sort, so both return the same ``uniq`` and ``inverse``."""
    b, read_len = reads.shape
    flat = reads.unfold(1, k, 1).reshape(-1, k)
    uniq, inverse = torch.unique(flat, dim=0, return_inverse=True)
    return uniq, inverse, (b, read_len - k + 1)


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
        t0 = obs_trace.now()
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
                backend: str = "torch", dedup: bool = False,
                mesh=None) -> torch.Tensor:
        """(B, n_kmers, W) int32: AND over η of per-probe row values.

        ``bit_probe`` plans extract the probed bit first, so values are
        {0, 1} per word slot; row plans return full AND-ed word masks.
        ``matrix`` may be 1-D when ``W == 1``. ``dedup=True`` probes each
        distinct kmer once through the same backend (the same answers).
        ``mesh`` is the ``"sharded"`` backend's tuple of devices (default
        :func:`default_mesh` of the matrix's device).
        """
        reads = as_reads(reads, matrix.device)
        matrix = matrix.reshape(self.matrix_shape)
        if dedup:
            return self._execute_dedup(matrix, reads, backend, mesh)
        if backend == "torch":
            locs = self.locations(reads)
            rows = matrix[self.row_indices(locs)]
            return _finish_probe(rows, locs, bit_probe=self.bit_probe)
        if backend == "idl_probe":
            return self._execute_idl_probe(matrix, reads)
        if backend == "sharded":
            return self._execute_sharded(matrix, reads, mesh)
        raise ValueError(
            f"unknown query backend {backend!r} (want one of {BACKENDS})")

    def _execute_idl_probe(self, matrix, reads):
        cplan = self.compact_plan(reads)
        record_locality(
            scheme=self.scheme, op="query",
            tile_bytes=self.run_dma_bytes(cplan), n_runs=cplan.n_runs,
            n_probes=cplan.n_probes)
        t0 = obs_trace.now()
        if not self.bit_probe:
            out = probe_kernel.gather_planned_rows(matrix, cplan)
        elif self.row_words <= PROBE_BITS_MAX_WORDS:
            out = probe_kernel.probe_planned_bits(matrix, cplan)
        else:
            out = probe_kernel.gather_planned_bits(matrix, cplan)
        record_stage("query", "launch", t0)
        return out

    def _execute_sharded(self, matrix, reads, mesh):
        """The reference's ``_sharded_executor`` over a tuple of devices.

        Bit probes: shard ``s`` owns rows ``[s·r, (s+1)·r)``, ``r =
        ceil(n_rows / n)``, hashes the batch on its device, reduces its
        local probes to per-(kmer, slot) miss counts over η, and the counts
        sum on the mesh's first device; a hit is zero misses anywhere. Row
        probes: shard ``s`` owns file words ``[s·w, (s+1)·w)``, gathers and
        ANDs over η on its device, and the slices concatenate. A shard
        whose range is empty is skipped; the answer goes to the matrix's
        device.
        """
        mesh = tuple(default_mesh(matrix.device) if mesh is None else mesh)
        n_rows, w = self.matrix_shape
        extent = n_rows if self.bit_probe else w
        per = -(-extent // len(mesh))
        parts = []
        for s, dev in enumerate(mesh):
            lo, hi = s * per, min((s + 1) * per, extent)
            if lo >= hi:
                continue
            locs = self.locations(reads.to(dev))
            if self.bit_probe:
                parts.append(local_miss_counts(
                    matrix[lo:hi].to(dev), locs, lo, hi).to(mesh[0]))
            else:
                mat = matrix[:, lo:hi].to(dev)
                parts.append(and_reduce(mat[locs], dim=1).to(mesh[0]))
        if self.bit_probe:
            out = (sum(parts) == 0).to(torch.int32)
        else:
            out = torch.cat(parts, dim=-1)
        return out.to(matrix.device)

    def _execute_dedup(self, matrix, reads, backend, mesh=None):
        """The unique-kmer probe path, factored on the reads' device.

        Each distinct kmer is probed as a standalone length-k read through
        a derived ``(U_pad, k)`` plan (a kmer's rolling location is a
        function of its own bases), ``U_pad`` the next power of two, the
        pad rows repeating the last distinct kmer; they are probed in
        order of their repetition-0 location (a stable sort), and the
        answers go back through the inverse. The distinct kmers, the pad
        and the sort equal the reference's, so the dedup plan's
        ``locality.*`` counters do too.
        """
        k = self.cfg.k
        uniq, inverse, (b, n_k) = factor_unique_kmers_device(reads, k)
        u_pad = _next_pow2(uniq.shape[0])
        if u_pad > uniq.shape[0]:
            uniq = torch.cat([uniq, uniq[-1:].expand(
                u_pad - uniq.shape[0], k)])
        kplan = plan_query(
            self.cfg, self.scheme, (u_pad, k), self.matrix_shape,
            bit_probe=self.bit_probe, lane32=self.lane32,
            rows_per_block=self.rows_per_block,
            probes_per_run=self.probes_per_run, device=matrix.device)
        locs0 = kplan.locations(uniq)[:, 0, 0]
        order = torch.sort(locs0, stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.numel(), device=order.device)
        vals = kplan.execute(matrix, uniq[order], backend=backend, mesh=mesh)
        return vals[:, 0][rank[inverse]].reshape(b, n_k, vals.shape[-1])


def local_miss_counts(mat: torch.Tensor, locs: torch.Tensor, lo: int,
                      hi: int) -> torch.Tensor:
    """(B, n_kmers, W) int32 misses over η of the bit probes ``locs``
    (B, η, n_kmers) that land in rows ``[lo, hi)``, read from ``mat``, the
    matrix's slice of those rows; the other probes count no miss. Summed
    over every slice of the rows, a kmer hits iff its total is zero."""
    rows = locs >> 5
    local = (rows >= lo) & (rows < hi)
    got = mat[torch.where(local, rows - lo, 0)]           # (B, η, n_k, W)
    bit = (got >> (locs & 31).to(torch.int32)[..., None]) & 1
    miss = torch.where(local[..., None], 1 - bit, 0)
    return miss.sum(dim=1, dtype=torch.int32)


def default_mesh(device="cuda") -> tuple:
    """The ``"sharded"`` backends' 1-D mesh for a matrix on ``device``:
    every visible CUDA device, or ``(cpu,)`` off the card."""
    if torch.device(device).type != "cuda":
        return (torch.device("cpu"),)
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


# Bit probes of rows up to this many words (one 32-byte sector) take
# probe_planned_bits, one thread per key; wider rows take the gather's bit
# mode, a warp per key across the row. The faster of the two at each width
# on an H100 (chip_smoke.py phase 2f; PERF.md).
PROBE_BITS_MAX_WORDS = 8


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


class PlanCacheInfo(NamedTuple):
    """``lru_cache`` stats plus the eviction count of a bounded cache:
    every miss inserts one entry and ``currsize`` counts the kept ones, so
    ``misses - currsize`` were pushed out (both reset on clear)."""

    hits: int
    misses: int
    maxsize: Optional[int]
    currsize: int
    evictions: int


def _with_evictions(info) -> PlanCacheInfo:
    return PlanCacheInfo(
        hits=info.hits, misses=info.misses, maxsize=info.maxsize,
        currsize=info.currsize, evictions=info.misses - info.currsize)


def plan_cache_info() -> PlanCacheInfo:
    """Stats of the (bounded) query-plan cache."""
    return _with_evictions(plan_query.cache_info())


def clear_plan_cache() -> None:
    plan_query.cache_clear()


def _finish_probe(rows: torch.Tensor, locs: torch.Tensor, *,
                  bit_probe: bool) -> torch.Tensor:
    """(B, η, n_k, W) gathered rows -> (B, n_k, W) AND-over-η values."""
    if bit_probe:
        rows = ((rows >> (locs & 31)[..., None].to(torch.int32)) & 1)
    return and_reduce(rows, dim=1)


# ---------------------------------------------------------------------------
# Shared coverage reductions (MSMT postludes).
# ---------------------------------------------------------------------------

def coverage_need(theta: float, n_kmers):
    """Integer hit threshold for kmer-coverage >= theta (exact at 1.0):
    an ``int`` for an ``int`` kmer count, an int64 array (one threshold
    each) for an integer array of them."""
    if isinstance(n_kmers, np.ndarray):
        return np.ceil(theta * n_kmers - 1e-9).astype(np.int64)
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
