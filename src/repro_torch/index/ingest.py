"""The shared ingest layer: one planned insert path.

Port of :mod:`repro.index.ingest` (plans of every ``kind``, the plain and
the planned backend, the streaming archive builder and its sharded twin
:func:`build_sharded_archive`). Every insert is a
scatter-OR of single bits into a packed ``(n_rows, W)`` int32 bit-matrix,
described by ``(row, word_col, bit)`` targets. Backends:

* ``"torch"``      — the plain sort-dedup scatter (the port of ``"jnp"``);
* ``"idl_insert"`` — the compact plan built on the matrix's device (the
  batch's sorted unique bit positions and the reference planner's
  counters) + the CUDA ``insert_planned`` kernel, one launch per batch (on
  a CPU matrix, the kernel's plain version). The reference's numpy run
  planner stays as :meth:`InsertPlan.plan_runs`, off this path;
* ``"sharded"``    — the reference's ``shard_map`` inserter over a tuple of
  ``torch.device`` objects (``query.default_mesh``): ``"bits"`` plans split the
  rows, the others the word columns; each shard computes the whole
  target stream on its device, keeps its own slice's targets and
  scatters them with the plain scatter. Scatter-OR commutes, so no
  collective is needed.

Both update the matrix **in place** (the reference donates instead);
``donate=False`` scatters into a clone and leaves the input untouched.
``window_min`` (minimizer sub-sampling, :func:`minimizer_mask`) inserts
only each read's window-minimizer kmers, as the reference does.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.core import hashing, idl as idl_mod, minhash
from repro_torch.index import packed, query
from repro_torch.kernels.idl_insert import ops as ins_ops

BACKENDS = ("torch", "idl_insert", "sharded")
KINDS = ("bits", "rows", "cols")


# ---------------------------------------------------------------------------
# Minimizer sub-sampling.
# ---------------------------------------------------------------------------

def minimizer_mask(locs: torch.Tensor, w: int) -> torch.Tensor:
    """(B, n_kmers) bool: the kmer is a window-``w`` minimizer of its read.

    The rank is a re-mix of the kmer's repetition-0 location; a kmer is kept
    iff it attains the minimum rank of at least one length-``w`` window
    holding it: two sliding minima (``window_min`` launches on a CUDA
    tensor), the second over the inverted window minima, padded with
    ``0xFFFFFFFF`` (a sliding maximum of the minima). Reads shorter than
    ``w`` keep every kmer. Ranks are uint32 carried in int64, so the
    inversion is ``0xFFFFFFFF ^ x``, never ``~x``.
    """
    rank = hashing.mix32(locs[:, 0, :] ^ 0x9E3779B9)
    n_k = rank.shape[1]
    if w <= 1 or n_k < w:
        return torch.ones(rank.shape, dtype=torch.bool, device=rank.device)
    inv = hashing.M32 ^ minhash.sliding_window_min(rank, w)
    pad = inv.new_full((inv.shape[0], w - 1), hashing.M32)
    best = hashing.M32 ^ minhash.sliding_window_min(
        torch.cat([pad, inv, pad], dim=1), w)
    return best == rank


@dataclasses.dataclass(frozen=True)
class InsertPlan:
    """Static insert recipe for one (cfg, scheme, read_shape, matrix) tuple.

    ``kind`` names how a read's hash locations become (row, word, bit)
    targets: ``"bits"`` — locations are flat bit offsets of a packed word
    column (flat BF); ``"rows"`` — each read lands in aux filter rows and
    locations pick (word, bit) within the row (RAMBO); ``"cols"`` — each
    read owns an aux file column and locations pick the matrix row
    (bit-sliced layouts).
    """

    cfg: idl_mod.IDLConfig
    scheme: str
    read_shape: tuple[int, int]       # (B, read_len)
    matrix_shape: tuple[int, int]     # (n_rows, W)
    kind: str
    lane32: bool
    rows_per_block: int               # run-coalescing tile height
    inserts_per_run: int
    window_min: Optional[int] = None  # minimizer sub-sampling window

    @property
    def row_words(self) -> int:
        return self.matrix_shape[1]

    @property
    def block_bits(self) -> int:
        """Bits per tile in the flattened (rows*W*32) bit space."""
        return self.rows_per_block * self.row_words * 32

    # -- target stream (shared by every backend) ----------------------------
    def locations(self, reads: torch.Tensor) -> torch.Tensor:
        """(B, η, n_kmers) int64 hash locations (the query layer's body)."""
        return packed.batch_locations(self.cfg, reads, self.scheme,
                                      lane32=self.lane32)

    def targets(self, reads: torch.Tensor, aux: Optional[torch.Tensor] = None):
        """Flat int64 (row, word_col, bit) target streams.

        ``aux``: None (``"bits"``), (B, R) filter rows (``"rows"``), or
        (B,) file columns (``"cols"``). Targets masked off by minimizer
        sub-sampling are routed to the row past the matrix, which every
        backend drops.
        """
        locs = self.locations(reads)                    # (B, η, n_k)
        keep = None
        if self.window_min is not None:
            keep = minimizer_mask(locs, self.window_min)[:, None]
        if self.kind == "bits":
            row, wc, bit = locs >> 5, torch.zeros_like(locs), locs & 31
        elif self.kind == "cols":
            if aux is None:
                raise ValueError("kind='cols' plans need (B,) file columns")
            cols = aux.reshape(-1).to(torch.int64)[:, None, None]
            row = locs
            wc = (cols >> 5).expand_as(row)
            bit = (cols & 31).expand_as(row)
        elif self.kind == "rows":
            if aux is None:
                raise ValueError("kind='rows' plans need (B, R) filter rows")
            frows = aux.to(torch.int64)                 # (B, R)
            shape = frows.shape + locs.shape[1:]        # (B, R, η, n_k)
            row = frows[:, :, None, None].expand(shape)
            wc = (locs >> 5)[:, None].expand(shape)
            bit = (locs & 31)[:, None].expand(shape)
            if keep is not None:
                keep = keep[:, None]
        else:
            raise ValueError(f"unknown insert kind {self.kind!r}")
        if keep is not None:
            row = torch.where(keep, row, self.matrix_shape[0])
        return row.reshape(-1), wc.reshape(-1), bit.reshape(-1)

    def slice_targets(self, reads: torch.Tensor, aux, lo: int, hi: int):
        """The targets that land in the rows (``"bits"``) or word columns
        ``[lo, hi)``, relative to that slice of the matrix; every other
        target goes to the row past the slice, which every backend drops
        (a minimizer-masked target already lies past the full matrix)."""
        row, wc, bit = self.targets(reads, aux)
        if self.kind == "bits":
            local = (row >= lo) & (row < hi)
            row, n_rows = row - lo, hi - lo
        else:
            local = (wc >= lo) & (wc < hi)
            wc, n_rows = wc - lo, self.matrix_shape[0]
        return torch.where(local, row, n_rows), wc, bit

    def flat_positions(self, reads: torch.Tensor,
                       aux: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The batch's flat int64 bit positions ``(row * W + word) * 32 +
        bit`` on the reads' device; -1 (masked) for a row past the matrix,
        as the reference masks them."""
        row, wc, bit = self.targets(reads, aux)
        flat = (row * self.row_words + wc) * 32 + bit
        return torch.where(row < self.matrix_shape[0], flat, -1)

    def plan_runs(self, reads: torch.Tensor, aux: Optional[torch.Tensor] = None):
        """The reference's host-side sorted/deduplicated run plan (numpy;
        kept for parity, off the ingest path)."""
        return ins_ops.plan_insert_runs(
            self.flat_positions(reads, aux).cpu().numpy(),
            block_bits=self.block_bits,
            inserts_per_run=self.inserts_per_run,
        )

    def compact_plan(self, reads: torch.Tensor,
                     aux: Optional[torch.Tensor] = None):
        """The compact plan on the reads' device (what ``idl_insert``
        executes); times its ``locations`` and ``device_plan`` stages."""
        t0 = time.perf_counter()
        flat = self.flat_positions(reads, aux)
        t0 = query.record_stage("insert", "locations", t0)
        cplan = ins_ops.compact_insert_plan(
            flat, block_bits=self.block_bits,
            inserts_per_run=self.inserts_per_run,
        )
        query.record_stage("insert", "device_plan", t0)
        return cplan

    def run_dma_bytes(self, rplan) -> int:
        """Tile bytes the plan covers (read + write per touched block)."""
        return 0 if rplan is None else rplan.dma_bytes

    # -- execution ----------------------------------------------------------
    def execute(
        self,
        matrix: torch.Tensor,
        reads,
        aux=None,
        *,
        backend: str = "torch",
        donate: bool = True,
        mesh=None,
    ) -> torch.Tensor:
        """Scatter-OR the batch into ``matrix`` in place; returns it.

        ``matrix`` may be 1-D when ``W == 1``. ``donate=False`` scatters
        into a clone instead (one extra device copy) and returns the clone.
        ``mesh`` is the ``"sharded"`` backend's tuple of devices.
        """
        if not donate:
            matrix = matrix.clone()
        reads = query.as_reads(reads, matrix.device)
        if aux is not None:
            aux = torch.as_tensor(aux, device=matrix.device)
        mat = matrix.view(self.matrix_shape)
        if backend == "torch":
            packed.scatter_or_matrix(mat, *self.targets(reads, aux))
        elif backend == "idl_insert":
            cplan = self.compact_plan(reads, aux)
            if cplan is not None:
                query.record_locality(
                    scheme=self.scheme, op="insert",
                    tile_bytes=cplan.dma_bytes, n_runs=cplan.n_runs,
                    n_probes=cplan.n_locs, run_lengths=cplan.run_lengths)
            t0 = time.perf_counter()
            ins_ops.insert_planned(mat, cplan)
            query.record_stage("insert", "launch", t0)
        elif backend == "sharded":
            self._execute_sharded(mat, reads, aux, mesh)
        else:
            raise ValueError(
                f"unknown ingest backend {backend!r} (want one of {BACKENDS})")
        return matrix

    def _execute_sharded(self, mat, reads, aux, mesh) -> None:
        """The reference's ``_sharded_inserter`` over a tuple of devices:
        shard ``s`` owns rows (``"bits"``) or word columns ``[s·p,
        (s+1)·p)``, ``p = ceil(extent / n)``; a foreign target goes to the
        row past the shard's slice and is dropped. A slice that is not a
        dense tensor on its shard's device is scattered in a copy and
        copied back."""
        mesh = tuple(query.default_mesh(mat.device) if mesh is None
                     else mesh)
        split_rows = self.kind == "bits"
        extent = self.matrix_shape[0 if split_rows else 1]
        per = -(-extent // len(mesh))
        for s, dev in enumerate(mesh):
            lo, hi = s * per, min((s + 1) * per, extent)
            if lo >= hi:
                continue
            sub = mat[lo:hi] if split_rows else mat[:, lo:hi]
            work = sub.to(dev).contiguous()
            packed.scatter_or_matrix(work, *self.slice_targets(
                reads.to(dev), None if aux is None else aux.to(dev),
                lo, hi))
            if work.data_ptr() != sub.data_ptr():
                sub.copy_(work)


PLAN_CACHE_SIZE = 512


@functools.lru_cache(maxsize=PLAN_CACHE_SIZE)
def plan_insert(
    cfg: idl_mod.IDLConfig,
    scheme: str,
    read_shape: tuple[int, int],
    matrix_shape: tuple[int, int],
    *,
    kind: str,
    lane32: bool = False,
    rows_per_block: Optional[int] = None,
    inserts_per_run: Optional[int] = None,
    window_min: Optional[int] = None,
    device="cuda",
) -> InsertPlan:
    """Build (or fetch) the cached plan for one insert geometry.

    Defaults are the reference's: ``rows_per_block`` is ``L/32`` words for
    ``"bits"`` and otherwise ``L`` rows clamped to ``2**21 / (W·128)``, as a
    power of two that divides ``n_rows``; ``inserts_per_run`` is 128 on an
    accelerator and 32 on a CPU, read from the type of ``device``.
    ``window_min`` turns on minimizer sub-sampling.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown insert kind {kind!r} (want one of {KINDS})")
    n_rows, row_words = matrix_shape
    if inserts_per_run is None:
        inserts_per_run = 32 if torch.device(device).type == "cpu" else 128
    if rows_per_block is None:
        if kind == "bits":
            target = max(cfg.L // 32, 1)
        else:
            target = max(1, min(cfg.L, (1 << 21) // max(row_words * 128, 1)))
        rows_per_block = query._pow2_block(n_rows, target)
    if n_rows % rows_per_block:
        raise ValueError(
            f"rows_per_block={rows_per_block} must divide n_rows={n_rows}")
    return InsertPlan(
        cfg=cfg, scheme=scheme,
        read_shape=tuple(read_shape), matrix_shape=tuple(matrix_shape),
        kind=kind, lane32=lane32,
        rows_per_block=rows_per_block, inserts_per_run=inserts_per_run,
        window_min=window_min,
    )


def plan_cache_info() -> query.PlanCacheInfo:
    """Stats of the (bounded) insert-plan cache, with its eviction count."""
    return query._with_evictions(plan_insert.cache_info())


def clear_plan_cache() -> None:
    plan_insert.cache_clear()


# ---------------------------------------------------------------------------
# Streaming archive builder.
# ---------------------------------------------------------------------------

def _file_sequences(item, default_id: int):
    """Normalize an archive item to (file_id, [code arrays])."""
    from repro_torch.data import genome as genome_mod

    if isinstance(item, genome_mod.GenomeFile):
        return item.file_id, [np.asarray(item.genome)]
    if isinstance(item, str):
        return default_id, [
            np.asarray(codes)
            for codes in genome_mod.read_fasta(item).values()
        ]
    fid, codes = item
    return int(fid), [np.asarray(codes)]


def build_archive(
    index,
    files: Iterable,
    *,
    read_len: int = 230,
    chunk_reads: int = 64,
    backend: str = "idl_insert",
    window_min: Optional[int] = None,
    pad_final: bool = True,
    **kw,
):
    """Stream a whole archive into an engine; returns the updated engine.

    ``files``: an iterable of ``data.genome.GenomeFile``, ``(file_id,
    codes)`` pairs, or FASTA paths. Every sequence is chopped into
    fixed-``read_len`` windows overlapping by ``k - 1`` bases (every kmer
    covered; duplicates are free since scatter-OR is idempotent), batched
    ``chunk_reads`` at a time into the engine's ``insert_batch``. With
    ``pad_final`` a partial tail chunk repeats a read to fill the batch.
    ``window_min`` inserts only window-``w`` minimizer kmers (fewer bits
    than a full build).
    """
    from repro_torch.data import genome as genome_mod

    k = int(getattr(index, "k", None) or index.cfg.k)
    pending: dict[int, tuple[list, list]] = {}

    def flush(length: int, force: bool):
        nonlocal index
        reads_l, fids_l = pending[length]
        while len(reads_l) >= chunk_reads or (force and reads_l):
            take = min(chunk_reads, len(reads_l))
            batch, fids = reads_l[:take], fids_l[:take]
            del reads_l[:take], fids_l[:take]
            if pad_final and take < chunk_reads:
                batch = batch + [batch[0]] * (chunk_reads - take)
                fids = fids + [fids[0]] * (chunk_reads - take)
            index = index.insert_batch(
                np.stack(batch), np.asarray(fids, dtype=np.int32),
                backend=backend, window_min=window_min, **kw)

    for pos, item in enumerate(files):
        fid, seqs = _file_sequences(item, pos)
        for codes in seqs:
            windows = genome_mod.window_reads(codes, read_len, k)
            if windows.shape[0] == 0:
                continue
            length = windows.shape[1]
            reads_l, fids_l = pending.setdefault(length, ([], []))
            reads_l.extend(windows)
            fids_l.extend([fid] * windows.shape[0])
            flush(length, force=False)
    for length in sorted(pending):
        flush(length, force=True)
    return index


def build_sharded_archive(
    index,
    files: Iterable,
    *,
    n_shards: int,
    out_dir: Optional[str] = None,
    read_len: int = 230,
    chunk_reads: int = 64,
    backend: str = "idl_insert",
    window_min: Optional[int] = None,
    pad_final: bool = True,
    set_version: int = 0,
):
    """Partition an empty engine/state and stream the archive into every
    shard in parallel — one thread per shard over the insert path
    :func:`build_archive` uses (on a CUDA index each thread launches its
    own kernels on the device's default stream; a shard's words are
    written only by its own thread).

    Row-probe shards (bit-sliced / cobs) each ingest only their own file
    range — bit-sliced file ids are renumbered into the shard-local
    column space. Bit-probe shards (flat filter / rambo) each ingest EVERY
    read through a :class:`repro_torch.index.shards.ShardBuilder`, which
    keeps only the targets in the shard's word range (scatter-OR commutes
    and is idempotent, so dropping foreign targets is exact). Joining the
    result is bit-identical to the unsharded ``build_archive``.

    Returns ``(spec, [IndexState, ...])``; with ``out_dir`` also writes
    the shard-set snapshot (``shards.save_shard_set``) stamped
    ``set_version``.
    """
    from repro_torch.index import shards as shards_mod
    from repro_torch.index import state as state_mod

    spec, parts = shards_mod.partition_state(index, n_shards)
    items = []
    for pos, item in enumerate(files):
        fid, seqs = _file_sequences(item, pos)
        items.extend((fid, codes) for codes in seqs)
    build_kw = dict(read_len=read_len, chunk_reads=chunk_reads,
                    window_min=window_min, pad_final=pad_final)
    results: list = [None] * n_shards
    errors: list = []

    def run(s: int) -> None:
        try:
            if spec.row_probe:
                owned = shards_mod.shard_files(spec, s)
                base = owned[0] if (
                    owned and spec.meta.engine == "bitsliced") else 0
                own = set(owned)
                mine = [(fid - base, codes)
                        for fid, codes in items if fid in own]
                built = build_archive(
                    state_mod.to_engine(parts[s]), mine,
                    backend=backend, **build_kw)
                results[s] = state_mod.from_engine(built)
            else:
                builder = shards_mod.ShardBuilder(spec, s, parts[s])
                built = build_archive(builder, items,
                                      backend=backend, **build_kw)
                results[s] = built.state
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            errors.append((s, e))

    threads = [threading.Thread(target=run, args=(s,),
                                name=f"idl-shard-build-{s}")
               for s in range(n_shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        s, e = min(errors, key=lambda x: x[0])
        raise RuntimeError(f"shard {s} build failed: {e!r}") from e
    if out_dir is not None:
        shards_mod.save_shard_set(spec, results, out_dir,
                                  version=set_version)
    return spec, results
