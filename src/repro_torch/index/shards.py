"""Sharded archives: partition one :class:`IndexState` into N shard states.

Port of :mod:`repro.index.shards`. A match verdict is an integer coverage
threshold over per-kmer hit conjunctions, so shard-local partial results
merge **exactly**. Two partition axes, chosen by how the engine probes its
word matrix:

- ``axis="files"`` (row-probe engines: ``bitsliced``, ``cobs``) — each
  shard owns a contiguous file range and ALL bit rows for it. Bit-sliced
  shards own word columns of the ``(m, ceil(F/32))`` matrix (each column
  is 32 files); COBS shards own whole size-groups. A file's verdict
  depends only on its own column, so per-shard outputs merge by
  concatenation / OR over disjoint file sets.

- ``axis="words"`` (bit-probe engines: ``bloom``, ``rambo``) — each shard
  owns a slice of the packed words (flat filter: rows of the ``(m/32,)``
  vector; RAMBO: word columns of the stored ``(R·B, m/32)`` matrix, i.e.
  rows of the transposed probe matrix). Every probe lands in exactly ONE
  shard; a shard reduces its local probes to per-(kmer, slot) MISS counts
  over the η repetitions (:func:`partial_prober`, plain torch), and a kmer
  hits iff the total miss across shards is zero. :func:`merge_counts`
  sums the partial counts BEFORE the one coverage threshold.

Shard states are fresh, contiguous tensors (the kernel wrappers take
contiguous int32 only): :func:`partition_state` clones each slice and
leaves its input live. A RAMBO word shard keeps its transposed
``(span, R·B)`` copy on its words tensor (made at the first probe,
dropped by any in-place insert), where the reference transposes on every
call.

Persistence: :func:`save_shard_set` writes each shard through the
ordinary snapshot store (``store.save``) into ``shard_NN/`` dirs plus a
CRC-checked top-level ``shardset.json`` that pins every shard's own
manifest bytes; the files are the reference's, byte for byte, so a set
written by either package loads in the other. :func:`load_shard_set` /
:func:`load_shard` reject missing, foreign/rewritten, or mixed-geometry
shards with :class:`ShardSetError`\\ s naming the offending shard.

Build: :class:`ShardBuilder` is the bit-probe counterpart of a partition
slice — an engine-like facade ``ingest.build_archive`` can stream into,
computing full-geometry insert targets and keeping only the shard's word
range (scatter-OR commutes, so dropping foreign targets is exact). It
scatters in place, through the plain scatter (``"torch"``) or the
``insert_planned`` kernel (``"idl_insert"``, the default).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import zlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.index import engines, packed, query
from repro_torch.index import state as state_mod
from repro_torch.index import store

AXES = ("files", "words")

SET_FORMAT = "idl-shard-set"
SET_VERSION = 1
SET_MANIFEST = "shardset.json"


class ShardSetError(store.SnapshotError):
    """A shard set (or one of its shards) is missing, foreign, or
    geometrically inconsistent with its manifest."""


# ---------------------------------------------------------------------------
# ShardSpec — the partition plan.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How one logical index is cut into ``n_shards`` pieces.

    ``bounds`` has ``n_shards + 1`` entries over the engine's partition
    units (bit-sliced: 32-file word columns; cobs: size-groups; bloom /
    rambo: packed words); shard ``s`` owns ``[bounds[s], bounds[s+1])``.
    ``meta`` is the FULL unsharded :class:`StateMeta`.
    """

    axis: str
    n_shards: int
    bounds: Tuple[int, ...]
    meta: state_mod.StateMeta

    def __post_init__(self):
        if self.axis not in AXES:
            raise ShardSetError(
                f"unknown shard axis {self.axis!r} (want one of {AXES})")
        if len(self.bounds) != self.n_shards + 1:
            raise ShardSetError(
                f"{self.n_shards} shards need {self.n_shards + 1} bounds, "
                f"got {len(self.bounds)}")

    @property
    def row_probe(self) -> bool:
        return self.axis == "files"

    def shard_units(self, shard_id: int) -> Tuple[int, int]:
        """``[lo, hi)`` partition-unit range owned by ``shard_id``."""
        if not 0 <= shard_id < self.n_shards:
            raise ShardSetError(
                f"shard id {shard_id} out of range (n_shards="
                f"{self.n_shards})")
        return self.bounds[shard_id], self.bounds[shard_id + 1]


@dataclasses.dataclass(frozen=True)
class ShardSetMeta:
    """Everything the top-level manifest pins: the spec, the set version
    serving stamps on results, the shard dir names, and each shard's own
    manifest CRC (how foreign/rewritten shards are detected)."""

    spec: ShardSpec
    set_version: int
    shard_dirs: Tuple[str, ...]
    manifest_crcs: Tuple[int, ...]


def _axis_units(meta: state_mod.StateMeta) -> Tuple[str, int, str]:
    """(axis, n_partition_units, unit name) for an engine's geometry."""
    if meta.engine == "bitsliced":
        return "files", -(-meta.n_files // 32), "32-file word columns"
    if meta.engine == "cobs":
        return "files", len(meta.cfgs), "size-groups"
    if meta.engine in ("bloom", "rambo"):
        return "words", meta.cfgs[0].m // 32, "packed words"
    raise ShardSetError(f"unknown engine {meta.engine!r}")


def plan_shards(meta: state_mod.StateMeta, n_shards: int) -> ShardSpec:
    """Cut an index's partition units into ``n_shards`` contiguous ranges."""
    axis, units, name = _axis_units(meta)
    if not 1 <= n_shards <= units:
        raise ShardSetError(
            f"cannot cut a {meta.engine!r} index into {n_shards} shards: "
            f"it has {units} {name} (want 1 <= n_shards <= {units})")
    bounds = tuple(i * units // n_shards for i in range(n_shards + 1))
    return ShardSpec(axis=axis, n_shards=n_shards, bounds=bounds, meta=meta)


def shard_files(spec: ShardSpec, shard_id: int) -> Tuple[int, ...]:
    """Global file ids owned by a row-probe shard (its file range)."""
    if not spec.row_probe:
        raise ShardSetError(
            f"{spec.meta.engine!r} shards partition the word axis — no "
            f"shard owns a file range")
    lo, hi = spec.shard_units(shard_id)
    if spec.meta.engine == "bitsliced":
        return tuple(range(32 * lo, min(32 * hi, spec.meta.n_files)))
    return tuple(f for g in spec.meta.group_file_ids[lo:hi] for f in g)


def _expect_shard(spec: ShardSpec, shard_id: int):
    """(expected shard StateMeta, expected per-array word shapes)."""
    meta = spec.meta
    lo, hi = spec.shard_units(shard_id)
    if meta.engine == "bitsliced":
        f_lo, f_hi = 32 * lo, min(32 * hi, meta.n_files)
        return (dataclasses.replace(meta, n_files=f_hi - f_lo),
                ((meta.cfgs[0].m, hi - lo),))
    if meta.engine == "cobs":
        gfi = meta.group_file_ids[lo:hi]
        return (dataclasses.replace(meta, cfgs=meta.cfgs[lo:hi],
                                    group_file_ids=gfi),
                tuple((c.m, -(-len(g) // 32))
                      for c, g in zip(meta.cfgs[lo:hi], gfi)))
    if meta.engine == "bloom":
        return meta, ((hi - lo,),)
    return meta, ((meta.n_rep * meta.n_buckets, hi - lo),)


def _validate_shard(spec: ShardSpec, shard_id: int,
                    shard: state_mod.IndexState, label: str) -> None:
    exp_meta, exp_shapes = _expect_shard(spec, shard_id)
    if shard.meta != exp_meta:
        raise ShardSetError(
            f"{label} has mixed geometry: its meta does not match the "
            f"shard set's ({shard.meta} != {exp_meta})")
    got = tuple(tuple(int(d) for d in w.shape) for w in shard.words)
    want = tuple(tuple(int(d) for d in s) for s in exp_shapes)
    if got != want:
        raise ShardSetError(
            f"{label} has mixed geometry: word shapes {got} != expected "
            f"{want}")


# ---------------------------------------------------------------------------
# Partition / join — a bit-identical round trip.
# ---------------------------------------------------------------------------

def _fresh(words: torch.Tensor) -> torch.Tensor:
    """A dense copy of a slice (never a view of the input)."""
    return words.clone(memory_format=torch.contiguous_format)


def partition_state(index, n_shards: int):
    """Cut an engine/state into per-shard :class:`IndexState`\\ s.

    Returns ``(spec, [state, ...])``. Row-probe shards are themselves
    valid standalone engines over their file range (bit-sliced: a local
    ``n_files``; cobs: the owned groups with GLOBAL file ids and width —
    unowned files stay all-zero in its output). Bit-probe shards keep
    the FULL meta but hold only their word-range slice — they are probed
    through :func:`shard_query`, never as standalone engines. Slices are
    fresh contiguous tensors on the input's device: the input stays live.
    """
    full = state_mod.from_engine(index)
    state_mod.ensure_live(full, what="IndexState")
    spec = plan_shards(full.meta, n_shards)
    parts: List[state_mod.IndexState] = []
    for s in range(n_shards):
        lo, hi = spec.shard_units(s)
        exp_meta, _ = _expect_shard(spec, s)
        eng = full.meta.engine
        if eng == "cobs":
            words = tuple(_fresh(w) for w in full.words[lo:hi])
        elif eng == "bloom":
            words = (_fresh(full.words[0][lo:hi]),)
        else:  # bitsliced / rambo both slice word columns
            words = (_fresh(full.words[0][:, lo:hi]),)
        parts.append(state_mod.IndexState(words=words, meta=exp_meta))
    return spec, parts


def join_states(spec: ShardSpec,
                states: Sequence[state_mod.IndexState]) -> state_mod.IndexState:
    """Reassemble the unsharded :class:`IndexState` — bit-identical to the
    pre-partition input."""
    if len(states) != spec.n_shards:
        raise ShardSetError(
            f"shard set wants {spec.n_shards} shards, got {len(states)}")
    for s, st in enumerate(states):
        _validate_shard(spec, s, st, f"shard {s}")
    eng = spec.meta.engine
    if eng == "cobs":
        words = tuple(w for st in states for w in st.words)
    elif eng == "bloom":
        words = (torch.cat([st.words[0] for st in states], dim=0),)
    else:
        words = (torch.cat([st.words[0] for st in states], dim=1),)
    return state_mod.IndexState(words=words, meta=spec.meta)


# ---------------------------------------------------------------------------
# Partial probe + exact merge.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=128)
def partial_prober(cfg, scheme: str, lo: int, hi: int, transpose: bool):
    """The bit-probe partial for one (geometry, word range).

    ``run(words, reads) -> (B, n_k, W') int32`` local MISS counts over the
    η repetitions (W' = 1 for the flat filter, R·B for RAMBO). Probes
    outside ``[lo, hi)`` contribute nothing; a kmer hits iff its TOTAL
    miss over the shards is zero. A plain torch gather on the words'
    device (as the reference computes it outside any kernel); a RAMBO
    shard probes the transposed copy kept on its words tensor.
    """
    span = hi - lo

    def run(words, reads):
        mat = (engines.transposed_words(words) if transpose
               else words.reshape(span, 1))
        reads = query.as_reads(reads, words.device)
        locs = query.batch_locations(reads, cfg=cfg, scheme=scheme,
                                     lane32=False)     # (B, η, n_k)
        return query.local_miss_counts(mat, locs, lo, hi)

    return run


def shard_query(spec: ShardSpec, shard_id: int,
                shard: state_mod.IndexState, reads, *,
                backend: str = "idl_probe"):
    """One shard's partial answer for a read batch.

    Row-probe shards run their engine's ordinary ``query_batch`` (their
    slice IS a complete index over their file range). Bit-probe shards
    return partial miss counts from :func:`partial_prober`. Feed the
    per-shard outputs, in shard order, to :func:`merge_counts`.
    """
    state_mod.ensure_live(shard, what="shard state")
    if spec.row_probe:
        return state_mod.to_engine(shard).query_batch(reads, backend=backend)
    lo, hi = spec.shard_units(shard_id)
    fn = partial_prober(spec.meta.cfgs[0], spec.meta.scheme, lo, hi,
                        spec.meta.engine == "rambo")
    return fn(shard.words[0], reads)


def merge_counts(spec: ShardSpec, partials: Sequence):
    """Exactly reconstruct the unsharded engine's ``query_batch`` output
    from per-shard partials (shard order).

    Bit-sliced per-kmer file masks concatenate on the word axis; cobs
    per-kmer grids OR over disjoint file sets; bit-probe miss counts sum,
    and a kmer hits iff the total is zero. RAMBO's bucket grid becomes
    per-file hits through :func:`~repro_torch.index.engines.rambo_merge`.
    """
    if len(partials) != spec.n_shards:
        raise ShardSetError(
            f"merge_counts wants {spec.n_shards} partials, got "
            f"{len(partials)}")
    eng = spec.meta.engine
    if eng == "bitsliced":
        return torch.cat(list(partials), dim=-1)
    if eng == "cobs":
        out = partials[0]
        for p in partials[1:]:
            out = out | p
        return out
    total = partials[0]
    for p in partials[1:]:
        total = total + p
    member = total == 0                                  # (B, n_k, W')
    if eng == "bloom":
        return member[..., 0]                            # (B, n_k) bool
    meta = spec.meta
    return engines.rambo_merge(member, engines.rambo_assignment(
        meta.n_files, meta.n_buckets, meta.n_rep))       # (B, n_k, N)


def sharded_msmt(spec: ShardSpec, states: Sequence[state_mod.IndexState],
                 reads, theta: float = 1.0, *, backend: str = "idl_probe"):
    """MSMT over the shard set — bit-identical to ``state.msmt`` on the
    joined index (the scatter-gather oracle, run in one process)."""
    per = merge_counts(spec, [
        shard_query(spec, s, st, reads, backend=backend)
        for s, st in enumerate(states)])
    return state_mod.verdicts(spec.meta, per, theta)


# ---------------------------------------------------------------------------
# Distributed build — the bit-probe shard's insert facade.
# ---------------------------------------------------------------------------

def _shard_insert(plan, lo: int, hi: int, words: torch.Tensor, reads, aux,
                  backend: str) -> None:
    """Scatter the plan's targets that land in ``[lo, hi)`` (rows of a
    ``"bits"`` plan, word columns otherwise) into the shard's ``words`` in
    place; the foreign ones are dropped (``InsertPlan.slice_targets``)."""
    mat = words.view(hi - lo, 1) if plan.kind == "bits" else \
        words.view(words.shape[0], hi - lo)
    row, wc, bit = plan.slice_targets(reads, aux, lo, hi)
    if backend == "torch":
        packed.scatter_or_matrix(mat, row, wc, bit)
        return
    from repro_torch.index import ingest
    from repro_torch.kernels.idl_insert import ops as ins_ops

    local_plan = ingest.plan_insert(
        plan.cfg, plan.scheme, plan.read_shape, tuple(mat.shape),
        kind=plan.kind, lane32=plan.lane32, window_min=plan.window_min,
        device=words.device)
    flat = (row * mat.shape[1] + wc) * 32 + bit
    flat = torch.where(row < mat.shape[0], flat, -1)
    ins_ops.insert_planned(mat, ins_ops.compact_insert_plan(
        flat, block_bits=local_plan.block_bits,
        inserts_per_run=local_plan.inserts_per_run))


class ShardBuilder:
    """Engine-like facade for streaming reads into ONE bit-probe shard.

    Quacks enough like an engine for ``ingest.build_archive`` (``cfg``
    for kmer size, ``insert_batch`` returning a new value): computes the
    full-geometry insert targets and scatters only those in this shard's
    word range, in place. Windowed inserts hit every kmer and scatter-OR
    is idempotent and commutative, so N builders fed the same stream
    produce exactly the partition of the unsharded build. Linear-use like
    the engines: ``insert_batch`` marks the previous value consumed
    (``donate=False`` inserts into a copy).
    """

    BACKENDS = ("torch", "idl_insert")

    def __init__(self, spec: ShardSpec, shard_id: int,
                 shard: state_mod.IndexState):
        if spec.row_probe:
            raise ShardSetError(
                "ShardBuilder streams bit-probe shards; row-probe shards "
                "are standalone engines — build them with "
                "ingest.build_archive directly")
        self._spec = spec
        self._shard_id = shard_id
        self.state = shard

    @property
    def cfg(self):
        return self._spec.meta.cfgs[0]

    def insert_batch(self, reads, file_ids=None, *,
                     backend: str = "idl_insert", window_min=None,
                     donate: bool = True) -> "ShardBuilder":
        from repro_torch.index import ingest

        if backend not in self.BACKENDS:
            raise ValueError(
                f"ShardBuilder scatters through {self.BACKENDS} only "
                f"(got backend={backend!r})")
        state_mod.ensure_live(self.state, what="shard state")
        meta = self._spec.meta
        cfg = meta.cfgs[0]
        words = self.state.words[0]
        reads = query.as_reads(reads, words.device)
        if meta.engine == "bloom":
            aux = None
            plan = ingest.plan_insert(
                cfg, meta.scheme, tuple(reads.shape), (cfg.m // 32, 1),
                kind="bits", window_min=window_min, device=words.device)
        else:
            fids = np.atleast_1d(np.asarray(
                0 if file_ids is None else file_ids, dtype=np.int32))
            if fids.shape[0] == 1 and reads.shape[0] != 1:
                fids = np.broadcast_to(fids, (reads.shape[0],))
            asn = engines.rambo_assignment(meta.n_files, meta.n_buckets,
                                           meta.n_rep)
            offs = np.arange(meta.n_rep, dtype=np.int32) * meta.n_buckets
            aux = torch.as_tensor(asn[:, fids].T + offs[None, :],
                                  device=words.device)          # (B, R)
            plan = ingest.plan_insert(
                cfg, meta.scheme, tuple(reads.shape),
                (meta.n_rep * meta.n_buckets, cfg.m // 32),
                kind="rows", window_min=window_min, device=words.device)
        lo, hi = self._spec.shard_units(self._shard_id)
        if donate:
            engines._drop_transposed(words)
            state_mod.mark_consumed(self.state)
        else:
            words = words.clone()
        _shard_insert(plan, lo, hi, words, reads, aux, backend)
        return ShardBuilder(
            self._spec, self._shard_id,
            state_mod.IndexState(words=(words,), meta=self.state.meta))


# ---------------------------------------------------------------------------
# Persistence — per-shard snapshot dirs + a CRC-checked set manifest.
# ---------------------------------------------------------------------------

def _shard_dir(shard_id: int) -> str:
    return f"shard_{shard_id:02d}"


def _body_crc(body: dict) -> int:
    return zlib.crc32(json.dumps(body, sort_keys=True).encode("utf-8"))


def save_shard_set(spec: ShardSpec,
                   states: Sequence[state_mod.IndexState],
                   directory: str, *, version: int = 0) -> str:
    """Write a shard set: ``shard_NN/`` ordinary snapshots plus the
    CRC-checked top-level ``shardset.json`` pinning every shard's own
    manifest bytes. Geometry is validated BEFORE anything is written."""
    if len(states) != spec.n_shards:
        raise ShardSetError(
            f"shard set wants {spec.n_shards} shards, got {len(states)}")
    for s, st in enumerate(states):
        _validate_shard(spec, s, st, f"shard {s}")
    os.makedirs(directory, exist_ok=True)
    entries = []
    for s, st in enumerate(states):
        name = _shard_dir(s)
        store.save(st, os.path.join(directory, name))
        with open(os.path.join(directory, name, store.MANIFEST), "rb") as f:
            crc = zlib.crc32(f.read())
        entries.append({"dir": name, "manifest_crc32": crc})
    body = {
        "format": SET_FORMAT,
        "version": SET_VERSION,
        "set_version": int(version),
        "axis": spec.axis,
        "n_shards": spec.n_shards,
        "bounds": [int(b) for b in spec.bounds],
        "meta": store.meta_to_json(spec.meta),
        "shards": entries,
    }
    doc = {"crc32": _body_crc(body), "body": body}
    tmp = os.path.join(directory, SET_MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(directory, SET_MANIFEST))
    return directory


def is_shard_set(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, SET_MANIFEST))


def read_set_meta(directory: str) -> ShardSetMeta:
    """Read + verify the top-level manifest — O(manifest), no array bytes.
    The scatter gateway boots its geometry from this alone."""
    path = os.path.join(directory, SET_MANIFEST)
    if not os.path.exists(path):
        raise ShardSetError(
            f"no {SET_MANIFEST} in {directory!r} — not a shard set")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ShardSetError(
            f"corrupt {SET_MANIFEST} in {directory!r}: {e}") from e
    body = doc.get("body") if isinstance(doc, dict) else None
    if not isinstance(body, dict):
        raise ShardSetError(
            f"corrupt {SET_MANIFEST} in {directory!r}: no manifest body")
    if _body_crc(body) != doc.get("crc32"):
        raise ShardSetError(
            f"{SET_MANIFEST} in {directory!r} failed its checksum — the "
            f"shard-set manifest is truncated or rewritten")
    if body.get("format") != SET_FORMAT:
        raise ShardSetError(
            f"{directory!r} is not a shard set (format tag "
            f"{body.get('format')!r}, want {SET_FORMAT!r})")
    if body.get("version") != SET_VERSION:
        raise ShardSetError(
            f"shard-set format version {body.get('version')!r} in "
            f"{directory!r} is not supported (this build reads version "
            f"{SET_VERSION})")
    try:
        meta = store.meta_from_json(body["meta"])
        n = int(body["n_shards"])
        bounds = tuple(int(b) for b in body["bounds"])
        axis = body["axis"]
        shard_dirs = tuple(str(e["dir"]) for e in body["shards"])
        crcs = tuple(int(e["manifest_crc32"]) for e in body["shards"])
        set_version = int(body["set_version"])
    except (KeyError, TypeError, ValueError) as e:
        raise ShardSetError(
            f"corrupt {SET_MANIFEST} in {directory!r}: {e!r}") from e
    if len(shard_dirs) != n or len(crcs) != n:
        raise ShardSetError(
            f"shard-set manifest in {directory!r} lists "
            f"{len(shard_dirs)} shard dirs for n_shards={n}")
    for name in shard_dirs:
        if os.path.basename(name) != name or name in ("", ".", ".."):
            raise ShardSetError(
                f"shard dir {name!r} in {directory!r} is not a plain "
                f"directory name")
    spec = ShardSpec(axis=axis, n_shards=n, bounds=bounds, meta=meta)
    want = plan_shards(meta, n)
    if spec != want:
        raise ShardSetError(
            f"shard-set manifest in {directory!r} disagrees with the "
            f"partition plan for its own meta (axis/bounds drift)")
    return ShardSetMeta(spec=spec, set_version=set_version,
                        shard_dirs=shard_dirs, manifest_crcs=crcs)


def load_shard(directory: str, shard_id: int, *,
               set_meta: ShardSetMeta = None,
               **load_kw) -> Tuple[ShardSetMeta, state_mod.IndexState]:
    """Load ONE shard, validated against the set manifest: its dir must
    exist, its own manifest bytes must match the pinned CRC (foreign or
    rewritten shards are rejected by name), and its geometry must match
    the spec. ``load_kw`` passes through to ``store.load`` (``device``
    included)."""
    sm = set_meta if set_meta is not None else read_set_meta(directory)
    if not 0 <= shard_id < sm.spec.n_shards:
        raise ShardSetError(
            f"shard id {shard_id} out of range (n_shards="
            f"{sm.spec.n_shards})")
    name = sm.shard_dirs[shard_id]
    sub = os.path.join(directory, name)
    manifest = os.path.join(sub, store.MANIFEST)
    if not os.path.exists(manifest):
        raise ShardSetError(
            f"shard {name!r} is missing from shard set {directory!r}")
    with open(manifest, "rb") as f:
        crc = zlib.crc32(f.read())
    if crc != sm.manifest_crcs[shard_id]:
        raise ShardSetError(
            f"shard {name!r} in {directory!r}: its {store.MANIFEST} does "
            f"not match the shard-set manifest (crc32 {crc} != "
            f"{sm.manifest_crcs[shard_id]}) — foreign or rewritten shard")
    try:
        st = store.load(sub, **load_kw)
    except ShardSetError:
        raise
    except store.SnapshotError as e:
        raise ShardSetError(f"shard {name!r} in {directory!r}: {e}") from e
    _validate_shard(sm.spec, shard_id, st, f"shard {name!r}")
    return sm, st


def load_shard_set(directory: str, **load_kw):
    """Load every shard. Returns ``(ShardSetMeta, [IndexState, ...])``."""
    sm = read_set_meta(directory)
    states = [load_shard(directory, s, set_meta=sm, **load_kw)[1]
              for s in range(sm.spec.n_shards)]
    return sm, states
