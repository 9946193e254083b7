"""Functional index state: word matrices plus static meta.

Port of :mod:`repro.index.state` for all four engines. An
:class:`IndexState` is a tuple of packed ``(n_rows, W)`` int32 word
matrices (one per COBS size group, one for every other engine) and a
hashable :class:`StateMeta`; engines are thin views over it.

Inserts update the word matrix **in place** (torch has no donation); the
consumed-value guard stays: an insert marks its input value consumed, and
touching it again raises :class:`StaleIndexError`. ``donate=False`` clones
the matrix first and leaves the input live.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import idl as idl_mod
from repro_torch.index import registry


class StaleIndexError(RuntimeError):
    """A consumed index value was used again."""


_STALE_MSG = (
    "this {what} was consumed by an insert: the update was applied to its "
    "storage in place and handed to the returned value, so only the "
    "*returned* index may be used (linear-use style). Keep the result of "
    "insert()/insert_batch(), or pass donate=False to keep the input alive "
    "at the cost of one copy."
)


def mark_consumed(obj) -> None:
    """Flag a (frozen) index value as consumed. Idempotent."""
    object.__setattr__(obj, "_consumed", True)


def ensure_live(obj, what: str = "index value") -> None:
    """Raise :class:`StaleIndexError` if ``obj`` was consumed by an insert."""
    if getattr(obj, "_consumed", False):
        raise StaleIndexError(_STALE_MSG.format(what=what))


ENGINES = ("bloom", "cobs", "rambo", "bitsliced")


@dataclasses.dataclass(frozen=True)
class StateMeta:
    """Hashable static half of an :class:`IndexState` (the reference's
    fields, so snapshot manifests read the same in both packages)."""

    engine: str                                   # one of ENGINES
    scheme: str
    cfgs: Tuple[idl_mod.IDLConfig, ...]
    n_files: Optional[int] = None                 # cobs / rambo / bitsliced
    k: Optional[int] = None                       # cobs top-level kmer size
    group_file_ids: Optional[Tuple[Tuple[int, ...], ...]] = None   # cobs
    n_buckets: Optional[int] = None               # rambo B
    n_rep: Optional[int] = None                   # rambo R

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(
                f"unknown engine kind {self.engine!r} (want one of {ENGINES})"
            )
        for cfg in self.cfgs:
            registry.check_config(cfg, self.scheme)


@dataclasses.dataclass(frozen=True)
class IndexState:
    """Index storage: int32 word matrices plus meta."""

    words: Tuple[torch.Tensor, ...]
    meta: StateMeta

    @property
    def nbytes(self) -> int:
        return sum(int(w.numel()) * 4 for w in self.words)

    @property
    def device(self) -> torch.device:
        return self.words[0].device


def kmer_size(meta: StateMeta) -> int:
    """The kmer size every read/query against this state is cut into."""
    return int(meta.k if meta.k is not None else meta.cfgs[0].k)


def from_numpy(meta_json: dict, words: Sequence[np.ndarray],
               device="cuda") -> IndexState:
    """An :class:`IndexState` from a snapshot's manifest meta and its word
    arrays (uint32 or int32, as the reference writes them), on ``device``.

    This is how a state built by either package — the JAX reference
    included — is carried into the port.
    """
    from repro_torch.index import store

    meta = store.meta_from_json(meta_json)
    dev = torch.device(device)
    tensors = []
    for arr in words:
        if arr.dtype not in (np.uint32, np.int32):
            raise ValueError(f"word arrays must be uint32/int32, got {arr.dtype}")
        host = arr.view(np.int32)
        if dev.type == "cpu" or not host.flags.writeable:
            # one host copy: the state must never alias the caller's array,
            # and torch takes no read-only one; an upload copies anyway
            host = np.array(host, copy=True)
        tensors.append(torch.from_numpy(host).to(dev))
    return IndexState(words=tuple(tensors), meta=meta)


def from_engine(index) -> IndexState:
    """Extract the :class:`IndexState` behind an engine value."""
    from repro_torch.index import engines

    if isinstance(index, IndexState):
        return index
    if isinstance(index, engines.PackedBloomIndex):
        ensure_live(index, what="engine")
        return IndexState(
            words=(index.words,),
            meta=StateMeta(engine="bloom", scheme=index.scheme,
                           cfgs=(index.cfg,)),
        )
    if isinstance(index, engines.CobsIndex):
        ensure_live(index, what="engine")
        return IndexState(
            words=tuple(g.words for g in index.groups),
            meta=StateMeta(
                engine="cobs", scheme=index.scheme,
                cfgs=tuple(g.cfg for g in index.groups),
                n_files=index.n_files, k=index.k,
                group_file_ids=tuple(g.file_ids for g in index.groups)),
        )
    if isinstance(index, engines.RamboIndex):
        ensure_live(index, what="engine")
        return IndexState(
            words=(index.words,),
            meta=StateMeta(engine="rambo", scheme=index.scheme,
                           cfgs=(index.cfg,), n_files=index.n_files,
                           n_buckets=index.n_buckets, n_rep=index.n_rep),
        )
    if isinstance(index, engines.BitSlicedIndex):
        ensure_live(index, what="engine")
        return IndexState(
            words=(index.words,),
            meta=StateMeta(engine="bitsliced", scheme=index.scheme,
                           cfgs=(index.cfg,), n_files=index.n_files),
        )
    raise TypeError(f"not a GeneIndex engine or IndexState: {type(index)!r}")


def to_engine(state: IndexState):
    """Rebuild the engine view a state was extracted from (loss-free)."""
    from repro_torch.index import engines

    ensure_live(state, what="IndexState")
    meta = state.meta
    if meta.engine == "bloom":
        return engines.PackedBloomIndex(
            cfg=meta.cfgs[0], scheme=meta.scheme, words=state.words[0])
    if meta.engine == "cobs":
        return engines.CobsIndex(
            groups=tuple(
                engines.CobsGroupState(cfg=cfg, file_ids=fids, words=w)
                for cfg, fids, w in zip(meta.cfgs, meta.group_file_ids,
                                        state.words)),
            scheme=meta.scheme, n_files=meta.n_files, k=meta.k)
    if meta.engine == "rambo":
        return engines.RamboIndex(
            cfg=meta.cfgs[0], scheme=meta.scheme, n_files=meta.n_files,
            n_buckets=meta.n_buckets, n_rep=meta.n_rep, words=state.words[0])
    if meta.engine == "bitsliced":
        return engines.BitSlicedIndex(
            cfg=meta.cfgs[0], scheme=meta.scheme, n_files=meta.n_files,
            words=state.words[0])
    raise ValueError(f"unknown engine kind {meta.engine!r}")


def insert(state: IndexState, reads, file_ids=None, *, donate: bool = True,
           **kw) -> IndexState:
    """Insert and return the updated state; consumes ``state`` unless
    ``donate=False``."""
    new_eng = to_engine(state).insert_batch(reads, file_ids, donate=donate,
                                            **kw)
    if donate:
        mark_consumed(state)
    return from_engine(new_eng)


def query(state: IndexState, reads, **kw) -> torch.Tensor:
    """Per-kmer membership query (engine-shaped output)."""
    return to_engine(state).query_batch(reads, **kw)


def msmt(state: IndexState, reads, theta: float = 1.0, **kw) -> torch.Tensor:
    """Multiple-Set Membership Test at coverage threshold ``theta``."""
    return to_engine(state).msmt(reads, theta=theta, **kw)
