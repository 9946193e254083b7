"""Versioned on-disk snapshots of an :class:`IndexState`.

Port of :mod:`repro.index.store`, with the same format: one directory
holding ``manifest.json`` (format tag, integer version, ``StateMeta``, and
per-array shape / dtype / CRC-32) and one ``words_<i>.npy`` (uint32) per
word matrix (a COBS index writes one per size group). Snapshots of every
engine written by either package load in the other. A shard-set snapshot
(:mod:`repro_torch.index.shards`) is refused by :func:`load` with a pointer
to ``shards.load_shard_set``, and :func:`read_meta` answers with its full
unsharded meta.

``verify`` picks when the checksum pass runs: ``"eager"`` (before ``load``
returns), ``"lazy"`` (a background thread; :func:`check_verified` reports
its outcome) or ``"off"``. Manifest shape/dtype specs are always checked.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from typing import Dict, Optional, Union

import numpy as np

from repro_torch.core import idl as idl_mod
from repro_torch.index import state as state_mod

FORMAT = "idl-index-snapshot"
VERSION = 1
MANIFEST = "manifest.json"


class SnapshotError(ValueError):
    """A snapshot directory is missing, foreign, corrupt, or from an
    incompatible format version."""


# ---------------------------------------------------------------------------
# Meta <-> JSON.
# ---------------------------------------------------------------------------

def _cfg_from_json(d: dict) -> idl_mod.IDLConfig:
    try:
        return idl_mod.IDLConfig(**d)
    except TypeError as e:
        raise SnapshotError(
            f"snapshot IDLConfig does not match this build's fields: {e}"
        ) from e


def meta_to_json(meta: state_mod.StateMeta) -> dict:
    return {
        "engine": meta.engine,
        "scheme": meta.scheme,
        "cfgs": [dataclasses.asdict(c) for c in meta.cfgs],
        "n_files": meta.n_files,
        "k": meta.k,
        "group_file_ids": (
            None if meta.group_file_ids is None
            else [list(g) for g in meta.group_file_ids]),
        "n_buckets": meta.n_buckets,
        "n_rep": meta.n_rep,
    }


def meta_from_json(d: dict) -> state_mod.StateMeta:
    try:
        return state_mod.StateMeta(
            engine=d["engine"],
            scheme=d["scheme"],
            cfgs=tuple(_cfg_from_json(c) for c in d["cfgs"]),
            n_files=d.get("n_files"),
            k=d.get("k"),
            group_file_ids=(
                None if d.get("group_file_ids") is None
                else tuple(tuple(int(i) for i in g)
                           for g in d["group_file_ids"])),
            n_buckets=d.get("n_buckets"),
            n_rep=d.get("n_rep"),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise SnapshotError(f"snapshot meta is malformed: {e!r}") from e


# ---------------------------------------------------------------------------
# Save / load.
# ---------------------------------------------------------------------------

def save(index, directory: str) -> str:
    """Write a versioned snapshot of an ``IndexState`` (or engine view).

    Creates ``directory`` if needed and (over)writes ``manifest.json`` plus
    one ``words_<i>.npy`` (uint32) per word matrix. Returns ``directory``.
    """
    state = state_mod.from_engine(index)
    state_mod.ensure_live(state, what="IndexState")
    os.makedirs(directory, exist_ok=True)
    arrays = []
    for i, w in enumerate(state.words):
        arr = np.ascontiguousarray(w.cpu().numpy().view(np.uint32))
        fname = f"words_{i}.npy"
        np.save(os.path.join(directory, fname), arr)
        arrays.append({
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc32": zlib.crc32(arr),
        })
    manifest = {
        "format": FORMAT,
        "version": VERSION,
        "meta": meta_to_json(state.meta),
        "arrays": arrays,
    }
    tmp = os.path.join(directory, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(directory, MANIFEST))  # atomic publish
    return directory


def _read_manifest(directory: str) -> dict:
    path = os.path.join(directory, MANIFEST)
    if not os.path.exists(path):
        from repro_torch.index import shards as shards_mod

        if shards_mod.is_shard_set(directory):
            raise SnapshotError(
                f"{directory!r} is a SHARD-SET snapshot, not a single-index "
                f"snapshot — load it with "
                f"repro_torch.index.shards.load_shard_set (or read its meta "
                f"with store.read_meta)")
        raise SnapshotError(f"no {MANIFEST} in {directory!r} — not a snapshot")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as e:
        raise SnapshotError(f"corrupt {MANIFEST} in {directory!r}: {e}") from e
    if manifest.get("format") != FORMAT:
        raise SnapshotError(
            f"{directory!r} is not an index snapshot "
            f"(format tag {manifest.get('format')!r}, want {FORMAT!r})")
    version = manifest.get("version")
    if version != VERSION:
        raise SnapshotError(
            f"snapshot format version {version!r} is not supported by this "
            f"build (reads version {VERSION}); rebuild the snapshot or "
            f"upgrade the reader")
    return manifest


VERIFY_MODES = ("eager", "lazy", "off")


def _crc_error(spec: dict, crc: int, when: str = "") -> SnapshotError:
    return SnapshotError(
        f"array {spec['file']!r} failed its {when}checksum (crc32 {crc} != "
        f"manifest {spec['crc32']}) — snapshot is corrupt")


class _LazyVerify:
    """Handle for one background checksum pass over a snapshot."""

    def __init__(self, directory: str, specs: list):
        self.directory = directory
        self.error: Optional[SnapshotError] = None
        self._thread = threading.Thread(
            target=self._run, args=(specs,), daemon=True,
            name="idl-snapshot-verify")
        self._thread.start()

    def _run(self, specs: list) -> None:
        try:
            for spec in specs:
                arr = np.load(os.path.join(self.directory, spec["file"]),
                              mmap_mode="r")
                crc = zlib.crc32(np.ascontiguousarray(arr))
                if crc != spec["crc32"]:
                    raise _crc_error(spec, crc, "background ")
        except SnapshotError as e:
            self.error = e
        except Exception as e:  # noqa: BLE001 - any read failure is corrupt
            self.error = SnapshotError(
                f"background verify of {self.directory!r} failed: {e!r}")

    def check(self, *, wait: bool = True) -> bool:
        if wait:
            self._thread.join()
        elif self._thread.is_alive():
            return False
        if self.error is not None:
            raise self.error
        return True


_lazy_verifies: Dict[str, _LazyVerify] = {}
_lazy_lock = threading.Lock()


def check_verified(directory: str, *, wait: bool = True) -> bool:
    """Outcome of a ``verify="lazy"`` load's background checksum pass:
    True once it finished clean (or none is registered), False while it
    runs and ``wait=False``; raises :class:`SnapshotError` on corruption."""
    with _lazy_lock:
        handle = _lazy_verifies.get(os.path.abspath(directory))
    if handle is None:
        return True
    return handle.check(wait=wait)


def read_meta(directory: str) -> state_mod.StateMeta:
    """Just the snapshot's :class:`StateMeta` (no array bytes touched): how
    the fabric gateway learns the geometry without holding the index. A
    shard set answers with the FULL unsharded meta from its CRC-checked
    set manifest."""
    if not os.path.exists(os.path.join(directory, MANIFEST)):
        from repro_torch.index import shards as shards_mod

        if shards_mod.is_shard_set(directory):
            return shards_mod.read_set_meta(directory).spec.meta
    return meta_from_json(_read_manifest(directory)["meta"])


def _normalize_verify(verify) -> str:
    if verify is True:
        return "eager"
    if verify is False:
        return "off"
    if verify not in VERIFY_MODES:
        raise ValueError(
            f"verify must be one of {VERIFY_MODES} (or a legacy bool), "
            f"got {verify!r}")
    return verify


def load(directory: str, *, mmap: bool = True,
         verify: Union[str, bool] = "eager",
         device="cuda") -> state_mod.IndexState:
    """Load a snapshot into an :class:`IndexState` on ``device``.

    ``mmap=True`` opens the word files memory-mapped (copy-on-write, so
    the mapping is never written back), so bytes page in as the upload
    consumes them; checksums run over the mapped bytes without a copy. Raises :class:`SnapshotError` on any
    mismatch (foreign, corrupt, truncated or future-version snapshots).
    """
    verify = _normalize_verify(verify)
    manifest = _read_manifest(directory)
    specs = manifest.get("arrays", [])
    if len(specs) != len(manifest["meta"].get("cfgs", ())):
        raise SnapshotError(
            f"snapshot has {len(specs)} arrays but meta describes "
            f"{len(manifest['meta'].get('cfgs', ()))} — manifest is "
            f"inconsistent")
    words = []
    for spec in specs:
        fname = spec["file"]
        if os.path.basename(fname) != fname or fname in ("", ".", ".."):
            # a crafted manifest must not read outside the snapshot dir
            raise SnapshotError(
                f"snapshot array file {fname!r} is not a plain file name")
        path = os.path.join(directory, fname)
        if not os.path.exists(path):
            raise SnapshotError(f"snapshot array file missing: {path!r}")
        try:
            arr = np.load(path, mmap_mode="c" if mmap else None)
        except ValueError as e:
            raise SnapshotError(f"corrupt array file {path!r}: {e}") from e
        if list(arr.shape) != list(spec["shape"]) or \
                str(arr.dtype) != spec["dtype"]:
            raise SnapshotError(
                f"array {spec['file']!r} is {arr.dtype}{arr.shape}, "
                f"manifest says {spec['dtype']}{tuple(spec['shape'])}")
        if verify == "eager":
            crc = zlib.crc32(np.ascontiguousarray(arr))
            if crc != spec["crc32"]:
                raise _crc_error(spec, crc)
        words.append(arr)
    state = state_mod.from_numpy(manifest["meta"], words, device)
    if verify == "lazy":
        with _lazy_lock:
            _lazy_verifies[os.path.abspath(directory)] = _LazyVerify(
                directory, list(specs))
    return state


def load_engine(directory: str, **kw):
    """Load a snapshot and rebuild the engine view in one call."""
    return state_mod.to_engine(load(directory, **kw))
