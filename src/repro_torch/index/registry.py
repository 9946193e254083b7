"""HashScheme registry — the single point of hash-family dispatch.

Port of :mod:`repro.index.registry`. A scheme bundles up to three location
paths, each taking ``(cfg, tensor)`` with any leading batch axes:

* ``rolling``    — (cfg, codes) -> (..., η, n_kmers) locations for every
  stride-1 kmer of base codes (the 64-bit hash path);
* ``kmer_batch`` — (cfg, packed kmers) -> (..., η, n) locations for an
  arbitrary batch of packed kmers. Optional;
* ``rolling32``  — the 32-bit lane variant of ``rolling`` (the bit-sliced
  serving path). Optional.

Built-in schemes: ``idl`` (the paper's hash), ``rh`` (random-hash
baseline), ``lsh`` (rehashed MinHash ablation, Table 4), ``idl-bbf``
(IDL × Blocked-BF composition, §3.3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import idl as idl_mod

LocationFn = Callable[[idl_mod.IDLConfig, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HashScheme:
    """A named hash family with its location paths."""

    name: str
    rolling: LocationFn
    kmer_batch: Optional[LocationFn] = None
    rolling32: Optional[LocationFn] = None
    doc: str = ""
    # raises ValueError for a configuration the scheme cannot hash into
    # range (None: every IDLConfig is valid)
    check: Optional[Callable[[idl_mod.IDLConfig], None]] = None


_REGISTRY: dict[str, HashScheme] = {}


def register(scheme: HashScheme) -> HashScheme:
    """Register (or replace) a scheme under ``scheme.name``."""
    _REGISTRY[scheme.name] = scheme
    return scheme


def get(name: str) -> HashScheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown hash scheme {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> list[str]:
    return sorted(_REGISTRY)


def check_config(cfg: idl_mod.IDLConfig, scheme: str) -> None:
    """Raise ``ValueError`` unless ``scheme`` can hash ``cfg`` into range:
    every engine's ``build`` and every :class:`~repro_torch.index.state
    .StateMeta` (snapshot loads, engine views) pass through here, before any
    words are allocated or probed."""
    check = get(scheme).check
    if check is not None:
        check(cfg)


def locations(cfg: idl_mod.IDLConfig, codes: torch.Tensor, scheme: str
              ) -> torch.Tensor:
    """Rolling locations of ``scheme`` for all stride-1 kmers of ``codes``."""
    return get(scheme).rolling(cfg, codes)


def locations32(cfg: idl_mod.IDLConfig, codes: torch.Tensor, scheme: str
                ) -> torch.Tensor:
    """32-bit-lane rolling locations (the bit-sliced serving path)."""
    s = get(scheme)
    if s.rolling32 is None:
        raise ValueError(f"scheme {s.name!r} has no 32-bit lane path")
    return s.rolling32(cfg, codes)


def kmer_locations(cfg: idl_mod.IDLConfig, kmer_arr: torch.Tensor,
                   scheme: str) -> torch.Tensor:
    """Locations for an arbitrary batch of packed kmers."""
    s = get(scheme)
    if s.kmer_batch is None:
        raise ValueError(f"kmer-batch API not defined for scheme {s.name!r}")
    return s.kmer_batch(cfg, kmer_arr)


register(HashScheme(
    name="idl",
    rolling=idl_mod.idl_locations_rolling,
    kmer_batch=idl_mod.idl_locations_kmer_batch,
    rolling32=idl_mod.idl_locations_rolling32,
    doc="IDentity with Locality: ψ(x) = ρ₁(MinHash(x)) + ρ₂(x) (Theorem 1).",
))

register(HashScheme(
    name="rh",
    rolling=idl_mod.rh_locations_rolling,
    kmer_batch=idl_mod.rh_locations,
    rolling32=idl_mod.rh_locations_rolling32,
    doc="Random-hash baseline (MurmurHash-style partitioned BF).",
))

register(HashScheme(
    name="lsh",
    rolling=idl_mod.lsh_locations_rolling,
    doc="Rehashed MinHash only (Table 4 ablation: locality, identity loss).",
))

register(HashScheme(
    name="idl-bbf",
    rolling=idl_mod.idl_bbf_locations_rolling,
    check=idl_mod.check_bbf_config,
    doc="IDL × Blocked-Bloom composition (§3.3): window + one cache line.",
))
