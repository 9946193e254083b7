"""HashScheme registry — the single point of hash-family dispatch.

Port of :mod:`repro.index.registry` for the 32-bit lane path: ``idl`` and
``rh`` with their ``rolling32`` location functions. (``lsh`` and
``idl-bbf`` have only 64-bit paths in the reference.)
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
    rolling32: Optional[LocationFn] = None
    doc: str = ""


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


def locations32(cfg: idl_mod.IDLConfig, codes: torch.Tensor, scheme: str
                ) -> torch.Tensor:
    """32-bit-lane rolling locations (the serving path)."""
    s = get(scheme)
    if s.rolling32 is None:
        raise ValueError(f"scheme {s.name!r} has no 32-bit lane path")
    return s.rolling32(cfg, codes)


register(HashScheme(
    name="idl",
    rolling32=idl_mod.idl_locations_rolling32,
    doc="IDentity with Locality: ψ(x) = ρ₁(MinHash(x)) + ρ₂(x) (Theorem 1).",
))

register(HashScheme(
    name="rh",
    rolling32=idl_mod.rh_locations_rolling32,
    doc="Random-hash baseline (MurmurHash-style partitioned BF).",
))
