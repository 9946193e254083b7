"""Arch registry: every configuration the port serves is selectable by name.

Port of the registry half of :mod:`repro.configs.base`. An
:class:`ArchSpec` bundles, per architecture:

  * the FULL published config (exact numbers from the assignment),
  * a REDUCED smoke config (same family, tiny sizes) for CPU tests,
  * ``shapes``: the architecture's own input-shape set,
  * ``step_fn(config, shape)`` — the function that serves one batch of a
    ``serve`` cell or takes one train step of a ``train`` cell,
  * ``model_flops_fn(config, shape)`` — the model FLOPs of one step.

The reference's mesh and ``PartitionSpec`` fields and its ``input_specs``
/ ``abstract_state`` (``ShapeDtypeStruct`` stand-ins for its dry run) have
no counterpart yet. The families are those of the reference: ``lm`` (five
transformer archs), ``recsys`` (fm, sasrec, two-tower-retrieval, mind),
``gnn`` (equiformer-v2) and ``genesearch`` (idl-genesearch, serve-only);
:func:`all_archs` lists the same 11 names as the reference's. A family's
modules are imported on the first registry lookup, not with the package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture × input-shape) cell."""

    name: str
    kind: str                 # "train" | "serve"
    meta: dict[str, Any]
    skip_reason: Optional[str] = None


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str               # "lm" | "gnn" | "recsys" | "genesearch"
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: dict[str, ShapeCell]
    step_fn: Callable[[Any, ShapeCell], Callable]
    model_flops_fn: Optional[Callable[[Any, ShapeCell], float]] = None


_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate arch {spec.name}")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> ArchSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import side-effect registration, deferred to avoid cycles
    from repro_torch.configs import (  # noqa: F401
        arctic_480b, equiformer_v2, fm, granite_20b, granite_moe_1b_a400m,
        idl_genesearch, internlm2_20b, mind, nemotron_4_340b, sasrec,
        two_tower_retrieval,
    )
