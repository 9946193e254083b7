"""Arch registry: every configuration the port serves is selectable by name.

Port of :mod:`repro.configs.base`. An :class:`ArchSpec` bundles, per
architecture:

  * the FULL published config (exact numbers from the assignment),
  * a REDUCED smoke config (same family, tiny sizes) for CPU tests,
  * ``shapes``: the architecture's own input-shape set,
  * ``input_specs(config, shape)`` — every input as a tensor on the
    ``"meta"`` device (the reference's ``ShapeDtypeStruct`` stand-ins: a
    shape and a dtype, no allocation),
  * ``abstract_state(config, shape)`` — the step's carried state (params /
    TrainState / KV cache / index) on ``"meta"``,
  * ``step_fn(config, shape)`` — the function that serves one batch of a
    ``serve`` cell or takes one train step of a ``train`` cell,
  * ``state_spec_fn`` / ``batch_spec_fn`` — ``(config, path, shape) ->
    spec``, a leaf's partition spec as a tuple of mesh-axis entries
    (:mod:`repro_torch.distributed.sharding`),
  * ``model_flops_fn(config, shape)`` — the model FLOPs of one step.

Meta leaves keep the reference's shapes; their dtypes are the reference's
with two recorded mappings: uint32 words ride as int32 views of the same
bits and a uint64 hash as int64. A leaf's path is the reference's path
string (dict keys and dataclass field names joined by ``/``,
:func:`tree_paths`), which the spec functions match on. The families are
the reference's: ``lm`` (five transformer archs), ``recsys`` (fm, sasrec,
two-tower-retrieval, mind), ``gnn`` (equiformer-v2) and ``genesearch``
(idl-genesearch, serve-only); :func:`all_archs` lists the same 11 names
as the reference's. A family's modules are imported on the first
registry lookup, not with the package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import NamedSharding, axis_sizes
from repro_torch.train.checkpoint import _flatten_with_paths


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
    # fns taking (config, shape_cell) — family modules fill these in
    input_specs: Callable[[Any, ShapeCell], dict]
    abstract_state: Callable[[Any, ShapeCell], Any]
    step_fn: Callable[[Any, ShapeCell], Callable]
    state_spec_fn: Callable[[Any, str, tuple], tuple]  # (cfg, path, shape)
    batch_spec_fn: Callable[[Any, str, tuple], tuple]
    model_flops_fn: Optional[Callable[[Any, ShapeCell], float]] = None

    def cells(self) -> list[tuple[str, ShapeCell]]:
        return [(n, c) for n, c in self.shapes.items()]


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


def abstract(shape: tuple, dtype) -> torch.Tensor:
    """A ``(shape, dtype)`` stand-in on the ``"meta"`` device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def tree_paths(tree) -> dict:
    """{path: leaf} of a tree in JAX's order, keyed by the reference's path
    strings: dict keys (sorted) and a dataclass's field names joined by
    ``/``; ``None`` leaves are absent."""
    from repro_torch.train.checkpoint import _flatten_with_paths

    return {"/".join(p.lstrip(".") for p in key.split("/")): leaf
            for key, leaf in _flatten_with_paths(tree).items()}


# --------------------------------------------------------------------------
# sharding helpers shared by family modules
# --------------------------------------------------------------------------

DP_AXES = ("pod", "data")


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in DP_AXES if a in mesh.mesh_dim_names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def valid_spec(mesh, shape: tuple, spec: tuple) -> tuple:
    """Drop mesh axes absent from this mesh (e.g. 'pod' on single-pod) and
    sharded dims the axis size doesn't divide (the reference's
    GSPMD-safe fallback)."""
    fixed: list = []
    for i, ax in enumerate(spec):
        if i >= len(shape):
            break
        if ax is not None:
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
            ax = None if not axes else (axes[0] if len(axes) == 1 else axes)
        if ax is None or shape[i] % axis_size(mesh, ax):
            fixed.append(None)
        else:
            fixed.append(ax)
    return tuple(fixed)


def tree_shardings(mesh, tree, spec_fn: Callable[[str, tuple], tuple]
                   ) -> dict:
    """{path: :class:`NamedSharding`} of every leaf of ``tree`` (meta or
    real tensors), by ``spec_fn(path, shape)`` made valid on ``mesh``.
    Keyed by path where the reference returns a tree of the same
    structure."""
    return {path: NamedSharding(mesh, valid_spec(
        mesh, tuple(leaf.shape), spec_fn(path, tuple(leaf.shape))))
        for path, leaf in tree_paths(tree).items()}


def generic_state_spec(path: str, shape: tuple) -> tuple:
    """Fallback FSDP heuristic: biggest dim over (pod,data), next over model.

    Used by families without bespoke rules; exact-name rules in the family
    modules take precedence.
    """
    if len(shape) == 0 or max(shape) == 1 or len(shape) == 1:
        return ()
    order = np.argsort(shape)[::-1]
    spec: list = [None] * len(shape)
    spec[int(order[0])] = DP_AXES
    if len(shape) >= 2 and shape[int(order[1])] > 1:
        spec[int(order[1])] = "model"
    return tuple(spec)


def cell_rules(spec: ArchSpec, cell: ShapeCell, mesh) -> sh.ShardingRules:
    """The reference's rules for a cell's step: ``default_mapping`` on
    ``mesh``, with the sequence-parallel residual stream for LM cells that
    do not decode (training and prefill)."""
    seq_parallel = spec.family == "lm" and cell.meta.get("mode") != "decode"
    return sh.ShardingRules(mesh, sh.default_mapping(
        mesh, seq_parallel=seq_parallel))


def cell_shardings(spec: ArchSpec, cfg, mesh, state, batch
                   ) -> tuple[dict, dict]:
    """({path: NamedSharding} of ``state``, the same of ``batch``) by the
    arch's spec functions, made valid on ``mesh``."""
    return (tree_shardings(mesh, state,
                           lambda p, s: spec.state_spec_fn(cfg, p, s)),
            tree_shardings(mesh, batch,
                           lambda p, s: spec.batch_spec_fn(cfg, p, s)))


def distribute_cell(spec: ArchSpec, cfg, mesh, state, batch):
    """``(state, batch)`` as DTensors on ``mesh``, laid out as
    :func:`cell_shardings` says (each process keeps its own shards of the
    trees it holds whole)."""
    state_sh, batch_sh = cell_shardings(spec, cfg, mesh, state, batch)
    return (sh.distribute_tree(state, state_sh),
            sh.distribute_tree(batch, batch_sh))
