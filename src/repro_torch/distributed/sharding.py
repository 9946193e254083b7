"""Logical-axis sharding: model code names axes, policies map them to a mesh.

Port of :mod:`repro.distributed.sharding` over ``torch.distributed``'s
``DeviceMesh`` and DTensor placements. A :class:`ShardingRules` maps
logical axis names to mesh axes (or None = replicated):
:meth:`ShardingRules.spec` gives the reference's ``PartitionSpec`` as a
plain tuple of mesh-axis entries (``None``, one axis name, or a tuple of
names), and :meth:`ShardingRules.named` its DTensor placements. A spec
entry becomes ``Shard(dim)`` on each mesh dim it names and every other
mesh dim is ``Replicate()``; a dim sharded over two axes (``("pod",
"data")``) is ``Shard(dim)`` on both, split in mesh order.

Default production mapping (the reference's):
  batch    -> ("pod", "data")   activations' batch dim (DP)
  fsdp     -> ("pod", "data")   params' largest dim (FSDP / ZeRO-3)
  embed    -> None              d_model of activations stays replicated on TP
  heads    -> "model"           attention heads (TP)
  kv_heads -> "model" if divisible else None (MQA/GQA replication)
  mlp      -> "model"           d_ff (TP)
  experts  -> "model"           MoE expert dim (EP)
  vocab    -> "model"           output logits dim
  seq      -> None ("model" under sequence-parallel prefill)
  nodes/edges -> ("pod", "data")  GNN graph partition
  table_rows  -> "model"          recsys embedding-table rows
  files       -> "model"          gene-search index file axis

With no rules active, :func:`shard` returns its input. The port's models
dropped the reference's ``shard(...)`` calls (its ``layers``,
``transformer``, ``recsys`` and ``equiformer`` modules): on one card they
are no-ops, and with rules active they would act on DTensor inputs only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_STATE = threading.local()


def axis_sizes(mesh) -> dict[str, int]:
    """{mesh axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of a spec (a tuple of mesh-axis entries, one
    a tensor dim): ``Shard(dim)`` on each mesh dim an entry names,
    ``Replicate()`` on the rest."""
    out: list = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            out[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """One device's local shape of a global ``shape`` (each sharded dim
        must divide by its axes' sizes, as ``valid_spec`` leaves it)."""
        sizes = axis_sizes(self.mesh)
        out = list(shape)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            for axis in (entry,) if isinstance(entry, str) else entry:
                if out[dim] % sizes[axis]:
                    raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                     f"divide over mesh axis {axis!r}")
                out[dim] //= sizes[axis]
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any
    mapping: dict[str, Any]

    def spec(self, logical: Sequence[str | None] | str | None) -> tuple:
        if logical is None:
            return ()
        if isinstance(logical, str):
            logical = (logical,)
        axes: list = []
        used: set[str] = set()
        for name in logical:
            if name is None:
                axes.append(None)
                continue
            mesh_axes = self.mapping.get(name)
            if mesh_axes is None:
                axes.append(None)
                continue
            if isinstance(mesh_axes, str):
                mesh_axes = (mesh_axes,)
            free = tuple(a for a in mesh_axes if a not in used)
            used.update(free)
            # no axis left is replicated (PartitionSpec reads () as None)
            axes.append(None if not free else
                        free if len(free) > 1 else free[0])
        return tuple(axes)

    def named(self, logical) -> tuple:
        """The DTensor placements of ``spec(logical)`` on the mesh."""
        return placements(self.mesh, self.spec(logical))


def default_mapping(mesh, *, seq_parallel: bool = False) -> dict[str, Any]:
    axes = mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in axes)
    tp = "model" if "model" in axes else None
    return {
        "batch": dp, "fsdp": dp,
        "embed": None,
        "heads": tp, "kv_heads": tp, "mlp": tp, "experts": tp, "vocab": tp,
        # Megatron-style sequence parallelism: the residual stream ("seq")
        # is seq-sharded over the TP axis; inside attention/MLP the seq dim
        # is unsharded ("act_seq") and the TP axis moves to heads/mlp
        "seq": tp if seq_parallel else None,
        "act_seq": None,
        # flattened (B·S) token dim (MoE dispatch/combine)
        "tokens": dp,
        "nodes": dp, "edges": dp,
        "table_rows": tp, "files": tp,
        "expert_cap": dp,
    }


def make_rules(mesh, **overrides) -> ShardingRules:
    mapping = default_mapping(mesh)
    mapping.update(overrides)
    return ShardingRules(mesh=mesh, mapping=mapping)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def active_rules() -> ShardingRules | None:
    return getattr(_STATE, "rules", None)


def shard(x: torch.Tensor, logical) -> torch.Tensor:
    """``x`` laid out by logical axis names: a DTensor is redistributed to
    the active rules' placements; a plain tensor, or any tensor with no
    rules active, comes back as it is."""
    rules = active_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(rules.mesh, rules.named(logical))


def shard_if_divisible(x: torch.Tensor, logical, dim: int,
                       axis_name: str = "model") -> torch.Tensor:
    """Shard unless the dim doesn't divide the mesh axis (KV-head
    replication)."""
    rules = active_rules()
    if rules is None:
        return x
    size = axis_sizes(rules.mesh).get(axis_name, 1)
    if x.shape[dim] % max(size, 1):
        logical = tuple(
            None if i == dim else l for i, l in enumerate(logical)
        )
    return shard(x, logical)
