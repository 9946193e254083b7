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

With no rules active, :func:`shard` returns its input, so the models'
``shard(...)`` calls (at the reference's call sites, with its logical
axes) cost nothing on one card. A step runs sharded when its state and
inputs are DTensors (:func:`distribute_tree`) and it is called under
:func:`sharded_step`: each ``shard`` then redistributes its DTensor to
the rules' placements, the collective GSPMD would insert at a
``with_sharding_constraint``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Sequence

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

_STATE = threading.local()


def axis_sizes(mesh) -> dict[str, int]:
    """{mesh axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of a spec (a tuple of mesh-axis entries, one
    a tensor dim): ``Shard(dim)`` on each mesh dim of more than one device
    that an entry names, ``Replicate()`` on the rest (a dim split over one
    device is whole, and DTensor handles it best as replicated)."""
    out: list = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            i = mesh.mesh_dim_names.index(axis)
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
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
    return x.redistribute(rules.mesh, _fit(x.shape, rules.named(logical),
                                           rules.mesh))


def _fit(shape, where: tuple, mesh) -> list:
    """``where`` without the splits of a dim over more devices than it has
    entries (a batch of one over 'data'): such a dim stays whole, where
    GSPMD would pad it, and DTensor could not reshape it."""
    ways = [1] * len(shape)
    out = []
    for size, p in zip(mesh.shape, where):
        if isinstance(p, Shard):
            if shape[p.dim] < ways[p.dim] * size:
                p = Replicate()
            else:
                ways[p.dim] *= size
        out.append(p)
    return out


def like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` laid out as ``x`` is, its pending partial sums reduced: a
    block's output projection handed back to the residual stream it
    reads, as GSPMD reduces a tensor-parallel product where it meets the
    next layout. Plain tensors come back as they are."""
    if (not isinstance(y, DTensor) or not isinstance(x, DTensor)
            or tuple(y.shape) != tuple(x.shape)
            or tuple(y.placements) == tuple(x.placements)):
        return y
    return y.redistribute(x.device_mesh, x.placements)


def layout(x: torch.Tensor, logical) -> torch.Tensor:
    """``x`` laid out by logical axis names as :func:`shard` lays it out,
    where the step needs one layout that GSPMD would choose by itself and
    DTensor does not: a step's inputs read by the rules of the activations
    they meet (not one of the reference's constraints)."""
    return shard(x, logical)


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


def gather_dims(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` with ``dims`` whole on every device (their mesh axes
    replicated, every other dim's sharding kept): the all-gather GSPMD
    inserts before a reshape that merges a sharded dim into the one
    before it, which DTensor cannot do locally. A plain tensor comes back
    as it is."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    want = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def split_last(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``x`` with its last dim split into ``shape``. A DTensor whose last
    dim is sharded over mesh axes whose size does not divide ``shape[0]``
    first gathers that dim (as the reference replicates KV heads that do
    not divide the model axis); a plain tensor is only reshaped."""
    if shape[0] % ways(x, -1):
        x = gather_dims(x, (-1,))
    return x.reshape(*x.shape[:-1], *shape)


def contract_as(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` laid out to be contracted with ``w`` (``x @ w``): its last dim
    split over each mesh axis that splits ``w``'s first dim and that ``x``
    leaves whole. Done here, before the product, autograd saves the split
    ``x`` too, and the weight's gradient is a product of shards rather
    than one repeated over the axis. A plain operand: ``x`` as it is."""
    if not isinstance(x, DTensor) or not isinstance(w, DTensor):
        return x
    want = list(x.placements)
    for i, p in enumerate(w.placements):
        if isinstance(p, Shard) and p.dim == 0 and isinstance(want[i],
                                                               Replicate):
            want[i] = Shard(x.ndim - 1)
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def merge_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with its last ``n`` dims merged into one. A DTensor keeps an
    even split of the first of them and gathers any other split among
    them first (DTensor merges those locally only)."""
    first = x.ndim - n
    gather = [d for d in range(first + 1, x.ndim) if ways(x, d) > 1]
    if x.shape[first] % ways(x, first):
        gather.append(first)
    if gather:
        x = gather_dims(x, gather)
    return x.reshape(*x.shape[:first], -1)


def ways(x: torch.Tensor, dim: int) -> int:
    """Into how many parts ``x``'s dim ``dim`` is sharded (1 for a plain
    tensor)."""
    if not isinstance(x, DTensor):
        return 1
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == dim % x.ndim:
            n *= size
    return n


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every pending ``Partial`` placement reduced (to
    ``Replicate``): a row gather over a sharded dim leaves its result
    partial, and DTensor cannot carry that partial value through a
    following index. A plain tensor comes back as it is."""
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def index_select(x: torch.Tensor, dim: int, index: torch.Tensor
                 ) -> torch.Tensor:
    """``x.index_select(dim, index)`` (``index`` 1-D). On DTensors each
    device takes its own entries of ``index`` from ``x`` made whole along
    ``dim`` (the all-gather GSPMD gives a gathered operand), and in
    backward adds them into a gradient of ``x`` that is partial over the
    mesh axes splitting ``index``: DTensor's own ``index_select`` backward
    mistakes that partial gradient for a whole one, and the indexing
    forms have no sharded backward in every release."""
    if not isinstance(x, DTensor) and not isinstance(index, DTensor):
        return x.index_select(dim, index)
    return _select_rows(x, dim, index)


def rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` for a 1-D ``index``; on DTensors
    :func:`index_select` along dim 0."""
    if not isinstance(x, DTensor) and not isinstance(index, DTensor):
        return x[index]
    return _select_rows(x, 0, index)


def _select_rows(x, dim: int, index):
    mesh = (x if isinstance(x, DTensor) else index).device_mesh
    whole = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, whole, run_check=False)
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, whole, run_check=False)
    dim %= x.ndim
    index = index.redistribute(mesh, [
        Shard(0) if isinstance(p, Shard) else Replicate()
        for p in index.placements])
    # x whole along dim, and whole on every mesh dim that splits index
    want = [Replicate() if isinstance(pi, Shard) or p.is_partial() or (
        isinstance(p, Shard) and p.dim == dim) else p
        for p, pi in zip(x.placements, index.placements)]
    x = x.redistribute(mesh, want)
    out = [Shard(dim) if isinstance(pi, Shard) else p
           for p, pi in zip(want, index.placements)]
    return _SelectRows.apply(x, index, dim, tuple(out))


class _SelectRows(torch.autograd.Function):
    """Each device's rows of a DTensor ``index_select`` on local shards;
    the gradient of the operand partial over the mesh dims that split the
    index."""

    @staticmethod
    def forward(ctx, x, index, dim, out):
        local_index = index.to_local()
        ctx.dim, ctx.out, ctx.index = dim, out, local_index
        ctx.x_local_shape = x.to_local().shape
        ctx.x_spec = (x.device_mesh, tuple(x.placements), x.shape, x.stride())
        got = x.to_local().index_select(dim, local_index)
        shape = list(x.shape)
        shape[dim] = index.shape[0]
        return DTensor.from_local(got, x.device_mesh, out, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_strides(shape))

    @staticmethod
    def backward(ctx, grad):
        mesh, where, shape, stride = ctx.x_spec
        g = grad.redistribute(mesh, ctx.out).to_local()
        local = g.new_zeros(ctx.x_local_shape).index_add(ctx.dim, ctx.index, g)
        grad_where = [Partial() if isinstance(o, Shard) and o.dim == ctx.dim
                      and not (isinstance(w, Shard) and w.dim == ctx.dim)
                      else w for w, o in zip(where, ctx.out)]
        return (DTensor.from_local(local, mesh, grad_where, run_check=False,
                                   shape=shape, stride=stride),
                None, None, None)


def _contiguous_strides(shape) -> tuple:
    out, n = [], 1
    for d in reversed(list(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (rows of a 2-D table, ``ids`` of any shape) for a
    DTensor table: an embedding lookup, which on a row-split table each
    device answers from its own rows (a masked local gather), the partial
    rows then summed across the split, where indexing would gather the
    whole table first. ``None`` for a plain table: the caller's own
    gather is the plain path."""
    if not isinstance(table, DTensor):
        return None
    return reduce_partial(torch.nn.functional.embedding(ids.long(), table))


def grad_as_placed(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is laid out as ``x`` is (its pending sums
    done) before it flows on: the slices of one stacked DTensor then hand
    its ``unbind`` gradients of one layout to stack, which DTensor
    requires. A plain tensor, or one outside autograd, as it is."""
    if isinstance(x, DTensor) and x.requires_grad:
        # a partial value's gradient is whole on its partial axes
        mesh = x.device_mesh
        where = tuple(Replicate() if p.is_partial() else p
                      for p in x.placements)
        x.register_hook(lambda g: g.redistribute(mesh, where)
                        if tuple(g.placements) != where else g)
    return x


def distribute_tree(tree, shardings: dict):
    """``tree`` (dicts and dataclasses of tensors, the registry's state or
    batch) with each leaf a DTensor laid out by ``shardings[path]`` (a
    :class:`NamedSharding`, keyed as ``configs.base.tree_shardings`` keys
    them). Every process holds the whole tree (the same seed) and keeps
    its own shard of each leaf: nothing is communicated."""
    from repro_torch.train.checkpoint import _flatten_with_paths, _rebuild

    out = {}
    for key, leaf in _flatten_with_paths(tree).items():
        sh = shardings["/".join(p.lstrip(".") for p in key.split("/"))]
        out[key] = distribute_tensor(leaf, sh.mesh, sh.placements,
                                     src_data_rank=None)
    return _rebuild(tree, out)


@contextlib.contextmanager
def sharded_step(rules: ShardingRules):
    """The context a step runs sharded under: ``rules`` active, and a
    plain tensor the step makes (positions, masks, zeros for a scatter)
    met by a DTensor as a replicated one."""
    with use_rules(rules), implicit_replication():
        yield


def inference(fn):
    """``fn`` (a serve step) run under ``torch.inference_mode``, or under
    ``torch.no_grad`` while rules are active: a DTensor's views cannot be
    inference tensors."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        mode = torch.inference_mode if active_rules() is None else torch.no_grad
        with mode():
            return fn(*args, **kwargs)
    return run
