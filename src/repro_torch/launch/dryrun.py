"""Dry run of every (arch x shape x mesh) cell: shard, count, roofline.

Port of :mod:`repro.launch.dryrun` for the card. The reference jits each
step under its sharding rules for a 256- or 512-device TPU mesh, compiles
the SPMD-partitioned program and reads one device's FLOPs, bytes,
collective bytes and memory from it. Per cell, the port:

1. builds the cell's state and inputs on the ``"meta"`` device (the
   registry's ``abstract_state`` / ``input_specs``: shapes, no memory);
2. under a fake process group of the mesh's world size (one process
   standing for every device, :func:`fake_process_group`), builds
   :func:`~repro_torch.launch.mesh.make_production_mesh`, the reference's
   rules (``default_mapping(mesh, seq_parallel=...)``, sequence-parallel
   for LM cells that do not decode) and each leaf's placements from
   ``tree_shardings``, and turns the state and inputs into DTensors whose
   local shards are meta tensors (:func:`~repro_torch.distributed.
   sharding.distribute_tree`);
3. runs the registry's ``step_fn`` once under
   :func:`~repro_torch.distributed.sharding.sharded_step` and
   :class:`LocalCounter`, which sees the operators DTensor runs on one
   device's local shards (an operator on DTensors is counted where it
   runs on the shards, never at its global shape):
   - ``flops_per_chip``: every matrix product's FLOPs on the local
     shards, by ``FlopCounterMode``'s formulas (a remat recomputation
     included, as the reference's trip-aware HLO count includes it; a
     step with no matrix product, FM's, takes ``model_flops`` over the
     chips);
   - ``bytes_per_chip``: every operator's input and output bytes (a row
     gather's source only where it is gathered), as if nothing were fused
     or cached: an upper bound on what HBM moves (the counterpart of HLO's
     "bytes accessed" before fusion);
   - ``coll_bytes_per_chip``: the result bytes of every collective the
     step issues (``_c10d_functional`` all-gather, all-reduce,
     reduce-scatter, all-to-all), summed by the reference's kinds in
     ``coll_breakdown`` with their ``count``, as the reference's
     ``collective_bytes`` sums an HLO module's;
   - ``memory_stats``: one device's ``argument_size_in_bytes`` (the
     state's and inputs' local shards), ``output_size_in_bytes`` (the
     outputs' local shards) and ``temp_size_in_bytes`` (the peak of the
     bytes the step allocates, less those it returns);
4. records the roofline at the H100's rates
   (:mod:`repro_torch.roofline.analysis`), ``"count_split": "local
   shards"``, and beside it the unsharded totals over the chips
   (``even_split``: what an even split of the single-device count would
   say).

The mesh is a CPU mesh standing for the card's: a shard-to-shard
redistribution is counted as the all-to-all NCCL runs, not as the gloo
fallback's all-gather (:func:`alltoall_as_on_card`); the multi-pod mesh
runs as its ('dp', 'model') view, 'dp' the flattened ('pod', 'data')
pair that every reference spec splits together (:func:`folded`). The
reference's ``collective-permute`` key stays 0: DTensor issues none. The
gene-search
serve step cannot run on meta (its kernels and host planner need real
data) and its work is integer: it is counted from its shapes, split
evenly, with a ``count_source`` saying so. Cells with a ``skip_reason``
are recorded as skipped. The reference's ``roofline/hlo_cost.py`` parses
XLA HLO and is not ported: the count on local shards takes over its FLOP,
byte and collective count.

Usage:
    python -m repro_torch.launch.dryrun --arch sasrec --shape serve_p99 --mesh single
    python -m repro_torch.launch.dryrun --all    # every cell, both meshes
                                                 # (a subprocess per cell)
Records land in ``--out`` (default ``runs/dryrun/``) as one JSON per cell,
``{arch}__{shape}__{mesh}.json``, as the reference names them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

MESHES = {"single": 256, "multi": 512}
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
COLL_SOURCE = ("LocalCounter: the result bytes of each _c10d_functional "
               "collective the sharded step issues on one device, by kind")


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A default process group of ``world_size`` ranks held by this one
    process (``torch.testing``'s fake backend: collectives do nothing),
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def alltoall_as_on_card():
    """DTensor's shard-to-shard redistribution as it runs on the card (an
    all-to-all) while the dry run's mesh is a CPU mesh, where DTensor
    would fall back to gloo's all-gather and chunk."""
    from torch.distributed.tensor import placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        from torch.distributed import _functional_collectives as funcol

        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    before = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = before


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(obj)
               if isinstance(t, torch.Tensor))


# row gathers: the source (first argument) is read only where the output
# takes from it, not whole
_GATHERS = (torch.ops.aten.index_select.default,
            torch.ops.aten.embedding.default,
            torch.ops.aten.index.Tensor, torch.ops.aten.gather.default)


class ByteCounter(TorchDispatchMode):
    """Sums every operator's input and output tensor bytes (views and
    other aliasing operators move none; a row gather's source counts as
    the bytes it gathers)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func is torch.ops.aten.detach.default:
            return out
        n = _nbytes((args, kwargs, out))
        if func in _GATHERS:
            n -= max(0, _nbytes(args[0]) - _nbytes(out))
        self.bytes += n
        return out


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """(m, n) @ (n,): 2 m n FLOPs (``FlopCounterMode`` has no formula)."""
    return 2 * a_shape[0] * a_shape[1]


def _dot_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


_MATVEC = {torch.ops.aten.mv: _mv_flop, torch.ops.aten.dot: _dot_flop}


def _collective_kinds() -> dict:
    """{collective operator: the reference's kind} (``_c10d_functional``'s
    operators exist once ``torch.distributed`` has registered them)."""
    import torch.distributed._functional_collectives  # noqa: F401

    c10d = torch.ops._c10d_functional
    return {
        c10d.all_gather_into_tensor.default: "all-gather",
        c10d.all_gather_into_tensor_coalesced.default: "all-gather",
        c10d.all_reduce.default: "all-reduce",
        c10d.all_reduce_.default: "all-reduce",
        c10d.all_reduce_coalesced.default: "all-reduce",
        c10d.reduce_scatter_tensor.default: "reduce-scatter",
        c10d.reduce_scatter_tensor_coalesced.default: "reduce-scatter",
        c10d.all_to_all_single.default: "all-to-all",
        torch.ops._dtensor.shard_dim_alltoall.default: "all-to-all",
    }


# bookkeeping operators of the functional collectives: no work of their own
_NO_WORK = ("_c10d_functional::wait_tensor",
            "_c10d_functional::_wrap_tensor_autograd")


def _tensors(obj) -> list:
    """The tensors of a tree of tuples, lists, dicts and dataclasses."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class LocalCounter(TorchDispatchMode):
    """Counts a sharded step as one device runs it. An operator on
    DTensors is handed on (``NotImplemented``) to DTensor, which runs it
    on the local shards; those operators come back here and are counted:
    FLOPs by ``FlopCounterMode``'s formulas, bytes by :class:`ByteCounter`'s
    rule, each collective's result bytes by kind, and the bytes of every
    storage the step allocates while it lives (its peak). The sharding
    propagator's shape inference at the global shapes runs on fake
    tensors and is not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = dict.fromkeys(COLL_KINDS, 0)
        self.coll["count"] = 0
        self.live = 0
        self.peak = 0
        self._formulas = FlopCounterMode(
            display=False, custom_mapping=_MATVEC).flop_registry
        self._kinds = _collective_kinds()
        self._alive: dict = {}          # id(storage) -> nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = pytree.tree_leaves((args, kwargs))
        if any(isinstance(t, DTensor) for t in leaves):
            return NotImplemented
        if func is torch.ops.aten.equal.default and args[0].is_meta:
            # DTensor's check that an embedding's two masks agree: meta
            # tensors hold no values to compare
            return True
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in leaves + outs):
            return out          # shape inference, not the device's work
        self._allocated(leaves, outs)
        kind = self._kinds.get(func)
        if kind is not None:
            self.coll[kind] += _nbytes(out)
            self.coll["count"] += 1
            return out
        if func.is_view or func is torch.ops.aten.detach.default \
                or func.name() in _NO_WORK:
            return out
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        n = _nbytes((args, kwargs, out))
        if func in _GATHERS:
            n -= max(0, _nbytes(args[0]) - _nbytes(out))
        self.bytes += n
        return out

    def _allocated(self, inputs: list, outs: list) -> None:
        have = {id(t.untyped_storage()) for t in inputs
                if isinstance(t, torch.Tensor)}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in have or key in self._alive:
                continue
            self._alive[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        self.live -= self._alive.pop(key, 0)

    def held(self, tree) -> int:
        """The bytes of ``tree``'s storages that the step allocated."""
        seen = {id(_local(t).untyped_storage()) for t in _tensors(tree)}
        return sum(n for k, n in self._alive.items() if k in seen)


def folded(mesh):
    """(the mesh a sharded step runs on, the map of a spec entry onto it).
    The multi-pod mesh runs as its 2-D view ``("dp", "model")``, 'dp' the
    flattened ('pod', 'data') pair: every spec and rule of the reference
    splits those two axes together, so a device's shards, work and
    collectives are the same on the view, and DTensor's search over its
    operators' sharding strategies is many times faster on two mesh dims
    than on three. Any other mesh runs as it is."""
    names = mesh.mesh_dim_names
    if "pod" not in names:
        return mesh, lambda entry: entry
    if "dp" not in mesh._get_root_mesh()._flatten_mapping:
        mesh["pod", "data"]._flatten("dp")
    rest = tuple(n for n in names if n not in ("pod", "data"))

    def fold(entry):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "pod" not in axes and "data" not in axes:
            return entry
        i = axes.index("pod") if "pod" in axes else -1
        if axes[i:i + 2] != ("pod", "data"):
            raise ValueError(f"{entry!r} splits 'pod' and 'data' apart")
        axes = axes[:i] + ("dp",) + axes[i + 2:]
        return axes[0] if len(axes) == 1 else axes
    return mesh[("dp",) + rest], fold


def count_sharded(spec, cfg, cell, mesh) -> dict:
    """One device's counts of ``cell``'s step run sharded on ``mesh`` under
    the cell's rules, on meta state and inputs laid out by the arch's spec
    functions: ``flops``, ``bytes``, ``coll`` (bytes by kind and
    ``count``), ``output_bytes``, ``temp_bytes`` and ``count_source``."""
    from repro_torch.configs import base
    from repro_torch.distributed import sharding as sh

    t0 = time.perf_counter()
    run_mesh, fold = folded(mesh)
    rules = base.cell_rules(spec, cell, mesh)
    rules = sh.ShardingRules(run_mesh, {k: fold(v)
                                        for k, v in rules.mapping.items()})
    state, batch = spec.abstract_state(cfg, cell), spec.input_specs(cfg, cell)
    state_sh, batch_sh = base.cell_shardings(spec, cfg, mesh, state, batch)
    state, batch = (sh.distribute_tree(tree, {
        p: sh.NamedSharding(run_mesh, tuple(fold(e) for e in ns.spec))
        for p, ns in shardings.items()})
        for tree, shardings in ((state, state_sh), (batch, batch_sh)))
    step = spec.step_fn(cfg, cell)
    counter = LocalCounter()
    with alltoall_as_on_card(), sh.sharded_step(rules), counter:
        out = step(state, batch)
    del state, batch
    source = ("LocalCounter over step_fn on DTensors of meta local shards "
              "(FlopCounterMode's formulas, ByteCounter's rule)")
    flops = float(counter.flops)
    if flops == 0:
        flops = float(spec.model_flops_fn(cfg, cell)) / mesh.size()
        source += ("; no matrix product ran (FlopCounterMode counts those "
                   "only), so the FLOPs are model_flops over the chips")
    made = counter.held(out)
    return {"flops": flops, "bytes": float(counter.bytes),
            "coll": dict(counter.coll),
            "output_bytes": sum(_nbytes(_local(t)) for t in _tensors(out)),
            "temp_bytes": max(0, counter.peak - made),
            "count_source": source, "count_s": time.perf_counter() - t0}


def gather_bytes(cfg, cell) -> int:
    """The gene-search serve step's bytes from its shapes: the queries,
    each kmer's η probed rows of F/32 words, the (B, F/32) masks."""
    b = cell.meta["batch"]
    return (b * cfg.read_len
            + 4 * b * cfg.n_kmers * cfg.eta * cfg.file_words
            + 4 * b * cfg.file_words)


def count_cell(spec, cfg, cell) -> dict:
    """The whole cell's ``flops`` and ``bytes`` (over every device) and
    where they came from (``count_source``)."""
    t0 = time.perf_counter()
    if spec.family == "genesearch":
        return {"flops": spec.model_flops_fn(cfg, cell),
                "bytes": gather_bytes(cfg, cell),
                "count_source": "shapes: model_flops (integer hash and AND "
                                "work) and the row gather's bytes; the "
                                "serve step's kernels need real data",
                "count_s": time.perf_counter() - t0}
    state = spec.abstract_state(cfg, cell)
    batch = spec.input_specs(cfg, cell)
    step = spec.step_fn(cfg, cell)
    with FlopCounterMode(display=False, custom_mapping=_MATVEC) as flops, \
            ByteCounter() as nbytes:
        step(state, batch)
    source = "FlopCounterMode and ByteCounter over step_fn on meta tensors"
    total = float(flops.get_total_flops())
    if total == 0:
        total = float(spec.model_flops_fn(cfg, cell))
        source += ("; no matrix product ran (FlopCounterMode counts those "
                   "only), so the FLOPs are model_flops")
    return {"flops": total, "bytes": float(nbytes.bytes),
            "count_source": source, "count_s": time.perf_counter() - t0}


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: str,
             overrides: dict | None = None) -> dict:
    from repro_torch.configs import base as cfg_base, get
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import analysis

    spec = get(arch)
    cfg = spec.make_config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = spec.shapes[shape]
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                 "kind": cell.kind}
    if cell.skip_reason:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip_reason
        _write(out_dir, rec)
        return rec

    state = spec.abstract_state(cfg, cell)
    batch = spec.input_specs(cfg, cell)
    with fake_process_group(MESHES[mesh_name]):
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"),
                                    device_type="cpu")
        chips = mesh.size()
        state_sh, batch_sh = cfg_base.cell_shardings(spec, cfg, mesh, state,
                                                     batch)
        pairs = []
        for tree, shardings in ((state, state_sh), (batch, batch_sh)):
            leaves = cfg_base.tree_paths(tree)
            pairs += [(leaves[p], shardings[p]) for p in leaves]
        mem = analysis.memory_stats(pairs)
        if spec.family == "genesearch":
            local = None
        else:
            local = count_sharded(spec, cfg, cell, mesh)
    even = count_cell(spec, cfg, cell)
    mf = spec.model_flops_fn(cfg, cell) if spec.model_flops_fn else None
    if local is None:
        counts, split, coll = even, "even", None
        coll_source = ("not counted: the step is counted from its shapes")
        flops, nbytes = even["flops"] / chips, even["bytes"] / chips
    else:
        counts, split, coll = local, "local shards", local["coll"]
        coll_source = COLL_SOURCE
        flops, nbytes = local["flops"], local["bytes"]
        mem.update(output_size_in_bytes=local["output_bytes"],
                   temp_size_in_bytes=local["temp_bytes"])
    coll_total = None if coll is None else float(
        sum(v for k, v in coll.items() if k != "count"))
    roof = analysis.Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, bytes_per_chip=nbytes,
        coll_bytes_per_chip=coll_total, coll_breakdown=coll or {},
        model_flops=mf, memory_stats=mem)
    print("memory_stats:", mem)
    rec.update(roof.to_json())
    rec.update(status="ok", count_split=split,
               count_source=counts["count_source"], coll_source=coll_source,
               even_split={"flops_per_chip": even["flops"] / chips,
                           "bytes_per_chip": even["bytes"] / chips},
               count_s=round(counts["count_s"], 2))
    _write(out_dir, rec)
    return rec


def _write(out_dir: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def run_all(out_dir: str, meshes: list[str], jobs: int = 2,
            archs: list[str] | None = None, timeout: int = 3600) -> int:
    """Every cell in a fresh subprocess (its own process group)."""
    from repro_torch.configs import all_archs, get

    cells = []
    for arch in (archs or all_archs()):
        for shape, _ in get(arch).cells():
            for mesh_name in meshes:
                cells.append((arch, shape, mesh_name))
    procs: list[tuple] = []
    failures = 0

    def reap(block: bool) -> int:
        nonlocal procs
        fails, alive = 0, []
        for p, meta, t0 in procs:
            if p.poll() is None and not block:
                alive.append((p, meta, t0))
                continue
            try:
                p.wait(timeout=max(1, timeout - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                print(f"TIMEOUT {meta}")
                fails += 1
                continue
            if p.returncode != 0:
                print(f"FAIL {meta} rc={p.returncode}")
                fails += 1
            else:
                print(f"ok   {meta}")
        procs = alive
        return fails

    for arch, shape, mesh_name in cells:
        done = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
        if os.path.exists(done):
            print(f"skip {arch}/{shape}/{mesh_name} (cached)")
            continue
        while len(procs) >= jobs:
            failures += reap(block=False)
            if len(procs) >= jobs:
                time.sleep(2)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh_name,
               "--out", out_dir]
        p = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        procs.append((p, f"{arch}/{shape}/{mesh_name}", time.time()))
    failures += reap(block=True)
    return failures


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=sorted(MESHES), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--out", default="runs/dryrun")
    args = ap.parse_args()

    if args.all:
        fails = run_all(args.out, sorted(MESHES), jobs=args.jobs,
                        archs=args.archs)
        sys.exit(1 if fails else 0)

    try:
        rec = run_cell(args.arch, args.shape, args.mesh, args.out)
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("coll_breakdown", "memory_stats")},
                         indent=1))
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
