"""Dry run of every (arch x shape x mesh) cell: shard, count, roofline.

Port of :mod:`repro.launch.dryrun` for the card. The reference lowers and
compiles each cell for a 256- or 512-device TPU mesh and reads XLA's cost
and memory analysis. Per cell, the port instead:

1. builds the cell's state and inputs on the ``"meta"`` device (the
   registry's ``abstract_state`` / ``input_specs``: shapes, no memory);
2. under a fake process group of the mesh's world size (one process
   standing for every device, :func:`fake_process_group`), builds
   :func:`~repro_torch.launch.mesh.make_production_mesh` and each leaf's
   local shard from ``tree_shardings``: ``memory_stats`` holds one
   device's bytes of state and inputs (``argument_size_in_bytes``);
3. runs the registry's ``step_fn`` once on the meta state and inputs
   under ``torch.utils.flop_counter.FlopCounterMode`` and
   :class:`ByteCounter`: every FLOP of the step's matrix products (a
   remat recomputation included, as the reference's trip-aware HLO count
   includes it; a step with no matrix product, FM's, takes its
   ``model_flops``), and every operator's input and output bytes (a row
   gather's source only where it is gathered). The byte count charges
   each operator as if nothing were fused or cached, so it is an upper
   bound on what HBM moves (the counterpart of HLO's "bytes accessed"
   before fusion);
4. records ``flops_per_chip`` and ``bytes_per_chip`` as those totals over
   ``chips``, an even split (``"count_split": "even"``), and the
   roofline at the H100's rates (:mod:`repro_torch.roofline.analysis`).

Collectives are not counted in one process: ``coll_bytes_per_chip`` is
``null`` with a ``coll_source`` saying so, and the bottleneck is taken
over the terms that exist. A step that cannot run on meta is counted from
its shapes, with a ``count_source`` saying so: the gene-search serve
step's kernels and host planner need real data, and its work is integer
(no FLOPs ``FlopCounterMode`` sees), so it takes its ``model_flops`` and
its row gather's bytes. Cells with a ``skip_reason`` are recorded as
skipped. The reference's ``roofline/hlo_cost.py`` parses XLA HLO and is
not ported: ``FlopCounterMode`` takes over its trip-aware count.

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

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

MESHES = {"single": 256, "multi": 512}
COLL_SOURCE = ("not counted: the dry run is one process under a fake "
               "process group, which runs no collective")


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
        pairs = []
        for tree, fn in ((state, spec.state_spec_fn),
                         (batch, spec.batch_spec_fn)):
            shardings = cfg_base.tree_shardings(
                mesh, tree, lambda p, s, fn=fn: fn(cfg, p, s))
            leaves = cfg_base.tree_paths(tree)
            pairs += [(leaves[p], shardings[p]) for p in leaves]
        mem = analysis.memory_stats(pairs)
    counts = count_cell(spec, cfg, cell)
    mf = spec.model_flops_fn(cfg, cell) if spec.model_flops_fn else None
    roof = analysis.Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=counts["flops"] / chips,
        bytes_per_chip=counts["bytes"] / chips,
        coll_bytes_per_chip=None, coll_breakdown={},
        model_flops=mf, memory_stats=mem)
    print("memory_stats:", mem)
    rec.update(roof.to_json())
    rec.update(status="ok", count_split="even",
               count_source=counts["count_source"], coll_source=COLL_SOURCE,
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
