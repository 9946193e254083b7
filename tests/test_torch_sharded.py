"""The port's steps run sharded on DTensor state over a DeviceMesh, on the
CPU.

* Real gloo groups of 2 and 4 processes (``torch.multiprocessing``
  spawn, a ``FileStore`` under ``tmp_path``, each process joined within
  ``WORKER_TIMEOUT``): on meshes ``(data, model)`` of ``(2, 1)``,
  ``(1, 2)`` and ``(2, 2)``, every process runs the registry's train step
  twice on plain tensors and twice on DTensors laid out by the arch's
  spec functions under the reference's rules, from the same seeded
  weights and batches, and compares (on each process, whole tensors):
  - smoke-config train steps of ``granite-moe-1b-a400m`` (MoE) and
    ``granite-20b`` (MQA: one KV head), SASRec and two-tower: losses
    rtol 1e-5, parameters after 2 AdamW steps within ``adamw_bound``;
  - the Equiformer's train step: losses rtol 1e-4, parameters within
    ``adamw_bound``;
  - the MoE's routing indices: exactly equal;
  - SASRec's ``serve_p99`` scores: rtol 1e-5, atol 1e-6.
* Under a fake group of 256 and 512 devices, collective bytes and
  per-device FLOPs worked out by hand (:class:`dryrun.LocalCounter`):
  a data-parallel linear layer's train step all-reduces exactly its
  gradient's bytes, once; a column-then-row-parallel MLP reduces its
  activation once; a product sharded over every axis counts total/chips
  FLOPs, and one replicated over the model axis 16 times that.
* ``CheckpointManager.restore(sharding_fn=)`` gives DTensors whose local
  shards are the saved leaves' slices.
* Without rules, ``shard`` is the identity at every call site: the
  models call it where the reference does, with its logical axes.
"""

import ast
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_mod  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_state as ts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 300
LR = 1e-3
STEPS = 2
TRAIN_ARCHS = {"granite-moe-1b-a400m": 1e-5, "granite-20b": 1e-5,
               "sasrec": 1e-5, "two-tower-retrieval": 1e-5,
               "equiformer-v2": 1e-4}
SERVE_TOL = dict(rtol=1e-5, atol=1e-6)
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}


def adamw_bound(lr: float, steps: int) -> float:
    """How far two runs of ``steps`` AdamW steps may put one weight apart
    when their gradients differ by rounding only: a gradient within
    rounding of zero may take opposite signs, and each step moves a
    weight by at most lr * |m_hat / sqrt(v_hat)| (<= 1.008 for up to 8
    steps), so 2 * lr * 1.008 a step, plus 1e-5 of f32 rounding."""
    return 2 * lr * 1.008 * steps + 1e-5


def needs_fake_group():
    pytest.importorskip(
        "torch.testing._internal.distributed.fake_pg",
        reason=f"torch {torch.__version__} has no fake process group")


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# the workers: every process of a gloo group runs each case plain and
# sharded and writes what it measured
# --------------------------------------------------------------------------

def _small(arch: str):
    """(spec, smoke config, a small train cell, its seeded numpy batch)."""
    from repro_torch.data import graph_pipeline, recsys_pipeline

    spec = configs.get(arch)
    cfg = spec.make_smoke_config()
    rng = np.random.default_rng(7)
    if spec.family == "lm":
        cell = base.ShapeCell("train_4k", "train", {"seq": 16, "batch": 4})
        toks = rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)
        return spec, cfg, cell, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if spec.family == "gnn":
        cell = dataclasses.replace(spec.shapes["full_graph_sm"], meta={
            "nodes": 24, "edges": 64, "d_feat": 5, "classes": 3,
            "task": "node_cls"})
        g = graph_pipeline.synth_graph(24, 64, d_feat=5, n_classes=3, seed=7)
        return spec, cfg, cell, graph_pipeline.full_batch(g)
    cell = dataclasses.replace(spec.shapes["train_batch"], meta={"batch": 8})
    gen = recsys_pipeline.SessionGenerator(recsys_pipeline.RecsysSynthConfig(
        n_items=getattr(cfg, "n_items", 1 << 10),
        n_users=getattr(cfg, "n_users", 1 << 10),
        session_len=getattr(cfg, "seq_len", 12), seed=7))
    if arch == "sasrec":
        return spec, cfg, cell, gen.sasrec_batch(8)
    return spec, cfg, cell, gen.twotower_batch(8, cfg.n_user_feats,
                                               cfg.n_item_feats)


def _init(spec, cfg, cell):
    """A seeded train state of ``spec``'s arch on the CPU."""
    from repro_torch.configs import equiformer_v2, lm_common
    from repro_torch.models import equiformer, recsys, transformer

    if spec.family == "lm":
        params = transformer.lm_init(3, cfg, device="cpu").params()
        return ts.TrainState.create(params, lm_common.choose_optimizer(cfg))
    if spec.family == "gnn":
        params = equiformer.equiformer_init(
            3, equiformer_v2.cell_config(cfg, cell), device="cpu")
        return ts.TrainState.create(params, opt.adamw(LR))
    init = {"sasrec": recsys.sasrec_init,
            "two-tower-retrieval": recsys.twotower_init}[spec.name]
    return ts.TrainState.create(init(3, cfg, device="cpu"), opt.adamw(LR))


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _routes():
    """Record each MoE routing call: (the list, the undo)."""
    from repro_torch.models import moe

    route, seen = moe.route, []

    def wrapper(params, x, cfg, groups=1):
        out = route(params, x, cfg, groups)
        seen.append(_whole(out[2]))
        return out
    moe.route = wrapper
    return seen, lambda: setattr(moe, "route", route)


def _train_case(arch: str, mesh) -> dict:
    spec, cfg, cell, host = _small(arch)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}
    step = spec.step_fn(cfg, cell)
    rules = base.cell_rules(spec, cell, mesh)
    out: dict = {}
    for name in ("plain", "sharded"):
        state = _init(spec, cfg, cell)
        b = batch
        if name == "sharded":
            state, b = base.distribute_cell(spec, cfg, mesh, state, batch)
        seen, undo = _routes()
        losses = []
        try:
            for _ in range(STEPS):
                if name == "sharded":
                    with sh.sharded_step(rules):
                        state, m = step(state, b)
                else:
                    state, m = step(state, b)
                losses.append(float(_whole(m["loss"])))
        finally:
            undo()
        out[name] = (losses, {k: _whole(v) for k, v in
                              base.tree_paths(state.params).items()}, seen)
    (lp, pp, rp), (ls, ps, rs) = out["plain"], out["sharded"]
    sharded = sum(isinstance(v, DTensor) and any(
        isinstance(p, Shard) for p in v.placements)
        for v in base.tree_paths(state.params).values())
    return {"losses_plain": lp, "losses_sharded": ls,
            "param_err": max(float((pp[k] - ps[k]).abs().max()) for k in pp),
            "routes": len(rp),
            "routes_equal": len(rp) == len(rs) and all(
                torch.equal(a, b) for a, b in zip(rp, rs)),
            "sharded_leaves": sharded}


def _serve_case(mesh) -> dict:
    """SASRec's ``serve_p99`` step at 8 requests, plain and sharded."""
    from repro_torch.models import recsys

    spec = configs.get("sasrec")
    cfg = spec.make_smoke_config()
    cell = dataclasses.replace(spec.shapes["serve_p99"],
                               meta={"batch": 8, "mode": "score"})
    rng = np.random.default_rng(11)
    batch = {"seq": torch.from_numpy(rng.integers(
                 -1, cfg.n_items, (8, cfg.seq_len)).astype(np.int32)),
             "cands": torch.from_numpy(rng.integers(
                 0, cfg.n_items, (8, 20)).astype(np.int32))}
    params = recsys.sasrec_init(5, cfg, device="cpu")
    step = spec.step_fn(cfg, cell)
    want = step(params, batch)
    p, b = base.distribute_cell(spec, cfg, mesh, params, batch)
    with sh.sharded_step(base.cell_rules(spec, cell, mesh)):
        got = _whole(step(p, b))
    return {"close": bool(torch.allclose(got, want, **SERVE_TOL)),
            "max_abs_err": float((got - want).abs().max()),
            "shape_equal": tuple(got.shape) == tuple(want.shape)}


def _worker(rank: int, world: int, shape: tuple, store: str, out_dir: str):
    torch.manual_seed(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        res = {arch: _train_case(arch, mesh) for arch in TRAIN_ARCHS}
        res["sasrec-serve"] = _serve_case(mesh)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


_RESULTS: dict = {}


@pytest.fixture(params=sorted(MESHES))
def mesh_results(request, tmp_path_factory):
    """{rank: results} of one gloo group run on one mesh (run once a
    mesh; every process must exit 0 within ``WORKER_TIMEOUT``)."""
    name = request.param
    if name not in _RESULTS:
        shape = MESHES[name]
        world = shape[0] * shape[1]
        tmp = tmp_path_factory.mktemp(f"gloo{name}")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_worker, args=(
            r, world, shape, str(tmp / "store"), str(tmp)))
            for r in range(world)]
        for p in procs:
            p.start()
        codes = []
        for p in procs:
            p.join(WORKER_TIMEOUT)
            if p.is_alive():
                p.kill()
                p.join()
            codes.append(p.exitcode)
        assert codes == [0] * world, codes
        _RESULTS[name] = {r: json.loads((tmp / f"rank{r}.json").read_text())
                          for r in range(world)}
    return name, _RESULTS[name]


@pytest.mark.parametrize("arch", sorted(TRAIN_ARCHS))
def test_sharded_train_step_equals_plain(arch, mesh_results):
    name, results = mesh_results
    for rank, res in results.items():
        r = res[arch]
        np.testing.assert_allclose(r["losses_sharded"], r["losses_plain"],
                                   rtol=TRAIN_ARCHS[arch], atol=0)
        lr = 3e-4 if configs.get(arch).family == "lm" else LR  # AdamW's
        assert r["param_err"] <= adamw_bound(lr, STEPS), (rank, r)
        # the mesh shards something: (2, 1) the FSDP dims, (1, 2) the TP
        # ones
        assert r["sharded_leaves"] > 0, (rank, name)


def test_sharded_routing_equals_plain(mesh_results):
    for rank, res in mesh_results[1].items():
        r = res["granite-moe-1b-a400m"]
        assert r["routes"] == 2 * STEPS         # 2 layers, each step
        assert r["routes_equal"], rank


def test_sharded_serve_step_equals_plain(mesh_results):
    for rank, res in mesh_results[1].items():
        r = res["sasrec-serve"]
        assert r["shape_equal"] and r["close"], (rank, r)


# --------------------------------------------------------------------------
# collectives and FLOPs worked out by hand, under a fake group
# --------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.fixture(params=["single", "multi"])
def fake_mesh(request):
    """(the production mesh under a fake group of its size, its
    data-parallel width); the group is destroyed at teardown."""
    needs_fake_group()
    multi = request.param == "multi"
    with dryrun.fake_process_group(dryrun.MESHES[request.param]):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi,
                                             device_type="cpu")
        yield mesh, 32 if multi else 16


def _count(mesh, fn, *args) -> dryrun.LocalCounter:
    counter = dryrun.LocalCounter()
    with sh.sharded_step(sh.make_rules(mesh)), counter:
        fn(*args)
    return counter


def _placed(mesh, x, spec):
    return sh.distribute_tree({"x": x}, {"x": sh.NamedSharding(mesh, spec)})["x"]


def test_data_parallel_gradient_is_all_reduced_once(fake_mesh):
    """A linear layer's train step over a batch sharded on the data axes:
    the weight's gradient is a partial sum over them, reduced by one
    all-reduce of exactly its bytes; the FLOPs are the forward and the
    weight-gradient products on the device's rows."""
    mesh, dp = fake_mesh
    b, d_in, d_out = 1024, 256, 512
    state = ts.TrainState.create({"w": _meta(d_in, d_out)}, opt.adamw(LR))
    state = sh.distribute_tree(state, {p: sh.NamedSharding(mesh, ())
                                       for p in base.tree_paths(state)})
    batch = {"x": _placed(mesh, _meta(b, d_in), (base.dp_axes(mesh), None))}
    step = ts.make_train_step(
        lambda p, x: (((x["x"] @ p["w"]) ** 2).mean(), {}), opt.adamw(LR))
    c = _count(mesh, step, state, batch)
    assert c.coll == {"all-gather": 0, "all-reduce": d_in * d_out * 4,
                      "reduce-scatter": 0, "all-to-all": 0,
                      "collective-permute": 0, "count": 1}
    assert c.flops == 2 * (2 * (b // dp) * d_in * d_out)


def test_column_then_row_parallel_mlp_reduces_its_activation_once(
        fake_mesh):
    """x @ W1 (columns over 'model') @ W2 (rows over 'model'): the second
    product is a partial sum over 'model', reduced once to the
    activation's layout: one all-reduce of the device's activation
    bytes."""
    mesh, dp = fake_mesh
    b, d, f = 512, 1024, 4096
    x = _placed(mesh, _meta(b, d), (base.dp_axes(mesh), None))
    w1 = _placed(mesh, _meta(d, f), (None, "model"))
    w2 = _placed(mesh, _meta(f, d), ("model", None))

    def mlp(x, w1, w2):
        h = sh.shard(torch.relu(x @ w1), ("batch", "mlp"))
        return sh.shard(h @ w2, ("batch", None))
    c = _count(mesh, mlp, x, w1, w2)
    assert c.coll["all-reduce"] == (b // dp) * d * 4
    assert c.coll["count"] == 1
    assert c.flops == 2 * 2 * (b // dp) * d * (f // 16)


def test_flops_per_device_follow_replication(fake_mesh):
    """A product sharded over every mesh axis counts total / chips FLOPs on
    a device; with its weight replicated over 'model' (16 devices), 16
    times that."""
    mesh, dp = fake_mesh
    b, d, f = 2048, 512, 1024
    total = 2 * b * d * f
    chips = mesh.size()
    x = _placed(mesh, _meta(b, d), (base.dp_axes(mesh), None))
    split = _count(mesh, torch.matmul, x,
                   _placed(mesh, _meta(d, f), (None, "model")))
    assert split.flops == total // chips
    whole = _count(mesh, torch.matmul, x, _placed(mesh, _meta(d, f), ()))
    assert whole.flops == 16 * total // chips
    assert split.coll["count"] == whole.coll["count"] == 0


# --------------------------------------------------------------------------
# restore onto a mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 3])
def test_restore_places_leaves_on_a_mesh(tmp_path, rank):
    """``restore(sharding_fn=)``: each placed leaf comes back a DTensor of
    the asked placements whose local shard is this process's slice of the
    saved leaf (on a fake group of 4 as rank 0 and rank 3 of a (2, 2)
    mesh); a leaf ``sharding_fn`` leaves alone comes back plain."""
    needs_fake_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    rng = np.random.default_rng(5)
    tree = {"params": {"w": torch.from_numpy(
                           rng.normal(size=(8, 6)).astype(np.float32)),
                       "b": torch.from_numpy(
                           rng.normal(size=(6,)).astype(np.float32)),
                       "e": torch.from_numpy(rng.normal(size=(4, 6)).astype(
                           np.float32)).to(torch.bfloat16)},
            "step": torch.tensor(3, dtype=torch.int32)}
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(3, tree, blocking=True)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        where = {"params/w": (Shard(0), Shard(1)),
                 "params/e": (Replicate(), Shard(0))}

        def sharding_fn(path):
            key = "/".join(p.lstrip(".") for p in path.split("/"))
            return (mesh, where[key]) if key in where else None
        like = {"params": {k: torch.zeros_like(v)
                           for k, v in tree["params"].items()},
                "step": torch.zeros((), dtype=torch.int32)}
        got, manifest = mgr.restore(like, sharding_fn=sharding_fn)
        i, j = divmod(rank, 2)
        w, e = got["params"]["w"], got["params"]["e"]
        assert isinstance(w, DTensor) and tuple(w.placements) == where[
            "params/w"]
        assert torch.equal(w.to_local(),
                           tree["params"]["w"][4 * i:4 * i + 4, 3 * j:3 * j + 3])
        assert isinstance(e, DTensor) and e.dtype == torch.bfloat16
        assert torch.equal(e.to_local(), tree["params"]["e"][2 * j:2 * j + 2])
        assert not isinstance(got["params"]["b"], DTensor)
        assert torch.equal(got["params"]["b"], tree["params"]["b"])
        assert int(got["step"]) == 3 and manifest["step"] == 3
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the call sites, without rules
# --------------------------------------------------------------------------

PAIRS = [("models/layers.py", "models/layers.py"),
         ("models/moe.py", "models/moe.py"),
         ("models/transformer.py", "models/transformer.py"),
         ("models/recsys.py", "models/recsys.py"),
         ("models/equiformer.py", "models/equiformer.py"),
         ("configs/idl_genesearch.py", "configs/idl_genesearch.py")]


def _logical_axes(path: str) -> set:
    """The logical-axes argument of every ``shard`` and
    ``shard_if_divisible`` call in a module, as source text."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {ast.unparse(node.args[1]) for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", None) in ("shard",
                                                   "shard_if_divisible")}


@pytest.mark.parametrize("ref,port", PAIRS, ids=[p for p, _ in PAIRS])
def test_models_shard_where_the_reference_does(ref, port):
    """Every logical layout the reference's module constrains to
    (``shard(x, (...))`` and ``shard_if_divisible``) the port's module
    constrains to as well."""
    want = _logical_axes(os.path.join(REPO, "src", "repro", ref))
    got = _logical_axes(os.path.join(REPO, "src", "repro_torch", port))
    assert want, ref
    assert want <= got, want - got


def test_shard_calls_are_the_identity_without_rules():
    """Without rules every layout helper hands its tensor back untouched,
    so the models' plain path is the one the parity tests pin."""
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert sh.active_rules() is None
    assert sh.shard(x, ("batch", None, "embed")) is x
    assert sh.layout(x, ("edges",)) is x
    assert sh.gather_dims(x, (1,)) is x
    assert sh.reduce_partial(x) is x
    assert sh.grad_as_placed(x) is x
    assert sh.ways(x, 0) == 1
    assert sh.split_last(x, (2, 2)).shape == (2, 3, 2, 2)
    idx = torch.tensor([2, 0])
    assert torch.equal(sh.index_select(x, 1, idx), x.index_select(1, idx))
    assert inspect.signature(sh.shard).parameters.keys() == {"x", "logical"}
