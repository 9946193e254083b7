"""The port's distributed half against the reference, on the CPU.

* int8 gradient compression (``distributed/collectives.py``): ``q`` equal
  and ``scale`` equal bit for bit to the reference's on the same seeded
  arrays; error feedback equal; a train step with
  ``make_compression("int8")`` against the reference's with the
  tolerances of ``test_torch_train.py::test_train_step_matches_reference``
  (loss terms rtol 1e-5, atol 1e-6; parameters within the AdamW bound
  ``2 lr n 1.001 + 1e-6`` after n steps), the compressed gradients equal
  but for one-quantum flips where f32 rounding crosses an int8 boundary
  (measured: 1 of 82,752 elements at the first step), and ``grad_norm``
  within the norm of those flips plus the same tolerance;
* elastic planning and shard reassignment (``fault_tolerance.py``);
* the aliases (``packed.scatter_or_bitsliced`` / ``scatter_or_rows``, the
  lazy ``packed.coverage_need``, ``serving.genesearch``'s re-exports) and
  the absence of the reference's removed v1 stubs;
* sharding: ``ShardingRules.spec`` equal to the reference's on every
  logical name; for every arch's full config, every non-skipped cell and
  both production meshes, each state and batch leaf's spec and local
  shard shape equal to the reference's ``valid_spec`` and
  ``NamedSharding(AbstractMesh(...), spec).shard_shape``. The port's mesh
  is built by ``make_production_mesh`` under a fake process group of 256
  or 512 ranks held by this one process (``torch.testing``'s private fake
  backend: the fixture skips, naming the torch version, where it is
  missing), destroyed in the fixture's teardown.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    Replicate, Shard, distribute_tensor)

import repro.configs as j_configs  # noqa: E402
from repro.configs import base as j_base  # noqa: E402
from repro.distributed import collectives as j_coll  # noqa: E402
from repro.distributed import fault_tolerance as j_ft  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.index import packed as j_packed  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serving import genesearch as j_gs  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_state as j_ts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed import fault_tolerance as ft  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.index import packed, query  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import genesearch, service  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_state as ts  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(arch, name) for arch in j_configs.all_archs()
         for name, cell in j_configs.get(arch).cells()
         if not cell.skip_reason]


# --------------------------------------------------------------------------
# int8 compression
# --------------------------------------------------------------------------

def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 64)).astype(np.float32))
    q, s = collectives.quantize_int8(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    err = (collectives.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.51


def test_error_feedback_accumulates():
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(
        size=(32,)).astype(np.float32))}
    ef = collectives.init_error_feedback(g)
    assert ef.residual["w"].dtype == torch.float32
    assert not ef.residual["w"].any()
    comp, ef = collectives.compress_with_feedback(g, ef)
    # residual = g - Q(g); next step's compression sees g + residual
    np.testing.assert_allclose((comp["w"] + ef.residual["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-5, atol=1e-6)


def _arrays():
    rng = np.random.default_rng(7)
    spiky = rng.normal(size=(4096,)).astype(np.float32)
    spiky[::97] *= 1e3
    return {
        "normal": rng.normal(size=(64, 64)).astype(np.float32),
        "spiky": spiky,
        "tiny": (rng.normal(size=(3, 5, 7)) * 1e-30).astype(np.float32),
        "zeros": np.zeros((17,), np.float32),
        "halves": (np.arange(-300, 301) / 2.0).astype(np.float32),
        "bf16": rng.normal(size=(33, 9)).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_arrays()))
def test_int8_q_and_scale_bit_equal_to_reference(name):
    a = _arrays()[name]
    if name == "bf16":
        jx, tx = jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    else:
        jx, tx = jnp.asarray(a), torch.from_numpy(a)
    jq, js = j_coll.quantize_int8(jx)
    q, s = collectives.quantize_int8(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().view(np.uint32) == np.asarray(js).view(np.uint32)
    np.testing.assert_array_equal(
        collectives.dequantize_int8(q, s).numpy(),
        np.asarray(j_coll.dequantize_int8(jq, js)))


def test_compress_with_feedback_equals_reference():
    """Two rounds of error feedback: compressed gradients and residuals
    equal the reference's bit for bit."""
    rng = np.random.default_rng(3)
    grads = [{"a": rng.normal(size=(8, 6)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
             for _ in range(2)]
    jef = j_coll.init_error_feedback(jax.tree.map(jnp.asarray, grads[0]))
    ef = collectives.init_error_feedback(opt.tree_map(torch.from_numpy,
                                                      grads[0]))
    for g in grads:
        jcomp, jef = j_coll.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), jef)
        comp, ef = collectives.compress_with_feedback(
            opt.tree_map(torch.from_numpy, g), ef)
        for got, want in ((comp, jcomp), (ef.residual, jef.residual)):
            for x, y in zip(opt.tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_make_compression_kinds():
    assert collectives.make_compression(None) is None
    assert collectives.make_compression("none") is None
    with pytest.raises(ValueError, match="unknown compression"):
        collectives.make_compression("fp8")
    g = {"w": torch.tensor([0.5, -1.0, 0.25])}
    out = collectives.make_compression("int8")(g)
    q, s = collectives.quantize_int8(g["w"])
    assert torch.equal(out["w"], q.float() * s)


def test_int8_train_step_matches_reference():
    """Three AdamW steps with ``make_compression("int8")`` through
    ``make_train_step``, granite-moe's smoke config, against the
    reference's step with its own int8 hook, each hook's output recorded.
    The gradients differ by f32 rounding, so an element within rounding of
    a quantization boundary may round to the next int8 step: the
    compressed trees must agree except at at most 0.1% of the elements,
    each off by one quantization step (its tensor's scale); the loss
    terms within rtol 1e-5, atol 1e-6; ``grad_norm`` (of the compressed
    gradients) within the norm of the two trees' difference plus that
    tolerance; the parameters within the AdamW bound."""
    arch = "granite-moe-1b-a400m"
    jcfg = j_configs.get(arch).make_smoke_config()
    cfg = configs.get(arch).make_smoke_config()
    jp = j_tf.lm_init(jax.random.PRNGKey(0), jcfg)
    lr = 1e-3
    jopt, popt = j_opt.adamw(lr), opt.adamw(lr)
    seen: dict = {"ref": [], "port": []}

    def recording(hook, key):
        def run(grads):
            out = hook(grads)
            seen[key].append(out)
            return out
        return run
    jstep = j_ts.make_train_step(
        lambda p, b: j_tf.lm_loss(p, b, jcfg, loss_chunks=2), jopt,
        grad_compression=recording(j_coll.make_compression("int8"), "ref"))
    pstep = ts.make_train_step(
        lambda p, b: tf.lm_loss(p, b, cfg, loss_chunks=2), popt,
        grad_compression=recording(collectives.make_compression("int8"),
                                   "port"))
    jstate = j_ts.TrainState.create(jp, jopt)
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         cfg, "cpu")
    rng = np.random.default_rng(40)
    for i in range(3):
        batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
                 for k in ("tokens", "labels")}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = pstep(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        flips, total, diff2 = 0, 0, 0.0
        got = ckpt._flatten_with_paths(seen["port"][i])
        for k, w in j_ckpt._flatten_with_paths(seen["ref"][i]).items():
            g, w = got[k].numpy(), np.asarray(w)
            scale = float(np.abs(w).max()) / 127.0 + 1e-12
            d = np.abs(g - w)
            assert float(d.max()) <= scale * (1 + 1e-5), k
            flips += int((d > scale * 1e-3).sum())
            total += d.size
            diff2 += float((d.astype(np.float64) ** 2).sum())
        assert flips <= total * 1e-3, (i, flips)
        for k in jm:
            tol = LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(float(jm[k]))
            if k == "grad_norm":
                tol += diff2 ** 0.5
            assert abs(float(m[k]) - float(jm[k])) <= tol, (i, k)
        bound = 2 * lr * (i + 1) * 1.001 + 1e-6
        got = ckpt._flatten_with_paths({".params": state.params})
        for k, w in j_ckpt._flatten_with_paths(
                {".params": jstate.params}).items():
            assert float(np.abs(got[k].numpy() - np.asarray(w)).max()) \
                <= bound, k


# --------------------------------------------------------------------------
# elasticity
# --------------------------------------------------------------------------

def test_elastic_plan():
    plan = ft.plan_elastic_mesh(512, 16)
    assert (plan.data, plan.model, plan.dropped) == (32, 16, 0)
    assert plan.n_devices == 512
    plan = ft.plan_elastic_mesh(500, 16)
    assert (plan.data, plan.dropped) == (31, 4)
    with pytest.raises(RuntimeError):
        ft.plan_elastic_mesh(8, 16)
    with pytest.raises(ValueError):
        ft.plan_elastic_mesh(8, 0)
    for n, m in ((448, 16), (7, 2), (1, 1)):
        assert dataclasses.asdict(ft.plan_elastic_mesh(n, m)) == \
            dataclasses.asdict(j_ft.plan_elastic_mesh(n, m))


def test_reassign_covers_all_shards():
    """Seeded cases over the reference property test's ranges: every
    shard lands on exactly one survivor, as the reference assigns it."""
    rng = np.random.default_rng(11)
    for _ in range(60):
        n_shards = int(rng.integers(1, 65))
        n_workers = int(rng.integers(2, 33))
        failed_id = int(rng.integers(0, 32))
        failed = {failed_id} if failed_id < n_workers else set()
        out = ft.reassign_shards(n_shards, failed, n_workers)
        got = sorted(s for shards in out.values() for s in shards)
        assert got == list(range(n_shards))
        assert not (set(out) & failed)
        assert out == j_ft.reassign_shards(n_shards, failed, n_workers)
    with pytest.raises(RuntimeError):
        ft.reassign_shards(4, {0, 1}, 2)


# --------------------------------------------------------------------------
# aliases
# --------------------------------------------------------------------------

def test_scatter_or_aliases_match_reference():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 64, 200).astype(np.int32)
    fids = rng.integers(0, 128, 200).astype(np.int32)
    locs = rng.integers(0, 32 * 4, 200).astype(np.int32)
    want = np.asarray(j_packed.scatter_or_bitsliced(
        jnp.zeros((64, 4), jnp.uint32), jnp.asarray(rows), jnp.asarray(fids)))
    got = packed.scatter_or_bitsliced(torch.zeros((64, 4), dtype=torch.int32),
                                      torch.from_numpy(rows),
                                      torch.from_numpy(fids))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    want = np.asarray(j_packed.scatter_or_rows(
        jnp.zeros((64, 4), jnp.uint32), jnp.asarray(rows), jnp.asarray(locs)))
    got = packed.scatter_or_rows(torch.zeros((64, 4), dtype=torch.int32),
                                 torch.from_numpy(rows),
                                 torch.from_numpy(locs))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_reexports_and_absent_v1_stubs():
    """``packed.coverage_need`` is ``query.coverage_need``; genesearch
    re-exports the service's surface. The reference's removed v1 entry
    points are ``ImportError`` stubs there; the port never had them, so
    they are absent (recorded in ROADMAP Queue C)."""
    assert packed.coverage_need is query.coverage_need
    for name in ("GeneSearchService", "SearchRequest", "SearchResult",
                 "ServiceConfig", "BatchStats"):
        assert getattr(genesearch, name) is getattr(service, name)
        assert hasattr(j_gs, name)
    for mod, jmod, names in (
            (packed, j_packed, ("insert_batch_words", "insert_batch_bitsliced",
                                "insert_batch_rows")),
            (genesearch, j_gs, ("empty_index", "insert_read_batch",
                                "build_archive", "insert_read", "serve_step",
                                "match_file_ids"))):
        for name in names:
            assert callable(getattr(jmod, name))
            assert not hasattr(mod, name), name
    with pytest.raises(AttributeError):
        packed.no_such_name


# --------------------------------------------------------------------------
# sharding rules and meshes
# --------------------------------------------------------------------------

@pytest.fixture
def mesh(request):
    """(name, the port's production mesh under a fake process group of its
    world size); the group is destroyed at teardown."""
    name = request.param
    pytest.importorskip(
        "torch.testing._internal.distributed.fake_pg",
        reason=f"torch {torch.__version__} has no fake process group")
    shape, axes = MESHES[name]
    with dryrun.fake_process_group(int(np.prod(shape))):
        dmesh = mesh_mod.make_production_mesh(multi_pod=(name == "multi"),
                                              device_type="cpu")
        assert tuple(dmesh.shape) == shape
        assert tuple(dmesh.mesh_dim_names) == axes
        yield name, dmesh
    assert not dist.is_initialized()


def abstract_mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


LOGICAL = [None, "batch", "fsdp", "embed", "heads", "kv_heads", "mlp",
           "experts", "vocab", "seq", "act_seq", "tokens", "nodes", "edges",
           "table_rows", "files", "expert_cap", "unknown",
           ("batch", None, "embed"), ("batch", "fsdp"), ("heads", "mlp"),
           ("batch", "seq", "heads", None), ("nodes", "edges"),
           ("tokens", "experts")]


@pytest.mark.parametrize("mesh", ["single", "multi"], indirect=True)
def test_sharding_rules_spec_matches_reference(mesh):
    name, dmesh = mesh
    amesh = abstract_mesh(name)
    for seq_parallel in (False, True):
        jrules = j_sh.ShardingRules(mesh=amesh, mapping=j_sh.default_mapping(
            amesh, seq_parallel=seq_parallel))
        rules = sh.ShardingRules(mesh=dmesh, mapping=sh.default_mapping(
            dmesh, seq_parallel=seq_parallel))
        assert rules.mapping == jrules.mapping
        for logical in LOGICAL:
            assert rules.spec(logical) == tuple(jrules.spec(logical)), logical
    jrules = j_sh.make_rules(amesh, kv_heads=None, seq="model")
    rules = sh.make_rules(dmesh, kv_heads=None, seq="model")
    for logical in LOGICAL:
        assert rules.spec(logical) == tuple(jrules.spec(logical)), logical
    # placements: each entry's mesh dims shard that tensor dim
    want = {"single": (Shard(0), Shard(2)),
            "multi": (Shard(0), Shard(0), Shard(2))}[name]
    assert sh.make_rules(dmesh).named(("batch", None, "heads")) == want
    assert sh.make_rules(dmesh).named(None) == (Replicate(),) * len(want)


@pytest.mark.parametrize("mesh", ["single"], indirect=True)
def test_shard_is_identity_without_rules_and_redistributes_dtensors(mesh):
    _, dmesh = mesh
    x = torch.arange(12.0).reshape(3, 4)
    assert sh.shard(x, ("batch", "heads")) is x
    assert sh.shard_if_divisible(x, ("batch", "heads"), 1) is x
    d = distribute_tensor(torch.empty((64, 32), device="meta"), dmesh,
                          [Replicate(), Replicate()])
    with sh.use_rules(sh.make_rules(dmesh)):
        assert sh.active_rules() is not None
        assert sh.shard(x, ("batch", "heads")) is x
        out = sh.shard(d, ("batch", "heads"))
        assert tuple(out.placements) == (Shard(0), Shard(1))
        assert tuple(out.to_local().shape) == (4, 2)
        # 8 KV heads over 16 'model' devices: that dim stays replicated
        kv = sh.shard_if_divisible(
            distribute_tensor(torch.empty((64, 8), device="meta"), dmesh,
                              [Replicate(), Replicate()]),
            ("batch", "kv_heads"), 1)
        assert tuple(kv.placements) == (Shard(0), Replicate())
    assert sh.active_rules() is None



@pytest.mark.parametrize("mesh", ["single", "multi"], indirect=True)
def test_mesh_helpers_match_reference(mesh):
    """``dp_axes``, ``axis_size``, ``valid_spec`` and the fallback
    ``generic_state_spec`` against the reference's on the same mesh
    shape."""
    name, dmesh = mesh
    amesh = abstract_mesh(name)
    assert base.DP_AXES == j_base.DP_AXES
    assert base.dp_axes(dmesh) == j_base.dp_axes(amesh)
    for axes in (None, "data", "model", "pod", ("pod", "data"),
                 ("pod", "data", "model")):
        assert base.axis_size(dmesh, axes) == j_base.axis_size(amesh, axes)
    shapes = [(), (7,), (1, 1), (4096, 1024), (1024, 4096), (48, 6144, 128),
              (3, 5, 7, 11), (16, 16), (1, 30)]
    for shape in shapes:
        spec = j_base.generic_state_spec("x", shape)
        assert base.generic_state_spec("x", shape) == tuple(spec), shape
        assert _strip(base.valid_spec(dmesh, shape, tuple(spec))) == _strip(
            j_base.valid_spec(amesh, shape, spec)), shape

_TREES: dict = {}


def trees(arch, cell_name):
    """(port cfg, reference cfg, {"state"/"batch": (port tree, reference
    {path: shape}, port spec fn, reference spec fn)}), cached across the
    two meshes."""
    if (arch, cell_name) not in _TREES:
        spec, jspec = configs.get(arch), j_configs.get(arch)
        cfg, jcfg = spec.make_config(), jspec.make_config()
        cell, jcell = spec.shapes[cell_name], jspec.shapes[cell_name]

        def ref_shapes(tree):
            flat, _ = jax.tree_util.tree_flatten_with_path(tree)
            return {"/".join(j_base._pp(p) for p in path): tuple(leaf.shape)
                    for path, leaf in flat}
        _TREES[arch, cell_name] = (cfg, jcfg, {
            "state": (spec.abstract_state(cfg, cell),
                      ref_shapes(jspec.abstract_state(jcfg, jcell)),
                      spec.state_spec_fn, jspec.state_spec_fn),
            "batch": (spec.input_specs(cfg, cell),
                      ref_shapes(jspec.input_specs(jcfg, jcell)),
                      spec.batch_spec_fn, jspec.batch_spec_fn)})
    return _TREES[arch, cell_name]


def _strip(spec: tuple) -> tuple:
    """A spec without its trailing ``None`` entries (``P(a, None) ==
    P(a)`` in effect)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("mesh", ["single", "multi"], indirect=True)
@pytest.mark.parametrize("arch,cell_name", CELLS)
def test_local_shard_shapes_match_reference(arch, cell_name, mesh):
    """Every state and batch leaf: the port's valid spec and local shard
    shape on the production mesh equal the reference's on an
    ``AbstractMesh`` of the same shape and names."""
    name, dmesh = mesh
    amesh = abstract_mesh(name)
    cfg, jcfg, parts = trees(arch, cell_name)
    for part, (tree, jshapes, fn, jfn) in parts.items():
        shardings = base.tree_shardings(dmesh, tree,
                                        lambda p, s: fn(cfg, p, s))
        assert list(shardings) == list(jshapes), part
        for path, shape in jshapes.items():
            jspec = j_base.valid_spec(amesh, shape, jfn(jcfg, path, shape))
            got = shardings[path]
            assert _strip(got.spec) == _strip(jspec), (part, path)
            assert got.shard_shape(shape) == \
                JNamedSharding(amesh, jspec).shard_shape(shape), (part, path)


@pytest.mark.parametrize("mesh", ["single", "multi"], indirect=True)
def test_dtensor_local_shards_equal_shard_shape(mesh):
    """DTensor itself, given a leaf's placements, makes the local shard
    ``shard_shape`` names: granite-moe's stacked expert and attention
    weights and a decode cache, bf16, on meta."""
    _, dmesh = mesh
    spec = configs.get("granite-moe-1b-a400m")
    cfg = spec.make_config()
    state = spec.abstract_state(cfg, spec.shapes["decode_32k"])
    shardings = base.tree_shardings(
        dmesh, state, lambda p, s: spec.state_spec_fn(cfg, p, s))
    leaves = base.tree_paths(state)
    for path in ("params/layers/moe/wi", "params/layers/attn/wq",
                 "params/embed", "cache/k"):
        sharding = shardings[path]
        assert any(isinstance(p, Shard) for p in sharding.placements), path
        local = distribute_tensor(leaves[path], dmesh,
                                  list(sharding.placements)).to_local()
        assert tuple(local.shape) == sharding.shard_shape(
            tuple(leaves[path].shape)), path
        assert local.dtype == leaves[path].dtype


def test_no_process_group_left():
    """Every fake group above was destroyed with its test."""
    assert not dist.is_initialized()


def test_host_mesh_spans_the_group():
    """``make_host_mesh`` is one 'data' axis over the group's processes
    (a one-process gloo group here)."""
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:0",
                            rank=0, world_size=1)
    try:
        m = mesh_mod.make_host_mesh("cpu")
        assert tuple(m.mesh_dim_names) == ("data",)
        assert tuple(m.shape) == (1,)
    finally:
        dist.destroy_process_group()
