"""PyTorch port vs the JAX reference for the EquiformerV2 GNN: the graph
pipeline and fanout sampler, the real-SH Wigner matrices, the segment
ops, the Equiformer's forward, loss and gradients (node classification
and molecule regression, remat on and off), the registry's train step
and the rotation-invariance property.

Parameters come from the reference's ``equiformer_init(PRNGKey(0), cfg)``
through ``convert.equiformer_params_from_jax``; graphs from the
reference's ``graph_pipeline`` with a per-test seed.

Tolerances (f32, on the CPU; the two frameworks sum in different orders):

* ``synth_graph``, ``full_batch``, ``FanoutLoader``, ``molecule_batch``:
  exactly equal;
* Wigner matrices at l_max 6 (random, axis-aligned and near-pole edges):
  atol 1e-5 (measured: at most 1.1e-6);
* ``segment_softmax``, ``scatter_mean``: rtol 1e-6, atol 1e-7 (measured:
  6e-8);
* forward and loss at the smoke config: rtol 1e-4, atol 1e-5 (measured:
  outputs within 4.8e-7, the loss within 2.5e-7 relative); at the full
  widths cut to 2 layers on a 64-node graph: rtol 1e-3 (measured: 9.2e-8
  relative on the loss);
* every gradient leaf within 1e-4 of that leaf's max |g| (measured: under
  1.6e-6);
* remat on against off: the same limits; the train step's parameters
  within ``2 * lr * n * 1.001 + 1e-6`` (``tests/test_torch_train.py``;
  measured: 2.3e-5);
* rotation invariance of the port's outputs: rtol and atol 2e-3, the
  reference's own property test (measured: 7.2e-7).
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import repro.configs as j_configs  # noqa: E402
from repro.data import graph_pipeline as j_graph  # noqa: E402
from repro.models import equiformer as j_eq  # noqa: E402
from repro.models import gnn_common as j_gnn  # noqa: E402
from repro.models import so3 as j_so3  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_state as j_ts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import equiformer_v2  # noqa: E402
from repro_torch.data import graph_pipeline as graph  # noqa: E402
from repro_torch.models import convert, equiformer as eq  # noqa: E402
from repro_torch.models import gnn_common, so3  # noqa: E402
from repro_torch.models import remat as remat_mod  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_state as ts  # noqa: E402

KEY = jax.random.PRNGKey(0)
CPU = "cpu"
SMOKE_TOL = dict(rtol=1e-4, atol=1e-5)
FULL_RTOL = 1e-3
GRAD_REL = 1e-4


def j_batch(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def t_batch(batch) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves_with_paths(tree) -> dict:
    return {k: np.asarray(v)
            for k, v in j_ckpt._flatten_with_paths(tree).items()}


def assert_batches_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# the graph pipeline and the fanout sampler
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d_feat", [0, 12])
def test_synth_graph_and_full_batch_match_reference(d_feat):
    jg = j_graph.synth_graph(300, 2000, d_feat=d_feat, n_classes=7, seed=4)
    g = graph.synth_graph(300, 2000, d_feat=d_feat, n_classes=7, seed=4)
    for f in dataclasses.fields(jg):
        a, b = getattr(g, f.name), getattr(jg, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert_batches_equal(graph.full_batch(g), j_graph.full_batch(jg))


@pytest.mark.parametrize("fanouts,max_nodes,max_edges",
                         [([5, 5], 1024, 8192), ([15, 10], 600, 700)],
                         ids=["launcher", "cut"])
def test_fanout_loader_matches_reference(fanouts, max_nodes, max_edges):
    """Four batches in a row (the sampler's RNG carried between them),
    the CSR graph, and a cut where the pad truncates nodes and edges."""
    jg = j_graph.synth_graph(512, 4096, n_classes=8, seed=1)
    g = graph.synth_graph(512, 4096, n_classes=8, seed=1)
    jl = j_graph.FanoutLoader(jg, 16, fanouts, max_nodes, max_edges, seed=2)
    pl = graph.FanoutLoader(g, 16, fanouts, max_nodes, max_edges, seed=2)
    assert np.array_equal(pl.csr.indptr, jl.csr.indptr)
    assert np.array_equal(pl.csr.indices, jl.csr.indices)
    for _ in range(4):
        assert_batches_equal(pl.next_batch(), jl.next_batch())


def test_sample_fanout_and_pad_match_reference():
    rng_j, rng_p = np.random.default_rng(9), np.random.default_rng(9)
    src = np.random.default_rng(3).integers(0, 50, 400)
    dst = np.random.default_rng(4).integers(0, 50, 400)
    jcsr = j_gnn.CSRGraph.from_edge_index(src, dst, 60)   # 10 isolated nodes
    csr = gnn_common.CSRGraph.from_edge_index(src, dst, 60)
    assert (csr.n_nodes, csr.n_edges) == (jcsr.n_nodes, jcsr.n_edges)
    seeds = np.array([0, 55, 7, 12])
    want = j_gnn.sample_fanout(jcsr, seeds, [3, 2], rng_j)
    got = gnn_common.sample_fanout(csr, seeds, [3, 2], rng_p)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    nodes, s, d = got
    assert_batches_equal(
        gnn_common.pad_graph_batch(s, d, len(nodes), 64, 64),
        j_gnn.pad_graph_batch(s, d, len(nodes), 64, 64))
    with pytest.raises(ValueError, match="exceeds pad"):
        gnn_common.pad_graph_batch(s, d, len(nodes), 4, 4)


def test_molecule_batch_matches_reference():
    assert_batches_equal(graph.molecule_batch(6, 30, 64, seed=5),
                         j_graph.molecule_batch(6, 30, 64, seed=5))


# --------------------------------------------------------------------------
# Wigner matrices
# --------------------------------------------------------------------------

def edge_vectors() -> np.ndarray:
    """Random directions, the six axis directions, and edges near the
    poles of ``rotation_to_z`` (|d_z| around its 0.9 switch, and within
    1e-7 of ±z, where its ``eps`` matters)."""
    rng = np.random.default_rng(13)
    rand = rng.normal(size=(64, 3)) * rng.uniform(0.1, 5.0, (64, 1))
    axes = np.concatenate([np.eye(3), -np.eye(3)]) * 1.7
    c = 0.9 / np.sqrt(1 - 0.9 ** 2)
    switch = np.array([[1.0, 0.0, c * (1 + s)] for s in (-1e-6, 0.0, 1e-6)]
                      + [[0.0, 1.0, -c * (1 + s)] for s in (-1e-6, 1e-6)])
    pole = np.array([[1e-7, 0, 1], [0, -1e-7, 1], [1e-7, 1e-7, -1],
                     [3e-5, -2e-5, -2.0], [1e-12, 0, 3.0]])
    return np.concatenate([rand, axes, switch, pole]).astype(np.float32)


def test_rotation_to_z_matches_reference_and_rotates_onto_z():
    v = edge_vectors()
    want = np.asarray(j_so3.rotation_to_z(jnp.asarray(v)))
    got = so3.rotation_to_z(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    d = v / np.linalg.norm(v, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.einsum("eij,ej->ei", got, d),
                               np.tile([0, 0, 1.0], (len(v), 1)), atol=1e-5)


def test_wigner_matrices_match_reference_at_lmax_6():
    """R^0..R^6 over every edge of :func:`edge_vectors` (atol 1e-5), each
    orthogonal, and the block-diagonal form and ``sh_l1`` equal."""
    m3 = j_so3.rotation_to_z(jnp.asarray(edge_vectors()))
    want = j_so3.wigner_matrices(m3, 6)
    t3 = torch.from_numpy(np.array(m3))
    got = so3.wigner_matrices(t3, 6)
    assert len(got) == len(want) == 7
    for l, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape == (len(edge_vectors()), 2 * l + 1,
                                             2 * l + 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=f"l={l}")
        eye = np.broadcast_to(np.eye(2 * l + 1), g.shape)
        np.testing.assert_allclose((g @ g.transpose(1, 2)).numpy(), eye,
                                   atol=1e-4)
    np.testing.assert_allclose(so3.block_diag_wigner(t3, 3).numpy(),
                               np.asarray(j_so3.block_diag_wigner(m3, 3)),
                               atol=1e-5)
    d = torch.from_numpy(edge_vectors())
    assert np.array_equal(so3.sh_l1(d).numpy(),
                          np.asarray(j_so3.sh_l1(jnp.asarray(d.numpy()))))


# --------------------------------------------------------------------------
# segment ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("trailing", [(), (3,)], ids=["flat", "heads"])
def test_segment_ops_match_reference_with_empty_segments(trailing):
    """Segments 0, 4 and 9 receive no entry (the softmax's -inf max is
    zeroed, the mean divides by 1); -1e30 logits as the Equiformer's
    masked edges."""
    rng = np.random.default_rng(17)
    seg = rng.choice([1, 2, 3, 5, 6, 7, 8], size=40).astype(np.int32)
    logits = rng.normal(size=(40,) + trailing).astype(np.float32) * 3
    logits[:3] = -1e30
    want = j_gnn.segment_softmax(jnp.asarray(logits), jnp.asarray(seg), 10)
    got = gnn_common.segment_softmax(torch.from_numpy(logits),
                                     torch.from_numpy(seg), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    want = j_gnn.scatter_mean(jnp.asarray(logits[3:]), jnp.asarray(seg[3:]),
                              10)
    got = gnn_common.scatter_mean(torch.from_numpy(logits[3:]),
                                  torch.from_numpy(seg[3:]), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert not got[[0, 4, 9]].any()


# --------------------------------------------------------------------------
# the Equiformer
# --------------------------------------------------------------------------

def smoke_cfg(task: str, remat: bool = False):
    """The smoke config (d_hidden 16, l_max 2, m_max 1, 2 heads, 2
    layers) with 8 classes or none (regression)."""
    jcfg = j_configs.get("equiformer-v2").make_smoke_config()
    cfg = configs.get("equiformer-v2").make_smoke_config()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    kw = dict(n_classes=8 if task == "node_cls" else 0, remat=remat)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def full_cfg(remat: bool = True):
    """The published widths (d_hidden 128, l_max 6, m_max 2, 8 heads) cut
    to 2 layers, with 8 classes."""
    jcfg = j_configs.get("equiformer-v2").make_config()
    cfg = configs.get("equiformer-v2").make_config()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    kw = dict(n_layers=2, n_classes=8, remat=remat)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def task_batch(task: str, seed: int) -> dict:
    """A padded fanout batch (masked edges and nodes, -1 labels) of a
    512-node graph, or four molecules."""
    if task == "node_cls":
        g = j_graph.synth_graph(512, 4096, n_classes=8, seed=seed)
        return j_graph.FanoutLoader(g, 8, [5, 5], 256, 512,
                                    seed=seed).next_batch()
    return j_graph.molecule_batch(4, 12, 24, seed=seed)


_PARAMS: dict = {}


def params_for(jcfg):
    key = dataclasses.astuple(dataclasses.replace(jcfg, remat=False))
    if key not in _PARAMS:
        _PARAMS[key] = np_tree(j_eq.equiformer_init(KEY, jcfg))
    return _PARAMS[key]


def ref_value_and_grads(jcfg, batch):
    npp = params_for(jcfg)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p, b: j_eq.equiformer_loss(p, b, jcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, npp), j_batch(batch))
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        leaves_with_paths({".params": grads})


def assert_grads_close(got: dict, want: dict, rel: float):
    got_flat = ckpt._flatten_with_paths({".params": got})
    assert set(got_flat) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got_flat[k].numpy() - w).max()) <= rel * scale, k


@pytest.mark.parametrize("task", ["node_cls", "regression"])
def test_forward_matches_reference_smoke(task):
    jcfg, cfg = smoke_cfg(task)
    batch = task_batch(task, seed=3)
    want = np.asarray(j_eq.equiformer_forward(
        jax.tree.map(jnp.asarray, params_for(jcfg)), j_batch(batch), jcfg))
    params = convert.equiformer_params_from_jax(params_for(jcfg), CPU)
    got = eq.equiformer_forward(params, t_batch(batch), cfg)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **SMOKE_TOL)


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
@pytest.mark.parametrize("task", ["node_cls", "regression"])
def test_loss_and_grads_match_reference_smoke(task, remat):
    """Loss, metric and every gradient leaf against
    ``jax.value_and_grad``; remat on and off give the same."""
    jcfg, cfg = smoke_cfg(task, remat)
    batch = task_batch(task, seed=4)
    want_loss, want_metrics, want_grads = ref_value_and_grads(jcfg, batch)
    params = convert.equiformer_params_from_jax(params_for(jcfg), CPU)
    loss, metrics, grads = ts.value_and_grad(
        lambda p, b: eq.equiformer_loss(p, b, cfg), params, t_batch(batch))
    np.testing.assert_allclose(float(loss), want_loss, **SMOKE_TOL)
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, **SMOKE_TOL)
    assert_grads_close(grads, want_grads, GRAD_REL)


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
def test_loss_and_grads_match_reference_full_width(remat):
    """d_hidden 128, l_max 6, m_max 2, 8 heads at 2 layers on a 64-node,
    256-edge graph: loss rtol 1e-3, gradients within 1e-4 of each leaf's
    max |g|."""
    jcfg, cfg = full_cfg(remat)
    batch = j_graph.full_batch(j_graph.synth_graph(64, 256, n_classes=8,
                                                   seed=6))
    want_loss, _, want_grads = ref_value_and_grads(jcfg, batch)
    params = convert.equiformer_params_from_jax(params_for(jcfg), CPU)
    loss, _, grads = ts.value_and_grad(
        lambda p, b: eq.equiformer_loss(p, b, cfg), params, t_batch(batch))
    np.testing.assert_allclose(float(loss), want_loss, rtol=FULL_RTOL)
    assert_grads_close(grads, want_grads, GRAD_REL)


def test_remat_checkpoints_each_layer(monkeypatch):
    """Under autograd with remat each layer goes through
    ``remat_mod.checkpoint``; without remat, or under
    no_grad, none does; the loss is the same either way."""
    jcfg, cfg = smoke_cfg("node_cls", remat=True)
    params = convert.equiformer_params_from_jax(params_for(jcfg), CPU)
    batch = t_batch(task_batch("node_cls", seed=5))
    calls = []
    real = remat_mod.checkpoint

    def counting(fn, *args):
        calls.append(fn.__name__)
        return real(fn, *args)
    monkeypatch.setattr(remat_mod, "checkpoint", counting)
    losses = []
    for remat, want in ((True, ["_layer"] * cfg.n_layers), (False, [])):
        calls.clear()
        c = dataclasses.replace(cfg, remat=remat)
        losses.append(float(ts.value_and_grad(
            lambda p, b: eq.equiformer_loss(p, b, c), params, batch)[0]))
        assert calls == want
    calls.clear()
    with torch.no_grad():
        losses.append(float(eq.equiformer_loss(params, batch, cfg)[0]))
    assert calls == []
    np.testing.assert_allclose(losses[1:], [losses[0]] * 2, **SMOKE_TOL)


def assert_freed_without_collector(make_refs):
    """With the cyclic collector off, ``make_refs()`` runs a step, drops
    everything it made and returns weakrefs to tensors it held: each must
    be dead (freed by reference counting alone)."""
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        refs = make_refs()
        alive = [name for name, r in refs.items() if r() is not None]
    finally:
        if was:
            gc.enable()
    assert alive == []


def test_remat_step_state_dies_without_the_collector():
    """An AdamW step of the Equiformer under remat (a checkpoint a layer):
    once its state and outputs are dropped, a parameter leaf and a moment
    are freed at once. The loss equals the reference's."""
    jcfg, cfg = smoke_cfg("node_cls", remat=True)
    batch = task_batch("node_cls", seed=6)
    want_loss, _, _ = ref_value_and_grads(jcfg, batch)
    losses = []

    def step_once():
        state = ts.TrainState.create(
            convert.equiformer_params_from_jax(params_for(jcfg), CPU),
            opt.adamw(1e-3))
        step = ts.make_train_step(lambda p, b: eq.equiformer_loss(p, b, cfg),
                                  opt.adamw(1e-3))
        state, m = step(state, t_batch(batch))
        losses.append(float(m["loss"]))
        return {"param": weakref.ref(state.params["layers"]["so2"]["w0_r"]),
                "moment": weakref.ref(state.opt_state["mu"]["embed"])}
    assert_freed_without_collector(step_once)
    np.testing.assert_allclose(losses[0], want_loss, **SMOKE_TOL)

def test_registry_train_step_matches_reference():
    """Three AdamW steps of the registry's ``molecule`` step (the cell's
    config: regression) against the reference's (jitted), at the smoke
    widths, on molecule batches."""
    spec, jspec = configs.get("equiformer-v2"), j_configs.get("equiformer-v2")
    assert spec.family == jspec.family == "gnn"
    assert {n: dataclasses.asdict(c) for n, c in spec.shapes.items()} == \
        {n: dataclasses.asdict(c) for n, c in jspec.shapes.items()}
    jcfg, cfg = smoke_cfg("regression")
    cell, jcell = spec.shapes["molecule"], jspec.shapes["molecule"]
    assert dataclasses.asdict(equiformer_v2.cell_config(cfg, cell)) == \
        dataclasses.asdict(j_configs.equiformer_v2.cell_config(jcfg, jcell))
    jp = j_eq.equiformer_init(KEY, j_configs.equiformer_v2.cell_config(
        jcfg, jcell))
    jstate = j_ts.TrainState.create(jp, j_opt.adamw(1e-3))
    state = convert.train_state_from_jax(np_tree(jstate), cfg, CPU)
    jstep = jax.jit(jspec.step_fn(jcfg, jcell))
    step = spec.step_fn(cfg, cell)
    lr = 1e-3
    for i in range(3):
        batch = j_graph.molecule_batch(4, 12, 24, seed=60 + i)
        jstate, jm = jstep(jstate, j_batch(batch))
        state, m = step(state, t_batch(batch))
        assert set(m) == set(jm) == {"mse", "loss", "grad_norm"}
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **SMOKE_TOL,
                                       err_msg=k)
    got = ckpt._flatten_with_paths({".params": state.params})
    for k, w in leaves_with_paths({".params": jstate.params}).items():
        assert float(np.abs(got[k].numpy() - w).max()) <= \
            2 * lr * 3 * 1.001 + 1e-6, k
    for c in spec.shapes.values():
        full = spec.make_config()
        assert spec.model_flops_fn(full, c) == jspec.model_flops_fn(
            jspec.make_config(), c)


def random_rotation(seed: int) -> np.ndarray:
    """QR of a gaussian, det fixed to +1 (the reference's construction)."""
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


@pytest.mark.parametrize("widths", ["smoke", "full"])
def test_rotation_invariance(widths):
    """Scalar outputs are invariant under a global rotation of the input
    positions (``tests/test_models_smoke.py``'s property, rtol and atol
    2e-3), on the port, at the smoke widths and the full ones."""
    if widths == "smoke":
        jcfg, cfg = smoke_cfg("node_cls")
        cfg = dataclasses.replace(cfg, n_classes=3)
        jcfg = dataclasses.replace(jcfg, n_classes=3)
        g = j_graph.synth_graph(16, 40, n_classes=3, seed=2)
    else:
        jcfg, cfg = full_cfg(remat=False)
        g = j_graph.synth_graph(32, 96, n_classes=8, seed=2)
    params = convert.equiformer_params_from_jax(params_for(jcfg), CPU)
    batch = t_batch(j_graph.full_batch(g))
    with torch.no_grad():
        out1 = eq.equiformer_forward(params, batch, cfg)
        batch2 = dict(batch, positions=batch["positions"] @ torch.from_numpy(
            random_rotation(5).T))
        out2 = eq.equiformer_forward(params, batch2, cfg)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_so2_conv_zeroes_orders_above_m_max():
    """Coefficients with |m| > m_max come out zero; the rest equal the
    reference's."""
    jcfg, cfg = full_cfg()
    rng = np.random.default_rng(19)
    x = rng.normal(size=(5, cfg.n_coeff, cfg.d_hidden)).astype(np.float32)
    rad = rng.normal(size=(5, cfg.m_max + 1, cfg.d_hidden)).astype(np.float32)
    npp = params_for(jcfg)
    lp = jax.tree.map(lambda a: a[0], npp["layers"])
    want = np.asarray(j_eq.so2_conv(jax.tree.map(jnp.asarray, lp),
                                    jnp.asarray(x), jnp.asarray(rad), jcfg))
    got = eq.so2_conv(convert.equiformer_params_from_jax(lp, CPU),
                      torch.from_numpy(x), torch.from_numpy(rad), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    kept = sorted(i for _, idx in cfg.m_blocks() for i in idx)
    assert kept == sorted(i for _, idx in jcfg.m_blocks() for i in idx)
    dropped = sorted(set(range(cfg.n_coeff)) - set(kept))
    assert not got[:, dropped].any()
