"""PyTorch port vs the JAX reference for the recsys family: ``hash_rows``
under its three schemes, ``embedding_bag``, the session generator, FM,
two-tower, SASRec and MIND (forward, the registry's score and retrieval
steps, loss and gradients, the registry's train step).

Parameters come from the reference's ``*_init(PRNGKey(0), smoke cfg)``
through ``convert.recsys_params_from_jax``; ids and batches from the
reference's ``SessionGenerator`` or a per-test ``np.random.default_rng``.

Tolerances (f32, on the CPU; the two frameworks sum in different orders):

* ``hash_rows``, the generator's batches: exactly equal (rows int32);
* ``embedding_bag``, forward, score and retrieval: rtol 1e-5, atol 1e-6
  (measured: at most 1.4e-6 absolute on SASRec's hidden states, which are
  of order 1, and 2.7e-7 elsewhere);
* loss rtol 1e-5, atol 1e-6 (measured: within 2.6e-7 relative); every
  gradient leaf within 2e-5 of that leaf's max |g| (measured: under
  1.5e-6);
* the registry's train step, three AdamW steps: loss and metrics rtol
  1e-5, atol 1e-6 (measured: 1.3e-7 relative), parameters within ``2 *
  lr * n * 1.001 + 1e-6`` of the reference's (measured: 1.5e-5 at most,
  on two-tower's towers); a gradient within rounding of zero may take
  opposite signs in the two frameworks, and ``tests/test_torch_train.py``
  derives the bound.
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
from repro.core import hashing as j_hashing  # noqa: E402
from repro.data import recsys_pipeline as j_pipe  # noqa: E402
from repro.models import recsys as j_recsys  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import train_state as j_ts  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import hashing  # noqa: E402
from repro_torch.data import recsys_pipeline as pipe  # noqa: E402
from repro_torch.models import convert, recsys  # noqa: E402
from repro_torch.models import remat as remat_mod  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_state as ts  # noqa: E402

KEY = jax.random.PRNGKey(0)
ARCHS = ["fm", "sasrec", "two-tower-retrieval", "mind"]
INITS = {"fm": j_recsys.fm_init, "sasrec": j_recsys.sasrec_init,
         "two-tower-retrieval": j_recsys.twotower_init,
         "mind": j_recsys.mind_init}
LOSSES = {"fm": (j_recsys.fm_loss, recsys.fm_loss),
          "sasrec": (j_recsys.sasrec_loss, recsys.sasrec_loss),
          "two-tower-retrieval": (j_recsys.twotower_loss,
                                  recsys.twotower_loss),
          "mind": (j_recsys.mind_loss, recsys.mind_loss)}
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 2e-5
FM_FULL_ROWS = 39 * (1 << 20)          # 40,894,464: FM's real row count
CPU = "cpu"


def j_batch(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def t_batch(batch) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves_with_paths(tree) -> dict:
    return {k: np.asarray(v)
            for k, v in j_ckpt._flatten_with_paths(tree).items()}


@pytest.fixture(scope="module")
def pair():
    """arch -> (reference cfg, reference params, port cfg, port params):
    the smoke configs with the reference's weights."""
    out = {}

    def get(arch, scheme="none"):
        if arch not in out:
            jcfg = j_configs.get(arch).make_smoke_config()
            cfg = configs.get(arch).make_smoke_config()
            assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
            jp = INITS[arch](KEY, jcfg)
            out[arch] = (jcfg, jp, cfg, np_tree(jp))
        jcfg, jp, cfg, npp = out[arch]
        return (dataclasses.replace(jcfg, hash_scheme=scheme), jp,
                dataclasses.replace(cfg, hash_scheme=scheme),
                convert.recsys_params_from_jax(npp, CPU))
    return get


def generator(seed, cfg):
    return pipe.SessionGenerator(pipe.RecsysSynthConfig(
        n_items=getattr(cfg, "n_items", 1 << 10), n_users=1 << 12,
        session_len=getattr(cfg, "seq_len", 12), seed=seed))


def train_batch(arch, cfg, seed, b=8) -> dict:
    """A training batch of ``arch`` from the generator; SASRec's carries
    -1 pads in ``seq`` and ``pos`` (masked positions)."""
    gen = generator(seed, cfg)
    if arch == "fm":
        return gen.fm_batch(b, cfg.n_sparse, cfg.vocab_per_field)
    if arch == "two-tower-retrieval":
        return gen.twotower_batch(b, cfg.n_user_feats, cfg.n_item_feats)
    if arch == "mind":
        batch = gen.mind_batch(b)
        batch["mask"][:, :3] = 0.0          # a short history
        return batch
    batch = gen.sasrec_batch(b)
    batch["seq"][:, :2] = -1
    batch["pos"][:, :2] = -1
    return batch


# --------------------------------------------------------------------------
# hash_rows: integer semantics
# --------------------------------------------------------------------------

EDGE_IDS = np.array([-1, -2, -255, -256, -257, -(1 << 31), (1 << 31) - 1, 0,
                     1, 255, 256, 4095, 4096, 40894463, 40894464],
                    dtype=np.int32)


def test_int32_ids_enter_the_64_bit_hash_sign_extended():
    """An int32 id becomes the uint64 of ``astype(uint64)`` (sign-extended,
    as ``jnp`` and numpy convert): its int64 carrier has the same bits,
    and the hash of the carrier is the reference's hash."""
    t = torch.from_numpy(EDGE_IDS).to(torch.int64)
    want = EDGE_IDS.astype(np.uint64)
    assert np.array_equal(t.numpy().view(np.uint64), want)
    assert np.array_equal(np.asarray(jnp.asarray(EDGE_IDS).astype(jnp.uint64)),
                          want)
    for m in (1000, 4096, FM_FULL_ROWS):
        got = hashing.hash_to_range(t, 0x5EED, m).numpy()
        ref = np.asarray(j_hashing.hash_to_range(
            jnp.asarray(want), 0x5EED, m)).astype(np.int64)
        assert np.array_equal(got, ref), m


@pytest.mark.parametrize("n_rows", [1000, 1 << 10, 8 * 256, 1 << 16,
                                    FM_FULL_ROWS])
@pytest.mark.parametrize("scheme", ["none", "rh", "idl"])
def test_hash_rows_matches_reference(scheme, n_rows):
    """Every scheme exactly equal, int32, with negative ids, the int32
    extremes and session-like runs, at smoke sizes and FM's full row
    count (39 x 2^20)."""
    rng = np.random.default_rng(7)
    ids = np.concatenate([
        EDGE_IDS,
        rng.integers(-(1 << 31), 1 << 31, 2000).astype(np.int32),
        (rng.integers(0, 1 << 20) + np.arange(-300, 300)).astype(np.int32)])
    want = np.asarray(j_recsys.hash_rows(jnp.asarray(ids), n_rows, scheme))
    got = recsys.hash_rows(torch.from_numpy(ids), n_rows, scheme)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < n_rows
    with pytest.raises(ValueError):
        recsys.hash_rows(torch.from_numpy(ids), n_rows, "bogus")


def test_hash_rows_idl_keeps_session_neighbours_in_one_window():
    """The paper's locality on embedding rows: ids of one 256-id block
    share an L-row window under ``idl`` and scatter under ``rh``."""
    ids = torch.arange(1 << 16, (1 << 16) + 256, dtype=torch.int32)
    idl = recsys.hash_rows(ids, FM_FULL_ROWS, "idl")
    rh = recsys.hash_rows(ids, FM_FULL_ROWS, "rh")
    assert len(torch.unique(idl // 4096)) == 1
    assert len(torch.unique(rh // 4096)) > 200


# --------------------------------------------------------------------------
# the session generator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("builder", ["sessions", "sasrec_batch", "mind_batch",
                                     "fm_batch", "twotower_batch",
                                     "retrieval_batch"])
def test_session_generator_matches_reference(builder):
    """Each builder, called three times in a row, exactly equal (values,
    dtypes, and the generator's state)."""
    kw = dict(n_items=1 << 16, n_users=1 << 12, session_len=20, seed=3)
    jgen = j_pipe.SessionGenerator(j_pipe.RecsysSynthConfig(**kw))
    gen = pipe.SessionGenerator(pipe.RecsysSynthConfig(**kw))
    args = {"sessions": (16,), "sasrec_batch": (16,), "mind_batch": (16, 5),
            "fm_batch": (16, 39, 1 << 20), "twotower_batch": (16, 8, 4),
            "retrieval_batch": (100,)}[builder]
    for _ in range(3):
        want = getattr(jgen, builder)(*args)
        got = getattr(gen, builder)(*args)
        if builder == "sessions":
            want, got = {"s": want}, {"s": got}
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# embedding_bag
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["none", "idl"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("form", ["fixed", "ragged", "ragged-tail"])
def test_embedding_bag_matches_reference(form, mode, scheme):
    """Fixed (B, k) bags, and ragged bags with two empty ones (first and
    middle); ``ragged-tail`` leaves ids past ``offsets[-1]`` in no bag."""
    rng = np.random.default_rng(11)
    table = rng.normal(size=(500, 6)).astype(np.float32)
    if form == "fixed":
        ids, offsets = rng.integers(-50, 5000, (7, 3)).astype(np.int32), None
    else:
        ids = rng.integers(-50, 5000, 20).astype(np.int32)
        end = 20 if form == "ragged" else 16
        offsets = np.array([0, 0, 4, 9, 9, 13, end], dtype=np.int32)
    want = j_recsys.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids),
        None if offsets is None else jnp.asarray(offsets), mode, scheme)
    got = recsys.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids),
        None if offsets is None else torch.from_numpy(offsets), mode, scheme)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    if offsets is not None:
        assert not got[0].any() and not got[3].any()    # the empty bags


# --------------------------------------------------------------------------
# forward, score and retrieval
# --------------------------------------------------------------------------

def _forward(mod, arch, params, batch, cfg):
    if arch == "fm":
        return (mod.fm_forward(params, batch["feats"], cfg),)
    if arch == "sasrec":
        return (mod.sasrec_forward(params, batch["seq"], cfg),)
    if arch == "mind":
        return (mod.mind_interests(params, batch["seq"], batch["mask"], cfg),)
    return tuple(mod.twotower_embed(params, batch, cfg))


@pytest.mark.parametrize("scheme", ["none", "rh", "idl"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, scheme, pair):
    """``fm_forward``, ``sasrec_forward`` (RoPE and the causal mask of
    ``layers.attention``), ``mind_interests`` (routing over the interest
    axis) and ``twotower_embed`` (without the reference's dead ``ue``
    sum) under each row scheme."""
    jcfg, jp, cfg, params = pair(arch, scheme)
    batch = train_batch(arch, cfg, seed=21)
    want = _forward(j_recsys, arch, jp, j_batch(batch), jcfg)
    got = _forward(recsys, arch, params, t_batch(batch), cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


def serve_batch(arch, cfg, mode, seed, b=6, n=300) -> dict:
    """Inputs of a ``score`` (b requests) or ``retrieval`` (1 x n
    candidates) cell, as the reference's ``*_inputs`` shape them."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    if arch == "fm":
        if mode == "score":
            return {"feats": rng.integers(0, 1 << 20, (b, cfg.n_sparse))
                    .astype(i32)}
        return {"context": rng.integers(0, 1 << 20, (1, cfg.n_sparse))
                .astype(i32), "cands": rng.integers(0, 1 << 20, n).astype(i32)}
    if arch == "two-tower-retrieval":
        if mode == "score":
            return {"user_feats": rng.integers(0, 1 << 20, (b, 8)).astype(i32),
                    "item_feats": rng.integers(0, 1 << 20, (b, 4)).astype(i32)}
        return {"user_feats": rng.integers(0, 1 << 20, (1, 8)).astype(i32),
                "cand_feats": rng.integers(0, 1 << 20, (n, 4)).astype(i32)}
    rows = 1 if mode == "retrieval" else b
    out = {"seq": rng.integers(0, 1 << 20, (rows, cfg.seq_len)).astype(i32),
           "cands": (rng.integers(0, 1 << 20, n) if mode == "retrieval" else
                     rng.integers(0, 1 << 20, (b, 100))).astype(i32)}
    if arch == "mind":
        out["mask"] = (rng.random((rows, cfg.seq_len)) < 0.8).astype(
            np.float32)
    return out


@pytest.mark.parametrize("cell", ["serve_p99", "retrieval_cand"])
@pytest.mark.parametrize("arch", ARCHS)
def test_registry_serve_steps_match_reference(arch, cell, pair):
    """The registry's ``step_fn`` of a score and a retrieval cell against
    the reference's (jitted) on the same inputs."""
    jcfg, jp, cfg, params = pair(arch)
    spec, jspec = configs.get(arch), j_configs.get(arch)
    mode = spec.shapes[cell].meta["mode"]
    assert dataclasses.asdict(spec.shapes[cell]) == dataclasses.asdict(
        jspec.shapes[cell])
    batch = serve_batch(arch, cfg, mode, seed=31)
    want = jax.jit(jspec.step_fn(jcfg, jspec.shapes[cell]))(jp, j_batch(batch))
    got = spec.step_fn(cfg, spec.shapes[cell])(params, t_batch(batch))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_registry_shapes_and_flops_match_reference():
    for arch in ARCHS:
        spec, jspec = configs.get(arch), j_configs.get(arch)
        assert spec.family == jspec.family == "recsys"
        assert {n: dataclasses.asdict(c) for n, c in spec.shapes.items()} \
            == {n: dataclasses.asdict(c) for n, c in jspec.shapes.items()}
        full, jfull = spec.make_config(), jspec.make_config()
        assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
        for cell in spec.shapes.values():
            assert spec.model_flops_fn(full, cell) == \
                jspec.model_flops_fn(jfull, cell)


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------

def _grads_close(got: dict, want: dict):
    got_flat = ckpt._flatten_with_paths({".params": got})
    assert set(got_flat) == set(want)
    for k, w in want.items():
        g = got_flat[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_REL * scale, k


@pytest.mark.parametrize("scheme", ["none", "idl"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, scheme, pair):
    """Value, metrics and every gradient leaf (the tables' dense
    gradients included) against ``jax.value_and_grad``."""
    jcfg, jp, cfg, params = pair(arch, scheme)
    jloss_fn, loss_fn = LOSSES[arch]
    batch = train_batch(arch, cfg, seed=41)
    (jl, jm), jg = jax.value_and_grad(
        lambda p, b: jloss_fn(p, b, jcfg), has_aux=True)(jp, j_batch(batch))
    loss, metrics, grads = ts.value_and_grad(
        lambda p, b: loss_fn(p, b, cfg), params, t_batch(batch))
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   **LOSS_TOL)
    _grads_close(grads, leaves_with_paths({".params": jg}))


@pytest.mark.parametrize("row_chunk", [3, 8])
def test_twotower_loss_in_row_blocks_matches_reference(row_chunk, pair,
                                                       monkeypatch):
    """The port takes the (B, B) in-batch logits in blocks of rows, each
    block checkpointed under autograd when there is more than one: loss
    and gradients equal the reference's whole-matrix ones."""
    jcfg, jp, cfg, params = pair("two-tower-retrieval")
    batch = train_batch("two-tower-retrieval", cfg, seed=44)
    (jl, _), jg = jax.value_and_grad(
        lambda p, b: j_recsys.twotower_loss(p, b, jcfg), has_aux=True)(
        jp, j_batch(batch))
    calls = []
    real = remat_mod.checkpoint

    def counting(fn, *args):
        calls.append(fn.__name__)
        return real(fn, *args)
    monkeypatch.setattr(remat_mod, "checkpoint", counting)
    monkeypatch.setattr(recsys, "TWOTOWER_ROW_CHUNK", row_chunk)
    loss, _, grads = ts.value_and_grad(
        lambda p, b: recsys.twotower_loss(p, b, cfg), params, t_batch(batch))
    assert calls == (["_inbatch_nll_rows"] * 3 if row_chunk == 3 else [])
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    _grads_close(grads, leaves_with_paths({".params": jg}))


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


def test_twotower_step_state_dies_without_the_collector(pair, monkeypatch):
    """The registry's two-tower train step with the (B, B) logits in three
    checkpointed row blocks: once its state and outputs are dropped, a
    parameter leaf and an AdamW moment are freed at once. The loss equals
    the reference's whole-matrix one."""
    jcfg, jp, cfg, _ = pair("two-tower-retrieval")
    monkeypatch.setattr(recsys, "TWOTOWER_ROW_CHUNK", 3)
    batch = train_batch("two-tower-retrieval", cfg, seed=45)
    want = float(j_recsys.twotower_loss(jp, j_batch(batch), jcfg)[0])
    spec = configs.get("two-tower-retrieval")
    losses = []

    def step_once():
        state = convert.train_state_from_jax(
            np_tree(j_ts.TrainState.create(jp, j_opt.adamw(1e-3))), cfg, CPU)
        state, m = spec.step_fn(cfg, spec.shapes["train_batch"])(
            state, t_batch(batch))
        losses.append(float(m["loss"]))
        return {"param": weakref.ref(state.params["user_tower"]["w0"]),
                "moment": weakref.ref(state.opt_state["nu"]["item_table"])}
    assert_freed_without_collector(step_once)
    np.testing.assert_allclose(losses[0], want, **LOSS_TOL)

def test_sasrec_loss_masks_negative_positives(pair):
    """Positions whose positive id is -1 add nothing: the loss equals the
    one over the unmasked positions only, as the reference's."""
    jcfg, jp, cfg, params = pair("sasrec")
    batch = train_batch("sasrec", cfg, seed=42)
    batch["pos"][:, 5:] = -1
    want = float(j_recsys.sasrec_loss(jp, j_batch(batch), jcfg)[0])
    got = float(recsys.sasrec_loss(params, t_batch(batch), cfg)[0])
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    batch["pos"][:] = -1
    assert float(recsys.sasrec_loss(params, t_batch(batch), cfg)[0]) == 0.0


def test_mind_loss_takes_the_first_interest_on_a_tie(pair, monkeypatch):
    """Two interests with the same dot against the positive but different
    elsewhere: both frameworks pick the first (``argmax``'s tie rule), so
    the loss is the first one's, not the second's."""
    jcfg, jp, cfg, params = pair("mind")
    d, k = cfg.embed_dim, cfg.n_interests
    assert k == 2
    rng = np.random.default_rng(5)
    v = rng.normal(size=(3, k, d)).astype(np.float32) * 0.1
    v[:, :, 0] = 1.0                           # equal dot with e_0 ...
    v[:, 1, 1:] = -v[:, 0, 1:]                 # ... different elsewhere
    table = rng.normal(size=(cfg.n_items, d)).astype(np.float32) * 0.1
    table[7] = np.eye(d, dtype=np.float32)[0]  # the positive's row: e_0
    batch = {"seq": np.zeros((3, cfg.seq_len), np.int32),
             "mask": np.ones((3, cfg.seq_len), np.float32),
             "pos": np.full(3, 7, np.int32),
             "negs": rng.integers(0, cfg.n_items, (3, 4)).astype(np.int32)}
    monkeypatch.setattr(j_recsys, "mind_interests",
                        lambda *a, **kw: jnp.asarray(v))
    monkeypatch.setattr(recsys, "mind_interests",
                        lambda *a, **kw: torch.from_numpy(v))
    jp = dict(jp, item_table=jnp.asarray(table))
    params = dict(params, item_table=torch.from_numpy(table))
    want = float(j_recsys.mind_loss(jp, j_batch(batch), jcfg)[0])
    got = float(recsys.mind_loss(params, t_batch(batch), cfg)[0])
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    ne = table[batch["negs"]]

    def loss_with(best):
        pos = (best * table[7]).sum(-1)
        neg = np.einsum("bd,bnd->bn", best, ne)
        logits = np.concatenate([pos[:, None], neg], 1)
        lse = np.log(np.exp(logits).sum(1))
        return float(-(pos - lse).mean())
    np.testing.assert_allclose(got, loss_with(v[:, 0]), rtol=1e-5)
    assert abs(got - loss_with(v[:, 1])) > 1e-3


def test_mind_routing_gives_identical_interests(pair):
    """Routing logits start at zero, so the softmax over interests is
    uniform and every capsule stays equal, in the reference as here: each
    ``mind_loss`` takes interest 0 through a K-way tie."""
    jcfg, jp, cfg, params = pair("mind")
    batch = t_batch(train_batch("mind", cfg, seed=43))
    v = recsys.mind_interests(params, batch["seq"], batch["mask"], cfg)
    assert torch.equal(v[:, 0], v[:, 1])


# --------------------------------------------------------------------------
# the registry's train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_registry_train_step_matches_reference(arch, pair):
    """Three AdamW (1e-3) steps through the registry's ``train_batch``
    ``step_fn`` against the reference's (jitted), from the same state:
    loss, metrics and grad norm each step, parameters after steps 1 and 3
    within the AdamW bound; the state's step advances."""
    jcfg, jp, cfg, _ = pair(arch)
    spec, jspec = configs.get(arch), j_configs.get(arch)
    cell, jcell = spec.shapes["train_batch"], jspec.shapes["train_batch"]
    jstate = j_ts.TrainState.create(jp, j_opt.adamw(1e-3))
    state = convert.train_state_from_jax(np_tree(jstate), cfg, CPU)
    assert set(ckpt._flatten_with_paths(state)) == set(
        j_ckpt._flatten_with_paths(jstate))
    jstep = jax.jit(jspec.step_fn(jcfg, jcell))
    step = spec.step_fn(cfg, cell)
    lr = 1e-3
    for i in range(3):
        batch = train_batch(arch, cfg, seed=50 + i)
        jstate, jm = jstep(jstate, j_batch(batch))
        state, m = step(state, t_batch(batch))
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL,
                                       err_msg=k)
        assert int(state.step) == int(jstate.step) == i + 1
        if i in (0, 2):
            got = ckpt._flatten_with_paths({".params": state.params})
            bound = 2 * lr * (i + 1) * 1.001 + 1e-6
            for k, w in leaves_with_paths({".params": jstate.params}).items():
                assert float(np.abs(got[k].numpy() - w).max()) <= bound, k


def test_train_state_from_jax_checks_depth(pair):
    jcfg, jp, cfg, _ = pair("sasrec")
    jstate = np_tree(j_ts.TrainState.create(jp, j_opt.adamw(1e-3)))
    with pytest.raises(ValueError, match="layers"):
        convert.train_state_from_jax(
            jstate, dataclasses.replace(cfg, n_blocks=3), CPU)
