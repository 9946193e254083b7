"""PyTorch port vs the JAX reference for the LM family's training path: the
optimizers, ``lm_loss`` and its gradients, the train step (with
microbatching) and the registry's train step for each of the five LM
archs' smoke configs, checkpoints both ways, the IDL n-gram dedup pipeline,
the fault-tolerant loop and the launcher.

Parameters come from the reference's ``lm_init(PRNGKey(0), cfg)`` (f32)
through ``params_from_jax`` / ``train_state_from_jax``; tokens, labels and
gradients from a per-test ``np.random.default_rng(seed)``.

Tolerances (f32, on the CPU; the two frameworks sum in different orders):

* optimizers on identical gradients, three updates: updates and f32
  moments rtol 1e-5, atol 1e-9; Adafactor's bf16 momentum within one bf16
  ulp (its f32 value, equal within ~1e-7, can round to a neighbouring
  bf16 value); global norm and clipped tree rtol 1e-6;
* ``lm_loss`` and its metrics rtol 1e-5, atol 1e-6; every gradient leaf
  within 2e-5 of that leaf's max |g| (measured: under 1.3e-6);
* train step: loss, metrics and grad norm at every step rtol 1e-5, atol
  1e-6; parameters after n AdamW steps within ``2 * lr * n * 1.001 +
  1e-6`` of the reference's. AdamW moves a weight by about lr * sign(g)
  a step (|m_hat / sqrt(v_hat)| <= 1.0007 for n <= 3, by Cauchy-Schwarz
  over b1 0.9 and b2 0.95), so a gradient within rounding of zero, which
  may take opposite signs in the two frameworks, can put two updates 2 *
  lr apart;
* the pipeline, checkpoints and resume: exactly equal.
"""

import dataclasses
import gc
import io
import os
import signal
import subprocess
import sys
import time
import weakref
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import repro.configs as j_configs  # noqa: E402
from repro.data import lm_pipeline as j_lm_pipeline  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_state as j_ts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import lm_common  # noqa: E402
from repro_torch.core import cache_model  # noqa: E402
from repro_torch.data import lm_pipeline  # noqa: E402
from repro_torch.distributed import fault_tolerance as ft  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import remat as remat_mod  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_state as ts  # noqa: E402

KEY = jax.random.PRNGKey(0)
LM_ARCHS = ["arctic-480b", "granite-moe-1b-a400m", "granite-20b",
            "nemotron-4-340b", "internlm2-20b"]
OPT_TOL = dict(rtol=1e-5, atol=1e-9)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 2e-5
CPU = "cpu"
ROOT = Path(__file__).resolve().parent.parent


def t(a) -> torch.Tensor:
    return convert.tensor_from_numpy(np.asarray(a), CPU)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves_with_paths(tree) -> dict:
    """The reference tree's leaves as numpy arrays under its checkpoint
    keys (``_flatten_with_paths``)."""
    return {k: np.asarray(v) for k, v in j_ckpt._flatten_with_paths(tree).items()}


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def assert_within_bf16_ulp(got, want):
    g, w = as_f32(got), as_f32(want)
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w) - ulp))


def lm_batch(seed, vocab, b, s, masked=True) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    if masked:
        labels[rng.random((b, s)) < 0.2] = -1
    return {"tokens": toks, "labels": labels}


def j_batch(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def t_batch(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def lm_pair():
    """arch -> (reference cfg, reference params, port cfg, numpy params):
    the smoke configs with the reference's weights."""
    out = {}

    def get(arch):
        if arch not in out:
            jcfg = j_configs.get(arch).make_smoke_config()
            cfg = configs.get(arch).make_smoke_config()
            jp = j_tf.lm_init(KEY, jcfg)
            out[arch] = (jcfg, jp, cfg, np_tree(jp))
        return out[arch]
    return get


# --------------------------------------------------------------------------
# optimizers on identical gradients
# --------------------------------------------------------------------------

def _param_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "stack": rng.normal(size=(3, 4, 7)).astype(np.float32),
            "b": {"scale": rng.normal(size=(5,)).astype(np.float32)}}


def _grad_trees(seed, n):
    rng = np.random.default_rng(seed)
    like = _param_tree(0)
    return [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.1).astype(
        np.float32), like) for _ in range(n)]


def _port_tree(tree):
    return jax.tree.map(lambda a: t(a), tree)


def _compare_state(got, want):
    """Port optimizer state against the reference's, leaf by leaf by key."""
    got_flat = {k: v for k, v in ckpt._flatten_with_paths(got).items()}
    want_flat = leaves_with_paths(want)
    assert set(got_flat) == set(want_flat)
    for k, w in want_flat.items():
        g = got_flat[k]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            assert_within_bf16_ulp(g, w)
        elif k.endswith("step"):
            assert int(g) == int(w) and g.dtype == torch.int32
        else:
            np.testing.assert_allclose(g.numpy(), w, **OPT_TOL, err_msg=k)


OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(lr=1e-2), {}),
    "adamw-nowd": (lambda m: m.adamw(lr=1e-2, weight_decay=0.0), {}),
    "adafactor": (lambda m: m.adafactor(lr=1e-2), {}),
    "adafactor-nomomentum": (lambda m: m.adafactor(lr=1e-2, momentum=0.0), {}),
    "adafactor-wd": (lambda m: m.adafactor(lr=1e-2, weight_decay=0.1), {}),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_reference(name):
    """Three updates on identical gradients: updates, applied parameters and
    every state leaf (bf16 momentum, ``None`` when momentum is 0) against
    the reference's."""
    make, _ = OPTIMIZERS[name]
    jo, po = make(j_opt), make(opt)
    params = _param_tree(1)
    jparams = jax.tree.map(jnp.asarray, params)
    pparams = _port_tree(params)
    jstate, pstate = jo.init(jparams), po.init(pparams)
    _compare_state(pstate, jstate)
    for g in _grad_trees(2, 3):
        jup, jstate = jo.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        pup, pstate = po.update(_port_tree(g), pstate, pparams)
        for k, w in leaves_with_paths(jup).items():
            np.testing.assert_allclose(
                ckpt._flatten_with_paths(pup)[k].numpy(), w, **OPT_TOL)
        _compare_state(pstate, jstate)
        jparams = j_opt.apply_updates(jparams, jup)
        assert opt.apply_updates(pparams, pup) is not None
        for k, w in leaves_with_paths(jparams).items():
            np.testing.assert_allclose(
                ckpt._flatten_with_paths(pparams)[k].numpy(), w, **OPT_TOL)
    if "nomomentum" in name:
        assert pstate["per_param"]["w"]["m"] is None
    if name.startswith("adafactor"):
        assert pstate["per_param"]["stack"]["vr"].shape == (3, 4)
        assert pstate["per_param"]["stack"]["vc"].shape == (3, 7)


def test_apply_updates_casts_before_the_add():
    """A bf16 parameter takes ``p + u.astype(bf16)``, not an f32 add
    rounded after: bit for bit the reference's. At p = 1 an update of
    0.00392 (just over half a bf16 ulp) rounds to 2^-8 first, and the add
    then ties to 1.0; the f32 add would round up to 1 + 2^-7."""
    rng = np.random.default_rng(3)
    p = np.concatenate([np.ones(4, np.float32),
                        rng.normal(size=(60,)).astype(np.float32)])
    u = np.concatenate([np.full(4, 0.00392, np.float32),
                        (rng.normal(size=(60,)) * 3e-3).astype(np.float32)])
    jp = jnp.asarray(p).astype(jnp.bfloat16)
    want = np.asarray(j_opt.apply_updates({"p": jp}, {"p": jnp.asarray(u)})["p"])
    pt = t(np.asarray(jp))
    f32_then_cast = (pt.float() + t(u)).to(torch.bfloat16)
    got = opt.apply_updates({"p": pt}, {"p": t(u)})
    assert got["p"].dtype == torch.bfloat16 and got["p"] is pt
    np.testing.assert_array_equal(got["p"].view(torch.int16).numpy(),
                                  want.view(np.int16))
    assert got["p"][:4].tolist() == [1.0] * 4
    assert f32_then_cast[:4].tolist() == [1.0078125] * 4


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "keeps"])
def test_global_norm_and_clip_match_reference(max_norm):
    g = _grad_trees(4, 1)[0]
    want_tree, want_norm = j_opt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm)
    got_tree, got_norm = opt.clip_by_global_norm(_port_tree(g), max_norm)
    np.testing.assert_allclose(float(opt.global_norm(_port_tree(g))),
                               float(j_opt.global_norm(g)), rtol=1e-6)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    for k, w in leaves_with_paths(want_tree).items():
        np.testing.assert_allclose(
            ckpt._flatten_with_paths(got_tree)[k].numpy(), w, rtol=1e-6)


def test_make_optimizer_names():
    assert opt.make_optimizer("adamw", 1e-3).init is not None
    assert opt.make_optimizer("adafactor", 1e-3).init is not None
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.make_optimizer("sgd", 1e-3)


# --------------------------------------------------------------------------
# lm_loss and its gradients
# --------------------------------------------------------------------------

_REF_LOSS: dict = {}


def _ref_loss_and_grads(arch, lm_pair, chunks, seed):
    key = (arch, chunks, seed)
    if key not in _REF_LOSS:
        jcfg, jp, cfg, _ = lm_pair(arch)
        batch = lm_batch(seed, cfg.vocab, 2, 16)
        (loss, metrics), grads = jax.value_and_grad(
            lambda p, b: j_tf.lm_loss(p, b, jcfg, loss_chunks=chunks),
            has_aux=True)(jp, j_batch(batch))
        _REF_LOSS[key] = (batch, float(loss),
                          {k: float(v) for k, v in metrics.items()},
                          leaves_with_paths({".params": grads}))
    return _REF_LOSS[key]


def _assert_grads_close(got: dict, want: dict):
    """Every leaf within GRAD_REL of the reference leaf's max |g|."""
    got_flat = ckpt._flatten_with_paths({".params": got})
    assert set(got_flat) == set(want)
    for k, w in want.items():
        g = got_flat[k].float().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_REL * scale, k


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_grads_match_reference(arch, chunks, remat, lm_pair):
    """Value, the three metrics and every gradient leaf against
    ``jax.value_and_grad(lm_loss)``, labels with -1 (masked)."""
    batch, want_loss, want_metrics, want_grads = _ref_loss_and_grads(
        arch, lm_pair, chunks, seed=21)
    assert (batch["labels"] == -1).any()
    _, _, cfg, npp = lm_pair(arch)
    cfg = dataclasses.replace(cfg, remat=remat)
    params = convert.params_from_jax(npp, cfg, CPU).params()
    loss, metrics, grads = ts.value_and_grad(
        lambda p, b: tf.lm_loss(p, b, cfg, loss_chunks=chunks), params,
        t_batch(batch))
    np.testing.assert_allclose(float(loss), want_loss, **LOSS_TOL)
    assert set(metrics) == {"ce", "zloss", "moe_aux"} == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, **LOSS_TOL)
    _assert_grads_close(grads, want_grads)
    assert all(not p.requires_grad for p in opt.tree_leaves(params))


def test_lm_loss_without_grad_equals_with(lm_pair):
    """Outside autograd nothing is checkpointed; same value, and the loss
    over n chunks equals the one-chunk loss within f32 rounding."""
    _, _, cfg, npp = lm_pair("granite-moe-1b-a400m")
    params = convert.params_from_jax(npp, cfg, CPU).params()
    batch = t_batch(lm_batch(22, cfg.vocab, 2, 16))
    with torch.no_grad():
        plain, _ = tf.lm_loss(params, batch, cfg, loss_chunks=4)
        one, _ = tf.lm_loss(params, batch, cfg, loss_chunks=1)
        odd, _ = tf.lm_loss(params, batch, cfg, loss_chunks=5)  # 1 chunk
    loss, _, _ = ts.value_and_grad(
        lambda p, b: tf.lm_loss(p, b, cfg, loss_chunks=4), params, batch)
    assert float(plain) == float(loss)
    assert float(odd) == float(one)
    np.testing.assert_allclose(float(plain), float(one), rtol=1e-6)


def test_remat_checkpoints_layers_and_chunks(lm_pair, monkeypatch):
    """Under autograd with remat each layer and each loss chunk goes
    through ``remat_mod.checkpoint``; without remat only the chunks;
    under no_grad nothing."""
    _, _, cfg, npp = lm_pair("granite-20b")
    params = convert.params_from_jax(npp, cfg, CPU).params()
    batch = t_batch(lm_batch(23, cfg.vocab, 2, 16))
    calls = []
    real = remat_mod.checkpoint

    def counting(fn, *args):
        calls.append(fn.__name__)
        return real(fn, *args)
    monkeypatch.setattr(remat_mod, "checkpoint", counting)
    for remat, want in ((True, ["_block"] * cfg.n_layers
                         + ["_ce_chunk"] * 4),
                        (False, ["_ce_chunk"] * 4)):
        calls.clear()
        c = dataclasses.replace(cfg, remat=remat)
        ts.value_and_grad(lambda p, b: tf.lm_loss(p, b, c, loss_chunks=4),
                          params, batch)
        assert calls == want
    calls.clear()
    with torch.no_grad():
        tf.lm_loss(params, batch, cfg, loss_chunks=4)
    assert calls == []


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _assert_params_within(state: ts.TrainState, jstate, bound: float):
    got = ckpt._flatten_with_paths({".params": state.params})
    for k, w in leaves_with_paths({".params": jstate.params}).items():
        assert float(np.abs(got[k].numpy() - w).max()) <= bound, k


@pytest.mark.parametrize("microbatch", [0, 2], ids=["whole", "microbatch2"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_matches_reference(arch, microbatch, lm_pair):
    """Three AdamW steps through ``make_train_step`` against the
    reference's (jitted) on the same batches: loss, metrics and grad norm
    at each step, parameters after steps 1 and 3 within the AdamW bound;
    the step count and the state's own tensors advance in place."""
    jcfg, jp, cfg, _ = lm_pair(arch)
    lr = 1e-3
    jopt, popt = j_opt.adamw(lr), opt.adamw(lr)
    jstep = jax.jit(j_ts.make_train_step(
        lambda p, b: j_tf.lm_loss(p, b, jcfg, loss_chunks=2), jopt,
        microbatch=microbatch))
    pstep = ts.make_train_step(
        lambda p, b: tf.lm_loss(p, b, cfg, loss_chunks=2), popt,
        microbatch=microbatch)
    jstate = j_ts.TrainState.create(jp, jopt)
    state = convert.train_state_from_jax(np_tree(jstate), cfg, CPU)
    embed = state.params["embed"]
    for i in range(3):
        batch = lm_batch(30 + i, cfg.vocab, 4, 16)
        jstate, jm = jstep(jstate, j_batch(batch))
        state, m = pstep(state, t_batch(batch))
        assert set(m) == set(jm) == {"ce", "zloss", "moe_aux", "loss",
                                     "grad_norm"}
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL,
                                       err_msg=k)
        assert int(state.step) == int(jstate.step) == i + 1
        assert int(state.opt_state["step"]) == i + 1
        if i in (0, 2):
            _assert_params_within(state, jstate, 2 * lr * (i + 1) * 1.001
                                  + 1e-6)
    assert state.params["embed"] is embed      # updated in place



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_remat_checkpoint_equals_the_direct_call(dtype):
    """``remat.checkpoint`` of a function of a dict of leaves, a non-leaf
    input and a flag, with several outputs (one a float, one an integer
    tensor, one detached): the same outputs and exactly the same
    gradients as the direct call, in f32 and in bf16, and under
    ``no_grad`` the same outputs."""
    def fn(p, x, scale):
        y = torch.tanh(x @ p["w"] + p["b"]) * scale
        return y, 0.5, (y > 0).sum(), y.detach().sum()

    def leaves():
        gen = torch.Generator().manual_seed(3)
        w = torch.randn((6, 4), generator=gen).to(dtype).requires_grad_()
        b = torch.randn((4,), generator=gen).to(dtype).requires_grad_()
        e = torch.randn((5, 6), generator=gen).to(dtype).requires_grad_()
        return w, b, e

    grads = []
    for call in (fn, lambda *a: remat_mod.checkpoint(fn, *a)):
        w, b, e = leaves()
        y, half, pos, _ = call({"w": w, "b": b}, e * 2, 1.5)
        assert half == 0.5 and pos.dtype == torch.int64
        grads.append((y.detach(), torch.autograd.grad(
            (y.float() ** 2).sum(), [w, b, e])))
    (y0, g0), (y1, g1) = grads
    assert torch.equal(y0, y1)
    for a, c in zip(g0, g1):
        assert a.dtype == dtype and torch.equal(a, c)
    w, b, e = leaves()
    with torch.no_grad():
        out = remat_mod.checkpoint(fn, {"w": w, "b": b}, e, 1.5)
    assert torch.equal(out[0], fn({"w": w, "b": b}, e, 1.5)[0])


FIRST_CHECKPOINT = """
import gc, weakref, torch
gc.disable()
from repro_torch.models import remat

def f(p, x):
    return torch.tanh(x @ p["w"] + p["b"])

gen = torch.Generator().manual_seed(0)
w, b, e = (torch.randn(s, generator=gen, requires_grad=True)
           for s in ((4, 4), (4,), (3, 4)))
out = remat.checkpoint(f, {"w": w, "b": b}, e * 2)
g = torch.autograd.grad(out.sum(), [w, b, e])
refs = [weakref.ref(t) for t in (w, b, e)]
del w, b, e, out, g
print(sum(r() is not None for r in refs))
"""


def test_first_checkpoint_of_a_process_leaves_no_cycle():
    """A fresh interpreter with the collector off from its start: after
    its first ``remat.checkpoint`` and the gradients, every leaf dies with
    its last reference (``torch.utils.checkpoint``'s first call alone
    keeps all three, through its lazy ``torch._dynamo`` import)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", FIRST_CHECKPOINT],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split()[-1] == "0"


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


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
def test_train_step_state_dies_without_the_collector(remat, lm_pair):
    """Once a ``make_train_step`` step's state and outputs are dropped, a
    parameter leaf and an AdamW moment are freed at once: the checkpoints
    (each layer under remat, each loss chunk always) leave no reference
    cycle. The loss still equals the reference's."""
    jcfg, jp, cfg, _ = lm_pair("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, remat=remat)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    batch = lm_batch(36, cfg.vocab, 2, 16)
    jopt = j_opt.adamw(1e-3)
    _, jm = j_ts.make_train_step(
        lambda p, b: j_tf.lm_loss(p, b, jcfg, loss_chunks=2), jopt)(
        j_ts.TrainState.create(jp, jopt), j_batch(batch))
    losses = []

    def step_once():
        state = convert.train_state_from_jax(
            np_tree(j_ts.TrainState.create(jp, jopt)), cfg, CPU)
        step = ts.make_train_step(
            lambda p, b: tf.lm_loss(p, b, cfg, loss_chunks=2), opt.adamw(1e-3))
        state, m = step(state, t_batch(batch))
        losses.append(float(m["loss"]))
        return {"param": weakref.ref(state.params["ln_f"]),
                "layer": weakref.ref(state.params["layers"]["attn"]["wq"]),
                "moment": weakref.ref(state.opt_state["mu"]["embed"])}
    assert_freed_without_collector(step_once)
    np.testing.assert_allclose(losses[0], float(jm["loss"]), **LOSS_TOL)


def test_loop_with_checkpoints_frees_its_state_without_the_collector(
        tmp_path, lm_pair):
    """``loop.run`` with async and blocking checkpoints: once its result
    is dropped, a parameter leaf and an AdamW moment are freed at once
    (flattening a tree for a checkpoint leaves no reference cycle)."""
    _, _, cfg, npp = lm_pair("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, remat=True)
    rng = np.random.default_rng(38)

    def next_batch():
        return t_batch(lm_batch(int(rng.integers(1 << 30)), cfg.vocab, 2, 16))

    def run_once():
        result = loop.run(
            lambda p, b: tf.lm_loss(p, b, cfg, loss_chunks=2),
            convert.params_from_jax(npp, cfg, CPU).params(), opt.adamw(1e-3),
            next_batch, loop.LoopConfig(total_steps=4, ckpt_every=2,
                                        ckpt_dir=str(tmp_path), log_every=1))
        assert int(result.state.step) == 4
        return {"param": weakref.ref(result.state.params["ln_f"]),
                "moment": weakref.ref(result.state.opt_state["nu"]["embed"])}
    assert_freed_without_collector(run_once)


def test_value_and_grad_frees_params_and_grads_without_the_collector(lm_pair):
    """``value_and_grad`` alone (remat on, chunked loss): the parameters,
    the aliases the loss differentiates through (they share the
    parameters' storage) and the gradients die with their last
    reference."""
    _, _, cfg, npp = lm_pair("granite-20b")
    cfg = dataclasses.replace(cfg, remat=True)
    batch = t_batch(lm_batch(37, cfg.vocab, 2, 16))

    def grads_once():
        refs = {}

        def loss_fn(p, b):
            refs["alias"] = weakref.ref(p["ln_f"])
            refs["layer_alias"] = weakref.ref(p["layers"]["attn"]["wq"])
            return tf.lm_loss(p, b, cfg, loss_chunks=4)
        params = convert.params_from_jax(npp, cfg, CPU).params()
        loss, metrics, grads = ts.value_and_grad(loss_fn, params, batch)
        assert torch.isfinite(loss)
        refs["param"] = weakref.ref(params["ln_f"])
        refs["grad"] = weakref.ref(grads["layers"]["mlp"]["wi"])
        return refs
    assert_freed_without_collector(grads_once)

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_registry_train_step_matches_reference(arch, lm_pair):
    """The registry's ``step_fn`` on ``train_4k`` cut to (2, 16): the
    optimizer of ``choose_optimizer``, the loss chunks of
    ``loss_chunks_for`` and no microbatching, against the reference's."""
    jcfg, jp, cfg, _ = lm_pair(arch)
    spec, jspec = configs.get(arch), j_configs.get(arch)
    meta = {"seq": 16, "batch": 2}
    cell = dataclasses.replace(spec.shapes["train_4k"], meta=meta)
    jcell = dataclasses.replace(jspec.shapes["train_4k"], meta=meta)
    assert lm_common.loss_chunks_for(cell) == \
        j_configs.lm_common.loss_chunks_for(jcell) == 8
    assert lm_common.microbatch_for(cfg, cell) == 0
    jstate = j_ts.TrainState.create(jp, j_configs.lm_common.choose_optimizer(
        jcfg))
    state = convert.train_state_from_jax(np_tree(jstate), cfg, CPU)
    assert set(ckpt._flatten_with_paths(state)) == set(
        j_ckpt._flatten_with_paths(jstate))
    batch = lm_batch(40, cfg.vocab, 2, 16, masked=False)
    jstate, jm = jax.jit(jspec.step_fn(jcfg, jcell))(jstate, j_batch(batch))
    state, m = spec.step_fn(cfg, cell)(state, t_batch(batch))
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL)
    _assert_params_within(state, jstate, 2 * 3e-4 * 1.001 + 1e-6)


def test_choose_optimizer_by_size():
    """Adafactor above 30e9 parameters (arctic, nemotron at full size),
    else AdamW at 3e-4, as the reference chooses."""
    for arch in LM_ARCHS:
        full = configs.get(arch).make_config()
        got = lm_common.choose_optimizer(full)
        state = got.init({"w": torch.zeros(2, 3)})
        want_adafactor = full.param_count() > 30e9
        assert ("per_param" in state) == want_adafactor
        jstate = j_configs.lm_common.choose_optimizer(
            j_configs.get(arch).make_config()).init({"w": jnp.zeros((2, 3))})
        assert ("per_param" in jstate) == want_adafactor


def test_grad_compression_hook_sees_the_grads(lm_pair):
    _, _, cfg, npp = lm_pair("internlm2-20b")
    seen = []

    def compress(grads):
        seen.append(sorted(grads))
        return opt.tree_map(torch.zeros_like, grads)
    step = ts.make_train_step(
        lambda p, b: tf.lm_loss(p, b, cfg, loss_chunks=2),
        opt.adamw(1e-3, weight_decay=0.0), grad_compression=compress)
    params = convert.params_from_jax(npp, cfg, CPU).params()
    state = ts.TrainState.create(opt.tree_map(torch.clone, params),
                                 opt.adamw(1e-3, weight_decay=0.0))
    state, m = step(state, t_batch(lm_batch(41, cfg.vocab, 2, 16)))
    assert seen == [sorted(params)]
    assert float(m["grad_norm"]) == 0.0
    for a, b in zip(opt.tree_leaves(state.params), opt.tree_leaves(params)):
        assert torch.equal(a, b)    # zero grads, no decay: no change


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _npz_members(path) -> dict:
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("which", ["adamw", "adafactor", "adafactor-nomom"])
def test_checkpoint_keys_match_reference(which, lm_pair):
    jcfg, jp, cfg, _ = lm_pair("granite-moe-1b-a400m")
    make = {"adamw": lambda m: m.adamw(),
            "adafactor": lambda m: m.adafactor(),
            "adafactor-nomom": lambda m: m.adafactor(momentum=0.0)}[which]
    jstate = j_ts.TrainState.create(jp, make(j_opt))
    want = list(j_ckpt._flatten_with_paths(jstate))
    state = ts.TrainState.create(
        convert.params_from_jax(np_tree(jp), cfg, CPU).params(), make(opt))
    assert list(ckpt._flatten_with_paths(state)) == want
    assert ".params/layers/attn/wq" in want and ".step" in want
    assert (".opt_state/mu/embed" in want) == (which == "adamw")
    assert any(k.endswith("/m") for k in want) == (which == "adafactor")


def test_checkpoint_port_to_reference_and_back(tmp_path, lm_pair):
    """An f32 AdamW state after one step: the port's checkpoint restores in
    the reference bit for bit, the reference's in the port, and both npz
    files hold the same members byte for byte; the manifests are equal."""
    jcfg, jp, cfg, _ = lm_pair("internlm2-20b")
    jopt = j_opt.adamw(1e-3)
    jstate = j_ts.TrainState.create(jp, jopt)
    jstate, _ = jax.jit(j_ts.make_train_step(
        lambda p, b: j_tf.lm_loss(p, b, jcfg, loss_chunks=2), jopt))(
        jstate, j_batch(lm_batch(50, cfg.vocab, 2, 16)))
    state = convert.train_state_from_jax(np_tree(jstate), cfg, CPU)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    ckpt.CheckpointManager(str(port_dir)).save(
        1, state, extra={"pipeline": {"cursor": 7}}, blocking=True)
    j_ckpt.CheckpointManager(str(ref_dir)).save(
        1, jstate, extra={"pipeline": {"cursor": 7}}, blocking=True)
    assert _npz_members(port_dir / "ckpt_00000001.npz") == _npz_members(
        ref_dir / "ckpt_00000001.npz")
    assert (port_dir / "ckpt_00000001.json").read_text() == (
        ref_dir / "ckpt_00000001.json").read_text()

    like = j_ts.TrainState.create(jp, jopt)
    restored, manifest = j_ckpt.CheckpointManager(str(port_dir)).restore(like)
    assert manifest["extra"] == {"pipeline": {"cursor": 7}}
    for k, w in leaves_with_paths(jstate).items():
        np.testing.assert_array_equal(
            np.asarray(j_ckpt._flatten_with_paths(restored)[k]), w)

    fresh = ts.TrainState.create(
        convert.params_from_jax(np_tree(jp), cfg, CPU).params(),
        opt.adamw(1e-3))
    got, manifest = ckpt.CheckpointManager(str(ref_dir)).restore(fresh)
    assert manifest["step"] == 1
    for k, w in leaves_with_paths(jstate).items():
        g = ckpt._flatten_with_paths(got)[k]
        assert str(g.dtype) == "torch." + str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


def test_checkpoint_bf16_leaves_bit_exact(tmp_path, lm_pair):
    """Adafactor's bf16 momentum (and bf16 parameters) from a reference
    checkpoint restore bit for bit in the port; the port writes those
    leaves byte for byte as the reference does (descr '<V2'). The
    reference itself cannot restore a bf16 leaf (``np.load`` gives
    ``|V2``, which it cannot cast): recorded, not repaired."""
    jcfg, _, cfg, _ = lm_pair("granite-moe-1b-a400m")
    jp = j_tf.lm_init(KEY, jcfg, dtype=jnp.bfloat16)
    jopt = j_opt.adafactor(lr=1e-2)
    jstate = j_ts.TrainState.create(jp, jopt)
    jstate, _ = jax.jit(j_ts.make_train_step(
        lambda p, b: j_tf.lm_loss(p, b, jcfg, loss_chunks=2), jopt))(
        jstate, j_batch(lm_batch(51, cfg.vocab, 2, 16)))
    flat = leaves_with_paths(jstate)
    bf16 = [k for k, v in flat.items() if v.dtype.name == "bfloat16"]
    assert ".opt_state/per_param/layers/attn/wq/m" in bf16
    assert ".params/embed" in bf16
    assert any(np.any(flat[k].view(np.uint16) != 0) for k in bf16
               if k.endswith("/m"))
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    j_ckpt.CheckpointManager(str(ref_dir)).save(2, jstate, blocking=True)

    like = ts.TrainState.create(
        convert.params_from_jax(np_tree(jp), cfg, CPU).params(),
        opt.adafactor(lr=1e-2))
    got, _ = ckpt.CheckpointManager(str(ref_dir)).restore(like)
    got_flat = ckpt._flatten_with_paths(got)
    for k in bf16:
        assert got_flat[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got_flat[k].view(torch.int16).numpy(), flat[k].view(np.int16))

    ckpt.CheckpointManager(str(port_dir)).save(2, got, blocking=True)
    ref_m = _npz_members(ref_dir / "ckpt_00000002.npz")
    port_m = _npz_members(port_dir / "ckpt_00000002.npz")
    assert ref_m == port_m
    with pytest.raises(ValueError, match="cast"):
        j_ckpt.CheckpointManager(str(port_dir)).restore(jstate)


def test_checkpoint_async_save_gc_and_errors(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6.0).reshape(2, 3), "n": {"b": torch.ones(2)}}
    for s in (1, 2, 3, 4):
        path = mgr.save(s, opt.tree_map(lambda x: x * s, tree))
        assert path.endswith(f"ckpt_{s:08d}")
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    got, manifest = mgr.restore(tree)
    assert manifest["step"] == 4
    assert torch.equal(got["w"], tree["w"] * 4)
    got3, _ = mgr.restore(tree, step=3)
    assert torch.equal(got3["n"]["b"], torch.full((2,), 3.0))
    with pytest.raises(ValueError, match="checkpoint shape"):
        mgr.restore({"w": torch.zeros(3, 3), "n": {"b": torch.ones(2)}})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({**tree, "extra": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(str(tmp_path / "empty")).restore(tree)
    assert not list(tmp_path.glob("*.tmp*"))


def test_checkpoint_async_snapshot_is_taken_at_save(tmp_path):
    """The host copy is made before ``save`` returns, so an in-place update
    right after (the next train step) does not reach the file."""
    mgr = ckpt.CheckpointManager(str(tmp_path))
    w = torch.zeros(1 << 16)
    mgr.save(1, {"w": w})
    w.add_(1.0)
    got, _ = mgr.restore({"w": w})
    assert float(got["w"].abs().max()) == 0.0


# --------------------------------------------------------------------------
# the LM pipeline with its n-gram dedup filter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dedup,scheme", [(True, "idl"), (True, "rh"),
                                          (False, "idl")],
                         ids=["idl", "rh", "off"])
def test_lm_pipeline_matches_reference(dedup, scheme):
    kw = dict(vocab=512, seq_len=32, global_batch=2, doc_len=128,
              dedup=dedup, dedup_scheme=scheme, seed=3)
    jp = j_lm_pipeline.LMPipeline(j_lm_pipeline.LMPipelineConfig(**kw))
    pp = lm_pipeline.LMPipeline(lm_pipeline.LMPipelineConfig(**kw))
    for _ in range(12):
        want, got = jp.next_batch(), pp.next_batch()
        assert set(got) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    assert pp.state_dict() == jp.state_dict()
    assert (pp.dropped > 0) == dedup
    if dedup:
        assert pp.bf.probes == jp.bf.probes
        assert len(pp.bf.byte_trace) == len(jp.bf.byte_trace)
        for a, b in zip(pp.bf.byte_trace, jp.bf.byte_trace):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pp.bf.bits, jp.bf.bits)


def test_lm_pipeline_resume_replays_exactly():
    kw = dict(vocab=512, seq_len=32, global_batch=2, doc_len=128)
    a = lm_pipeline.LMPipeline(lm_pipeline.LMPipelineConfig(**kw))
    for _ in range(5):
        a.next_batch()
    state = a.state_dict()
    b = lm_pipeline.LMPipeline(lm_pipeline.LMPipelineConfig(**kw))
    b.load_state_dict(state)
    jb = j_lm_pipeline.LMPipeline(j_lm_pipeline.LMPipelineConfig(**kw))
    jb.load_state_dict(state)
    assert b.state_dict() == state == jb.state_dict()
    nxt, jnxt = b.next_batch(), jb.next_batch()
    np.testing.assert_array_equal(nxt["tokens"], jnxt["tokens"])
    np.testing.assert_array_equal(b.bf.bits, jb.bf.bits)
    assert b.dropped == jb.dropped


def test_lm_dedup_idl_locality_beats_rh():
    """The reference's locality check through the port's cache model: the
    dedup filter's probe trace is more page-local under IDL than RH."""
    rates = {}
    for scheme in ("idl", "rh"):
        pipe = lm_pipeline.LMPipeline(lm_pipeline.LMPipelineConfig(
            vocab=512, seq_len=32, global_batch=2, doc_len=256,
            dedup=True, dedup_scheme=scheme))
        for _ in range(6):
            pipe.next_batch()
        trace = np.concatenate(pipe.bf.byte_trace) * 8
        rates[scheme] = cache_model.two_level_miss_rates(
            trace, l1_bytes=64 * 1024, line_bytes=4096)[0]
    assert rates["rh"] > 2 * rates["idl"]


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------

TINY = tf.LMConfig(name="t", n_layers=1, d_model=16, n_heads=2,
                   n_kv_heads=1, d_ff=32, vocab=64, remat=False)


def _tiny_params(seed=0):
    return tf.lm_init(seed, TINY, device=CPU).params()


def _pipe(doc_len=64):
    return lm_pipeline.LMPipeline(lm_pipeline.LMPipelineConfig(
        vocab=64, seq_len=16, global_batch=4, doc_len=doc_len, dedup=True))


def _batches(pipe):
    return lambda: {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()}


def _run(params, total, pipe, ckpt_dir=None, **kw):
    lcfg = loop.LoopConfig(total_steps=total, ckpt_every=4,
                           ckpt_dir=ckpt_dir, log_every=1, **kw)
    return loop.run(
        lambda p, b: tf.lm_loss(p, b, TINY, loss_chunks=4),
        params, opt.adamw(1e-2), _batches(pipe), lcfg,
        pipeline_state=pipe.state_dict, restore_pipeline=pipe.load_state_dict)


def test_loop_loss_decreases_on_a_repeated_batch():
    params = _tiny_params()
    before = opt.tree_map(torch.clone, params)
    batch = _batches(_pipe())()
    res = loop.run(lambda p, b: tf.lm_loss(p, b, TINY, loss_chunks=4),
                   params, opt.adamw(1e-2), lambda: batch,
                   loop.LoopConfig(total_steps=12, log_every=1))
    losses = [h["loss"] for h in res.history]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5
    assert int(res.state.step) == 12 and res.resumed_from is None
    for a, b in zip(opt.tree_leaves(params), opt.tree_leaves(before)):
        assert torch.equal(a, b)        # the caller's tensors stay


def test_loop_resume_equals_uninterrupted(tmp_path):
    """4 steps, a checkpoint, a fresh process-like restart to 8 steps:
    the losses of steps 4-7 and the final state equal an uninterrupted
    8-step run's, bit for bit (the pipeline replays its cursor)."""
    params = _tiny_params()
    whole = _run(params, 8, _pipe())
    first = _run(params, 4, _pipe(), ckpt_dir=str(tmp_path))
    assert int(first.state.step) == 4
    assert ckpt.CheckpointManager(str(tmp_path)).all_steps() == [4]
    second = _run(params, 8, _pipe(), ckpt_dir=str(tmp_path))
    assert second.resumed_from == 4
    assert [h["step"] for h in second.history] == [4, 5, 6, 7]
    assert [h["loss"] for h in second.history] == \
        [h["loss"] for h in whole.history[4:]]
    a = ckpt._flatten_with_paths(whole.state)
    b = ckpt._flatten_with_paths(second.state)
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_loop_flags_a_straggler_step():
    hb = ft.Heartbeat(straggler_factor=2.0, window=16)
    for i in range(10):
        hb.start_step(i)
        hb.end_step()
    hb.start_step(99)
    time.sleep(0.05)
    ev = hb.end_step()
    assert ev is not None and ev.step == 99 and ev.duration > 2 * ev.median

    def slow_at_10(step_fn):
        def wrapped(state, batch):
            out = step_fn(state, batch)
            if int(out[0].step) == 11:
                time.sleep(1.0)
            return out
        return wrapped
    res = loop.run(lambda p, b: tf.lm_loss(p, b, TINY, loss_chunks=4),
                   _tiny_params(), opt.adamw(1e-2), _batches(_pipe()),
                   loop.LoopConfig(total_steps=12, log_every=1,
                                   straggler_factor=3.0),
                   step_fn_transform=slow_at_10)
    # a busy host may slow another step too; step 10 must be flagged
    assert 10 in [e.step for e in res.straggler_events]
    assert res.history[10].get("straggler") == 1.0
    assert all(h.get("straggler") == 1.0 for h in res.history
               if h["step"] in {e.step for e in res.straggler_events})


def test_loop_preemption_forces_a_blocking_checkpoint(tmp_path):
    """A SIGTERM during step 2 ends the loop after that step with a
    blocking checkpoint at step 3; the rerun resumes there."""
    pipe = _pipe()
    batches = _batches(pipe)
    calls = []

    def next_batch():
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return batches()
    prev = signal.getsignal(signal.SIGTERM)
    res = loop.run(lambda p, b: tf.lm_loss(p, b, TINY, loss_chunks=4),
                   _tiny_params(), opt.adamw(1e-2), next_batch,
                   loop.LoopConfig(total_steps=20, ckpt_every=100,
                                   ckpt_dir=str(tmp_path), log_every=1,
                                   install_signal_handlers=True),
                   pipeline_state=pipe.state_dict,
                   restore_pipeline=pipe.load_state_dict)
    assert signal.getsignal(signal.SIGTERM) is prev     # handlers restored
    assert res.preempted and int(res.state.step) == 3
    assert [h["step"] for h in res.history] == [0, 1, 2]
    mgr = ckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    _, manifest = mgr.restore(res.state)
    assert manifest["extra"]["pipeline"] == pipe.state_dict()
    again = _run(_tiny_params(), 5, _pipe(), ckpt_dir=str(tmp_path))
    assert again.resumed_from == 3 and int(again.state.step) == 5


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_train_launcher_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-moe-1b-a400m", "--device", "cpu", "--steps", "6",
         "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("done: granite-moe-1b-a400m loss ")
    assert "'grad_norm'" in lines[0] and "'moe_aux'" in lines[0]
    mgr = ckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 6
    manifest = mgr.restore(ts.TrainState.create(
        tf.lm_init(0, configs.get("granite-moe-1b-a400m").make_smoke_config(),
                   device=CPU).params(), opt.adamw(1e-3)))[1]
    assert manifest["extra"]["pipeline"]["cursor"] > 0


def test_train_launcher_refuses_other_families():
    """Only the serve-only family and unknown archs are refused; the port
    trains exactly the reference's trainable archs (every family but
    ``genesearch``)."""
    with pytest.raises(SystemExit, match="serve-only"):
        train_launcher.main(["--arch", "idl-genesearch", "--device", "cpu"])
    with pytest.raises(KeyError, match="unknown arch"):
        train_launcher.main(["--arch", "no-such-arch", "--device", "cpu"])
    want = {a for a in j_configs.all_archs()
            if j_configs.get(a).family != "genesearch"}
    got = {a for a in configs.all_archs()
           if configs.get(a).family in train_launcher.RUNNERS}
    assert got == want
    assert not hasattr(train_launcher, "NOT_PORTED")


@pytest.mark.parametrize("arch", ["fm", "equiformer-v2"])
def test_train_launcher_trains_recsys_and_gnn(arch, capsys):
    """``--device cpu`` trains a recsys arch and the GNN for a few steps
    in process; every logged loss is finite."""
    train_launcher.main(["--arch", arch, "--device", "cpu", "--steps", "4",
                         "--batch", "8"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith(f"done: {arch} loss ")
    first, last = (float(x) for x in lines[-1].split("loss ")[1].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


def test_train_launcher_recsys():
    """The port's counterpart of ``tests/test_launchers.py::
    test_train_launcher_recsys``: ``fm`` for 10 steps at batch 32, as a
    subprocess on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "fm",
         "--device", "cpu", "--steps", "10", "--batch", "32"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-1500:]
    assert "done: fm" in out.stdout
