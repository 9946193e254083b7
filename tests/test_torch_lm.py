"""PyTorch port vs the JAX reference for the LM family's serving path: the
building blocks, both MoE dispatch paths, the transformer's forward,
prefill and KV-cache decode for each of the five LM archs' smoke configs,
the registry and the serve step functions.

Tolerances (f32 parameters, on the CPU): logits rtol 1e-4 and atol 1e-5;
block outputs rtol 1e-5 and atol 1e-6 (the two frameworks' f32 matmuls
and the MoE combine's scatter-add sum in different orders, so equality is
within a tolerance, never bit for bit); bf16 KV caches compared as f32
within one bf16 ulp of the larger magnitude; routing indices, capacity
positions and drop masks exactly equal. Parameters come from the
reference's ``lm_init(PRNGKey(0), cfg)`` through ``params_from_jax``;
tokens from a per-test ``np.random.default_rng(seed)``.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import repro.configs as j_configs  # noqa: E402
from repro.configs import lm_common as j_lm_common  # noqa: E402
from repro.configs import idl_genesearch as j_idl_genesearch  # noqa: E402
from repro.data import genome as j_genome  # noqa: E402
from repro.index import engines as j_engines  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import lm_common  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import convert, layers, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

KEY = jax.random.PRNGKey(0)
LM_ARCHS = ["arctic-480b", "granite-moe-1b-a400m", "granite-20b",
            "nemotron-4-340b", "internlm2-20b"]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"


def t(a) -> torch.Tensor:
    """A reference or numpy array as a CPU tensor of the same dtype."""
    return convert.tensor_from_numpy(np.asarray(a), CPU)


def as_np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x).astype(np.float32))


def assert_within_bf16_ulp(got, want):
    """bf16 tensors compared as f32: within one bf16 ulp (2^-7 of the
    larger magnitude's power of two) of each other."""
    g, w = as_np(got), as_np(want)
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w) - ulp))


def tokens(seed: int, vocab: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def lm_pair():
    """arch -> (reference cfg, reference params, port cfg, port model): the
    smoke configs, the port's weights carried over from the reference's."""
    out = {}

    def get(arch, **moe_overrides):
        key = (arch, tuple(sorted(moe_overrides.items())))
        if key not in out:
            jcfg = j_configs.get(arch).make_smoke_config()
            cfg = configs.get(arch).make_smoke_config()
            if moe_overrides:
                jcfg = dataclasses.replace(
                    jcfg, moe=dataclasses.replace(jcfg.moe, **moe_overrides))
                cfg = dataclasses.replace(
                    cfg, moe=dataclasses.replace(cfg.moe, **moe_overrides))
            jp = j_tf.lm_init(KEY, jcfg)
            model = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                            CPU)
            out[key] = (jcfg, jp, cfg, model)
        return out[key]
    return get


# --------------------------------------------------------------------------
# the transformer against the reference, per arch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
class TestTransformerParity:
    def test_init_tree_matches_reference(self, arch):
        """lm_init draws the reference's tree: same keys, shapes, dtypes,
        and as many parameters as ``param_count``."""
        cfg = configs.get(arch).make_smoke_config()
        jcfg = j_configs.get(arch).make_smoke_config()
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            model = tf.lm_init(3, cfg, dtype=dt, device=CPU)
            shapes = jax.eval_shape(lambda k: j_tf.lm_init(k, jcfg, jdt), KEY)
            want = {jax.tree_util.keystr(p).replace("']['", ".").strip("[']"):
                    (tuple(leaf.shape), str(leaf.dtype))
                    for p, leaf in jax.tree_util.tree_flatten_with_path(
                        shapes)[0]}
            got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                   for k, v in model.state_dict().items()}
            assert got == want
            assert sum(p.numel() for p in model.parameters()) == \
                cfg.param_count()
        again, same = (tf.lm_init(s, cfg, device=CPU) for s in (3, 3))
        assert all(torch.equal(a, b) for a, b in zip(
            again.parameters(), same.parameters()))       # seeded
        other = tf.lm_init(4, cfg, device=CPU)
        assert not torch.equal(other.embed, same.embed)

    def test_forward(self, arch, lm_pair):
        jcfg, jp, cfg, model = lm_pair(arch)
        toks = tokens(11, cfg.vocab, (2, 12))
        want, want_aux = j_tf.lm_forward(jp, jnp.asarray(toks), jcfg)
        with torch.inference_mode():
            got, aux = tf.lm_forward(model.params(), t(toks), cfg)
            via_module = model(t(toks))[0]
        assert got.dtype == torch.float32 and got.shape == (2, 12, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        np.testing.assert_allclose(float(aux), float(want_aux), **BLOCK_TOL)
        assert torch.equal(via_module, got)

    def test_prefill_logits_and_cache(self, arch, lm_pair):
        jcfg, jp, cfg, model = lm_pair(arch)
        toks = tokens(12, cfg.vocab, (2, 9))
        want, jcache = j_tf.lm_prefill(jp, jnp.asarray(toks), jcfg)
        with torch.inference_mode():
            got, cache = model.prefill(t(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        for name in ("k", "v"):
            assert cache[name].dtype == torch.bfloat16
            assert cache[name].shape == jcache[name].shape
            assert_within_bf16_ulp(cache[name], jcache[name])
        assert cache["len"].dtype == torch.int32
        np.testing.assert_array_equal(cache["len"].numpy(), jcache["len"])

    @pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
    def test_decode_steps_after_prefill(self, arch, cache_dtype, lm_pair):
        """Prefill 8 tokens, pad the cache to 16, decode two tokens: the
        logits and the written caches against the reference's, each step
        fed the reference's cache (carried across with cache_from_jax).

        An f32 cache takes the logit tolerance at every step. A bf16 cache
        stores each new key and value rounded to bf16, and the two
        frameworks' f32 projections (equal within ~1e-7) can round one
        element to neighbouring bf16 values: the caches then agree within
        one bf16 ulp, and the logits within the tolerance one such ulp
        (2^-8 of a key element) allows, rtol and atol 1e-3; where every
        written bit agrees, the logit tolerance holds."""
        jcfg, jp, cfg, model = lm_pair(arch)
        jdt = getattr(jnp, cache_dtype)
        toks = tokens(13, cfg.vocab, (2, 8))
        nxt = tokens(14, cfg.vocab, (2, 2))
        _, jcache = j_tf.lm_prefill(jp, jnp.asarray(toks), jcfg)
        full = j_tf.init_kv_cache(jcfg, 2, 16, dtype=jdt)
        full["k"] = full["k"].at[:, :, :8].set(jcache["k"].astype(jdt))
        full["v"] = full["v"].at[:, :, :8].set(jcache["v"].astype(jdt))
        full["len"] = jcache["len"]
        for step in range(2):
            cache = convert.cache_from_jax(jax.tree.map(np.asarray, full), CPU)
            want, full = j_tf.lm_decode_step(jp, full, jnp.asarray(nxt[:, step]),
                                             jcfg)
            with torch.inference_mode():
                got, cache = model.decode_step(cache, t(nxt[:, step]))
            same_bits = True
            for name in ("k", "v"):
                assert cache[name].dtype == getattr(torch, cache_dtype)
                if cache_dtype == "bfloat16":
                    assert_within_bf16_ulp(cache[name], full[name])
                    same_bits &= np.array_equal(
                        cache[name].view(torch.int16).numpy(),
                        np.asarray(full[name]).view(np.int16))
                else:
                    np.testing.assert_allclose(cache[name].numpy(),
                                               np.asarray(full[name]),
                                               **BLOCK_TOL)
            tol = LOGIT_TOL if same_bits else dict(rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
            np.testing.assert_array_equal(cache["len"].numpy(), full["len"])

    def test_prefill_then_decode_equals_forward(self, arch):
        """The port's own consistency (the reference's test, with a
        per-test seed): prefill then one decode step == forward on the
        extended sequence, MoE capacity raised so no token drops."""
        cfg = configs.get(arch).make_smoke_config()
        if cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
        model = tf.lm_init(0, cfg, device=CPU)
        toks = torch.from_numpy(tokens(15, cfg.vocab, (2, 8)))
        nxt = torch.from_numpy(tokens(16, cfg.vocab, (2,)))
        with torch.inference_mode():
            logits_p, cache = model.prefill(toks)
            full = model.init_kv_cache(2, 16)
            full["k"][:, :, :8] = cache["k"]
            full["v"][:, :, :8] = cache["v"]
            full["len"] = cache["len"]
            logits_d, new = model.decode_step(full, nxt)
            logits_f, _ = model(torch.cat([toks, nxt[:, None]], dim=1))
        np.testing.assert_allclose(logits_d.numpy(), logits_f[:, -1].numpy(),
                                   rtol=0.05, atol=0.05)  # bf16 cache
        np.testing.assert_allclose(logits_p.numpy(), logits_f[:, -2].numpy(),
                                   **LOGIT_TOL)
        assert new["len"].tolist() == [9, 9]


def test_bf16_weights_carry_across_bit_for_bit():
    jcfg = j_configs.get("granite-moe-1b-a400m").make_smoke_config()
    cfg = configs.get("granite-moe-1b-a400m").make_smoke_config()
    jp = j_tf.lm_init(KEY, jcfg, dtype=jnp.bfloat16)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, CPU)
    assert model.dtype == torch.bfloat16
    assert model.layers.moe.router.dtype == torch.float32  # router stays f32
    got = model.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = jax.tree_util.keystr(path).replace("']['", ".").strip("[']")
        want = np.asarray(leaf)
        if want.dtype.name == "bfloat16":
            assert torch.equal(got[key].view(torch.int16),
                               torch.from_numpy(want.view(np.int16)))
        else:
            np.testing.assert_array_equal(got[key].numpy(), want)


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

ATTN = dict(d_model=32, n_heads=4, n_kv_heads=2, d_head=8)


def attn_pair(seed=0, **over):
    jcfg = j_layers.AttnConfig(**ATTN, **over)
    cfg = layers.AttnConfig(**ATTN, **over)
    jp = j_layers.attn_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, {k: t(v) for k, v in jp.items()}


def normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("window", [0, 3], ids=["full", "window3"])
def test_attention_matches_reference(window):
    jcfg, jp, cfg, p = attn_pair(window=window)
    x = normal(1, (2, 16, 32))
    want = j_layers.attention(jp, jnp.asarray(x), jcfg)
    got = layers.attention(p, t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    # a windowed row attends only its last `window` positions: moving an
    # earlier token changes nothing there
    if window:
        x2 = x.copy()
        x2[:, 0] += 1.0
        got2 = layers.attention(p, t(x2), cfg)
        np.testing.assert_allclose(got2[:, window:].numpy(),
                                   got[:, window:].numpy(), **BLOCK_TOL)
        assert not np.allclose(got2[:, 0].numpy(), got[:, 0].numpy())


@pytest.mark.parametrize("window,chunk", [(0, 4), (0, 8), (3, 4), (0, 5)],
                         ids=["c4", "c8", "window3-c4", "c5-falls-back"])
def test_attention_chunked_matches_full_and_reference(window, chunk):
    jcfg, jp, cfg, p = attn_pair(seed=2, window=window)
    x = normal(3, (2, 16, 32))
    full = layers.attention(p, t(x), cfg)
    got = layers.attention_chunked(p, t(x), cfg, chunk=chunk)
    want = j_layers.attention_chunked(jp, jnp.asarray(x), jcfg, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **BLOCK_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_writes_the_cache_like_the_reference(dtype):
    """Per-row cache lengths, one of them at S_max (the reference's one-hot
    writes nothing there): the written caches equal bit for bit (a bf16
    cache under f32 or bf16 compute), the outputs within tolerance."""
    jcfg, jp, cfg, p = attn_pair(seed=4)
    jdt = getattr(jnp, dtype)
    s_max = 6
    rng = np.random.default_rng(5)
    kc = jnp.asarray(rng.standard_normal((3, s_max, 2, 8)), jnp.bfloat16)
    vc = jnp.asarray(rng.standard_normal((3, s_max, 2, 8)), jnp.bfloat16)
    lens = np.array([0, 4, s_max], np.int32)
    x = jnp.asarray(normal(6, (3, 1, 32))).astype(jdt)
    jp_dt = {k: v.astype(jdt) for k, v in jp.items()}
    want, wk, wv = j_layers.attention_decode(jp_dt, x, jcfg, kc, vc,
                                             jnp.asarray(lens))
    got_k, got_v = t(kc), t(vc)
    got, gk, gv = layers.attention_decode(
        {k: t(v) for k, v in jp_dt.items()}, t(x), cfg, got_k, got_v,
        t(lens))
    assert gk is got_k and gv is got_v              # written in place
    for g, w in ((gk, wk), (gv, wv)):
        assert torch.equal(g.view(torch.int16),
                           torch.from_numpy(np.asarray(w).view(np.int16)))
    tol = BLOCK_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


@pytest.mark.parametrize("act", ["gelu", "silu", "relu", "relu2"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
def test_mlp_and_activations(act, gated):
    jcfg = j_layers.MlpConfig(16, 48, act, gated)
    cfg = layers.MlpConfig(16, 48, act, gated)
    jp = j_layers.mlp_init(jax.random.PRNGKey(1), jcfg)
    x = normal(7, (2, 5, 16))
    want = j_layers.mlp(jp, jnp.asarray(x), jcfg)
    got = layers.mlp({k: t(v) for k, v in jp.items()}, t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(
        layers.activation(act, t(x)).numpy(),
        np.asarray(j_layers.activation(act, jnp.asarray(x))), **BLOCK_TOL)


def test_norms_and_rope():
    x = normal(8, (2, 5, 3, 8))
    scale, bias = normal(9, (8,)), normal(10, (8,))
    np.testing.assert_allclose(
        layers.rmsnorm(t(x), t(scale)).numpy(),
        np.asarray(j_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        **BLOCK_TOL)
    np.testing.assert_allclose(
        layers.layernorm(t(x), t(scale), t(bias)).numpy(),
        np.asarray(j_layers.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias))), **BLOCK_TOL)
    np.testing.assert_array_equal(layers.rope_frequencies(8, 1e6),
                                  j_layers.rope_frequencies(8, 1e6))
    pos = np.array([[0, 3, 7, 100, 4095]], np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(t(x), t(pos)).numpy(),
        np.asarray(j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        **BLOCK_TOL)


# --------------------------------------------------------------------------
# MoE: both dispatch paths, drops, routing exactly
# --------------------------------------------------------------------------

def reference_routing(jp, x, cfg, groups):
    """The reference's routing lines (``moe.py``: router, softmax, top_k,
    per-group capacity positions) on its own arrays, with the smallest
    gap between each token's k-th and (k+1)-th probability."""
    b, s, d = x.shape
    tg = b * s // groups
    e, k = cfg.n_experts, cfg.top_k
    cap = j_moe._capacity(tg, cfg)
    xg = jnp.asarray(x).reshape(groups, tg, d)
    probs = jax.nn.softmax(xg.astype(jnp.float32) @ jp["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    flat_oh = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32).reshape(
        groups, tg * k, e)
    pos = jnp.sum((jnp.cumsum(flat_oh, axis=1) - flat_oh) * flat_oh, axis=-1)
    srt = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    gap = float(np.min(srt[..., k - 1] - srt[..., k]))
    return np.asarray(gate_idx), np.asarray(pos), np.asarray(pos < cap), gap


MOE = dict(d_model=16, d_ff=24, n_experts=8, top_k=2)


@pytest.mark.parametrize("residual", [0, 20], ids=["moe", "moe+residual"])
@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["cf1.25", "cf0.25-drops"])
@pytest.mark.parametrize("groups", [0, 2, 3],
                         ids=["global", "grouped2", "groups3-global"])
def test_moe_dispatch_paths_match_reference(groups, cf, residual):
    jcfg = j_moe.MoeConfig(**MOE, capacity_factor=cf, residual_d_ff=residual,
                           dispatch_groups=groups)
    cfg = moe.MoeConfig(**MOE, capacity_factor=cf, residual_d_ff=residual,
                        dispatch_groups=groups)
    jp = j_moe.moe_init(jax.random.PRNGKey(2), jcfg)
    p = convert._tree(jax.tree.map(np.asarray, jp), CPU)
    # seed 26: the smallest k-th vs (k+1)-th gap is 2.4e-3 (seeds 21-25
    # hold gaps under 1e-4, which the guard below refuses)
    x = normal(26, (2, 32, 16))
    # the reference's branch rule: grouped iff G > 1 and G | B·S
    G = groups if groups > 1 and 64 % groups == 0 else 1
    want_idx, want_pos, want_keep, gap = reference_routing(jp, x, jcfg, G)
    assert gap > 1e-4, "a near-tie could flip an expert between frameworks"
    *_, gate_idx, pos, keep, cap = moe.route(p, t(x), cfg, G)
    np.testing.assert_array_equal(gate_idx.numpy(), want_idx)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf < 1:
        assert not keep.all()                       # tokens drop
    want, want_aux = j_moe.moe(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe(p, t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **BLOCK_TOL)


def test_grouped_capacity_differs_from_global():
    """Per-group capacity: grouped dispatch drops differently from global
    at the same capacity factor, on both sides alike."""
    cfg = moe.MoeConfig(**MOE, capacity_factor=0.5, dispatch_groups=4)
    jcfg = j_moe.MoeConfig(**MOE, capacity_factor=0.5, dispatch_groups=4)
    jp = j_moe.moe_init(jax.random.PRNGKey(3), jcfg)
    p = convert._tree(jax.tree.map(np.asarray, jp), CPU)
    x = normal(22, (2, 16, 16))
    grouped, _ = moe.moe(p, t(x), cfg)
    flat, _ = moe.moe_grouped(p, t(x), cfg, groups=1)
    np.testing.assert_allclose(
        flat.numpy(),
        np.asarray(j_moe.moe(jp, jnp.asarray(x), dataclasses.replace(
            jcfg, dispatch_groups=0))[0]), **BLOCK_TOL)
    np.testing.assert_allclose(
        grouped.numpy(), np.asarray(j_moe.moe_grouped(jp, jnp.asarray(x),
                                                      jcfg)[0]), **BLOCK_TOL)
    assert not np.allclose(grouped.numpy(), flat.numpy())


def test_top_k_breaks_ties_like_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.2, 0.4, 0.0],
                      [0.0, 0.0, 0.5, 0.5]], np.float32)
    for k in (1, 2, 3):
        vals, idx = moe.top_k(t(probs), k)
        want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


# --------------------------------------------------------------------------
# configs, registry, serve steps
# --------------------------------------------------------------------------

def test_registry_holds_the_ported_archs():
    """Every arch of the reference's registry, each in its family."""
    assert configs.all_archs() == j_configs.all_archs()
    assert {a: configs.get(a).family for a in configs.all_archs()} == {
        **{a: "lm" for a in LM_ARCHS}, "idl-genesearch": "genesearch",
        "equiformer-v2": "gnn", **{a: "recsys" for a in (
            "fm", "sasrec", "two-tower-retrieval", "mind")}}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("no-such-arch")


def _fields(cfg) -> dict:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if d.get("moe") is not None:
        d["moe"] = dataclasses.asdict(d["moe"])
    return d


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_config_numbers_match_reference(arch):
    spec, jspec = configs.get(arch), j_configs.get(arch)
    for make, jmake in ((spec.make_config, jspec.make_config),
                        (spec.make_smoke_config, jspec.make_smoke_config)):
        cfg, jcfg = make(), jmake()
        assert _fields(cfg) == _fields(jcfg)
        assert cfg.head_dim == jcfg.head_dim
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert (lm_common.param_dtype(cfg) == torch.bfloat16) == (
            j_lm_common.param_dtype(jcfg) == jnp.bfloat16)
        assert dataclasses.asdict(cfg.attn_cfg()) == dataclasses.asdict(
            jcfg.attn_cfg())
    cfg, jcfg = spec.make_config(), jspec.make_config()
    expect = {
        "arctic-480b": (35, 7168, 56, 8, 32000),
        "granite-moe-1b-a400m": (24, 1024, 16, 8, 49155),
        "granite-20b": (52, 6144, 48, 1, 49152),
        "nemotron-4-340b": (96, 18432, 96, 8, 256000),
        "internlm2-20b": (48, 6144, 48, 8, 92544),
    }[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab) == expect
    assert lm_common.param_dtype(cfg) == torch.bfloat16
    assert set(spec.shapes) == set(jspec.shapes)
    for name, cell in spec.shapes.items():
        jcell = jspec.shapes[name]
        assert (cell.kind, cell.meta) == (jcell.kind, jcell.meta)
        assert (cell.skip_reason is None) == (jcell.skip_reason is None)
        assert spec.model_flops_fn(cfg, cell) == jspec.model_flops_fn(
            jcfg, jcell)
        scfg = lm_common._serve_cfg(cfg, cell)
        jscfg = j_lm_common._serve_cfg(jcfg, jcell)
        assert (scfg.attn_chunk, scfg.remat) == (jscfg.attn_chunk, jscfg.remat)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internlm2-20b"])
def test_serve_step_fns_match_reference(arch, lm_pair):
    """The registry's prefill and decode steps, port vs reference, on a
    prefill cell cut to (2, 8) and a decode cell over a 12-slot cache."""
    jcfg, jp, cfg, model = lm_pair(arch)
    spec, jspec = configs.get(arch), j_configs.get(arch)
    cell = dataclasses.replace(spec.shapes["prefill_32k"],
                               meta={"seq": 8, "batch": 2, "mode": "prefill"})
    jcell = dataclasses.replace(jspec.shapes["prefill_32k"], meta=cell.meta)
    toks = tokens(31, cfg.vocab, (2, 8))
    want, jcache = jspec.step_fn(jcfg, jcell)(jp, {"tokens": jnp.asarray(toks)})
    got, cache = spec.step_fn(cfg, cell)(model.params(), {"tokens": t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert_within_bf16_ulp(cache["k"], jcache["k"])

    dcell = spec.shapes["decode_32k"]
    full = j_tf.init_kv_cache(jcfg, 2, 12, dtype=jnp.bfloat16)
    full["k"] = full["k"].at[:, :, :8].set(jcache["k"])
    full["v"] = full["v"].at[:, :, :8].set(jcache["v"])
    full["len"] = jcache["len"]
    state = {"params": model.params(),
             "cache": convert.cache_from_jax(jax.tree.map(np.asarray, full),
                                             CPU)}
    nxt = tokens(32, cfg.vocab, (2,))
    want = jspec.step_fn(jcfg, jspec.shapes["decode_32k"])(
        {"params": jp, "cache": full}, {"tokens": jnp.asarray(nxt)})
    got = spec.step_fn(cfg, dcell)(state, {"tokens": t(nxt)})
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **LOGIT_TOL)
    assert_within_bf16_ulp(got["cache"]["v"], want["cache"]["v"])


def test_long_prefill_serves_through_chunked_attention():
    cfg = configs.get("granite-20b").make_smoke_config()
    cell = configs.get("granite-20b").shapes["prefill_32k"]
    assert lm_common._serve_cfg(cfg, cell).attn_chunk == 1024
    short = dataclasses.replace(cell, meta={**cell.meta, "seq": 8192})
    assert lm_common._serve_cfg(cfg, short) == dataclasses.replace(
        cfg, remat=False)
    full = configs.get("granite-20b").make_config()
    assert full.remat and not lm_common._serve_cfg(full, short).remat


def test_genesearch_spec_serves_like_the_reference():
    """idl-genesearch's registry step: the reference's plan.execute +
    file_match_mask over the same smoke-config index, equal bits."""
    spec, jspec = configs.get("idl-genesearch"), j_configs.get("idl-genesearch")
    cfg, jcfg = spec.make_smoke_config(), jspec.make_smoke_config()
    archive = j_genome.synth_archive(cfg.n_files, genome_len=800, seed=4)
    jeng = j_engines.BitSlicedIndex.build(jcfg.idl_config(), jcfg.scheme,
                                          jcfg.n_files)
    for f in archive:
        jeng = jeng.insert_batch(np.asarray(f.genome)[None],
                                 np.asarray([f.file_id], dtype=np.int32))
    words = np.asarray(jeng.words)
    reads = np.stack([np.asarray(archive[i].reads(cfg.read_len, 1)[0])
                      for i in range(0, cfg.n_files, 4)])
    cell, jcell = spec.shapes["serve_p99"], jspec.shapes["serve_p99"]
    want = np.asarray(jspec.step_fn(jcfg, jcell)(
        jnp.asarray(words), {"queries": jnp.asarray(reads)}))
    got = spec.step_fn(cfg, cell)(
        torch.from_numpy(words.view(np.int32)), {"queries": reads})
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    bits = np.unpackbits(want.view(np.uint8), axis=1, bitorder="little")
    assert all(bits[r, i * 4] for r, i in enumerate(range(len(reads))))
    for name in spec.shapes:
        assert spec.shapes[name].meta == jspec.shapes[name].meta
        assert spec.model_flops_fn(cfg, spec.shapes[name]) == \
            jspec.model_flops_fn(jcfg, jspec.shapes[name])
    assert dataclasses.asdict(spec.make_config()) == dataclasses.asdict(
        j_idl_genesearch.full_config())


def test_serve_launcher_resolves_arch_through_the_registry(capsys):
    with pytest.raises(SystemExit, match="'granite-20b' is 'lm'"):
        serve_launcher.main(["--arch", "granite-20b", "--device", "cpu"])
    with pytest.raises(KeyError, match="unknown arch"):
        serve_launcher.main(["--arch", "no-such-arch", "--device", "cpu"])
    serve_launcher.main(["--arch", "idl-genesearch", "--device", "cpu",
                         "--files", "32", "--batch", "4", "--requests", "1"])
    assert "recall 4/4" in capsys.readouterr().out


def test_lm_model_flops_on_a_cut_prefill_cell():
    """The MFU arithmetic chip_smoke.py uses on its 8 x 512 prefill."""
    cfg = configs.get("granite-moe-1b-a400m").make_config()
    cell = dataclasses.replace(
        configs.get("granite-moe-1b-a400m").shapes["prefill_32k"],
        meta={"seq": 512, "batch": 8, "mode": "prefill"})
    n = cfg.active_param_count()
    attn = 2 * 24 * 8 * 512 * 512 * 1024 * 0.5 * 2
    assert lm_common.lm_model_flops(cfg, cell) == 2.0 * n * 8 * 512 + attn
    assert math.isclose(lm_common.lm_model_flops(cfg, cell),
                        j_lm_common.lm_model_flops(
                            j_configs.get("granite-moe-1b-a400m").make_config(),
                            j_configs.base.ShapeCell("p", "serve", cell.meta)))
