"""Common neural building blocks — plain functions over parameter dicts.

Port of :mod:`repro.models.layers`. Parameters are nested dicts of tensors
under the reference's keys (``wq``, ``wk``, ``wv``, ``wo``, ``wi``,
``wg``); every apply function takes ``(params, inputs, cfg)``. The compute
dtype is the input's; weights are stored f32 (or bf16 under
``param_dtype``) and cast on use. The reference's sharding constraints
stand where the reference has them, with its logical axes
(:func:`~repro_torch.distributed.sharding.shard`: the identity without
rules, a DTensor redistribution under them).

Initialisers draw from a ``torch.Generator`` on the target device, so the
same seed gives the same weights on one device type (the values differ
from the reference's ``jax.random``; :mod:`repro_torch.models.convert`
carries a reference parameter tree across instead). On the ``"meta"``
device, which has no generator, :func:`generator` gives a stand-in and
the initialisers allocate and draw nothing: the tree keeps its paths,
shapes and dtypes (the counterpart of the reference's ``jax.eval_shape``
of an init).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (gather_dims, grad_as_placed,
                                              layout, like, merge_last, shard,
                                              shard_if_divisible, split_last,
                                              ways)

Params = dict

NEG_INF = -1e30     # the reference's mask fill


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``"meta"`` device."""

    device = torch.device("meta")


def generator(seed: int, device):
    """A generator on ``device`` seeded with ``seed`` (a
    :class:`MetaGenerator` on ``"meta"``)."""
    if torch.device(device).type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device).manual_seed(int(seed))


def randn(gen, shape: tuple) -> torch.Tensor:
    """f32 standard normals of ``shape`` drawn on ``gen``'s device."""
    return torch.randn(shape, device=gen.device, dtype=torch.float32,
                       generator=None if isinstance(gen, MetaGenerator)
                       else gen)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, *, lead: tuple = ()) -> torch.Tensor:
    """(``*lead``, d_in, d_out) normal weights scaled by 1/sqrt(d_in), drawn
    in f32 on ``gen``'s device and cast to ``dtype``."""
    w = randn(gen, (*lead, d_in, d_out))
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return (randn(gen, (vocab, d)) * 0.02).to(dtype)


def unstack(stacked: Params, n: int) -> list:
    """Every slice (views) of a tree whose leaves are stacked on axis 0
    (the per-layer leaves of the reference's ``vmap``ped inits), through
    one ``unbind`` a leaf: under autograd each stacked leaf's gradient is
    then one stack of the slices' gradients, not a full-size sum a
    slice."""
    parts = _unbind_tree(stacked)
    return [_pick(parts, i) for i in range(n)]


# module-level recursions: recursive closures would be reference cycles
def _unbind_tree(tree: Params) -> Params:
    return {k: _unbind_tree(v) if isinstance(v, dict) else _unbind(v)
            for k, v in tree.items()}


def _unbind(v: torch.Tensor) -> tuple:
    # a DTensor sharded over its layer dim gathers it first (DTensor cannot
    # unbind a sharded dim), and each slice's gradient comes back in the
    # slice's layout (DTensor stacks gradients of one layout only)
    return tuple(grad_as_placed(p)
                 for p in torch.unbind(gather_dims(v, (0,)), 0))


def _pick(tree: Params, i: int) -> Params:
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------

def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":      # jax.nn.gelu's default is the tanh form
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name == "relu":
        return F.relu(x)
    if name == "relu2":     # squared ReLU (Primer / Nemotron-4)
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {name!r}")


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: broadcastable to (..., seq)."""
    d_head = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(d_head, theta)).to(x.device)
    angles = positions[..., :, None, None].float() * freqs   # (..., S, 1, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# grouped-query attention (full, causal) + KV-cache decode
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    causal: bool = True
    # sliding-window attention (beyond-paper long-context option); 0 = full
    window: int = 0


def attn_init(gen: torch.Generator, cfg: AttnConfig, dtype=torch.float32, *,
              lead: tuple = ()) -> Params:
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * cfg.d_head, dtype,
                         lead=lead),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * cfg.d_head, dtype,
                         lead=lead),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * cfg.d_head, dtype,
                         lead=lead),
        "wo": dense_init(gen, cfg.n_heads * cfg.d_head, cfg.d_model, dtype,
                         lead=lead),
    }


def _qkv(params: Params, x: torch.Tensor, cfg: AttnConfig):
    b, s, _ = x.shape
    dt = x.dtype
    # the sequence whole inside the block (Megatron's all-gather at a
    # sequence-parallel stream's edge; a no-op on a plain tensor)
    x = layout(x, ("batch", "act_seq", "embed"))
    q = split_last(x @ params["wq"].to(dt), (cfg.n_heads, cfg.d_head))
    k = split_last(x @ params["wk"].to(dt), (cfg.n_kv_heads, cfg.d_head))
    v = split_last(x @ params["wv"].to(dt), (cfg.n_kv_heads, cfg.d_head))
    q = shard(q, ("batch", "act_seq", "heads", None))
    k = shard_if_divisible(k, ("batch", "act_seq", "kv_heads", None), dim=2)
    v = shard_if_divisible(v, ("batch", "act_seq", "kv_heads", None), dim=2)
    return q, k, v


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          cfg: AttnConfig) -> torch.Tensor:
    """(len(q_pos), len(k_pos)) bool: which keys each query may attend."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if cfg.causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if cfg.window:
        mask &= q_pos[:, None] - k_pos[None, :] < cfg.window
    return mask


def _group(q, k, v, cfg: AttnConfig, logical=None):
    """``(qg (B, S, h, g, d), k, v (B, S_k, h, d))``: the query heads in
    groups over the KV heads. Where the query heads are sharded more ways
    than the KV heads divide (a DTensor over a model axis wider than the
    KV heads), each KV head is repeated over its group instead (h = H,
    g = 1): the same scores, with the heads split locally, the repeated
    keys and values laid out by ``logical`` (as the queries are)."""
    b, s = q.shape[:2]
    groups = cfg.n_heads // cfg.n_kv_heads
    if cfg.n_kv_heads % ways(q, 2) == 0:
        return q.reshape(b, s, cfg.n_kv_heads, groups, cfg.d_head), k, v

    def rep(t):
        n = t.shape[1]
        t = t[:, :, :, None].expand(b, n, cfg.n_kv_heads, groups,
                                    cfg.d_head).reshape(
            b, n, cfg.n_heads, cfg.d_head)
        return t if logical is None else layout(t, logical)
    return q[:, :, :, None], rep(k), rep(v)


def _scores_to_out(qg, k, v, mask, cfg: AttnConfig, dt) -> torch.Tensor:
    """qg (B, q, h, g, d) against k, v (B, S, h, d) under a (q, S) or
    (B, 1, 1, 1, S)-broadcastable mask -> (B, q, h, g, d)."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(cfg.d_head))
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    if v.dtype != dt:       # jnp promotes a bf16 cache against f32 probs
        v = v.to(dt)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def attend(params: Params, x: torch.Tensor, cfg: AttnConfig,
           positions: Optional[torch.Tensor] = None, chunk: int = 0):
    """Causal GQA over ``x`` that also returns the keys (post-RoPE) and
    values it attended: ``(out (B, S, d_model), k, v)``. ``chunk`` > 0
    runs the query-chunked form when it divides S (else the full one)."""
    b, s, _ = x.shape
    dt = x.dtype
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    qg, kh, vh = _group(q, k, v, cfg, ("batch", "act_seq", "heads", None))
    kk = torch.arange(s, device=x.device)
    if chunk and s % chunk == 0:
        # the flash-attention outer loop: never the (S, S) score matrix,
        # one (B, H, chunk, S) buffer at a time (the reference's lax.map)
        out = torch.cat([
            _scores_to_out(qg[:, i:i + chunk], kh, vh,
                           _mask(kk[i:i + chunk], kk, cfg), cfg, dt)
            for i in range(0, s, chunk)], dim=1)
        out = shard(merge_last(out, 3), ("batch", "act_seq", "heads"))
    else:
        out = _scores_to_out(qg, kh, vh, _mask(kk, kk, cfg), cfg, dt)
        out = shard(merge_last(out, 3), ("batch", "act_seq", "heads"))
    return like(out @ params["wo"].to(dt), x), k, v


def attention(params: Params, x: torch.Tensor, cfg: AttnConfig,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (optionally causal / sliding-window) GQA attention.

    x: (B, S, d_model) -> (B, S, d_model).
    """
    return attend(params, x, cfg, positions)[0]


def attention_chunked(params: Params, x: torch.Tensor, cfg: AttnConfig,
                      positions: Optional[torch.Tensor] = None,
                      chunk: int = 1024) -> torch.Tensor:
    """Query-chunked causal GQA (flash-attention outer loop).

    Never materializes the (S, S) score matrix — per chunk the live buffer
    is (B, H, chunk, S): the long-prefill path. Falls back to
    :func:`attention` when ``chunk`` does not divide S, as the reference
    does. Numerics identical to :func:`attention` (tested).
    """
    return attend(params, x, cfg, positions, chunk=chunk)[0]


def attention_decode(
    params: Params, x: torch.Tensor, cfg: AttnConfig,
    k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache.

    x: (B, 1, d_model); caches: (B, S_max, n_kv, d_head); cache_len: (B,)
    Returns (out (B, 1, d_model), k_cache, v_cache). The new token's key
    and value are written INTO the caches at ``cache_len`` (the reference
    returns fresh arrays; the bits are the same): a ``cache_len`` at or
    past S_max writes nothing, as the reference's one-hot blend does.
    """
    b = x.shape[0]
    s_max = k_cache.shape[1]
    dt = x.dtype
    positions = cache_len[:, None]                       # (B, 1)
    q, k_new, v_new = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    # the cache keeps ITS dtype (bf16 in production even under f32 params)
    if isinstance(k_cache, DTensor):
        # the reference's one-hot blend, local on a sequence-sharded cache
        # (a scatter into the sharded dim has no local form)
        hot = (torch.arange(s_max, device=x.device)[None, :]
               == cache_len[:, None])[..., None, None]
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            cache.copy_(torch.where(hot, new.to(cache.dtype), cache))
    else:
        slot = cache_len.long().clamp(max=s_max - 1)
        idx = slot.view(b, 1, 1, 1).expand(b, 1, cfg.n_kv_heads, cfg.d_head)
        inside = (cache_len < s_max).view(b, 1, 1, 1)
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            old = cache.gather(1, idx)
            cache.scatter_(1, idx,
                           torch.where(inside, new.to(cache.dtype), old))
    k = k_cache if k_cache.dtype == dt else k_cache.to(dt)
    qg, k, v = _group(q, k, v_cache, cfg)
    valid = (torch.arange(s_max, device=x.device)[None, :]
             <= cache_len[:, None])                      # (B, S_max)
    out = _scores_to_out(qg, k, v, valid[:, None, None, None, :], cfg,
                         dt).reshape(b, 1, -1)
    return like(out @ params["wo"].to(dt), x), k_cache, v_cache


# --------------------------------------------------------------------------
# MLP (dense FFN)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    act: str = "silu"     # "silu" => SwiGLU (gated); others => plain 2-layer
    gated: bool = True


def mlp_init(gen: torch.Generator, cfg: MlpConfig, dtype=torch.float32, *,
             lead: tuple = ()) -> Params:
    p = {
        "wi": dense_init(gen, cfg.d_model, cfg.d_ff, dtype, lead=lead),
        "wo": dense_init(gen, cfg.d_ff, cfg.d_model, dtype, lead=lead),
    }
    if cfg.gated:
        p["wg"] = dense_init(gen, cfg.d_model, cfg.d_ff, dtype, lead=lead)
    return p


def mlp(params: Params, x: torch.Tensor, cfg: MlpConfig) -> torch.Tensor:
    dt = x.dtype
    stream, x = x, layout(x, ("batch", "act_seq", "embed"))
    # the weights split over d_ff as the hidden activation is, so each
    # device computes its own columns (GSPMD partitions the products so)
    wi, wo = (layout(params["wi"], (None, "mlp")),
              layout(params["wo"], ("mlp", None)))
    h = shard(x @ wi.to(dt), ("batch", "act_seq", "mlp"))
    if cfg.gated:
        g = x @ layout(params["wg"], (None, "mlp")).to(dt)
        h = activation(cfg.act, g) * h
    else:
        h = activation(cfg.act, h)
    return like(h @ wo.to(dt), stream)
