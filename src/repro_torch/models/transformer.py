"""Decoder-only transformer LM: dense or MoE, GQA, RoPE — serve and train.

Port of :mod:`repro.models.transformer` for the five LM archs (arctic-480b,
granite-moe-1b, granite-20b, nemotron-4-340b, internlm2-20b): the config,
init, forward, the training loss (:func:`lm_loss`, chunked cross-entropy
with z-loss and the MoE aux loss), prefill (filling a KV cache) and
one-token decode.

Parameters keep the reference's pytree: a nested dict whose per-layer
leaves are stacked along a leading ``(n_layers, ...)`` axis, so carrying
the reference's weights across is a copy
(:func:`repro_torch.models.convert.params_from_jax`). A Python loop over
the layers takes the place of the reference's ``lax.scan``. Under
autograd, ``cfg.remat`` checkpoints each layer
(:func:`repro_torch.models.remat.checkpoint`, the reference's
``jax.checkpoint`` of the scan body): a layer's activations are
recomputed in backward, so only each layer's input is kept. The loss's
sequence chunks are checkpointed likewise, so one chunk's logits are
live at a time. Serving runs without autograd and never checkpoints.
The reference's sharding constraints stand at its call sites, with its
logical axes (:func:`~repro_torch.distributed.sharding.shard`: the
identity without rules; under rules, on DTensor state, a
redistribution).
:class:`TransformerLM` holds such a tree as an ``nn.Module`` (its
``state_dict`` keys are the reference's paths); the functions take the
plain dict (``model.params()``), as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (contract_as, lookup,
                                              reduce_partial, shard)
from repro_torch.models import layers, moe as moe_mod, remat
from repro_torch.models.layers import Params


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    act: str = "silu"
    gated_mlp: bool = True
    moe: Optional[moe_mod.MoeConfig] = None
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # recompute each layer in backward (training only)
    remat: bool = True
    # sliding-window attention (beyond-paper option for long context); 0=full
    attn_window: int = 0
    # query-chunked (flash-style) attention; 0 = full scores. Enabled for
    # the 32k prefill shapes where full scores exceed device memory.
    attn_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def attn_cfg(self, window: Optional[int] = None) -> layers.AttnConfig:
        return layers.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.head_dim,
            rope_theta=self.rope_theta,
            window=self.attn_window if window is None else window,
        )

    def mlp_cfg(self) -> layers.MlpConfig:
        return layers.MlpConfig(self.d_model, self.d_ff, self.act,
                                self.gated_mlp)

    def param_count(self) -> int:
        """Total parameters (N for MODEL_FLOPS = 6·N·D)."""
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.moe is not None:
            f = self.moe.d_ff
            per_e = d * f * (3 if self.moe.gated else 2)
            ffn = self.moe.n_experts * per_e + d * self.moe.n_experts
            if self.moe.residual_d_ff:
                ffn += d * self.moe.residual_d_ff * (3 if self.gated_mlp else 2)
        else:
            ffn = d * self.d_ff * (3 if self.gated_mlp else 2)
        per_layer = attn + ffn + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Activated parameters per token (N_active for MoE)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        f = self.moe.d_ff
        per_e = d * f * (3 if self.moe.gated else 2)
        dense_like = dataclasses.replace(self, moe=None, d_ff=0,
                                         gated_mlp=False)
        base = dense_like.param_count()
        act_ffn = self.moe.top_k * per_e + d * self.moe.n_experts
        if self.moe.residual_d_ff:
            act_ffn += d * self.moe.residual_d_ff * (3 if self.gated_mlp else 2)
        return base + self.n_layers * act_ffn


# --------------------------------------------------------------------------
# the module
# --------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors registered as (frozen) parameters under its
    own keys; :meth:`params` gives the dict back."""

    def __init__(self, tree: Params):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def params(self) -> Params:
        out: Params = dict(self._parameters)
        for key, sub in self._modules.items():
            out[key] = sub.params()
        return out


class TransformerLM(ParamTree):
    """The LM's parameters (``embed``, ``layers``, ``ln_f`` and, untied,
    ``unembed``) with its config, and the serving entry points as
    methods."""

    def __init__(self, cfg: LMConfig, params: Params):
        super().__init__(params)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    @property
    def dtype(self) -> torch.dtype:
        return self.ln_f.dtype

    def forward(self, tokens: torch.Tensor):
        return lm_forward(self.params(), tokens, self.cfg)

    def prefill(self, tokens: torch.Tensor):
        return lm_prefill(self.params(), tokens, self.cfg)

    def decode_step(self, cache: Params, tokens: torch.Tensor):
        return lm_decode_step(self.params(), cache, tokens, self.cfg)

    def init_kv_cache(self, batch: int, max_len: int,
                      dtype=torch.bfloat16) -> Params:
        return init_kv_cache(self.cfg, batch, max_len, dtype=dtype,
                             device=self.device)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _layers_init(gen: torch.Generator, cfg: LMConfig, dtype) -> Params:
    """Every layer's parameters, stacked along a leading n_layers axis."""
    n, d = cfg.n_layers, cfg.d_model
    p: Params = {
        "ln1": torch.ones((n, d), dtype=dtype, device=gen.device),
        "ln2": torch.ones((n, d), dtype=dtype, device=gen.device),
        "attn": layers.attn_init(gen, cfg.attn_cfg(), dtype, lead=(n,)),
    }
    if cfg.moe is not None:
        p["moe"] = moe_mod.moe_init(gen, cfg.moe, dtype, lead=(n,))
    else:
        p["mlp"] = layers.mlp_init(gen, cfg.mlp_cfg(), dtype, lead=(n,))
    return p


def lm_init(seed: int, cfg: LMConfig, dtype=torch.float32,
            device="cuda") -> TransformerLM:
    """Random weights drawn on ``device`` from a generator seeded with
    ``seed`` (on ``"meta"``: shapes and dtypes only, nothing drawn)."""
    gen = layers.generator(seed, device)
    p: Params = {
        "embed": layers.embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "layers": _layers_init(gen, cfg, dtype),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = layers.dense_init(gen, cfg.d_model, cfg.vocab, dtype)
    return TransformerLM(cfg, p)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s slice (views) of the stacked layer tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# logical specs of layer weights once gathered over the FSDP axis: only
# the TP axis remains (the reference's per-layer weight all-gather)
_GATHERED_SPECS = {
    "wq": (None, "heads"), "wk": (None, "heads"), "wv": (None, "heads"),
    "wo": ("heads", None),
    "wi": (None, "mlp"), "wg": (None, "mlp"),
}


def _gather_fsdp(lp: Params) -> Params:
    """Layer weights laid out dp-gathered (TP only)."""
    out = {}
    for k, v in lp.items():
        if isinstance(v, dict):
            if k == "moe":
                out[k] = _gather_moe(v)
            else:
                out[k] = {
                    kk: shard(vv, _GATHERED_SPECS[kk])
                    if kk in _GATHERED_SPECS and vv.ndim == 2 else vv
                    for kk, vv in v.items()
                }
        else:
            out[k] = v
    return out


def _gather_moe(mp: Params) -> Params:
    out = {}
    for k, v in mp.items():
        if k in ("wi", "wg", "wo") and not isinstance(v, dict):
            out[k] = shard(v, ("experts", None, None))  # EP stays; dp gathered
        elif k == "residual" and isinstance(v, dict):
            out[k] = {
                kk: shard(vv, _GATHERED_SPECS[kk])
                if kk in _GATHERED_SPECS and vv.ndim == 2 else vv
                for kk, vv in v.items()
            }
        else:
            out[k] = v
    return out


def _block(cfg: LMConfig, lp: Params, x: torch.Tensor,
           positions: torch.Tensor):
    """One layer over the whole sequence: ``(x, aux, k, v)`` with the
    layer's post-RoPE keys and its values (the prefill's cache)."""
    lp = _gather_fsdp(lp)
    h = layers.rmsnorm(x, lp["ln1"])
    a, k, v = layers.attend(lp["attn"], h, cfg.attn_cfg(), positions,
                            chunk=cfg.attn_chunk)
    # the residual sum back in the seq-sharded stream
    x = shard(x + a, ("batch", "seq", "embed"))
    h = layers.rmsnorm(x, lp["ln2"])
    if cfg.moe is not None:
        y, aux = moe_mod.moe(lp["moe"], h, cfg.moe)
    else:
        y, aux = layers.mlp(lp["mlp"], h, cfg.mlp_cfg()), 0.0
    return shard(x + y, ("batch", "seq", "embed")), aux, k, v


def _embed(params: Params, tokens: torch.Tensor,
           embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tokens' rows of ``embed`` (default the parameter), in the
    parameters' dtype; a DTensor table answers from each device's rows
    (:func:`sharding.lookup`)."""
    embed = params["embed"] if embed is None else embed
    got = lookup(embed, tokens)
    return (embed[tokens] if got is None else got).to(params["ln_f"].dtype)


def lm_hidden(params: Params, tokens: torch.Tensor,
              cfg: LMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (final hidden (B, S, d), moe aux loss).

    Under autograd with ``cfg.remat`` each layer runs checkpointed."""
    # the embedding gathered over dp once (vocab stays TP-sharded)
    embed = shard(params["embed"], ("vocab", None))
    x = shard(_embed(params, tokens, embed), ("batch", "seq", "embed"))
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    recompute = cfg.remat and torch.is_grad_enabled()
    for lp in layers.unstack(params["layers"], cfg.n_layers):
        if recompute:
            x, a, _, _ = remat.checkpoint(_block, cfg, lp, x, positions)
        else:
            x, a, _, _ = _block(cfg, lp, x, positions)
        aux = aux + a
    return layers.rmsnorm(x, params["ln_f"]), aux


def _unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    w = params["unembed"] if "unembed" in params else params["embed"].T
    # contracted over d as the weight splits d (the reference's unembed
    # stays split on d)
    return contract_as(x, w) @ w.to(dt)


def lm_forward(params: Params, tokens: torch.Tensor,
               cfg: LMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S, V) f32, aux loss)."""
    x, aux = lm_hidden(params, tokens, cfg)
    return shard(_unembed(params, x).float(), ("batch", "seq", "vocab")), aux


def _ce_chunk(params: Params, xc: torch.Tensor, lc: torch.Tensor):
    """One sequence chunk's (-sum log-likelihood, sum logz^2, label count)
    over its unmasked labels (``< 0`` masked, after clipping to 0)."""
    logits = shard(_unembed(params, xc).float(), ("batch", "seq", "vocab"))
    logz = torch.logsumexp(logits, dim=-1)
    ll = reduce_partial(torch.gather(
        logits, -1, lc.clamp(min=0).long()[..., None]))[..., 0]
    ll = ll - logz
    mask = (lc >= 0).float()
    return -(ll * mask).sum(), ((logz * mask) ** 2).sum(), mask.sum()


def lm_loss(params: Params, batch: dict, cfg: LMConfig,
            loss_chunks: int = 8) -> tuple[torch.Tensor, dict]:
    """Next-token CE + z-loss + MoE aux, with CHUNKED cross-entropy.

    ``batch`` holds ``tokens`` and ``labels`` (B, S). The unembed + CE runs
    over ``loss_chunks`` sequence chunks (one chunk when it does not divide
    S); under autograd each chunk is checkpointed, so its (B, S/n, V)
    logits are recomputed in backward and only one chunk's are ever live.
    Returns (loss, {"ce", "zloss", "moe_aux"})."""
    x, aux = lm_hidden(params, batch["tokens"], cfg)   # (B, S, d)
    labels = batch["labels"]
    s = x.shape[1]
    n = loss_chunks if s % loss_chunks == 0 else 1
    w = s // n
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ce_sum, z_sum, cnt = zero, zero, zero
    for i in range(n):
        xc, lc = x[:, i * w:(i + 1) * w], labels[:, i * w:(i + 1) * w]
        if torch.is_grad_enabled():
            c, z, m = remat.checkpoint(_ce_chunk, params, xc, lc)
        else:
            c, z, m = _ce_chunk(params, xc, lc)
        ce_sum, z_sum, cnt = ce_sum + c, z_sum + z, cnt + m
    denom = torch.clamp(cnt, min=1.0)
    ce = ce_sum / denom
    zloss = 1e-4 * z_sum / denom
    loss = ce + zloss + aux
    return loss, {"ce": ce, "zloss": zloss, "moe_aux": aux}


# --------------------------------------------------------------------------
# prefill (serve): fill the KV cache for a prompt, return last-token logits
# --------------------------------------------------------------------------

def lm_prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig):
    """tokens (B, S) -> (last-position logits (B, V) f32, kv cache dict).

    The cache stores POST-RoPE keys (``attention_decode`` rotates only the
    incoming token and scores against the cache as-is), in bf16 whatever
    the parameters' dtype, as the reference's does."""
    x = shard(_embed(params, tokens), ("batch", "seq", "embed"))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    if isinstance(x, DTensor):
        # a DTensor layer's keys keep their layout: stacked at the end
        ks, vs = [], []
    else:
        ks = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
        vs = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    for i in range(cfg.n_layers):
        x, _, k, v = _block(cfg, layer_params(params["layers"], i), x,
                            positions)
        if isinstance(ks, list):
            ks.append(k.to(torch.bfloat16))
            vs.append(v.to(torch.bfloat16))
        else:
            ks[i], vs[i] = k, v
    if isinstance(ks, list):
        ks, vs = torch.stack(ks), torch.stack(vs)
    x = layers.rmsnorm(x, params["ln_f"])
    logits = _unembed(params, x[:, -1, :]).float()
    cache = {"k": ks, "v": vs,
             "len": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return logits, cache


# --------------------------------------------------------------------------
# decode (serve_step): one token against a per-layer KV cache
# --------------------------------------------------------------------------

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  dtype=torch.float32, device="cuda") -> Params:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def lm_decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                   cfg: LMConfig) -> tuple[torch.Tensor, Params]:
    """tokens (B,) int -> (logits (B, V) f32, updated cache).

    The new token's keys and values are written into ``cache``'s tensors
    in place; the returned cache holds them and ``len + 1``."""
    x = shard(_embed(params, tokens)[:, None, :],          # (B, 1, d)
              ("batch", None, "embed"))
    for i in range(cfg.n_layers):
        lp = _gather_fsdp(layer_params(params["layers"], i))
        h = layers.rmsnorm(x, lp["ln1"])
        a, _, _ = layers.attention_decode(
            lp["attn"], h, cfg.attn_cfg(), cache["k"][i], cache["v"][i],
            cache["len"])
        x = x + a
        h = layers.rmsnorm(x, lp["ln2"])
        if cfg.moe is not None:
            y, _ = moe_mod.moe(lp["moe"], h, cfg.moe)
        else:
            y = layers.mlp(lp["mlp"], h, cfg.mlp_cfg())
        x = x + y
    x = layers.rmsnorm(x, params["ln_f"])
    logits = _unembed(params, x[:, 0, :])
    new_cache = {"k": cache["k"], "v": cache["v"], "len": cache["len"] + 1}
    return logits.float(), new_cache
