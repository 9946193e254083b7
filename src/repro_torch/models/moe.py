"""Top-k routed Mixture-of-Experts with capacity-based dense dispatch.

Port of :mod:`repro.models.moe`. Tokens are assigned their top-k experts;
each expert takes up to C = ceil(T·k·cf / E) tokens (overflow drops,
GShard/Switch semantics); dispatch and combine are a gather and a
scatter-add by index. Load-balance aux loss per Switch Transformer.

Both of the reference's dispatch paths are one routine here: global
dispatch is group-local dispatch over one group (the reference's two
bodies compute the same values), and :func:`moe` keeps the reference's
branch rule, and each path's sharding constraints (the global path's
``(tokens, d)`` and ``(E, C, d)`` layouts, the grouped path's ``(G, ...)``
ones). The combine's scatter-add (atomic on the card) adds in an
order the device picks, so the port equals the reference within a float
tolerance, never bit for bit; routing indices and drops are exact.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import gather_dims, shard
from repro_torch.models import layers
from repro_torch.models.layers import Params


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act: str = "silu"
    gated: bool = True
    aux_loss_weight: float = 0.01
    # Arctic-style dense residual FFN running in parallel with the MoE path
    residual_d_ff: int = 0
    # group-local dispatch: tokens are dispatched within G groups, each
    # with its own capacity. 0 = global dispatch (baseline).
    dispatch_groups: int = 0


def moe_init(gen: torch.Generator, cfg: MoeConfig, dtype=torch.float32, *,
             lead: tuple = ()) -> Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        # the router stays f32
        "router": layers.dense_init(gen, d, e, torch.float32, lead=lead),
        "wi": layers.dense_init(gen, d, f, dtype, lead=(*lead, e)),
        "wo": layers.dense_init(gen, f, d, dtype, lead=(*lead, e)),
    }
    if cfg.gated:
        p["wg"] = layers.dense_init(gen, d, f, dtype, lead=(*lead, e))
    if cfg.residual_d_ff:
        p["residual"] = layers.mlp_init(
            gen, layers.MlpConfig(d, cfg.residual_d_ff, cfg.act, cfg.gated),
            dtype, lead=lead)
    return p


def _capacity(n_tokens: int, cfg: MoeConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, ties
    broken by the lower index (a stable descending sort;
    ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: Params, x: torch.Tensor, cfg: MoeConfig, groups: int = 1):
    """The router and the capacity assignment of ``x`` (B, S, d) in
    ``groups`` token groups: ``(probs (G, tg, E) f32, gate_vals (G, tg, k),
    gate_idx (G, tg, k), pos (G, tg·k), keep (G, tg·k) bool, cap)``."""
    b, s, d = x.shape
    t = b * s
    tg = t // groups
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(tg, cfg)
    xg = _tokens(x, groups)
    logits = xg.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                   # (G, tg, E)
    gate_vals, gate_idx = top_k(probs, k)                   # (G, tg, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    # position of each (token, choice) within its expert queue, per group
    flat_oh = F.one_hot(gate_idx, e).reshape(groups, tg * k, e)
    pos_in_expert = torch.cumsum(flat_oh, dim=1) - flat_oh
    pos = torch.sum(pos_in_expert * flat_oh, dim=-1)        # (G, tg·k)
    keep = pos < cap
    return probs, gate_vals, gate_idx, pos, keep, cap


def _tokens(x: torch.Tensor, groups: int) -> torch.Tensor:
    """``x`` (B, S, d) as ``groups`` token groups (G, T / G, d), laid out
    as the reference lays out its dispatch input: the global path's (T, d)
    and the grouped path's (G, T / G, d) over the token axes. A DTensor
    first gathers its sequence dim, so that merging it into the token dim
    is a local reshape."""
    b, s, d = x.shape
    x = gather_dims(x, (1,))
    if groups == 1:
        return shard(x.reshape(b * s, d), ("tokens", None))[None]
    return shard(x.reshape(groups, b * s // groups, d), ("tokens", None, None))


def _experts(xe: torch.Tensor, glob: bool) -> torch.Tensor:
    """The (G, E, C, d) expert slots in the reference's layout: (E, C, d)
    over experts and capacity on the global path, (G, E, C, d) over token
    groups and experts on the grouped one."""
    if glob:
        return shard(xe[0], ("experts", "expert_cap", None))[None]
    return shard(xe, ("tokens", "experts", None, None))


def moe(params: Params, x: torch.Tensor,
        cfg: MoeConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    groups = cfg.dispatch_groups
    if groups > 1 and (x.shape[0] * x.shape[1]) % groups == 0:
        return moe_grouped(params, x, cfg)
    return moe_grouped(params, x, cfg, groups=1)


def moe_grouped(params: Params, x: torch.Tensor, cfg: MoeConfig,
                groups: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-local dispatch: routing, capacity positions, gather and
    combine all happen WITHIN ``groups`` token groups (default
    ``cfg.dispatch_groups``), each with capacity ``_capacity(T / G)``;
    ``groups=1`` is the reference's global dispatch (:func:`moe`)."""
    b, s, d = x.shape
    dt = x.dtype
    t = b * s
    G = groups or cfg.dispatch_groups
    tg = t // G
    e, k = cfg.n_experts, cfg.top_k
    xs = gather_dims(x, (1,))       # the reshape into groups, once
    probs, gate_vals, gate_idx, pos, keep, cap = route(params, xs, cfg, G)
    expert = gate_idx.reshape(G, tg * k)
    token_ids = torch.arange(tg, device=x.device).repeat_interleave(k)
    token_ids = token_ids[None].expand(G, tg * k)

    # the (E, C) dispatch table of each group; a dropped choice writes to
    # one spare slot past the table (the reference's out-of-bounds drop)
    slot = torch.where(keep, expert * cap + pos, e * cap)
    dispatch = torch.scatter(
        torch.full((G, e * cap + 1), tg, dtype=torch.long, device=x.device),
        1, slot, token_ids)[:, :e * cap]

    # gather tokens (an empty slot, id tg, reads a zero row); run the
    # expert FFNs over E
    glob = G == 1
    xg = _tokens(xs, G)
    xg = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    xe = torch.gather(xg, 1, dispatch[..., None].expand(G, e * cap, d))
    xe = _experts(xe.reshape(G, e, cap, d), glob)
    h = torch.einsum("gecd,edf->gecf", xe, params["wi"].to(dt))
    if cfg.gated:
        gg = torch.einsum("gecd,edf->gecf", xe, params["wg"].to(dt))
        h = layers.activation(cfg.act, gg) * h
    else:
        h = layers.activation(cfg.act, h)
    ye = _experts(torch.einsum("gecf,efd->gecd", h, params["wo"].to(dt)),
                  glob)

    # token-major combine: each token's k expert outputs, weighted, then a
    # group-local scatter-add (dropped choices go to a spare row)
    gate_flat = torch.where(keep, gate_vals.reshape(G, tg * k), 0.0)
    src_token = torch.where(keep, token_ids, tg)
    picked = torch.gather(
        ye.reshape(G, e * cap, d), 1,
        torch.where(keep, expert * cap + pos, 0)[..., None].expand(
            G, tg * k, d))
    out = torch.scatter_add(
        torch.zeros((G, tg + 1, d), dtype=dt, device=x.device), 1,
        src_token[..., None].expand(G, tg * k, d),
        picked * gate_flat[..., None].to(dt))[:, :tg]
    out = (shard(out[0], ("tokens", None)) if glob
           else shard(out, ("tokens", None, None)))

    # Switch aux loss: E * sum(frac_tokens_e * mean_prob_e)
    frac = torch.mean(F.one_hot(gate_idx[..., 0], e).float(), dim=(0, 1))
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux = cfg.aux_loss_weight * e * torch.sum(frac * mean_prob)
    return _finish(params, x, out.reshape(t, d), aux, cfg)


def _finish(params, x, out, aux, cfg):
    b, s, d = x.shape
    out = out.reshape(b, s, d)
    if cfg.residual_d_ff:
        out = out + layers.mlp(
            params["residual"], x,
            layers.MlpConfig(cfg.d_model, cfg.residual_d_ff, cfg.act,
                             cfg.gated),
        )
    return out, aux
