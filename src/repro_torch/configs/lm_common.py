"""LM-family plumbing shared by the five transformer archs.

Port of :mod:`repro.configs.lm_common`: shapes, parameter dtype, the
optimizer choice, the loss-chunk and microbatch rules and the step
functions. Shapes (assignment):

  train_4k     seq 4,096  × global_batch 256   -> train step
  prefill_32k  seq 32,768 × global_batch 32    -> serve (prefill)
  decode_32k   seq 32,768 KV × global_batch 128 -> serve (one-token decode)
  long_500k    SKIPPED for all five archs: each is pure full-attention GQA
               per its public config (sub-quadratic attention required).

Sharding (the reference's rules): TP over 'model' (heads/mlp/experts/
vocab), FSDP over ('pod','data') (params' d_model dim), batch over
('pod','data'); KV caches shard batch over DP and seq over 'model'.
``input_specs`` / ``abstract_state`` give meta tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from typing import Any

from repro_torch.configs import base
from repro_torch.distributed import sharding
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt_mod, train_state as ts

DP = base.DP_AXES


def lm_shapes() -> dict[str, base.ShapeCell]:
    return {
        "train_4k": base.ShapeCell(
            "train_4k", "train", {"seq": 4096, "batch": 256}),
        "prefill_32k": base.ShapeCell(
            "prefill_32k", "serve", {"seq": 32768, "batch": 32, "mode": "prefill"}),
        "decode_32k": base.ShapeCell(
            "decode_32k", "serve", {"seq": 32768, "batch": 128, "mode": "decode"}),
        "long_500k": base.ShapeCell(
            "long_500k", "serve", {"seq": 524288, "batch": 1, "mode": "decode"},
            skip_reason=(
                "pure full-attention GQA arch (public config); long_500k "
                "requires sub-quadratic attention — skip sanctioned by the "
                "assignment"
            )),
    }


def param_dtype(cfg: tf.LMConfig) -> torch.dtype:
    # full-size archs serve in bf16 (production mixed precision); smoke
    # configs (<0.5e9 parameters) stay f32 for CPU tests
    return torch.bfloat16 if cfg.param_count() > 0.5e9 else torch.float32


def choose_optimizer(cfg: tf.LMConfig) -> opt_mod.Optimizer:
    if cfg.param_count() > 30e9:
        return opt_mod.adafactor(lr=1e-2)
    return opt_mod.adamw(lr=3e-4)


def _serve_cfg(cfg: tf.LMConfig, cell: base.ShapeCell) -> tf.LMConfig:
    # long prefill: full (S, S) scores would not fit; use the chunked path
    if cell.meta.get("mode") == "prefill" and cell.meta["seq"] > 8192:
        return dataclasses.replace(cfg, attn_chunk=1024, remat=False)
    return dataclasses.replace(cfg, remat=False)



# --------------------------------------------------------------------------
# input specs / abstract state (meta tensors)
# --------------------------------------------------------------------------

def input_specs(cfg: tf.LMConfig, cell: base.ShapeCell) -> dict:
    b, s = cell.meta["batch"], cell.meta["seq"]
    i32 = torch.int32
    if cell.kind == "train":
        return {"tokens": base.abstract((b, s), i32),
                "labels": base.abstract((b, s), i32)}
    if cell.meta["mode"] == "prefill":
        return {"tokens": base.abstract((b, s), i32)}
    return {"tokens": base.abstract((b,), i32)}


def abstract_params(cfg: tf.LMConfig) -> dict:
    return tf.lm_init(0, cfg, dtype=param_dtype(cfg), device="meta").params()


def abstract_state(cfg: tf.LMConfig, cell: base.ShapeCell):
    params = abstract_params(cfg)
    if cell.kind == "train":
        return ts.TrainState.create(params, choose_optimizer(cfg))
    if cell.meta["mode"] == "prefill":
        return params
    b, s = cell.meta["batch"], cell.meta["seq"]
    # KV caches are bf16 regardless of param dtype (production practice)
    cache = tf.init_kv_cache(cfg, b, s, dtype=torch.bfloat16, device="meta")
    return {"params": params, "cache": cache}

def loss_chunks_for(cell: base.ShapeCell) -> int:
    """CE chunk count: ~16k tokens per chunk so the logits buffer stays
    tens of MB even at vocab 256k (power-of-two, divides seq)."""
    b, s = cell.meta["batch"], cell.meta["seq"]
    target = max(1, (b * s) // 16384)
    n = 1
    while n * 2 <= min(target, s):
        n *= 2
    return max(n, 8) if s % max(n, 8) == 0 else n


def microbatch_for(cfg: tf.LMConfig, cell: base.ShapeCell) -> int:
    """Gradient-accumulation microbatches: 0 (none), as the reference
    chose for every LM cell; the knob stays on ``make_train_step``."""
    return 0


def step_fn(cfg: tf.LMConfig, cell: base.ShapeCell):
    """The step of ``cell``. A ``train`` cell: ``train_step(state, {"tokens",
    "labels"})`` -> (state, metrics) over a :class:`TrainState` (updated
    in place) with the optimizer of :func:`choose_optimizer`. A serve cell:
    ``prefill(params, {"tokens": (B, S)})`` -> (last logits, cache), or
    ``decode({"params", "cache"}, {"tokens": (B,)})`` -> ``{"logits",
    "cache"}``. ``params`` is the parameter dict
    (``TransformerLM.params()``)."""
    if cell.kind == "train":
        opt = choose_optimizer(cfg)
        nchunks = loss_chunks_for(cell)

        def loss(p, b):
            return tf.lm_loss(p, b, cfg, loss_chunks=nchunks)
        return ts.make_train_step(loss, opt,
                                  microbatch=microbatch_for(cfg, cell))
    scfg = _serve_cfg(cfg, cell)
    if cell.meta["mode"] == "prefill":
        @sharding.inference
        def prefill(params, batch):
            return tf.lm_prefill(params, batch["tokens"], scfg)
        return prefill

    @sharding.inference
    def decode(state, batch):
        logits, cache = tf.lm_decode_step(
            state["params"], state["cache"], batch["tokens"], scfg
        )
        return {"logits": logits, "cache": cache}
    return decode



# --------------------------------------------------------------------------
# sharding rules
# --------------------------------------------------------------------------

_PARAM_RULES: list[tuple[str, Any]] = [
    # (terminal name, spec for the trailing dims; leading dims -> None)
    ("embed", (DP, "model")),
    ("unembed", (DP, "model")),
    ("wq", (DP, "model")),
    ("wk", (DP, "model")),
    ("wv", (DP, "model")),
    ("wi", (DP, "model")),
    ("wg", (DP, "model")),
    ("wo", ("model", DP)),
    ("router", (DP, None)),
    ("pos", (None, None)),
]
_MOE_RULES: list[tuple[str, Any]] = [
    # stacked expert weights (L, E, a, b): experts over 'model' (EP)
    ("wi", ("model", DP, None)),
    ("wg", ("model", DP, None)),
    ("wo", ("model", None, DP)),
]
# state wrappers stripped so the parameter's path remains
_WRAPPERS = ("params", "opt_state", "per_param", "mu", "nu", "cache", "state")


def param_spec(path: str, shape: tuple) -> tuple:
    """Partition spec for one LM param leaf, by terminal name."""
    parts = path.split("/")
    name = parts[-1]
    if len(shape) <= 1:
        return ()
    rules = _PARAM_RULES
    if "moe" in parts and "residual" not in parts and len(shape) == 4:
        rules = _MOE_RULES
    for key, trailing in rules:
        if name == key:
            lead = len(shape) - len(trailing)
            if lead < 0:
                trailing = trailing[-len(shape):]
                lead = 0
            return (None,) * lead + tuple(trailing)
    return ()  # ln scales etc: replicate


def state_spec(cfg: tf.LMConfig, path: str, shape: tuple) -> tuple:
    """Spec for TrainState / serve-state leaves (optimizer state mirrors its
    param's spec; Adafactor's factored stats drop the corresponding axis)."""
    parts = [p for p in path.split("/") if p]
    if parts and parts[-1] in ("step", "len", "bias"):
        return ()
    if parts and parts[-1] in ("k", "v") and len(shape) == 5:
        return (None, DP, "model", None, None)   # KV cache (L, B, S, kv, dh)
    suffix = None
    if parts and parts[-1] in ("vr", "vc", "m"):
        suffix = parts[-1]
        parts = parts[:-1]
    ppath = "/".join(p for p in parts if p not in _WRAPPERS + ("v",))
    if suffix is None:
        return param_spec(ppath, shape)
    pspec = param_spec(ppath, shape + (1,))  # parent has one more dim
    pspec = pspec + (None,) * (len(shape) + 1 - len(pspec))
    if suffix == "m":
        return pspec[:-1] if len(pspec) == len(shape) + 1 else pspec
    if suffix == "vr":   # parent shape[:-1]
        return pspec[:-1]
    # vc: parent shape[:-2] + shape[-1:]
    return pspec[:-2] + pspec[-1:]


def fix_m_spec(cfg, path: str, shape: tuple) -> tuple:
    """Momentum has the SAME shape as the param — specialize here."""
    parts = [p for p in path.split("/") if p and p not in _WRAPPERS]
    if parts and parts[-1] == "m":
        parts = parts[:-1]
    return param_spec("/".join(parts), shape)


def lm_state_spec(cfg: tf.LMConfig, path: str, shape: tuple) -> tuple:
    parts = [p for p in path.split("/") if p]
    if parts and parts[-1] in ("m", "mu", "nu") or (
        len(parts) >= 2 and parts[-2] in ("mu", "nu")
    ):
        return fix_m_spec(cfg, path, shape)
    return state_spec(cfg, path, shape)


def lm_batch_spec(cfg: tf.LMConfig, path: str, shape: tuple) -> tuple:
    if len(shape) == 2:
        return (DP, None)
    if len(shape) == 1:
        return (DP,)
    return ()

def lm_model_flops(cfg: tf.LMConfig, cell: base.ShapeCell) -> float:
    n = cfg.active_param_count()
    b, s = cell.meta["batch"], cell.meta["seq"]
    hd = cfg.head_dim * cfg.n_heads
    if cell.kind == "train":
        attn = 6 * cfg.n_layers * b * s * s * hd * 0.5 * 2
        return 6.0 * n * b * s + attn
    if cell.meta["mode"] == "prefill":
        attn = 2 * cfg.n_layers * b * s * s * hd * 0.5 * 2
        return 2.0 * n * b * s + attn
    attn = 4 * cfg.n_layers * b * s * hd
    return 2.0 * n * b + attn


def make_lm_spec(name: str, full_cfg, smoke_cfg) -> base.ArchSpec:
    return base.register(base.ArchSpec(
        name=name,
        family="lm",
        make_config=full_cfg,
        make_smoke_config=smoke_cfg,
        shapes=lm_shapes(),
        input_specs=input_specs,
        abstract_state=abstract_state,
        step_fn=step_fn,
        state_spec_fn=lm_state_spec,
        batch_spec_fn=lm_batch_spec,
        model_flops_fn=lm_model_flops,
    ))
