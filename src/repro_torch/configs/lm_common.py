"""LM-family plumbing shared by the five transformer archs.

Port of :mod:`repro.configs.lm_common`: shapes, parameter dtype, the
optimizer choice, the loss-chunk and microbatch rules and the step
functions. Shapes (assignment):

  train_4k     seq 4,096  × global_batch 256   -> train step
  prefill_32k  seq 32,768 × global_batch 32    -> serve (prefill)
  decode_32k   seq 32,768 KV × global_batch 128 -> serve (one-token decode)
  long_500k    SKIPPED for all five archs: each is pure full-attention GQA
               per its public config (sub-quadratic attention required).

The reference's sharding rules and its ``input_specs`` /
``abstract_state`` belong to its mesh and dry run and have no counterpart
on one card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import base
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt_mod, train_state as ts


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
        @torch.inference_mode()
        def prefill(params, batch):
            return tf.lm_prefill(params, batch["tokens"], scfg)
        return prefill

    @torch.inference_mode()
    def decode(state, batch):
        logits, cache = tf.lm_decode_step(
            state["params"], state["cache"], batch["tokens"], scfg
        )
        return {"logits": logits, "cache": cache}
    return decode


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
        step_fn=step_fn,
        model_flops_fn=lm_model_flops,
    ))
