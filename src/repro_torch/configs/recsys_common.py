"""RecSys-family plumbing: the shared shapes and the step functions.

Port of :mod:`repro.configs.recsys_common`. Shapes (assignment):

  train_batch     batch=65,536     -> train step
  serve_p99       batch=512        -> forward scoring (online)
  serve_bulk      batch=262,144    -> forward scoring (offline)
  retrieval_cand  batch=1 x 1M candidates -> batched-dot retrieval scoring

The reference's sharding rules and its ``input_specs`` /
``abstract_state`` belong to its mesh and dry run and have no counterpart
on one card yet (ROADMAP item 14e).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs import base
from repro_torch.train import optimizer as opt_mod, train_state as ts


def recsys_shapes() -> dict[str, base.ShapeCell]:
    return {
        "train_batch": base.ShapeCell(
            "train_batch", "train", {"batch": 65536}),
        "serve_p99": base.ShapeCell(
            "serve_p99", "serve", {"batch": 512, "mode": "score"}),
        "serve_bulk": base.ShapeCell(
            "serve_bulk", "serve", {"batch": 262144, "mode": "score"}),
        "retrieval_cand": base.ShapeCell(
            "retrieval_cand", "serve",
            {"batch": 1, "candidates": 1_000_000, "mode": "retrieval"}),
    }


def make_recsys_spec(
    name: str, full_cfg, smoke_cfg, *,
    loss_fn: Callable, score_fn: Callable, retrieval_fn: Callable,
    model_flops_fn=None,
) -> base.ArchSpec:
    """Register an arch from its per-arch functions, each taking
    ``(params, batch, cfg)``: ``loss_fn`` -> (loss, metrics), ``score_fn``
    -> scores, ``retrieval_fn`` -> candidate scores.

    A ``train`` cell's step is ``train_step(state, batch) -> (state,
    metrics)`` over ``loss_fn`` with AdamW at 1e-3 (the state updated in
    place); a ``score`` or ``retrieval`` cell's is ``fn(params, batch)``
    under ``torch.inference_mode``."""

    def step_fn(cfg, cell):
        if cell.kind == "train":
            return ts.make_train_step(
                lambda p, b: loss_fn(p, b, cfg), opt_mod.adamw(1e-3))
        fn = score_fn if cell.meta["mode"] == "score" else retrieval_fn

        @torch.inference_mode()
        def serve(params, batch):
            return fn(params, batch, cfg)
        return serve

    return base.register(base.ArchSpec(
        name=name, family="recsys",
        make_config=full_cfg, make_smoke_config=smoke_cfg,
        shapes=recsys_shapes(),
        step_fn=step_fn,
        model_flops_fn=model_flops_fn,
    ))
