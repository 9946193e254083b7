"""RecSys-family plumbing: the shared shapes and the step functions.

Port of :mod:`repro.configs.recsys_common`. Shapes (assignment):

  train_batch     batch=65,536     -> train step
  serve_p99       batch=512        -> forward scoring (online)
  serve_bulk      batch=262,144    -> forward scoring (offline)
  retrieval_cand  batch=1 x 1M candidates -> batched-dot retrieval scoring

Embedding tables are row-sharded over 'model'; batches over
('pod','data'); tower/MLP weights FSDP over ('pod','data') (the
reference's rules). ``input_specs`` / ``abstract_state`` give meta
tensors.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs import base
from repro_torch.distributed import sharding
from repro_torch.train import optimizer as opt_mod, train_state as ts

DP = base.DP_AXES


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



def state_spec(cfg, path: str, shape: tuple) -> tuple:
    parts = [p for p in path.split("/") if p]
    if parts and parts[-1] == "step" or len(shape) == 0:
        return ()
    name = parts[-1]
    if name == "m" and len(parts) >= 2:
        name = parts[-2]
    if ("table" in name or name == "linear" or name == "pos") and len(shape) >= 2:
        return ("model",) + (None,) * (len(shape) - 1)   # row-sharded tables
    if len(shape) >= 2:
        return (None,) * (len(shape) - 2) + (DP, "model")
    return ()


def batch_spec(cfg, path: str, shape: tuple) -> tuple:
    if len(shape) == 0:
        return ()
    return (DP,) + (None,) * (len(shape) - 1)

def make_recsys_spec(
    name: str, full_cfg, smoke_cfg, *,
    init_fn: Callable, loss_fn: Callable,
    score_fn: Callable, retrieval_fn: Callable,
    train_inputs: Callable, score_inputs: Callable, retrieval_inputs: Callable,
    model_flops_fn=None,
) -> base.ArchSpec:
    """Register an arch from its per-arch functions: ``init_fn(seed, cfg,
    dtype, device)``; ``loss_fn``, ``score_fn`` and ``retrieval_fn`` each
    taking ``(params, batch, cfg)`` -> (loss, metrics), scores, candidate
    scores; ``*_inputs(cfg, cell)`` -> a dict of meta tensors.

    A ``train`` cell's step is ``train_step(state, batch) -> (state,
    metrics)`` over ``loss_fn`` with AdamW at 1e-3 (the state updated in
    place); a ``score`` or ``retrieval`` cell's is ``fn(params, batch)``
    under ``torch.inference_mode``."""

    def input_specs(cfg, cell):
        if cell.kind == "train":
            return train_inputs(cfg, cell)
        if cell.meta["mode"] == "score":
            return score_inputs(cfg, cell)
        return retrieval_inputs(cfg, cell)

    def abstract_state(cfg, cell):
        params = init_fn(0, cfg, device="meta")
        if cell.kind == "train":
            return ts.TrainState.create(params, opt_mod.adamw(1e-3))
        return params

    def step_fn(cfg, cell):
        if cell.kind == "train":
            return ts.make_train_step(
                lambda p, b: loss_fn(p, b, cfg), opt_mod.adamw(1e-3))
        fn = score_fn if cell.meta["mode"] == "score" else retrieval_fn

        @sharding.inference
        def serve(params, batch):
            return fn(params, batch, cfg)
        return serve

    return base.register(base.ArchSpec(
        name=name, family="recsys",
        make_config=full_cfg, make_smoke_config=smoke_cfg,
        shapes=recsys_shapes(),
        input_specs=input_specs,
        abstract_state=abstract_state,
        step_fn=step_fn,
        state_spec_fn=state_spec,
        batch_spec_fn=batch_spec,
        model_flops_fn=model_flops_fn,
    ))
