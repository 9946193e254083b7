"""Train state and the generic train step used by the loop.

Port of :mod:`repro.train.train_state`. Gradients come from
``torch.autograd.grad`` over the parameter leaves (the reference's
``jax.value_and_grad``). The step updates the state's tensors in place
(the optimizer's moments and the parameters) and returns the same
:class:`TrainState` object advanced by one: PyTorch has no donation, and
an in-place update is what donation buys the reference.

On DTensor state (a sharded step), a parameter's gradient comes out of
autograd in whatever layout its last use left: a parameter replicated
over a data-parallel axis gets a ``Partial`` sum. :func:`value_and_grad`
lays each gradient out as its parameter is laid out, once (an all-reduce,
or a reduce-scatter onto an FSDP shard), before the clip and the
optimizer read it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.train import optimizer as opt_mod


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor

    @classmethod
    def create(cls, params, optimizer: opt_mod.Optimizer) -> "TrainState":
        dev = opt_mod.tree_leaves(params)[0].device
        return cls(
            params=params,
            opt_state=optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=dev),
        )


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)`` with respect to every leaf of ``params``: the leaves are
    differentiated through aliases of their own storage, so the caller's
    tensors need no ``requires_grad``. Loss and metrics come back
    detached."""
    aliases = opt_mod.tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
    leaves = opt_mod.tree_leaves(aliases)
    with torch.enable_grad():
        loss, metrics = loss_fn(aliases, batch)
        grads = torch.autograd.grad(loss, leaves)
    by_leaf = {id(x): _as_param(g, x) for x, g in zip(leaves, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics,
            opt_mod.tree_map(lambda x: by_leaf[id(x)], aliases))


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its parameter (its pending
    reductions done once); any other gradient as it is."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(
    loss_fn: Callable, optimizer: opt_mod.Optimizer,
    *, grad_clip: float = 1.0, microbatch: int = 0,
    grad_compression: Callable | None = None,
):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``microbatch`` > 1 splits axis 0 of every batch leaf into that many
    accumulation steps, summing their gradients in f32 and dividing by the
    count, and averaging loss and metrics (the reference's ``lax.scan``).
    ``grad_compression`` optionally transforms grads before the optimizer.
    """

    def train_step(state: TrainState, batch):
        if microbatch and microbatch > 1:
            acc = opt_mod.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32),
                state.params)
            losses, metricses = [], []
            for i in range(microbatch):
                mbatch = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                       + tuple(v.shape[1:]))[i]
                          for k, v in batch.items()}
                loss, metrics, grads = value_and_grad(loss_fn, state.params,
                                                      mbatch)
                opt_mod.tree_map(lambda a, g: a.add_(g), acc, grads)
                losses.append(loss)
                metricses.append(metrics)
                del grads
            grads = opt_mod.tree_map(lambda g: g / microbatch, acc)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k].float() for m in metricses]).mean()
                       for k in metricses[0]}
        else:
            loss, metrics, grads = value_and_grad(loss_fn, state.params,
                                                  batch)

        if grad_compression is not None:
            grads = grad_compression(grads)
        grads, gnorm = opt_mod.clip_by_global_norm(grads, grad_clip)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        del grads
        opt_mod.apply_updates(state.params, updates)
        del updates
        state.opt_state = opt_state
        state.step = state.step + 1
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm})
        return state, metrics

    return train_step
