"""Activation checkpointing that frees its inputs with their last reference.

The counterpart of the reference's ``jax.checkpoint``: :func:`checkpoint`
runs ``fn`` without keeping its intermediates and recomputes them in
backward, through ``torch.utils.checkpoint(..., use_reentrant=False)``.

That checkpoint's first call in a process initialises ``torch._dynamo``
lazily, and the import leaves the frames of the stack it ran under in a
reference cycle: the caller's frames, and so a train step's parameters,
optimizer state and batch, live until the cyclic collector runs. Every
later call frees its tensors with their last reference. So the first
:func:`checkpoint` of a process first runs one tiny checkpoint in a
thread of its own, whose stack holds nothing, and the lazy
initialisation happens there.

A ``torch.autograd.Function`` that recomputes in its backward would leave
no cycle either, but costs memory: the gradient handed to a custom
function's backward stays referenced while the recomputed graph runs, so
the gradient of the function's input cannot accumulate into it in place,
and one more activation-sized buffer is live at each checkpoint (an
Equiformer layer of ``minibatch_lg``: 4.26 GB, past the card's memory).

``fn`` must be deterministic in its recomputation: every function the
models checkpoint is. A recomputation that adds in no fixed order (the
MoE combine's ``scatter_add_`` on a card) may differ from the forward by
rounding.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable

import torch
from torch.utils import checkpoint as torch_checkpoint


def _tiny_checkpoint() -> None:
    w = torch.ones(1, requires_grad=True)
    torch_checkpoint.checkpoint(torch.mul, w, w,
                                use_reentrant=False).sum().backward()


@functools.cache
def _first_use() -> None:
    """One tiny checkpoint in a fresh thread, once a process (see the
    module docstring); its error, if any, is raised here."""
    errors: list = []

    def run():
        try:
            _tiny_checkpoint()
        except BaseException as e:      # re-raised in the caller's thread
            errors.append(e)
    t = threading.Thread(target=run, name="remat-first-use")
    t.start()
    t.join()
    if errors:
        raise errors[0]


def checkpoint(fn: Callable, *args: Any):
    """``fn(*args)``, recomputed in backward instead of saved: the
    non-reentrant ``torch.utils.checkpoint``, after its lazy
    initialisation has run on a clean stack."""
    _first_use()
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False)
