"""Gradient compression with error feedback: int8 with a per-tensor scale.

Port of :mod:`repro.distributed.collectives`. int8 gradients with one f32
scale a tensor carry a quarter of f32's bytes through a reduction; error
feedback (Seide et al. 2014; Karimireddy et al. 2019) adds each step's
quantization residual back into the next step's gradient. The arithmetic
is the reference's step for step (f32 scale ``max|x| / 127 + 1e-12``,
round half to even, clip to +-127), so ``q`` and ``scale`` equal its
bits. Trees are the port's nested dicts
(:func:`repro_torch.train.optimizer.tree_map`); :func:`make_compression`
gives the hook that ``make_train_step(grad_compression=...)`` takes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.train.optimizer import tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: ``(q int8, scale f32 ())``."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@dataclasses.dataclass
class ErrorFeedbackState:
    residual: Any           # a tree matching the gradients', f32


def init_error_feedback(params) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress_with_feedback(grads, ef: ErrorFeedbackState
                           ) -> tuple[Any, ErrorFeedbackState]:
    """``g' = Q(g + residual)``; ``residual' = (g + residual) - g'``."""
    pairs = tree_map(_compress_one, grads, ef.residual)   # leaves: pairs
    comp = tree_map(lambda p: p[0], pairs)
    resid = tree_map(lambda p: p[1], pairs)
    return comp, ErrorFeedbackState(residual=resid)


def _compress_one(g: torch.Tensor, r: torch.Tensor):
    gf = g.float() + r
    deq = dequantize_int8(*quantize_int8(gf))
    return deq, gf - deq


def make_compression(kind: Optional[str]) -> Optional[Callable]:
    """The stateless hook for ``make_train_step``: ``None`` for ``None`` or
    ``"none"``; for ``"int8"``, each gradient leaf quantized and
    dequantized in one step."""
    if kind in (None, "none"):
        return None
    if kind == "int8":
        def compress(grads):
            return tree_map(lambda g: dequantize_int8(*quantize_int8(g)),
                            grads)
        return compress
    raise ValueError(f"unknown compression {kind!r}")
