"""Hand-rolled optimizers over nested dicts of tensors: AdamW and Adafactor.

Port of :mod:`repro.train.optimizer`. Adafactor (Shazeer & Stern 2018) is
the default for the >30B archs: the second moment is factored into row and
column statistics and the momentum is stored in bf16, so its state is ~2
bytes a parameter where Adam's is 8.

The API mirrors the reference's (and optax's): ``opt.init(params) ->
state``; ``opt.update(grads, state, params) -> (updates, state)``; apply
with :func:`apply_updates`. Unlike the reference, which returns fresh
arrays, ``update`` writes the moments into ``state``'s own tensors and
:func:`apply_updates` adds into the parameters in place (no donation in
PyTorch; the bits are the reference's arithmetic). A tree is a nested
dict whose leaves are tensors; ``None`` is an empty subtree, as in JAX.
The leaves may be DTensors (a sharded step): every update is an
elementwise or reducing operator that DTensor runs on the local shards,
and each in-place write keeps its tensor's placements.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Any
    update: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts; ``None`` stays
    ``None``), with the same positions of the trees in ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def apply_updates(params, updates):
    """``p + u.astype(p.dtype)`` for every leaf, added into ``p`` in place:
    the update is cast to the parameter's dtype BEFORE the add, as the
    reference does (a bf16 parameter takes a bf16 add)."""
    def add(p, u):
        p.add_(u.to(p.dtype))
        return p
    return tree_map(add, params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm
    before); the scale is cast to each leaf's dtype, as the reference's."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def adamw(
    lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
    eps: float = 1e-8, weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        def zeros(p):       # a DTensor's moments take its placements
            return torch.zeros_like(p, dtype=torch.float32)
        step_dev = tree_leaves(params)[0].device
        return {
            "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev),
        }

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        # bias corrections in f32 from the step count
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=t.device), t)

        def upd(g, mu, nu, p):
            g = g.float()
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g * g)
            return -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                          + weight_decay * p.float())

        updates = tree_map(upd, grads, state["mu"], state["nu"], params)
        return updates, {"mu": state["mu"], "nu": state["nu"], "step": step}

    return Optimizer(init=init, update=update)


# --------------------------------------------------------------------------
# Adafactor
# --------------------------------------------------------------------------

def adafactor(
    lr: float = 1e-2, decay: float = 0.8, eps1: float = 1e-30,
    eps2: float = 1e-3, clip_threshold: float = 1.0,
    momentum: float = 0.9, momentum_dtype=torch.bfloat16,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Factored second moment for >=2D params; full for 1D."""

    def _factored(p) -> bool:
        return p.dim() >= 2

    def init(params):
        def state_of(p):
            def zeros(shape, dtype=torch.float32):
                return torch.zeros(shape, dtype=dtype, device=p.device)
            m = zeros(p.shape, momentum_dtype) if momentum else None
            if _factored(p):
                return {"vr": zeros(p.shape[:-1]),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:]),
                        "m": m}
            return {"v": zeros(p.shape), "m": m}

        step_dev = tree_leaves(params)[0].device
        return {
            "per_param": tree_map(state_of, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev),
        }

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        beta2 = 1.0 - torch.pow(t, -decay)      # 0 at step 1

        def upd(g, s, p):
            g = g.float()
            g2 = g * g + eps1
            if _factored(p):
                vr = beta2 * s["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps1)
                vhat = vr[..., :, None] * vc[..., None, :] / denom[..., None]
                u = g * torch.rsqrt(vhat + eps1)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(v + eps1)
                s["v"].copy_(v)
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(u * u) + eps1)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            scale = torch.clamp(
                torch.sqrt(torch.mean(torch.square(p.float()))), min=eps2)
            u = -lr * scale * u
            if momentum:
                m = momentum * s["m"].float() + (1 - momentum) * u
                s["m"].copy_(m.to(momentum_dtype))
                u = m
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            return u

        # driven by grads: each parameter's state dict arrives as one leaf
        updates = tree_map(upd, grads, state["per_param"], params)
        return updates, {"per_param": state["per_param"], "step": step}

    return Optimizer(init=init, update=update)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr, **kw)
    if name == "adafactor":
        return adafactor(lr=lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
