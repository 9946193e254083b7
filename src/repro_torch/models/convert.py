"""Carry the reference's weights, KV caches and train states across.

The reference's parameter pytree, as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)`` on the reference's side), becomes
the port's with the same keys, shapes and dtypes: a
:class:`~repro_torch.models.transformer.TransformerLM` for an LM, the
plain dict for a recsys model or the Equiformer. Its ``TrainState``
becomes the port's :class:`~repro_torch.train.train_state.TrainState`.
The port never imports JAX to read them: a bf16 leaf arrives as a numpy
array of the ``bfloat16`` extension dtype and is reinterpreted through
its 16 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.layers import Params
from repro_torch.train import train_state as ts


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A numpy array (any float or int dtype, or ``bfloat16``) as a tensor
    of the same dtype and bits on ``device``, in memory of its own (the
    decode step writes its cache in place)."""
    a = np.array(a, order="C")              # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(tree, device):
    """Nested dicts of numpy leaves as tensors; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_from_jax(tree: Params, cfg: tf.LMConfig,
                    device="cuda") -> tf.TransformerLM:
    """The reference's ``lm_init`` tree (numpy leaves) as the port's model
    on ``device``, dtype for dtype."""
    return tf.TransformerLM(cfg, _tree(tree, device))


def recsys_params_from_jax(tree: Params, device="cuda") -> Params:
    """The reference's ``fm_init`` / ``sasrec_init`` / ``twotower_init`` /
    ``mind_init`` tree (numpy leaves) as the port's parameter dict on
    ``device``, dtype for dtype."""
    return _tree(tree, device)


def equiformer_params_from_jax(tree: Params, device="cuda") -> Params:
    """The reference's ``equiformer_init`` tree (numpy leaves; per-layer
    leaves stacked on axis 0) as the port's parameter dict on ``device``,
    dtype for dtype."""
    return _tree(tree, device)


def cache_from_jax(cache: Params, device="cuda") -> Params:
    """The reference's KV cache dict (``k``, ``v``, ``len``; numpy leaves)
    as the port's, dtype for dtype."""
    return _tree(cache, device)


def _n_stacked(params: Params) -> int | None:
    """The leading (layer) axis of a stacked per-layer tree, if any: an
    LM's ``layers``, SASRec's ``blocks`` or the Equiformer's ``layers``."""
    for key, leaf in (("layers", "ln1"), ("blocks", "ln1"),
                      ("layers", "ln_scale")):
        if isinstance(params.get(key), dict) and leaf in params[key]:
            return params[key][leaf].shape[0]
    return None


def train_state_from_jax(state, cfg, device="cuda") -> ts.TrainState:
    """The reference's ``TrainState`` (numpy leaves: ``params``; an AdamW
    ``opt_state`` of ``mu``/``nu``/``step`` or an Adafactor one of
    ``per_param`` ``vr``/``vc``/``v``/``m`` and ``step``; ``step``) as the
    port's on ``device``, dtype for dtype. ``cfg`` is the model's config
    (an LM's, a recsys arch's or the Equiformer's): a stacked tree's depth
    is checked against its ``n_layers`` or ``n_blocks``."""
    params = _tree(state.params, device)
    n = _n_stacked(params)
    want = getattr(cfg, "n_layers", getattr(cfg, "n_blocks", None))
    if n != want:
        raise ValueError(f"state has {n} layers; {cfg.name} has {want}")
    return ts.TrainState(params=params,
                         opt_state=_tree(state.opt_state, device),
                         step=tensor_from_numpy(state.step, device))
