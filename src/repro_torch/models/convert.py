"""Carry the reference's LM weights and KV caches across to the port.

The reference's parameter pytree, as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)`` on the reference's side), becomes a
:class:`~repro_torch.models.transformer.TransformerLM` with the same keys,
shapes and dtypes. The port never imports JAX to read it: a bf16 leaf
arrives as a numpy array of the ``bfloat16`` extension dtype and is
reinterpreted through its 16 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.layers import Params


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A numpy array (any float or int dtype, or ``bfloat16``) as a tensor
    of the same dtype and bits on ``device``, in memory of its own (the
    decode step writes its cache in place)."""
    a = np.array(a, order="C")              # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(tree: Params, device) -> Params:
    return {k: _tree(v, device) if isinstance(v, dict)
            else tensor_from_numpy(v, device) for k, v in tree.items()}


def params_from_jax(tree: Params, cfg: tf.LMConfig,
                    device="cuda") -> tf.TransformerLM:
    """The reference's ``lm_init`` tree (numpy leaves) as the port's model
    on ``device``, dtype for dtype."""
    return tf.TransformerLM(cfg, _tree(tree, device))


def cache_from_jax(cache: Params, device="cuda") -> Params:
    """The reference's KV cache dict (``k``, ``v``, ``len``; numpy leaves)
    as the port's, dtype for dtype."""
    return _tree(cache, device)
