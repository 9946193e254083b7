"""Entry point of the fused location kernels.

:func:`locations` runs the CUDA kernel on a CUDA tensor and the plain
version (:mod:`.ref`) on a CPU tensor; ``core.idl``'s rolling location
functions of the ``idl`` and ``rh`` schemes call it.
"""

from __future__ import annotations

import torch

from repro_torch.core import idl
from repro_torch.kernels.idl_locations import kernel


def locations(cfg: idl.IDLConfig, codes: torch.Tensor, scheme: str, *,
              lane32: bool) -> torch.Tensor:
    """(..., η, n_kmers) locations of ``scheme`` on the 32-bit lane path
    (``lane32``) or the 64-bit hash path, in one launch (see
    :func:`kernel.locations`)."""
    return kernel.locations(cfg, codes.contiguous(), scheme, lane32=lane32)
