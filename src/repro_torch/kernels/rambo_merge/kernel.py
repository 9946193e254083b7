"""Wrapper of the CUDA kernel ``csrc/rambo_merge.cu``: RAMBO's R-fold
merge and coverage count, from the bit-mode probe's answers to per-file
verdicts in one launch.

It replaces no TPU kernel (the JAX package merges with ``jnp``); it takes
the place of the ATen chain of gathers, ANDs, casts and a sum that wrote
ten times the answers' bytes. A CPU tensor takes the plain version
(:mod:`.ref`); a CUDA tensor launches the kernel or raises. The operand
checks run first, on either device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rambo_merge import ref

LIBRARY = "rambo_merge"       # build.SOURCES' key
NAME = "rambo_merge_coverage"  # the C entry point
SOURCE = "src/repro_torch/csrc/rambo_merge.cu"
REPLACES = None               # the JAX package merges with jnp
MAX_BUCKETS = 1344            # the kernel's 48 KB of shared memory a stripe

# Kernel launches so far (reset and read by callers that must show the
# kernel ran); the plain version counts nothing.
launches = 0

# the C entry point's arguments, the stream last
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 \
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def merge_coverage(ans: torch.Tensor, assign: torch.Tensor,
                   need: Union[int, torch.Tensor],
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N) bool: for each read b and file f, whether the kmers k with
    ``valid[b, k]`` (every kmer when ``valid`` is None) and ``ans[b, k,
    r·n_buckets + assign[r, f]] == 1`` for every repetition r number at
    least ``need[b]`` (or the scalar ``need``).

    ``ans`` is the (B, n_k, R·n_buckets) int32 {0, 1} answers of the bit
    probe, ``assign`` the (R, N) int32 file -> bucket map, ``need`` an int
    or a (B,) int32 tensor, ``valid`` a (B, n_k) bool tensor, all on one
    device. The kernel trusts ``assign`` to lie in ``[0, n_buckets)`` (a
    bucket outside hits nothing there; the plain version raises).
    """
    _check(ans, assign, need, valid)
    if ans.device.type == "cpu":
        return ref.merge_coverage_ref(ans, assign, need, valid)
    b, n_k, width = ans.shape
    n_rep, n_files = assign.shape
    out = torch.empty((b, n_files), dtype=torch.bool, device=ans.device)
    if out.numel():
        per_row = isinstance(need, torch.Tensor)
        build.launch(LIBRARY, _ARGTYPES, ans.device, ans.data_ptr(),
                     assign.data_ptr(), need.data_ptr() if per_row else None,
                     0 if per_row else need,
                     None if valid is None else valid.data_ptr(),
                     out.data_ptr(), b, n_k, n_rep, width // n_rep, n_files,
                     entry=NAME)
        global launches
        launches += 1
    return out


def _check(ans, assign, need, valid) -> None:
    """Raise unless the operands are what both versions take: ``ans``
    (B, n_k, R·n_buckets) int32, ``assign`` (R, N) int32 with R dividing
    the answers' width, ``need`` an int or a (B,) int32 tensor, ``valid``
    None or (B, n_k) bool, all tensors on one device; on a CUDA device
    also contiguous, with at most ``MAX_BUCKETS`` buckets."""
    tensors = {"ans": ans, "assign": assign}
    if isinstance(need, torch.Tensor):
        tensors["need"] = need
    elif not isinstance(need, int) or not -2 ** 31 <= need < 2 ** 31:
        raise ValueError(f"{NAME}: need must be a 32-bit int or a tensor, "
                         f"got {need!r}")
    if valid is not None:
        tensors["valid"] = valid
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{NAME}: operands must share one device, got "
                         f"{sorted(map(str, devices))}")
    want = {"ans": (torch.int32, 3), "assign": (torch.int32, 2),
            "need": (torch.int32, 1), "valid": (torch.bool, 2)}
    for name, t in tensors.items():
        dtype, ndim = want[name]
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{NAME}: {name} must be {ndim}-D {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    b, n_k, width = ans.shape
    n_rep = assign.shape[0]
    if n_rep < 1 or width % n_rep or width == 0:
        raise ValueError(f"{NAME}: {n_rep} repetitions do not divide the "
                         f"answers' width {width}")
    if "need" in tensors and tuple(need.shape) != (b,):
        raise ValueError(f"{NAME}: need {tuple(need.shape)} != ({b},)")
    if valid is not None and tuple(valid.shape) != (b, n_k):
        raise ValueError(f"{NAME}: valid {tuple(valid.shape)} != "
                         f"({b}, {n_k})")
    if ans.device.type == "cpu":
        return
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError(f"{NAME}: operands must be contiguous")
    if width // n_rep > MAX_BUCKETS:
        raise ValueError(f"{NAME}: {width // n_rep} buckets, the kernel "
                         f"takes at most {MAX_BUCKETS}")
