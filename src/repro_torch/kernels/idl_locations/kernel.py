"""Wrapper of the CUDA kernels ``csrc/idl_locations.cu``: a batch of reads'
codes to their IDL or RH locations in one launch, ``idl_locations32`` on
the 32-bit lane path and ``idl_locations64`` on the 64-bit hash path.

On the rolling location paths they replace the Pallas kernel
``repro/kernels/window_min/kernel.py::window_min`` together with the
location body around it. A CPU tensor takes the plain version
(:mod:`.ref`); a CUDA tensor launches the kernel or raises. The operand
checks run first, on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import hashing, idl
from repro_torch.kernels import build
from repro_torch.kernels.idl_locations import ref

LIBRARY = "idl_locations"                 # build.SOURCES' key
NAME32 = "idl_locations32"                # the C entry points
NAME64 = "idl_locations64"
SOURCE = "src/repro_torch/csrc/idl_locations.cu"
REPLACES = "src/repro/kernels/window_min/kernel.py:36"
SCHEMES = ("idl", "rh")
MAX_ETA = 16                              # the kernel's register arrays

# Kernel launches so far, one counter per entry point (reset and read by
# callers that must show the kernel ran); they count launches only, never
# the plain versions.
launches32 = 0
launches64 = 0

_PLAIN = {("idl", True): ref.idl_locations32_ref,
          ("rh", True): ref.rh_locations32_ref,
          ("idl", False): ref.idl_locations64_ref,
          ("rh", False): ref.rh_locations64_ref}

# hash32_to_range's branches, as the kernel numbers them
_LEMIRE, _SHIFT, _MODULO = 0, 1, 2


class _Range(ctypes.Structure):
    _fields_ = [("m", ctypes.c_uint64), ("kind", ctypes.c_int32),
                ("shift", ctypes.c_int32)]


class Config(ctypes.Structure):
    """The kernel's ``Config``, field for field."""

    _fields_ = [("k", ctypes.c_int32), ("t", ctypes.c_int32),
                ("eta", ctypes.c_int32), ("rh", ctypes.c_int32),
                ("exact", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("scale", ctypes.c_uint64), ("m_part", ctypes.c_uint64),
                ("anchor", _Range), ("local", _Range),
                ("mh_seed", ctypes.c_uint64),
                ("exact_seed", ctypes.c_uint64 * MAX_ETA),
                ("anchor_seed", ctypes.c_uint64 * MAX_ETA),
                ("local_seed", ctypes.c_uint64 * MAX_ETA)]


# codes, out, rows, n, the config (a host pointer), the stream
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [
    ctypes.POINTER(Config), ctypes.c_void_p]


def range32(m: int) -> _Range:
    """``hashing.hash32_to_range``'s branch for the range ``m``, with its
    check: a split Lemire product below 2**15, a top-bits shift for a power
    of two, a modulo otherwise."""
    if m <= 0 or m > (1 << 31):
        raise ValueError(f"bad range {m}")
    if m < (1 << 15):
        return _Range(m, _LEMIRE, 0)
    if m & (m - 1) == 0:
        return _Range(m, _SHIFT, 32 - (m.bit_length() - 1))
    return _Range(m, _MODULO, 0)


def range64(m: int) -> _Range:
    """``hashing.hash_to_range``'s range ``m``, with its check."""
    if m <= 0:
        raise ValueError(f"range m must be positive, got {m}")
    if m > (1 << 32):
        raise ValueError(f"range m={m} exceeds uint32")
    return _Range(m, _LEMIRE, 0)


@functools.lru_cache(maxsize=64)
def params(cfg: idl.IDLConfig, scheme: str, lane32: bool) -> Config:
    """The kernel's configuration for ``cfg`` and ``scheme`` on one path:
    ranges, their branches and the seeds' constants, worked out once."""
    rng = range32 if lane32 else range64
    eta = cfg.eta
    c = Config(k=cfg.k, t=cfg.t, eta=eta, rh=int(scheme == "rh"),
               exact=int(cfg.minhash_mode == "exact"), m_part=cfg.m_part)
    salt = idl._SALT_RH if scheme == "rh" else idl._SALT_LOCAL
    if scheme == "rh":
        c.local, c.scale = rng(cfg.m_part), 1
    else:
        c.local = rng(cfg.L)
        c.anchor = rng(cfg.m_part // cfg.L if cfg.align else cfg.anchor_range)
        c.scale = cfg.L if cfg.align else 1
    exact = cfg.exact_seeds()
    for j in range(eta):
        if lane32:
            c.local_seed[j] = (salt + 31 * j) & hashing.M32
            c.anchor_seed[j] = 2 * j + 3
            c.exact_seed[j] = exact[j]
        else:
            c.local_seed[j] = hashing.seed_const64(salt + 31 * j)
            c.anchor_seed[j] = hashing.seed_const64(idl._SALT_ANCHOR + 31 * j)
            c.exact_seed[j] = hashing.seed_const64(exact[j])
    c.mh_seed = idl._SALT_MH if lane32 else hashing.seed_const64(idl._SALT_MH)
    return c


def check(cfg: idl.IDLConfig, codes: torch.Tensor, scheme: str,
          lane32: bool) -> None:
    """Raise unless ``codes`` is a contiguous (n,) or (B, n) uint8 tensor on
    the CPU or a CUDA device with n >= k, and the scheme and widths are
    ones the kernel takes."""
    name = NAME32 if lane32 else NAME64
    if scheme not in SCHEMES:
        raise ValueError(f"{name}: scheme must be one of {SCHEMES}, "
                         f"got {scheme!r}")
    if not isinstance(codes, torch.Tensor) or codes.dtype != torch.uint8 \
            or codes.device.type not in ("cpu", "cuda") \
            or codes.dim() not in (1, 2) or not codes.is_contiguous():
        raise ValueError(
            f"{name}: codes must be a contiguous (n,) or (B, n) uint8 tensor "
            f"on the CPU or a CUDA device, got " + (
                f"{codes.dtype} {tuple(codes.shape)} on {codes.device} "
                f"(contiguous={codes.is_contiguous()})"
                if isinstance(codes, torch.Tensor) else type(codes).__name__))
    if codes.shape[-1] < cfg.k:
        raise ValueError(f"{name}: sequence length {codes.shape[-1]} < "
                         f"k={cfg.k}")
    if lane32 and cfg.t > 16:
        raise ValueError("32-bit path needs t <= 16")
    if cfg.eta > MAX_ETA:
        raise ValueError(f"{name}: eta {cfg.eta} exceeds {MAX_ETA}")


def locations(cfg: idl.IDLConfig, codes: torch.Tensor, scheme: str, *,
              lane32: bool) -> torch.Tensor:
    """``(..., η, n - k + 1)`` int64 locations in ``[0, 2**32)`` of every
    stride-1 kmer of ``(..., n)`` uint8 codes, under ``scheme`` (``"idl"``
    or ``"rh"``) on the 32-bit lane path (``lane32``) or the 64-bit hash
    path: one launch on a CUDA tensor, the plain version on a CPU one."""
    check(cfg, codes, scheme, lane32)
    if codes.device.type == "cpu":
        return _PLAIN[(scheme, lane32)](cfg, codes)
    config = params(cfg, scheme, lane32)
    n = codes.shape[-1]
    out = torch.empty(codes.shape[:-1] + (cfg.eta, n - cfg.k + 1),
                      dtype=torch.int64, device=codes.device)
    rows = codes.numel() // n
    if rows == 0:
        return out
    entry = NAME32 if lane32 else NAME64
    build.launch(LIBRARY, _ARGTYPES, codes.device, codes.data_ptr(),
                 out.data_ptr(), rows, n, ctypes.byref(config), entry=entry)
    global launches32, launches64
    if lane32:
        launches32 += 1
    else:
        launches64 += 1
    return out
