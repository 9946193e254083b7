"""Plain PyTorch versions of the fused location kernels: the eager
composition they replace. Codes are packed, hashed, reduced by the rolling
MinHash through ``window_min``'s plain version, densified and combined
operator by operator, so comparing a kernel with these on the card
compares it with no kernel at all."""

from __future__ import annotations

import torch

from repro_torch.core import hashing, idl, kmers, minhash
from repro_torch.kernels.window_min import ref as wm_ref

_M32 = hashing.M32


def _doph32(cfg: idl.IDLConfig, subk: torch.Tensor) -> torch.Tensor:
    """(..., η, n_kmers) densified one-permutation rolling MinHash."""
    h = hashing.mix32((hashing.mul32(subk, 0x9E3779B9) + idl._SALT_MH) & _M32)
    empty = minhash.FILL32
    mh = wm_ref.window_min_binned_ref(h, w=cfg.w, n_bins=cfg.eta,
                                      bin_shift=16, fill=empty)
    # rotation densification: an empty bin borrows from the next non-empty
    # bin, offset by a multiple of the golden constant; each rotation reads
    # the bins the last one filled
    for off in range(1, cfg.eta):
        donor = torch.roll(mh, -off, dims=-2)
        mh = torch.where(
            (mh == empty) & (donor != empty),
            (donor + ((0x9E3779B9 * off) & _M32)) & _M32,
            mh,
        )
    return mh


def _exact32(cfg: idl.IDLConfig, subk: torch.Tensor) -> torch.Tensor:
    """(..., η, n_kmers) η independent rolling MinHashes."""
    h = torch.stack([
        hashing.mix32((hashing.mul32(subk, 2 * s + 1) + s) & _M32)
        for s in cfg.exact_seeds()
    ], dim=-2)
    return wm_ref.window_min_binned_ref(h, w=cfg.w)


def idl_locations32_ref(cfg: idl.IDLConfig, codes: torch.Tensor
                        ) -> torch.Tensor:
    """(..., η, n_kmers) IDL locations using only 32-bit lane arithmetic."""
    subk = kmers.pack_kmers_u32(codes, cfg.t)
    mh = _doph32(cfg, subk) if cfg.minhash_mode == "doph" else _exact32(cfg, subk)
    hi, lo = kmers.pack_kmers_pair32(codes, cfg.k)
    locs = []
    for j in range(cfg.eta):
        mixed = hashing.mix32(hashing.mul32(mh[..., j, :], 2 * j + 3))
        if cfg.align:
            anchor = hashing.hash32_to_range(mixed, cfg.m_part // cfg.L) * cfg.L
        else:
            anchor = hashing.hash32_to_range(mixed, cfg.anchor_range)
        local = hashing.hash_pair32_to_range(hi, lo, idl._SALT_LOCAL + 31 * j,
                                             cfg.L)
        locs.append((anchor + local + j * cfg.m_part) & _M32)
    return torch.stack(locs, dim=-2)


def rh_locations32_ref(cfg: idl.IDLConfig, codes: torch.Tensor
                       ) -> torch.Tensor:
    """(..., η, n_kmers) random-hash locations on the 32-bit lane path."""
    hi, lo = kmers.pack_kmers_pair32(codes, cfg.k)
    return torch.stack([
        (hashing.hash_pair32_to_range(hi, lo, idl._SALT_RH + 31 * j, cfg.m_part)
         + j * cfg.m_part) & _M32
        for j in range(cfg.eta)
    ], dim=-2)


def idl_locations64_ref(cfg: idl.IDLConfig, codes: torch.Tensor
                        ) -> torch.Tensor:
    """(..., η, n_kmers) IDL locations on the 64-bit hash path: the rolling
    MinHash (DOPH with rotation densification, or η exact) over hash64'd
    sub-kmers, compared as uint64."""
    subk = kmers.pack_kmers(codes, cfg.t)
    if cfg.minhash_mode == "exact":
        h = torch.stack([hashing.hash64(subk, s) for s in cfg.exact_seeds()],
                        dim=-2)
        mh = wm_ref.window_min_binned_ref(h, w=cfg.w, unsigned=True)
    else:
        h = hashing.hash64(subk, idl._SALT_MH)
        mh = minhash.densify_rotation(wm_ref.window_min_binned_ref(
            h, w=cfg.w, n_bins=cfg.eta, bin_shift=minhash.BIN_SHIFT,
            fill=minhash.UINT64_MAX, unsigned=True))
    return idl.combine(cfg, mh, kmers.pack_kmers(codes, cfg.k))


def rh_locations64_ref(cfg: idl.IDLConfig, codes: torch.Tensor
                       ) -> torch.Tensor:
    """(..., η, n_kmers) random-hash locations on the 64-bit hash path."""
    return idl.rh_locations(cfg, kmers.pack_kmers(codes, cfg.k))
