"""IDentity-with-Locality (IDL) locations: the 64-bit hash path and the
32-bit lane path.

Port of :mod:`repro.core.idl`. ψ_j(x) = j·m' + ρ₁_j(MinHash_j(x)) + ρ₂_j(x):
a rolling densified one-permutation MinHash (or η exact MinHashes) picks
the anchor, a hash of the kmer itself picks the offset inside the L-window.
The 64-bit path (``idl_locations_rolling`` and the ``rh``, ``lsh`` and
``idl-bbf`` schemes) hashes uint64 kmers carried in int64; the 32-bit lane
path (``*_rolling32``) uses only 32-bit lane arithmetic.

Codes may carry leading batch axes: ``(..., n)`` uint8 codes give
``(..., η, n - k + 1)`` int64 locations in ``[0, m)``: the reference's
uint32 locations wherever m <= 2**32 (at m = 2**32 they reach 2**32 - 1).
Past that the 64-bit path's locations stay 64-bit (a flat filter of m =
2**35 bits), where the reference's wrap mod 2**32; the 32-bit lane path
keeps m <= 2**32. The rolling
locations of the ``idl`` and ``rh`` schemes, on both paths, take ``(n,)``
or ``(B, n)`` codes and run as one fused kernel launch on a CUDA tensor
(:mod:`repro_torch.kernels.idl_locations`; its plain version on a CPU
tensor); ``lsh``, ``idl-bbf`` and the kmer-batch form stay eager.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hashing, kmers, minhash

# seed salts (keep ρ₁, ρ₂ and MinHash streams independent)
_SALT_ANCHOR = 0xA17C
_SALT_LOCAL = 0x10CA
_SALT_MH = 0x0D0F
_SALT_RH = 0x5EED


@dataclasses.dataclass(frozen=True)
class IDLConfig:
    """Parameters of a gene-search IDL family (paper §5.1).

    Field for field the reference's ``IDLConfig``: snapshot manifests
    serialise it, so both packages read each other's snapshots.
    """

    k: int = 31          # kmer size (paper standard)
    t: int = 16          # sub-kmer size (paper recommends 16 for k=31)
    L: int = 1 << 15     # locality window
    eta: int = 4         # hash repetitions in the BF
    m: int = 1 << 26     # total BF bits (bit-sliced: matrix rows)
    minhash_mode: str = "doph"  # "doph" (paper §5.3.3) or "exact"
    # quantize the ρ₁ anchor to multiples of L so the locality window is
    # exactly one block; align=False is the paper-faithful layout
    align: bool = True

    def __post_init__(self):
        if not 1 <= self.t <= self.k <= 31:
            raise ValueError(f"need 1 <= t <= k <= 31, got t={self.t} k={self.k}")
        if self.m // self.eta <= self.L:
            raise ValueError(
                f"partition size m/η = {self.m // self.eta} must exceed L={self.L}"
            )

    @property
    def w(self) -> int:  # sub-kmers per kmer
        return self.k - self.t + 1

    @property
    def m_part(self) -> int:
        """Per-repetition sub-range; block-aligned mode rounds down to L."""
        part = self.m // self.eta
        if self.align:
            part = (part // self.L) * self.L
        return part

    @property
    def anchor_range(self) -> int:
        return self.m_part - self.L

    def exact_seeds(self) -> list[int]:
        return [_SALT_MH + 7919 * j for j in range(self.eta)]


def _minhash_rolling(cfg: IDLConfig, subk: torch.Tensor) -> torch.Tensor:
    if cfg.minhash_mode == "exact":
        return minhash.minhash_exact(subk, cfg.w, cfg.exact_seeds())
    return minhash.doph_minhash(subk, cfg.w, cfg.eta, seed=_SALT_MH)


def combine(cfg: IDLConfig, mh: torch.Tensor, kmer_arr: torch.Tensor
            ) -> torch.Tensor:
    """ψ_j(x) = j·m' + ρ₁_j(mh_j(x)) + ρ₂_j(x): ``(..., η, n)`` int64.

    align=True: ρ₁ picks a block index in [m'/L], scaled by L, so the
    locality window is one block. align=False: paper layout, ρ₁ uniform over
    [m' − L]. The sums are not wrapped: they lie in [0, m) at every m,
    where the reference's uint32 sums wrap past 2**32 (equal below it).
    """
    locs = []
    for j in range(cfg.eta):
        if cfg.align:
            anchor = hashing.hash_to_range(
                mh[..., j, :], _SALT_ANCHOR + 31 * j, cfg.m_part // cfg.L
            ) * cfg.L
        else:
            anchor = hashing.hash_to_range(
                mh[..., j, :], _SALT_ANCHOR + 31 * j, cfg.anchor_range)
        local = hashing.hash_to_range(kmer_arr, _SALT_LOCAL + 31 * j, cfg.L)
        locs.append(anchor + local + j * cfg.m_part)
    return torch.stack(locs, dim=-2)


def _fused(cfg: IDLConfig, codes: torch.Tensor, scheme: str, lane32: bool
           ) -> torch.Tensor:
    """The ``idl_locations`` kernels' entry point for ``scheme``."""
    from repro_torch.kernels.idl_locations import ops  # local: it imports us

    return ops.locations(cfg, codes, scheme, lane32=lane32)


def idl_locations_rolling(cfg: IDLConfig, codes: torch.Tensor) -> torch.Tensor:
    """IDL bit locations for every stride-1 kmer of ``(n,)`` or ``(B, n)``
    uint8 codes (the rolling MinHash as a sliding-window minimum):
    ``(..., η, n - k + 1)``, in one ``idl_locations64`` launch on a CUDA
    tensor."""
    return _fused(cfg, codes, "idl", lane32=False)


def idl_locations_kmer_batch(cfg: IDLConfig, kmer_arr: torch.Tensor
                             ) -> torch.Tensor:
    """IDL bit locations for an arbitrary batch of packed kmers; agrees
    exactly with :func:`idl_locations_rolling` on sequential kmers."""
    mh = minhash.minhash_kmer_batch(
        kmer_arr, cfg.k, cfg.t, cfg.eta,
        mode=cfg.minhash_mode, seed=_SALT_MH,
        seeds=cfg.exact_seeds() if cfg.minhash_mode == "exact" else None,
    )
    return combine(cfg, mh, kmer_arr)


# the idl-bbf scheme's block: one 512-bit (64-byte) cache line
BBF_BLOCK_BITS = 512


def check_bbf_config(cfg: IDLConfig, block_bits: int = BBF_BLOCK_BITS
                     ) -> None:
    """Refuse an ``idl-bbf`` configuration whose L-window is narrower than
    one block: the block is chosen among ``max(L // block_bits, 1)``, so
    with L < block_bits a probe lands up to ``block_bits - 1 - L`` bits past
    the window, and past m in the last window."""
    if cfg.L < block_bits:
        raise ValueError(
            f"idl-bbf needs L >= block_bits ({block_bits}); got L={cfg.L}")


def idl_bbf_locations_rolling(cfg: IDLConfig, codes: torch.Tensor,
                              block_bits: int = BBF_BLOCK_BITS
                              ) -> torch.Tensor:
    """IDL × Blocked-Bloom-filter composition (paper §3.3): the MinHash
    anchor of repetition 0 picks the L-window, a per-key hash picks one
    ``block_bits`` block inside it, and all η probes land in that block."""
    subk = kmers.pack_kmers(codes, cfg.t)
    mh = _minhash_rolling(cfg, subk)
    kmer_arr = kmers.pack_kmers(codes, cfg.k)
    n_blocks_in_window = max(cfg.L // block_bits, 1)
    window = hashing.hash_to_range(
        mh[..., 0, :], _SALT_ANCHOR, cfg.m // cfg.L) * cfg.L
    blk = hashing.hash_to_range(
        kmer_arr, _SALT_LOCAL, n_blocks_in_window) * block_bits
    return torch.stack([
        window + blk + hashing.hash_to_range(kmer_arr, _SALT_RH + 97 * j,
                                             block_bits)
        for j in range(cfg.eta)
    ], dim=-2)


def rh_locations(cfg: IDLConfig, kmer_arr: torch.Tensor) -> torch.Tensor:
    """Baseline partitioned-RH locations (MurmurHash-style), same layout."""
    return torch.stack([
        hashing.hash_to_range(kmer_arr, _SALT_RH + 31 * j, cfg.m_part)
        + j * cfg.m_part
        for j in range(cfg.eta)
    ], dim=-2)


def rh_locations_rolling(cfg: IDLConfig, codes: torch.Tensor) -> torch.Tensor:
    """:func:`rh_locations` of every stride-1 kmer of the codes, in one
    ``idl_locations64`` launch on a CUDA tensor."""
    return _fused(cfg, codes, "rh", lane32=False)


def lsh_locations_rolling(cfg: IDLConfig, codes: torch.Tensor
                          ) -> torch.Tensor:
    """Rehashed MinHash only (Table 4's ablation: locality but identity
    loss)."""
    mh = _minhash_rolling(cfg, kmers.pack_kmers(codes, cfg.t))
    return torch.stack([
        hashing.hash_to_range(mh[..., j, :], _SALT_ANCHOR + 31 * j,
                              cfg.m_part) + j * cfg.m_part
        for j in range(cfg.eta)
    ], dim=-2)


def locations(cfg: IDLConfig, codes: torch.Tensor, scheme: str
              ) -> torch.Tensor:
    """Rolling locations for a named scheme (dispatch lives in
    :mod:`repro_torch.index.registry`)."""
    from repro_torch.index import registry  # local import: registry imports us

    return registry.locations(cfg, codes, scheme)


def idl_locations_rolling32(cfg: IDLConfig, codes: torch.Tensor) -> torch.Tensor:
    """(..., η, n_kmers) IDL locations using only 32-bit lane arithmetic, in
    one ``idl_locations32`` launch on a CUDA tensor."""
    return _fused(cfg, codes, "idl", lane32=True)


def rh_locations_rolling32(cfg: IDLConfig, codes: torch.Tensor) -> torch.Tensor:
    """Baseline random-hash locations on the 32-bit lane path, in one
    ``idl_locations32`` launch on a CUDA tensor."""
    return _fused(cfg, codes, "rh", lane32=True)
