"""Real spherical-harmonic rotation matrices (Wigner D for real SH).

Port of :mod:`repro.models.so3`. The Ivanic & Ruedenberg recursion (J.
Phys. Chem. 1996 + 1998 erratum) builds R^l (the (2l+1)x(2l+1) rotation
acting on real SH coefficients of degree l) from R^{l-1} and the l=1
matrix. All loops are static Python over (l, m, n); every op is
vectorised over the edge batch. Each entry of R^l is its own small
expression, as in the reference: under XLA's ``jit`` they fuse, here each
is a few eager elementwise launches (thousands a call at l_max 6).

Index convention: R^l[..., m + l, n + l], m,n in [-l, l]. The l=1 real-SH
basis order is (y, z, x), i.e. m = (-1, 0, 1).
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch


def rotation_to_z(edge_vec: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Per-edge 3x3 rotation M with M @ d_hat = z_hat.

    edge_vec: (E, 3). Returns (E, 3, 3) with rows = new (x', y', z'=d_hat)
    axes — branchless reference-vector selection avoids the polar
    singularity.
    """
    d = edge_vec / (torch.linalg.vector_norm(edge_vec, dim=-1, keepdim=True)
                    + eps)
    near_z = torch.abs(d[..., 2:3]) > 0.9
    ref = torch.where(
        near_z,
        torch.tensor([1.0, 0.0, 0.0], dtype=edge_vec.dtype,
                     device=edge_vec.device),
        torch.tensor([0.0, 0.0, 1.0], dtype=edge_vec.dtype,
                     device=edge_vec.device),
    )
    x_ax = torch.linalg.cross(ref, d, dim=-1)
    x_ax = x_ax / (torch.linalg.vector_norm(x_ax, dim=-1, keepdim=True)
                   + eps)
    y_ax = torch.linalg.cross(d, x_ax, dim=-1)
    return torch.stack([x_ax, y_ax, d], dim=-2)  # rows


_R1_PERM = [1, 2, 0]


def _r1_from_matrix(m3: torch.Tensor) -> torch.Tensor:
    """3x3 rotation (xyz basis) -> R^1 in real-SH order (y, z, x)."""
    return m3[..., _R1_PERM, :][..., :, _R1_PERM]


@lru_cache(maxsize=None)
def _uvw(l: int, m: int, n: int) -> tuple[float, float, float]:
    denom = (l + n) * (l - n) if abs(n) < l else (2 * l) * (2 * l - 1)
    u = math.sqrt((l + m) * (l - m) / denom)
    dm0 = 1.0 if m == 0 else 0.0
    v = 0.5 * math.sqrt(
        (1.0 + dm0) * (l + abs(m) - 1) * (l + abs(m)) / denom
    ) * (1.0 - 2.0 * dm0)
    w = -0.5 * math.sqrt((l - abs(m) - 1) * (l - abs(m)) / denom) * (1.0 - dm0)
    return u, v, w


def _p(i: int, l: int, a: int, b: int, r1, rlm1):
    """Helper P_i^{a,b} of the recursion (vectorised over leading dims)."""
    if b == l:
        return (
            r1[..., i + 1, 2] * rlm1[..., a + l - 1, 2 * l - 2]
            - r1[..., i + 1, 0] * rlm1[..., a + l - 1, 0]
        )
    if b == -l:
        return (
            r1[..., i + 1, 2] * rlm1[..., a + l - 1, 0]
            + r1[..., i + 1, 0] * rlm1[..., a + l - 1, 2 * l - 2]
        )
    return r1[..., i + 1, 1] * rlm1[..., a + l - 1, b + l - 1]


def _u_fn(l, m, n, r1, rlm1):
    return _p(0, l, m, n, r1, rlm1)


def _v_fn(l, m, n, r1, rlm1):
    if m == 0:
        return _p(1, l, 1, n, r1, rlm1) + _p(-1, l, -1, n, r1, rlm1)
    if m > 0:
        s = math.sqrt(2.0) if m == 1 else 1.0
        out = _p(1, l, m - 1, n, r1, rlm1) * s
        if m != 1:
            out = out - _p(-1, l, -m + 1, n, r1, rlm1)
        return out
    s = math.sqrt(2.0) if m == -1 else 1.0
    out = _p(-1, l, -m - 1, n, r1, rlm1) * s
    if m != -1:
        out = out + _p(1, l, m + 1, n, r1, rlm1)
    return out


def _w_fn(l, m, n, r1, rlm1):
    if m == 0:
        raise AssertionError("w coefficient is zero for m == 0")
    if m > 0:
        return _p(1, l, m + 1, n, r1, rlm1) + _p(-1, l, -m - 1, n, r1, rlm1)
    return _p(1, l, m - 1, n, r1, rlm1) - _p(-1, l, -m + 1, n, r1, rlm1)


def wigner_matrices(m3: torch.Tensor, l_max: int) -> list[torch.Tensor]:
    """Real-SH rotation matrices [R^0, R^1, ..., R^l_max].

    m3: (..., 3, 3) xyz rotation matrices. R^l has shape (..., 2l+1, 2l+1).
    """
    batch = tuple(m3.shape[:-2])
    mats: list[torch.Tensor] = [
        torch.ones(batch + (1, 1), dtype=m3.dtype, device=m3.device)]
    if l_max == 0:
        return mats
    r1 = _r1_from_matrix(m3)
    mats.append(r1)
    for l in range(2, l_max + 1):
        rlm1 = mats[-1]
        rows = []
        for m in range(-l, l + 1):
            row = []
            for n in range(-l, l + 1):
                u, v, w = _uvw(l, m, n)
                # the reference starts each entry from zeros; 0 + t == t
                terms = [c * fn(l, m, n, r1, rlm1) for c, fn in
                         ((u, _u_fn), (v, _v_fn), (w, _w_fn))
                         if abs(c) > 1e-12]
                term = terms[0]
                for t in terms[1:]:
                    term = term + t
                row.append(term)
            rows.append(torch.stack(row, dim=-1))
        mats.append(torch.stack(rows, dim=-2))
    return mats


def block_diag_wigner(m3: torch.Tensor, l_max: int) -> torch.Tensor:
    """Stacked block-diagonal rotation over all degrees: (..., K, K),
    K = (l_max+1)^2 — convenient for a single einsum over flat coeffs."""
    mats = wigner_matrices(m3, l_max)
    k = (l_max + 1) ** 2
    out = m3.new_zeros(tuple(m3.shape[:-2]) + (k, k))
    off = 0
    for l, r in enumerate(mats):
        n = 2 * l + 1
        out[..., off: off + n, off: off + n] = r
        off += n
    return out


# --- real spherical harmonics evaluation (for tests) ----------------------

def sh_l1(d: torch.Tensor) -> torch.Tensor:
    """l=1 real SH (unnormalized, basis order y,z,x) of unit vectors."""
    return torch.stack([d[..., 1], d[..., 2], d[..., 0]], dim=-1)
