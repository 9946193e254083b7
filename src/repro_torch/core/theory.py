"""FPR theory: classic BF (eq. 5), IDL-BF bound (Theorem 2), parameter solvers.

The port's own copy of the reference's pure-``math`` module (no tensors)."""

from __future__ import annotations

import math


def bf_fpr(m: int, n: int, eta: int) -> float:
    """Classic BF false-positive rate, eq. (5)."""
    return (1.0 - math.exp(-eta * n / m)) ** eta


def bf_optimal_eta(m: int, n: int) -> int:
    """η* = ln(2)·m/n (rounded, >=1)."""
    return max(1, round(math.log(2) * m / n))


def bf_size_for_fpr(n: int, eps: float) -> int:
    """m = -n ln(ε) / ln²2 under optimal η."""
    return int(math.ceil(-n * math.log(eps) / (math.log(2) ** 2)))


def idl_bf_fpr_bound(
    m: int, n: int, eta: int, L: int, k: int = 31, t: int = 16,
    w1: int | None = None, w2: int | None = None,
) -> float:
    """Theorem 2 upper bound on IDL-BF FPR.

    ε ≤ ( w₂(1/L + η/m) + 2(1 − e^{−ηn/2m}) )^η
    with gene-search instantiation w₁ = k, w₂ = (k−t+1)² (Lemma 1).
    """
    if w1 is None:
        w1 = k
    if w2 is None:
        w2 = (k - t + 1) ** 2
    inner = w2 * (1.0 / L + eta / m) + 2.0 * (1.0 - math.exp(-eta * n / (2.0 * m)))
    return min(1.0, inner) ** eta


def idl_bf_fpr_bound_exact(
    m: int, n: int, eta: int, L: int, k: int = 31, t: int = 16,
) -> float:
    """Theorem 2 without the exponential approximation."""
    w1 = k
    w2 = (k - t + 1) ** 2
    base = 1.0 - (w1 * eta / m)
    if base <= 0.0:
        return 1.0
    inner = w2 * (1.0 / L + eta / m) + 2.0 * (1.0 - base ** (n / (2.0 * w1)))
    return min(1.0, inner) ** eta


def idl_limit_bound(L: int, eta: int, k: int = 31, t: int = 16) -> float:
    """m→∞ limit of the Thm 2 bound: (w₂/L)^η."""
    w2 = (k - t + 1) ** 2
    return min(1.0, w2 / L) ** eta


def grid_best_eta(m: int, n: int, L: int, k: int = 31, t: int = 16,
                  eta_max: int = 16) -> int:
    """Paper §6: grid-search η minimizing the Thm 2 bound."""
    best, best_eps = 1, float("inf")
    for eta in range(1, eta_max + 1):
        eps = idl_bf_fpr_bound(m, n, eta, L, k, t)
        if eps < best_eps:
            best, best_eps = eta, eps
    return best


def expected_adjacent_jaccard(k: int, t: int) -> float:
    """Jaccard of adjacent kmers' sub-kmer sets when all sub-kmers distinct.

    Adjacent windows of w = k−t+1 sub-kmers share w−1 elements:
    J = (w−1)/(w+1).
    """
    w = k - t + 1
    return (w - 1) / (w + 1)
