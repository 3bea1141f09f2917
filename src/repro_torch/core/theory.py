"""Theoretical results — paper §5 (Thm. 6, Table 2) and §3.3 (Thm. 2).

Expected replication factors under Clauset's power-law model (Eq. 11,
d_min = 1 ⇒ zeta distribution with parameter α). Where the paper cites other
papers' bounds we compute the expectations numerically from the same degree
model (derivations noted inline); ordering between methods is the claim under
test, not 3-digit agreement with Table 2.
"""
from __future__ import annotations

import numpy as np
from scipy.special import zeta

__all__ = [
    "zeta_mean_degree",
    "bound_proposed",
    "bound_general",
    "expected_rf_random_1d",
    "expected_rf_grid",
    "expected_rf_dbh",
    "table2",
]

_DMAX = 10**7  # truncation for numeric expectations over the zeta distribution


def _zeta_pmf(alpha: float, dmax: int = 100_000) -> tuple[np.ndarray, np.ndarray]:
    d = np.arange(1, dmax + 1, dtype=np.float64)
    pr = d**-alpha / zeta(alpha)
    return d, pr


def zeta_mean_degree(alpha: float) -> float:
    """E[d] = ζ(α−1)/ζ(α) for the zeta distribution with d_min = 1."""
    return zeta(alpha - 1) / zeta(alpha)


def bound_general(num_vertices: int, num_edges: int, k: int) -> float:
    """Theorem 6: RF_k ≤ (|V| + |E| + k)/|V| for any graph."""
    return (num_vertices + num_edges + k) / num_vertices


def bound_proposed(alpha: float, k: int = 256, num_vertices: int = 10**6) -> float:
    """Paper §5: E[(|V|+|E|+k)/|V|] ≈ 1 + ζ(α−1)/(2 ζ(α))."""
    return 1.0 + 0.5 * zeta(alpha - 1) / zeta(alpha) + k / num_vertices


def expected_rf_random_1d(alpha: float, k: int = 256) -> float:
    """Random edge hashing: a degree-d vertex lands in each of k parts with
    prob 1 − (1 − 1/k)^d ⇒ E[RF] = E_d[k(1 − (1−1/k)^d)]."""
    d, pr = _zeta_pmf(alpha)
    return float(np.sum(pr * k * (1.0 - (1.0 - 1.0 / k) ** d)))


def expected_rf_grid(alpha: float, k: int = 256) -> float:
    """2-D grid: a vertex's edges fall in its row (√k cells) as src or its
    column as dst ⇒ replicas bounded by the same coupon count over 2√k−1
    reachable cells."""
    c = 2 * int(np.sqrt(k)) - 1
    d, pr = _zeta_pmf(alpha)
    return float(np.sum(pr * c * (1.0 - (1.0 - 1.0 / c) ** d)))


def expected_rf_dbh(alpha: float, k: int = 256) -> float:
    """DBH: the lower-degree endpoint gets exactly 1 replica; the higher-degree
    endpoint behaves like random hashing. Approximate by splitting each
    vertex's incident edges: a fraction h(d) hash by the *other* endpoint.
    We use the simple upper-bound form of Xie et al.: degree-d vertex expects
    min(d, k(1−(1−1/k)^d)) replicas but with the low-degree side collapsed."""
    d, pr = _zeta_pmf(alpha)
    rand_part = k * (1.0 - (1.0 - 1.0 / k) ** d)
    # Low-degree vertices (d below the mean) are hashed by their own id — one
    # replica; high-degree vertices replicate like random.
    mean_d = zeta_mean_degree(alpha)
    reps = np.where(d <= mean_d, 1.0, rand_part)
    return float(np.sum(pr * reps))


def table2(alphas=(2.2, 2.4, 2.6, 2.8), k: int = 256, num_vertices: int = 10**6) -> dict:
    """Our Table-2 analogue: expected RF bounds per method per α.

    PAPER_TABLE2 holds the paper's published values for reference; the test
    asserts the *qualitative* claims — proposed ≲ NE ≪ hash methods, and
    proposed's bound equals 1 + ζ(α−1)/(2ζ(α))."""
    rows = {}
    for a in alphas:
        rows[a] = {
            "Random1D": expected_rf_random_1d(a, k),
            "Grid2D": expected_rf_grid(a, k),
            "DBH": expected_rf_dbh(a, k),
            "Proposed": bound_proposed(a, k, num_vertices),
        }
    return rows


PAPER_TABLE2 = {
    2.2: {"Random1D": 5.88, "Grid2D": 4.82, "DBH": 5.59, "HDRF": 5.36, "NE": 2.81, "BVC": 11.10, "Proposed": 2.88},
    2.4: {"Random1D": 3.46, "Grid2D": 3.13, "DBH": 3.21, "HDRF": 4.23, "NE": 1.68, "BVC": 6.39, "Proposed": 2.12},
    2.6: {"Random1D": 2.64, "Grid2D": 2.47, "DBH": 2.43, "HDRF": 3.61, "NE": 1.31, "BVC": 4.85, "Proposed": 1.88},
    2.8: {"Random1D": 2.23, "Grid2D": 2.13, "DBH": 2.05, "HDRF": 3.24, "NE": 1.13, "BVC": 4.10, "Proposed": 1.75},
}
