r"""Chebyshev machinery for CPAA (paper §2.2, §4.2); a copy of
`repro.core.chebyshev` for the PyTorch port.

The paper approximates f(x) = (1 - c x)^{-1} on (-1, 1) by the Chebyshev
expansion f(x) = c0/2 + sum_k c_k T_k(x) with

    c_k = (2/pi) * \int_0^pi cos(k t) / (1 - c cos t) dt.

Proposition 1 derives the closed form: the coefficients are geometric,

    c_0 = 2 / sqrt(1 - c^2),        c_k = c_0 * beta^k,
    beta = (1 - sqrt(1 - c^2)) / c,

so the per-iteration unaccumulated-mass ratio is sigma_c = beta (constant in
k), and the truncation error after M rounds is ERR_M = 2 beta^{M+1}/(1+beta)
(Formula 8). Everything here is closed-form float64 on host; the solver
consumes a precomputed coefficient vector (paper §4.1 point (1)).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "beta",
    "coefficient",
    "coefficients",
    "coefficient_integral",
    "sigma_c",
    "err_bound",
    "rounds_for_tolerance",
    "power_rounds_for_tolerance",
    "chunk_tail_ratio",
    "default_chunk",
    "ChebSchedule",
    "make_schedule",
]


def beta(c: float) -> float:
    """Geometric decay ratio beta = (1 - sqrt(1-c^2)) / c of the coefficients."""
    if not 0.0 < c < 1.0:
        raise ValueError(f"damping factor must be in (0,1), got {c}")
    return (1.0 - math.sqrt(1.0 - c * c)) / c


def coefficient(c: float, k: int) -> float:
    """Closed-form Chebyshev coefficient c_k = c0 * beta^k (Proposition 1)."""
    c0 = 2.0 / math.sqrt(1.0 - c * c)
    return c0 * beta(c) ** k


def coefficients(c: float, m: int) -> np.ndarray:
    """Vector [c_0, c_1, ..., c_M] (float64)."""
    c0 = 2.0 / math.sqrt(1.0 - c * c)
    b = beta(c)
    return c0 * np.power(b, np.arange(m + 1, dtype=float))


def coefficient_integral(c: float, k: int, n_quad: int = 200_001) -> float:
    r"""c_k by direct numerical quadrature of the paper's integral.

    Only used by tests to validate the closed form against the definition
    c_k = (2/pi) \int_0^pi cos(kt) / (1 - c cos t) dt.
    """
    t = np.linspace(0.0, math.pi, n_quad)
    integrand = np.cos(k * t) / (1.0 - c * np.cos(t))
    return float((2.0 / math.pi) * np.trapezoid(integrand, t))


def sigma_c(c: float) -> float:
    """Per-iteration unaccumulated-mass ratio (Proposition 1).

    The paper's expression sigma = (c^2 - (2-c)(1-s)) / (c^2 - c(1-s)) with
    s = sqrt(1-c^2) simplifies to beta; we keep the paper's form and assert
    the simplification in tests.
    """
    s = math.sqrt(1.0 - c * c)
    return (c * c - (2.0 - c) * (1.0 - s)) / (c * c - c * (1.0 - s))


def err_bound(c: float, m: int) -> float:
    """Relative truncation error ERR_M = 2 beta^{M+1} / (1 + beta) (Formula 8)."""
    b = beta(c)
    return 2.0 * b ** (m + 1) / (1.0 + b)


def rounds_for_tolerance(c: float, tol: float) -> int:
    """Smallest M with ERR_M < tol."""
    b = beta(c)
    # 2 b^{M+1}/(1+b) < tol  =>  M > log(tol (1+b)/2)/log(b) - 1
    m = math.log(tol * (1.0 + b) / 2.0) / math.log(b) - 1.0
    return max(1, int(math.ceil(m - 1e-12)))


def power_rounds_for_tolerance(c: float, tol: float) -> int:
    """Power-method analogue: residual decays as c^k; rounds for c^k < tol."""
    return max(1, int(math.ceil(math.log(tol) / math.log(c))))


# ----------------------------------------------------- a-posteriori control --
#
# Formula 8 is an A-PRIORI bound: it assumes the worst spectrum (all mass at
# x -> 1). Real graphs have a spectral gap, so the accumulator usually stops
# moving well before the bound. The adaptive solver (core.pagerank.
# cpaa_adaptive) runs the recurrence in chunks of R rounds and exits when the
# normalized L1 residual between accumulator snapshots drops under tol. The
# helpers below size R so that an exit decided from the chunk residual is
# sound: the not-yet-accumulated geometric tail after a residual-<=-tol stop
# is provably a small fraction of tol.


def chunk_tail_ratio(c: float, r: int) -> float:
    """Upper bound of (remaining tail) / (last chunk residual) after r rounds.

    The chunk residual between snapshots k-r and k carries coefficient mass
    ~ c0 beta^{k-r+1} (1 - beta^r) / (1 - beta); the tail beyond k is
    ~ c0 beta^{k+1} / (1 - beta). Their ratio is beta^r / (1 - beta^r),
    scaled by 1 / (1 - beta) to cover the worst-case per-mode sign
    cancellation inside the chunk (T_k(x) oscillates; the snapshot L1 can
    under-read the accumulated mass by up to the alternating-series factor).
    """
    b = beta(c)
    return b ** r / ((1.0 - b ** r) * (1.0 - b))


def default_chunk(c: float, tol: float | None = None, safety: float = 0.5,
                  max_chunk: int = 8) -> int:
    """Residual-check period R for `cpaa_adaptive`.

    Smallest R with chunk_tail_ratio(c, R) <= safety (exit on a chunk
    residual <= tol leaves a tail provably <= safety * tol), clamped to
    [2, max_chunk] — checking every round pays an extra normalization +
    reduction per SpMM for nothing, and a chunk beyond max_chunk delays the
    exit more than the check costs. When `tol` is given, R is additionally
    capped (down to 1 if need be) so at least one residual check happens
    before the a-priori round bound is hit — at very loose tolerances the
    bound is only a couple of rounds and a 2-round chunk would land its
    first check exactly on the cap, disabling adaptivity.
    """
    r = max_chunk
    for cand in range(2, max_chunk + 1):
        if chunk_tail_ratio(c, cand) <= safety:
            r = cand
            break
    if tol is not None:
        r = min(r, max(1, rounds_for_tolerance(c, tol) - 1))
    return r


@dataclass(frozen=True)
class ChebSchedule:
    """Precomputed iteration schedule consumed by the CPAA solver.

    Attributes:
      c:      damping factor.
      rounds: number of Chebyshev iterations M.
      coeffs: float64 [c_0 .. c_M]; coeffs[0] is halved ready for accumulation
              (the expansion starts with c0/2 * T_0).
      total_mass: S = c0/2 + sum_{k>=1} c_k = f(1) = 1/(1-c); the normalizer.
    """

    c: float
    rounds: int
    coeffs: np.ndarray
    total_mass: float

    @property
    def err_bound(self) -> float:
        return err_bound(self.c, self.rounds)


def make_schedule(c: float = 0.85, tol: float = 1e-6,
                  max_rounds: int | None = None,
                  rounds: int | None = None) -> ChebSchedule:
    """Schedule from a tolerance (ERR_M < tol) or an explicit round count."""
    m = rounds if rounds is not None else rounds_for_tolerance(c, tol)
    if max_rounds is not None:
        m = min(m, max_rounds)
    coef = coefficients(c, m)
    coef = coef.copy()
    coef[0] *= 0.5
    total = float(coef.sum())  # -> 1/(1-c) as m -> inf
    return ChebSchedule(c=c, rounds=m, coeffs=coef, total_mass=total)
