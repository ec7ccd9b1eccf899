"""PageRank via general orthogonal-polynomial expansions (port of
`repro.core.orthopoly`, the reference's beyond-paper basis ablation).

The paper's conclusion (§6) proposes trying other orthogonal polynomials as
future work. This module implements the general three-term-recurrence
solver

    f(x) = (1 - cx)^{-1} = sum_k a_k phi_k(x),
    phi_{k+1}(x) = (A_k x + B_k) phi_k(x) - C_k phi_{k-1}(x),
    v_{k+1} = A_k P v_k + B_k v_k - C_k v_{k-1}   (matrix form)

for any basis orthogonal on [-1, 1] (where P's spectrum lives, Lemma 2):
chebyshev (w = 1/sqrt(1-x^2), the paper), legendre (w = 1) and chebyshev2
(w = sqrt(1-x^2)). `basis_recurrence` and `series_coefficients` are numpy
copies of the reference's (float64 quadrature); `ortho_pagerank` runs the
recurrence on the port's `spmv`/`spmm` (one SpMM per round, a Python loop
where the reference unrolls under jit).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.ops import DeviceGraph, spmm, spmv

__all__ = ["basis_recurrence", "series_coefficients", "ortho_pagerank"]


def basis_recurrence(basis: str, k: int):
    """(A_k, B_k, C_k) with phi_{k+1} = (A_k x + B_k) phi_k - C_k phi_{k-1}."""
    if basis == "chebyshev":
        return (1.0 if k == 0 else 2.0), 0.0, (0.0 if k == 0 else 1.0)
    if basis == "chebyshev2":
        return 2.0, 0.0, (0.0 if k == 0 else 1.0)
    if basis == "legendre":
        return (2 * k + 1) / (k + 1), 0.0, k / (k + 1)
    raise ValueError(basis)


def _weight(basis: str, x: np.ndarray) -> np.ndarray:
    if basis == "chebyshev":
        return 1.0 / np.sqrt(1.0 - x * x)
    if basis == "chebyshev2":
        return np.sqrt(1.0 - x * x)
    if basis == "legendre":
        return np.ones_like(x)
    raise ValueError(basis)


def series_coefficients(basis: str, c: float, rounds: int,
                        n_quad: int = 200_001) -> np.ndarray:
    """a_k = <f, phi_k>_w / <phi_k, phi_k>_w by quadrature (float64).

    Integrates in t with x = cos t: the Chebyshev weight's endpoint
    singularities cancel against the Jacobian (w(cos t) sin t is smooth for
    every supported basis), so the trapezoid rule converges fast.
    """
    t = np.linspace(0.0, np.pi, n_quad)
    x = np.cos(t)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = _weight(basis, x) * np.sin(t)  # includes the |dx| = sin t Jacobian
    w[0] = w[-1] = 0.0 if basis != "chebyshev" else 1.0  # limit values
    f = 1.0 / (1.0 - c * x)
    phi_prev = np.ones_like(x)
    phi_cur = None
    coeffs = []
    for k in range(rounds + 1):
        if k == 0:
            phi = phi_prev
        elif k == 1:
            a0, b0, _ = basis_recurrence(basis, 0)
            phi_cur = (a0 * x + b0) * phi_prev
            phi = phi_cur
        else:
            ak, bk, ck = basis_recurrence(basis, k - 1)
            phi = (ak * x + bk) * phi_cur - ck * phi_prev
            phi_prev, phi_cur = phi_cur, phi
        num = np.trapezoid(f * phi * w, t)
        den = np.trapezoid(phi * phi * w, t)
        coeffs.append(num / den)
    return np.asarray(coeffs, float)


def ortho_pagerank(dg: DeviceGraph, basis: str = "legendre", c: float = 0.85,
                   rounds: int = 12, p: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """PageRank by truncated orthogonal series in `basis` (rounds SpMMs):
    [n] or [n, B] column-normalized, on the DeviceGraph's device. p
    defaults to ones (any scaling; the normalization absorbs it)."""
    if p is None:
        p = torch.ones((dg.n,), dtype=dg.inv_deg.dtype, device=dg.device)
    apply = spmv if p.ndim == 1 else spmm
    coeffs = torch.as_tensor(series_coefficients(basis, c, rounds),
                             dtype=p.dtype).to(p.device)
    v_prev = p                               # phi_0(P) p
    acc = coeffs[0] * v_prev
    a0, b0, _ = basis_recurrence(basis, 0)
    v_cur = a0 * apply(dg, p) + b0 * p       # phi_1(P) p
    acc = acc + coeffs[1] * v_cur
    for k in range(1, rounds):
        ak, bk, ck = basis_recurrence(basis, k)
        v_next = ak * apply(dg, v_cur) + bk * v_cur - ck * v_prev
        acc = acc + coeffs[k + 1] * v_next
        v_prev, v_cur = v_cur, v_next
    return acc / acc.sum(dim=0, keepdim=acc.ndim > 1)
