"""Nodal DG operators: Gauss-Legendre/Lobatto quadrature and Lagrange
matrices.

The port's copy of ``exahype_tpu/models/dg.py`` (pure NumPy, identical
arithmetic, so both packages build bitwise-equal operators —
``tests/test_torch_dg.py``).  It is a copy rather than an import because
importing ``exahype_tpu.models`` loads JAX (its ``__init__`` imports the
JAX physics modules eagerly), and this package never loads JAX.

Building blocks for the ADER-DG solver (the reference framework's headline
scheme; BASELINE.md north star is 3-D Euler ADER-DG order 3).  Everything is
nodal with collocation quadrature — so mass matrices are diagonal — on one
of the two bases the downstream ExaHyPE2 kernel generator offers:

- ``"legendre"`` (default): Gauss-Legendre points of [0, 1].  Collocation
  quadrature is exact through degree 2·order+1; the diagonal mass matrix is
  the EXACT Gram matrix.
- ``"lobatto"``: Gauss-Lobatto points (endpoints included).  Collocation is
  exact through degree 2·order−1, so the diagonal mass is the standard
  DGSEM *lumped* mass; in exchange face values are nodal (``phi0``/``phi1``
  are unit vectors — no extrapolation step) and the lumped weights still
  integrate the basis exactly (``w_i = ∫ℓ_i``, degree order ≤ 2·order−1),
  so cell means/mass bookkeeping stays exact.  Measured convergence of the
  ADER-DG solver on this basis is order N (vs the Legendre basis's N+1) —
  the classic mass-lumping cost; see ``tests/test_lobatto.py``.

All matrices are computed in float64 NumPy at setup time (they are tiny,
(order+1)²) and cast to the state dtype when applied.
"""

from __future__ import annotations

import numpy as np


def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` Gauss-Legendre nodes and weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)  # on [-1, 1]
    return (x + 1.0) / 2.0, w / 2.0


def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` Gauss-Lobatto nodes and weights on [0, 1] (endpoints included).

    Interior nodes are the roots of P'_{n−1}; weights on [−1,1] are
    ``2 / (n(n−1) P_{n−1}(x_i)²)``.  Exact through degree 2n−3.
    """
    if n < 2:
        raise ValueError("Gauss-Lobatto needs at least 2 nodes")
    Pm1 = np.polynomial.legendre.Legendre.basis(n - 1)
    interior = Pm1.deriv().roots() if n > 2 else np.array([])
    x = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    w = 2.0 / (n * (n - 1) * Pm1(x) ** 2)
    return (x + 1.0) / 2.0, w / 2.0


def basis_nodes(n: int, basis: str = "legendre") -> tuple[np.ndarray, np.ndarray]:
    """Nodes/weights on [0, 1] for a named nodal basis."""
    if basis == "legendre":
        return gauss_legendre(n)
    if basis == "lobatto":
        return gauss_lobatto(n)
    raise ValueError(f"unknown basis {basis!r} (legendre|lobatto)")


def lagrange_eval(nodes: np.ndarray, x: float) -> np.ndarray:
    """Values ℓ_i(x) of the Lagrange basis through ``nodes``."""
    n = len(nodes)
    out = np.ones(n)
    for i in range(n):
        for j in range(n):
            if j != i:
                out[i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
    return out


def lagrange_diff_matrix(nodes: np.ndarray) -> np.ndarray:
    """D[i, j] = ℓ'_j(ξ_i): nodal derivative matrix."""
    n = len(nodes)
    D = np.zeros((n, n))
    for j in range(n):
        for i in range(n):
            if i == j:
                D[i, j] = sum(
                    1.0 / (nodes[j] - nodes[k]) for k in range(n) if k != j
                )
            else:
                num = 1.0
                for k in range(n):
                    if k != j and k != i:
                        num *= (nodes[i] - nodes[k]) / (nodes[j] - nodes[k])
                D[i, j] = num / (nodes[j] - nodes[i])
    return D


class DGOperators:
    """Precomputed 1-D operator set for a given order.

    - ``nodes``, ``weights``: quadrature points/weights on [0,1] (order+1
      of each; Gauss-Legendre or Gauss-Lobatto per ``basis``)
    - ``D``: nodal derivative matrix
    - ``phi0``, ``phi1``: basis values at the faces x=0, x=1
    - ``K1inv``: inverse space-time predictor matrix
      (K1[σ,τ] = θ_σ(1)θ_τ(1) − w_τ D[τ,σ], the weak-in-time operator)
    """

    def __init__(self, order: int, basis: str = "legendre"):
        self.order = order
        self.basis = basis
        self.n_nodes = order + 1
        self.nodes, self.weights = basis_nodes(self.n_nodes, basis)
        self.D = lagrange_diff_matrix(self.nodes)
        self.phi0 = lagrange_eval(self.nodes, 0.0)
        self.phi1 = lagrange_eval(self.nodes, 1.0)
        # Kp[σ,τ] = ∫ θ'_σ θ_τ = w_τ D[τ,σ] under collocation (exact for
        # both bases: the integrand has degree ≤ 2·order−1).
        Kp = self.weights[None, :] * self.D.T
        K1 = np.outer(self.phi1, self.phi1) - Kp
        self.K1inv = np.linalg.inv(K1)
        # Volume stiffness applied transposed: Kvol[i,j] = w_j D[j,i] / w_i.
        self.Kvol = (self.weights[None, :] * self.D.T) / self.weights[:, None]


def subcell_projection(
    order: int, n_sub: int | None = None, basis: str = "legendre"
) -> np.ndarray:
    """P[s, i] = mean of basis ℓ_i over subcell s of [0,1] (n_sub per axis).

    Computed with Gauss-Legendre quadrature inside each subcell — exact for
    the degree-``order`` basis regardless of which nodal ``basis`` the
    solver uses.  Default n_sub = 2*order + 1 (the Dumbser subcell count,
    which makes one subcell-FV step at the DG CFL stable).
    """
    if n_sub is None:
        n_sub = 2 * order + 1
    nodes, weights = gauss_legendre(order + 1)
    P = np.zeros((n_sub, order + 1))
    cell_nodes, _ = basis_nodes(order + 1, basis)
    for s in range(n_sub):
        lo = s / n_sub
        for q, (xq, wq) in enumerate(zip(nodes, weights)):
            x = lo + xq / n_sub
            P[s] += wq * lagrange_eval(cell_nodes, x)
    return P


def subcell_reconstruction(
    order: int, n_sub: int | None = None, basis: str = "legendre"
) -> np.ndarray:
    """R = pseudo-inverse of the projection: R @ P = I on polynomials."""
    P = subcell_projection(order, n_sub, basis)
    return np.linalg.pinv(P)


def refine_interpolation(
    order: int, factor: int, basis: str = "legendre"
) -> np.ndarray:
    """``P[k, i, j]`` = coarse basis ``ℓ_j`` evaluated at fine node ``i`` of
    fine subcell ``k`` (``factor`` fine cells per coarse cell).

    Exact polynomial interpolation — prolongation preserves the order of
    the scheme (piecewise-constant upsampling would clip it to 1).
    """
    n = order + 1
    nodes, _ = basis_nodes(n, basis)
    P = np.zeros((factor, n, n))
    for k in range(factor):
        for i, xi in enumerate(nodes):
            P[k, i] = lagrange_eval(nodes, (k + xi) / factor)
    return P


def refine_restriction(
    order: int, factor: int, basis: str = "legendre"
) -> np.ndarray:
    """``R[j, k, i]`` = L2-projection weights of the piecewise fine nodal
    solution onto the coarse basis: ``c_j = Σ_{k,i} R[j,k,i] f_{k,i}``.

    Legendre: with the diagonal Gauss–Legendre mass matrix (the EXACT Gram
    matrix at these orders) this is ``w_i ℓ_j(x_{k,i}) / (factor · w_j)``.
    Lobatto: the lumped mass is not the exact Gram matrix, so the
    collocation-adjoint form would lose ``R·P = I``; instead the exact L2
    projection is assembled with Gauss-Legendre quadrature (degree 2·order
    integrands — exact): ``R = M⁻¹ A`` with ``M`` the exact Gram matrix and
    ``A[j,(k,i)] = (1/factor)∫ ℓ_j((k+ξ)/factor) ℓ_i(ξ) dξ``.

    Either way it is a true projection — ``R · P = I`` (tested) — and
    conserves every moment up to the scheme's order, in particular the
    cell mean (mass): the solvers' lumped cell-mean weights integrate
    degree-``order`` polynomials exactly for both bases.
    """
    n = order + 1
    P = refine_interpolation(order, factor, basis)
    if basis == "legendre":
        _, weights = gauss_legendre(n)
        R = np.zeros((n, factor, n))
        for j in range(n):
            for k in range(factor):
                for i in range(n):
                    R[j, k, i] = (
                        weights[i] * P[k, i, j] / (factor * weights[j])
                    )
        return R
    nodes, _ = basis_nodes(n, basis)
    qx, qw = gauss_legendre(n)  # exact ≤ 2n−1 ≥ 2·order
    E = np.stack([lagrange_eval(nodes, float(x)) for x in qx])  # [q, n]
    M = E.T @ (qw[:, None] * E)  # exact Gram matrix of the basis
    A = np.zeros((n, factor, n))
    for k in range(factor):
        Ec = np.stack(
            [lagrange_eval(nodes, (k + float(x)) / factor) for x in qx]
        )  # coarse basis at subcell-k quadrature points, [q, n]
        A[:, k, :] = Ec.T @ (qw[:, None] * E) / factor
    return np.linalg.solve(M, A.reshape(n, -1)).reshape(n, factor, n)
