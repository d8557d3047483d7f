"""Curvilinear (mapped) meshes: ADER-DG on smoothly deformed grids (PyTorch).

Port of ``exahype_tpu/models/curvilinear.py``.  The solver stays Cartesian
in reference coordinates ξ and the geometry moves into the physics through
the strong-conservation form ∂t(J q) + ∂_ξk(J a^k_i F_i(q)) = 0, a^k_i =
∂ξ^k/∂x_i: the evolved state is the densitized field Q̃ = J·q, and the
metric terms (J and the dim² entries J·a^k_i) ride as frozen per-node
slots, the heterogeneous-material mechanism (``ck_material_slots`` on the
CK predictor, a zero ``dissipation_mask`` on the faces).

Slot layout: ``[wave (n_wave), J, J·a^0_0 … J·a^0_{dim-1}, J·a^1_0, …]``
(k-major), ``n_wave + 1 + dim²`` variables.

The mapping ``x = mapping(ξ)`` is a torch function of a 1-D tensor of
``dim`` reference coordinates returning ``dim`` values;
:func:`metric_fields` differentiates it in forward mode
(``torch.func.vmap(torch.func.jacfwd(...))``), where the JAX package uses
``jax.vmap(jax.jacfwd(...))``, on the solver's device, with det dx/dξ and
its inverse by cofactors (NumPy's LU in the JAX package: the two agree to
rounding).  :func:`curvilinear_physics` lifts the port's
``(Q, axis, var_axis)`` callbacks; lifting ``models.elastic.elastic``'s pair
gives the pair tagged ``PhysicsTag("curvilinear_elastic", 2, 10, (ρ, λ,
μ))``, which ``models/aderdg_cuda.py`` compiles into the CK kernels
(``csrc/elastic.cuh::CurvilinearElastic``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from exahype_tpu_torch.models.aderdg import PhysicsTag


def n_vars_curvilinear(n_wave: int, dim: int) -> int:
    return n_wave + 1 + dim * dim


def curvilinear_physics(flux: Callable, eig: Callable, dim: int, n_wave: int):
    """Lift the port's ``(flux(Q, axis, var_axis), eig(Q, axis, var_axis))``
    onto the densitized curvilinear state (the JAX ``curvilinear_physics``,
    its operation order): along reference axis k the flux of the wave rows
    is Σ_i J·a^k_i F_i(Q̃_wave / J), zero on the metric rows; the wave speed
    is the Rusanov-safe bound ‖J·a^k‖₂/J · max_i λ_i(q).

    A tagged pair (``.physics``, a :class:`PhysicsTag` ``name``) gives a pair
    tagged ``PhysicsTag("curvilinear_" + name, dim, n_wave + 1 + dim²,
    params)``; an untagged one an untagged pair."""
    n_vars = n_vars_curvilinear(n_wave, dim)

    def cflux(Q, axis, var_axis):
        k = int(axis)
        va = var_axis
        J = Q.narrow(va, n_wave, 1)
        q = Q.narrow(va, 0, n_wave) / J
        rows = None
        for i in range(dim):
            term = Q.narrow(va, n_wave + 1 + k * dim + i, 1) * flux(q, i, va)
            rows = term if rows is None else rows + term
        return torch.cat([rows, torch.zeros_like(Q.narrow(va, n_wave, n_vars - n_wave))],
                         dim=va)

    def ceig(Q, axis, var_axis):
        k = int(axis)
        va = var_axis
        J = Q.select(va, n_wave)
        q = Q.narrow(va, 0, n_wave) / J.unsqueeze(va)
        norm2 = None
        for i in range(dim):
            a = Q.select(va, n_wave + 1 + k * dim + i) / J
            norm2 = a * a if norm2 is None else norm2 + a * a
        lam = eig(q, 0, va)
        for i in range(1, dim):
            lam = torch.maximum(lam, eig(q, i, va))
        return torch.sqrt(norm2) * lam

    base = getattr(flux, "physics", None)
    if base is not None and getattr(eig, "physics", None) == base:
        tag = PhysicsTag(f"curvilinear_{base.name}", int(dim), n_vars, base.params)
        cflux.physics = tag
        ceig.physics = tag
    return cflux, ceig


def curvilinear_dissipation_mask(n_wave: int, dim: int) -> tuple:
    """Freeze the metric slots against the Rusanov jump dissipation."""
    return (1,) * n_wave + (0,) * (1 + dim * dim)


def curvilinear_material_slots(n_wave: int, dim: int) -> tuple:
    """The frozen metric slots, the CK predictor's ``ck_material_slots``."""
    return tuple(range(n_wave, n_wave + 1 + dim * dim))


def hill_mapping(height: float, exp: Callable = torch.exp, sin: Callable = torch.sin):
    """The mapping of ``examples/seismic_topography.py:49-58``: y displaced
    by a Gaussian hill of ``height`` over x = 0.5, tapered to zero at the
    box's edges (so the periodic mesh stays periodic).  ``exp`` and ``sin``
    are the array library's (torch's by default)."""

    def mp(p):
        bump = height * exp(-(((p[0] - 0.5) / 0.15) ** 2))
        taper = sin(np.pi * p[1]) ** 2
        return (p[0], p[1] + bump * taper * (1.0 - p[1]))

    return mp


def _reference_nodes(solver):
    """The solver's reference node coordinates, ``[points, dim]`` float64
    NumPy (the state's layout without its var axis, flattened), and that
    layout's shape."""
    va = solver.var_axis
    no_var = tuple(s for e, s in enumerate(solver.state_shape) if e != va)
    xi = np.stack([np.broadcast_to(np.squeeze(np.asarray(c), va), no_var)
                   for c in solver.nodes_meshgrid()], axis=-1)
    return xi.reshape(-1, solver.dim), no_var


def _mapped(mapping: Callable, xi, device):
    """``(x [points, dim], dx/dξ [points, dim, dim])`` of ``mapping`` at the
    reference points ``xi`` by forward-mode differentiation, float64 tensors
    on ``device``."""
    def fn(p):
        x = mapping(p)
        return x if isinstance(x, torch.Tensor) else torch.stack(list(x))

    pts = torch.as_tensor(np.ascontiguousarray(xi), dtype=torch.float64, device=device)
    return torch.func.vmap(fn)(pts), torch.func.vmap(torch.func.jacfwd(fn))(pts)


def _det_inv(A):
    """det A and A⁻¹ of a batch of 2×2 or 3×3 matrices (cofactors over the
    determinant); raises ``ValueError`` unless det A > 0 everywhere."""
    dim = A.shape[-1]
    a = [[A[:, i, j] for j in range(dim)] for i in range(dim)]
    if dim == 2:
        cof = [[a[1][1], -a[1][0]], [-a[0][1], a[0][0]]]
    else:
        cof = [[a[(i + 1) % 3][(j + 1) % 3] * a[(i + 2) % 3][(j + 2) % 3]
                - a[(i + 1) % 3][(j + 2) % 3] * a[(i + 2) % 3][(j + 1) % 3]
                for j in range(3)] for i in range(3)]
    J = sum(a[0][j] * cof[0][j] for j in range(dim))
    if bool((J <= 0).any()):
        raise ValueError("mapping must be orientation-preserving (det dx/dξ > 0 at every node)")
    inv = torch.stack([torch.stack([cof[j][i] / J for j in range(dim)], -1)
                       for i in range(dim)], -2)
    return J, inv


def _slots(solver, J, Ja, no_var):
    """``[J, J·a^k_i (k-major)]`` stacked on the solver's var axis."""
    dim = solver.dim
    slots = [J.reshape(no_var)] + [np.reshape(Ja[k][i], no_var)
                                   for k in range(dim) for i in range(dim)]
    return np.moveaxis(np.stack(slots, axis=-1), -1, solver.var_axis)


def metric_fields(solver, mapping: Callable):
    """Exact nodal metric slots and physical node coordinates for a smooth
    mapping ``x = mapping(ξ)`` (the JAX ``metric_fields``), the mapping
    differentiated on the solver's device in float64.

    Returns ``(metric, xphys)``: ``metric``, float64 NumPy shaped like the
    solver's state with a var axis of ``1 + dim²``, ``[J, J·a^k_i]`` from
    forward-mode differentiation of the mapping at every node; ``xphys``,
    ``dim`` arrays (var axis squeezed) of the physical node coordinates.
    Raises ``ValueError`` unless det dx/dξ > 0 at every node."""
    dim = solver.dim
    xi, no_var = _reference_nodes(solver)
    x, A = _mapped(mapping, xi, solver.weights.device)
    J, Ainv = _det_inv(A)  # Ainv[points, k, i] = ∂ξ^k/∂x_i
    Ja = [[(J * Ainv[:, k, i]).cpu().numpy() for i in range(dim)] for k in range(dim)]
    x = x.cpu().numpy()
    return (_slots(solver, J.cpu().numpy(), Ja, no_var),
            [x[:, d].reshape(no_var) for d in range(dim)])


def metric_fields_curl(solver, mapping: Callable):
    """Kopriva's conservative curl-form metric slots (the JAX
    ``metric_fields_curl``): the same contract as :func:`metric_fields`, the
    entries J·a^k_i from the curl form evaluated with the solver's own
    collocation derivative D (2-D: Ja¹ = (D₂x₂, −D₂x₁), Ja² = (−D₁x₂,
    D₁x₁); 3-D: Ja^n_i = ½ ε_ijm [D_p(x_j D_q x_m) − D_q(x_j D_p x_m)]), so
    the discrete metric identity Σ_k D_k(J a^k_i) = 0 holds to rounding in
    each cell; J stays the exact pointwise Jacobian."""
    dim = solver.dim
    xi, no_var = _reference_nodes(solver)
    x_flat, A = _mapped(mapping, xi, solver.weights.device)
    J = _det_inv(A)[0].cpu().numpy()
    x_flat = x_flat.cpu().numpy()
    x = [x_flat[:, m].reshape(no_var) for m in range(dim)]
    D = np.asarray(solver.ops.D)
    dxs = solver._dxs

    def dref(f, q):
        out = np.tensordot(D, np.moveaxis(f, q, 0), axes=([1], [0]))
        return np.moveaxis(out, 0, q) / float(dxs[q])

    if dim == 2:
        Ja = [[dref(x[1], 1), -dref(x[0], 1)], [-dref(x[1], 0), dref(x[0], 0)]]
    elif dim == 3:
        eps = np.zeros((3, 3, 3))
        for i, j, m in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            eps[i, j, m] = 1.0
            eps[i, m, j] = -1.0
        dx = [[dref(x[m], q) for m in range(3)] for q in range(3)]
        Ja = []
        for n in range(3):
            p, q = (n + 1) % 3, (n + 2) % 3
            row = []
            for i in range(3):
                acc = 0.0
                for j in range(3):
                    for m in range(3):
                        e = eps[i, j, m]
                        if e == 0.0:
                            continue
                        acc = acc + 0.5 * e * (dref(x[j] * dx[q][m], p)
                                               - dref(x[j] * dx[p][m], q))
                row.append(acc)
            Ja.append(row)
    else:
        raise ValueError("curl-form metrics are defined for dim in (2, 3)")
    return _slots(solver, J, Ja, no_var), [x_flat[:, d].reshape(no_var) for d in range(dim)]


def densitize(q_wave, metric, var_axis: int):
    """The solver state from the physical wave variables and the metric
    slots, ``Q̃ = [J·q, J, J·a…]`` along ``var_axis`` (a tensor of
    ``q_wave``'s dtype and device; NumPy inputs are taken as tensors)."""
    q = torch.as_tensor(q_wave)
    m = torch.as_tensor(metric, device=q.device).to(q.dtype)
    return torch.cat([q * m.narrow(var_axis, 0, 1), m], dim=var_axis)


def undensitize(Q, n_wave: int, var_axis: int):
    """The physical wave variables q = Q̃_wave / J of a solver state."""
    Q = torch.as_tensor(Q)
    return Q.narrow(var_axis, 0, n_wave) / Q.narrow(var_axis, n_wave, 1)
