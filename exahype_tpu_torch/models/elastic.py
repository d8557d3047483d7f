"""Linear elasticity (velocity–stress form) in the SoA-P layout (PyTorch).

Port of four systems of ``exahype_tpu/models/elastic.py``: the 2-D
homogeneous system (``elastic_flux``, ``elastic_eigenvalue``, ``elastic``,
``plane_p_wave``, ``elastic_free_surface``; ``Q = [v_x, v_y, σ_xx, σ_yy,
σ_xy]``, ``examples/seismic_point_source.py``'s), the 2-D heterogeneous
system (``N_VARS_HET``, ``elastic_het_flux``, ``elastic_het_eigenvalue``,
``elastic_heterogeneous``, ``elastic_free_surface_het``; the 5 wave rows
and ρ, λ, μ per point, frozen), the 3-D homogeneous
system (``N_VARS_3D``, ``elastic3d_flux``, ``elastic3d_eigenvalue``,
``elastic3d``, ``elastic3d_free_surface``, ``plane_p_wave_3d``,
``plane_s_wave_3d``; 9 variables), whose constant materials ρ, λ, μ ride in
the pairs' :class:`~exahype_tpu_torch.models.aderdg.PhysicsTag`, and the
12-variable heterogeneous 3-D system (``_SIG``/``_sig_idx``,
``N_VARS_3D_HET``, ``elastic3d_het_flux``, ``elastic3d_het_eigenvalue``,
``elastic3d_heterogeneous``, ``elastic3d_free_surface_het``), the production
ExaSeis shape: ``Q = [v_x, v_y, v_z, σ_xx, σ_yy, σ_zz, σ_yz, σ_xz, σ_xy, ρ,
λ, μ]`` (Voigt stress ordering) with per-cell materials as frozen variables.
The JAX pair is var-last and reaches the solver through ``wrap_var_last``;
here the pair takes ``(Q, axis, var_axis)`` directly, as
:func:`~exahype_tpu_torch.models.aderdg.euler_physics` does.  The operation
order is the JAX package's, ``-0.0`` included: the het stress rows that do not
involve the normal are ``-z`` for a zero ``z``, the homogeneous ones
``-(0.0 * v_x)``, and the homogeneous velocity rows divide by ρ where the
het ones multiply by 1/ρ.  The CUDA kernels'
``__device__`` version is ``csrc/elastic.cuh``.

Also NumPy copies of the plane waves and ``_speeds`` (the JAX module
loads JAX), the initial state of ``bench.py::bench_ck``, and the absorbing
sponge ``sponge_source`` (``examples/seismic3d_layered.py``'s edges), whose
tag (:class:`SpongeTag`) the CUDA CK predictor reads.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from exahype_tpu_torch.models.aderdg import PhysicsTag, sign_reflect

N_VARS_3D_HET = 12
#: The frozen material slots (ρ, λ, μ) and the dissipation mask the CK
#: configuration of ``bench.py::bench_ck`` gives this system.
MATERIAL_SLOTS = (9, 10, 11)
DISSIPATION_MASK = (1.0,) * 9 + (0.0,) * 3

# σ_ij's Voigt index for (i, j), i <= j.
_SIG = {
    (0, 0): 3, (1, 1): 4, (2, 2): 5, (1, 2): 6, (0, 2): 7, (0, 1): 8,
}


def _sig_idx(i, j):
    return _SIG[(min(i, j), max(i, j))]


def _speeds(rho: float, lam: float, mu: float) -> tuple[float, float]:
    return math.sqrt((lam + 2 * mu) / rho), math.sqrt(mu / rho)


def _v(Q, k: int, va: int):
    return Q[(slice(None),) * va + (k,)]


# --------------------------------------------------- 2-D homogeneous system


def elastic_flux(Q, normal, var_axis, *, rho: float = 1.0, lam: float = 2.0,
                 mu: float = 1.0):
    """The 2-D flux along ``normal`` (the JAX ``elastic_flux``), stacked on
    the var axis."""
    va = var_axis
    vx, vy = _v(Q, 0, va), _v(Q, 1, va)
    sxx, syy, sxy = _v(Q, 2, va), _v(Q, 3, va), _v(Q, 4, va)
    if int(normal) == 0:
        comps = [-sxx / rho, -sxy / rho, -(lam + 2 * mu) * vx, -lam * vx, -mu * vy]
    else:
        comps = [-sxy / rho, -syy / rho, -lam * vy, -(lam + 2 * mu) * vy, -mu * vx]
    return torch.stack(comps, dim=va)


def elastic_eigenvalue(Q, normal, var_axis, *, rho: float = 1.0, lam: float = 2.0,
                       mu: float = 1.0):
    """The P-wave speed c_p on every point (the var axis reduced away)."""
    cp, _ = _speeds(rho, lam, mu)
    shape = Q.shape[:var_axis] + Q.shape[var_axis + 1:]
    return torch.full(shape, cp, dtype=Q.dtype, device=Q.device)


def _tagged(flux_fn, eig_fn, name: str, dim: int, n_vars: int, rho, lam, mu):
    params = (float(rho), float(lam), float(mu))

    def flux(Q, axis, var_axis):
        return flux_fn(Q, axis, var_axis, rho=params[0], lam=params[1], mu=params[2])

    def eig(Q, axis, var_axis):
        return eig_fn(Q, axis, var_axis, rho=params[0], lam=params[1], mu=params[2])

    tag = PhysicsTag(name, dim, n_vars, params)
    flux.physics = tag
    eig.physics = tag
    return flux, eig


def elastic(rho: float = 1.0, lam: float = 2.0, mu: float = 1.0):
    """(flux_fn, max_eigenvalue_fn) for 2-D elasticity, each tagged
    ``.physics = PhysicsTag("elastic", 2, 5, (ρ, λ, μ))``."""
    return _tagged(elastic_flux, elastic_eigenvalue, "elastic", 2, 5, rho, lam, mu)


def plane_p_wave(x, y, t, *, rho: float = 1.0, lam: float = 2.0, mu: float = 1.0,
                 k: float = 2 * np.pi, amplitude: float = 1e-3):
    """Exact P wave travelling in +x, v_x = A sin(k(x − c_p t)): the
    5-variable state on the coordinate arrays (variable axis last, float64
    NumPy)."""
    cp, _ = _speeds(rho, lam, mu)
    vx = amplitude * np.sin(k * (x - cp * t))
    z = np.zeros_like(vx)
    return np.stack([vx, z, -(lam + 2 * mu) / cp * vx, -lam / cp * vx, z], axis=-1)


def elastic_free_surface():
    """Traction-free wall hooks ``(reflect_fn, reflect_flux_fn)`` for the
    2-D system (the JAX ``elastic_free_surface``): the state ghost negates
    σ·n (axis 0: σ_xx, σ_xy; axis 1: σ_yy, σ_xy), the flux ghost the two
    velocity (traction) rows.  Sign tables, which the CUDA face stage
    compiles in."""
    state_signs = [[1.0, 1.0, -1.0, 1.0, -1.0], [1.0, 1.0, 1.0, -1.0, -1.0]]
    flux_signs = [[-1.0, -1.0, 1.0, 1.0, 1.0], [-1.0, -1.0, 1.0, 1.0, 1.0]]
    return sign_reflect(state_signs), sign_reflect(flux_signs)


# ------------------------------------------------ 2-D heterogeneous system

#: The 2-D system with per-cell materials: ``Q = [v_x, v_y, σ_xx, σ_yy,
#: σ_xy, ρ, λ, μ]``, the materials frozen (their flux rows are zero).
N_VARS_HET = 8
#: Its CK configuration (``tests/test_ck.py:139``): the frozen material
#: slots and the dissipation mask.
MATERIAL_SLOTS_HET = (5, 6, 7)
DISSIPATION_MASK_HET = (1.0,) * 5 + (0.0,) * 3


def elastic_het_flux(Q, normal, var_axis):
    """The 2-D flux along ``normal`` with the materials read per point
    (the JAX ``elastic_het_flux``, its operation order), stacked on the var
    axis; the material rows are zero."""
    va = var_axis
    vx, vy = _v(Q, 0, va), _v(Q, 1, va)
    sxx, syy, sxy = _v(Q, 2, va), _v(Q, 3, va), _v(Q, 4, va)
    rho, lam, mu = _v(Q, 5, va), _v(Q, 6, va), _v(Q, 7, va)
    inv_rho = 1.0 / rho
    z = torch.zeros_like(vx)
    if int(normal) == 0:
        comps = [-sxx * inv_rho, -sxy * inv_rho, -(lam + 2 * mu) * vx, -lam * vx, -mu * vy]
    else:
        comps = [-sxy * inv_rho, -syy * inv_rho, -lam * vy, -(lam + 2 * mu) * vy, -mu * vx]
    return torch.stack(comps + [z, z, z], dim=va)


def elastic_het_eigenvalue(Q, normal, var_axis):
    """The P-wave speed √((λ + 2μ)/ρ) of each point (the var axis reduced
    away)."""
    rho, lam, mu = _v(Q, 5, var_axis), _v(Q, 6, var_axis), _v(Q, 7, var_axis)
    return torch.sqrt((lam + 2 * mu) / rho)


def elastic_heterogeneous():
    """(flux_fn, max_eigenvalue_fn) for 2-D elasticity with per-cell
    materials (the JAX ``elastic_heterogeneous``), each tagged
    ``.physics = PhysicsTag("elastic_het", 2, 8)``."""

    def flux(Q, axis, var_axis):
        return elastic_het_flux(Q, axis, var_axis)

    def eig(Q, axis, var_axis):
        return elastic_het_eigenvalue(Q, axis, var_axis)

    tag = PhysicsTag("elastic_het", 2, N_VARS_HET)
    flux.physics = tag
    eig.physics = tag
    return flux, eig


def elastic_free_surface_het():
    """Traction-free wall hooks for the 8-variable system (the JAX
    ``elastic_free_surface_het``): the traction rows as in
    :func:`elastic_free_surface`, the frozen materials mirrored evenly in
    state and flux.  Sign tables, which the CUDA face stage compiles in."""
    even3 = [1.0, 1.0, 1.0]
    state_signs = [[1.0, 1.0, -1.0, 1.0, -1.0] + even3, [1.0, 1.0, 1.0, -1.0, -1.0] + even3]
    flux_signs = [[-1.0, -1.0, 1.0, 1.0, 1.0] + even3] * 2
    return sign_reflect(state_signs), sign_reflect(flux_signs)


# --------------------------------------------------- 3-D homogeneous system

N_VARS_3D = 9


def elastic3d_flux(Q, normal, var_axis, *, rho: float = 1.0, lam: float = 2.0,
                   mu: float = 1.0):
    """The 3-D flux along ``normal`` (the JAX ``elastic3d_flux``), stacked
    on the var axis: the velocity rows −σ_in/ρ, the stress rows in the
    reference's order, ``0.0 * v_x`` terms included."""
    n = int(normal)
    va = var_axis
    v = [_v(Q, i, va) for i in range(3)]
    comps = [None] * N_VARS_3D
    for i in range(3):
        comps[i] = -_v(Q, _sig_idx(i, n), va) / rho
    for i in range(3):
        for j in range(i, 3):
            val = lam * v[n] if i == j else 0.0 * v[0]
            if i == n:
                val = val + mu * v[j] + (mu * v[j] if j == n else 0.0)
            elif j == n:
                val = val + mu * v[i]
            comps[_sig_idx(i, j)] = -val
    return torch.stack(comps, dim=va)


def elastic3d_eigenvalue(Q, normal, var_axis, *, rho: float = 1.0, lam: float = 2.0,
                         mu: float = 1.0):
    """The P-wave speed c_p on every point (the var axis reduced away)."""
    return elastic_eigenvalue(Q, normal, var_axis, rho=rho, lam=lam, mu=mu)


def elastic3d(rho: float = 1.0, lam: float = 2.0, mu: float = 1.0):
    """(flux_fn, max_eigenvalue_fn) for 3-D elasticity, each tagged
    ``.physics = PhysicsTag("elastic3d", 3, 9, (ρ, λ, μ))``."""
    return _tagged(elastic3d_flux, elastic3d_eigenvalue, "elastic3d", 3, N_VARS_3D,
                   rho, lam, mu)


def elastic3d_free_surface():
    """Traction-free wall hooks for the 9-variable system (the JAX
    ``elastic3d_free_surface``): per wall axis n the state ghost negates
    the three σ_in rows, the flux ghost the three velocity rows."""
    state_signs = []
    for n in range(3):
        s = [1.0] * N_VARS_3D
        for i in range(3):
            s[_sig_idx(i, n)] = -1.0
        state_signs.append(s)
    flux_signs = [[-1.0] * 3 + [1.0] * 6 for _ in range(3)]
    return sign_reflect(state_signs), sign_reflect(flux_signs)


def plane_s_wave_3d(x, t, *, rho: float = 1.0, lam: float = 2.0,
                    mu: float = 1.0, k: float = 2 * np.pi,
                    amplitude: float = 1e-3):
    """Exact S wave travelling in +x, polarized in y (v_y, σ_xy only): the
    9-variable state on ``x`` (variable axis last, float64 NumPy)."""
    _, cs = _speeds(rho, lam, mu)
    vy = amplitude * np.sin(k * (x - cs * t))
    z = np.zeros_like(vy)
    return np.stack([z, vy, z, z, z, z, z, z, -mu / cs * vy], axis=-1)


# ------------------------------------------------ 3-D heterogeneous system


def elastic3d_het_flux(Q, normal, var_axis):
    """Flux along ``normal``, stacked on the var axis; the material rows
    are zero."""
    n = int(normal)
    va = var_axis
    v = [_v(Q, i, va) for i in range(3)]
    rho, lam, mu = _v(Q, 9, va), _v(Q, 10, va), _v(Q, 11, va)
    inv_rho = 1.0 / rho
    z = torch.zeros_like(v[0])
    comps = [None] * N_VARS_3D_HET
    for i in range(3):
        comps[i] = -_v(Q, _sig_idx(i, n), va) * inv_rho
    for i in range(3):
        for j in range(i, 3):
            val = lam * v[n] if i == j else z
            if i == n:
                val = val + mu * v[j] + (mu * v[j] if j == n else 0.0)
            elif j == n:
                val = val + mu * v[i]
            comps[_sig_idx(i, j)] = -val
    comps[9] = comps[10] = comps[11] = z
    return torch.stack(comps, dim=va)


def elastic3d_het_eigenvalue(Q, normal, var_axis):
    """The P-wave speed √((λ + 2μ)/ρ) (the var axis is reduced away)."""
    rho, lam, mu = _v(Q, 9, var_axis), _v(Q, 10, var_axis), _v(Q, 11, var_axis)
    return torch.sqrt((lam + 2 * mu) / rho)


def elastic3d_heterogeneous():
    """(flux_fn, max_eigenvalue_fn) for 3-D elasticity with per-cell
    materials, each tagged ``.physics = PhysicsTag("elastic3d_het", 3,
    12)``."""

    def flux(Q, axis, var_axis):
        return elastic3d_het_flux(Q, axis, var_axis)

    def eig(Q, axis, var_axis):
        return elastic3d_het_eigenvalue(Q, axis, var_axis)

    tag = PhysicsTag("elastic3d_het", 3, N_VARS_3D_HET)
    flux.physics = tag
    eig.physics = tag
    return flux, eig


def elastic3d_free_surface_het():
    """Traction-free wall hooks ``(reflect_fn, reflect_flux_fn)`` for the
    12-variable system (the JAX ``elastic3d_free_surface_het``): per wall
    axis n the state ghost negates the three σ_in rows, the flux ghost the
    velocity (traction) rows; the frozen materials mirror evenly.  Sign
    tables (:func:`~exahype_tpu_torch.models.aderdg.sign_reflect`), which
    the CUDA face stage compiles in."""
    state_signs = []
    for n in range(3):
        s = [1.0] * N_VARS_3D_HET
        for i in range(3):
            s[_sig_idx(i, n)] = -1.0
        state_signs.append(s)
    flux_signs = [[-1.0] * 3 + [1.0] * 6 + [1.0] * 3 for _ in range(3)]
    return sign_reflect(state_signs), sign_reflect(flux_signs)


def plane_p_wave_3d(x, t, *, rho: float = 1.0, lam: float = 2.0,
                    mu: float = 1.0, k: float = 2 * np.pi,
                    amplitude: float = 1e-3):
    """Exact P wave travelling in +x; the 9-variable state on the
    coordinate array ``x`` (variable axis last, float64 NumPy)."""
    cp, _ = _speeds(rho, lam, mu)
    vx = amplitude * np.sin(k * (x - cp * t))
    z = np.zeros_like(vx)
    return np.stack(
        [vx, z, z,
         -(lam + 2 * mu) / cp * vx, -lam / cp * vx, -lam / cp * vx,
         z, z, z],
        axis=-1,
    )


def two_layer_state(solver):
    """``bench.py::bench_ck``'s initial state (``bench.py:176-200``) on
    ``solver``'s nodes, float64 NumPy in the SoA-P layout: the plane P wave
    at t = 0 in slots 0–8, and a two-layer medium in slots 9–11 — ρ, λ, μ =
    1.2, 3.0, 1.5 below ``z = g2/(2·g0)`` and 1.0, 2.0, 1.0 above it.
    Returns ``(state, materials)``; ``materials`` is slots 9–11 alone."""
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    coords = solver.nodes_meshgrid()
    X = np.broadcast_to(np.squeeze(coords[0], va), no_var)
    Z = np.broadcast_to(np.squeeze(coords[2], va), no_var)
    wave = np.moveaxis(plane_p_wave_3d(X, 0.0), -1, va)
    grid = solver.grid_shape
    lower = Z < 0.5 * grid[2] / grid[0]
    mat = np.stack([
        np.where(lower, 1.2, 1.0),
        np.where(lower, 3.0, 2.0),
        np.where(lower, 1.5, 1.0),
    ], axis=va)
    return np.concatenate([wave, mat], axis=va), mat


def seismic_energy(Q, var_axis, materials=None):
    """Twice the seismic energy of ``Q`` summed over all nodes (the
    integrity reading of ``bench.py:224-250``): ρ|v|² + σ:S:σ with the
    isotropic compliance, σ:S:σ = [σ:σ − λ/(3λ+2μ)·(tr σ)²]/(2μ), from
    ``materials`` (slots 9–11 of the initial state) or ``Q``'s own.  A 0-d
    tensor in ``Q``'s dtype."""
    va = var_axis
    mats = Q.narrow(va, 9, 3) if materials is None else materials
    rho, lam, mu = (mats.select(va, k) for k in range(3))
    vel, diag, off = Q.narrow(va, 0, 3), Q.narrow(va, 3, 3), Q.narrow(va, 6, 3)
    v2 = torch.sum(rho.unsqueeze(va) * vel**2, dim=va)
    s_dd = torch.sum(diag**2, dim=va) + 2.0 * torch.sum(off**2, dim=va)
    trs = torch.sum(diag, dim=va)
    strain2 = (s_dd - lam / (3 * lam + 2 * mu) * trs**2) / (2.0 * mu)
    return torch.sum(v2 + strain2)


# ---------------------------------------------------------- absorbing edges


@dataclasses.dataclass(frozen=True, eq=False)
class SpongeTag:
    """What a :func:`sponge_source` closure computes, so the CUDA CK
    predictor can compile it in (``models/aderdg_cuda.py``): its
    parameters, and ``sigma``, the damping rate of each cell (float64
    NumPy, the solver's grid shape)."""

    width: float
    rate: float
    axes: tuple
    n_wave: int
    sigma: np.ndarray


def sponge_source(solver, width: float, rate: float, axes=None,
                  n_wave: int | None = None):
    """``source_fn`` damping the wave variables within ``width`` of the
    domain edges along ``axes`` (default: all), with a squared-cosine
    profile peaking at ``rate`` on the boundary: S = −σ(x)·Q on the first
    ``n_wave`` variables (default all), zero on the rest (the JAX
    ``sponge_source``, ``exahype_tpu/models/elastic.py:209-249``).  σ is
    computed per cell in float64 NumPy as the JAX closure computes it and
    cast to the state's dtype; the closure carries ``.sponge``, a
    :class:`SpongeTag`."""
    dim = solver.dim
    if axes is None:
        axes = tuple(range(dim))
    axes = tuple(int(d) for d in axes)
    sigma = np.zeros(solver.grid_shape)
    for d in axes:
        centers = (np.arange(solver.grid_shape[d]) + 0.5) * solver._dxs[d]
        extent = solver.grid_shape[d] * solver._dxs[d]
        edge = np.minimum(centers, extent - centers)
        prof = np.where(edge < width, np.cos(0.5 * np.pi * edge / width) ** 2, 0.0)
        shape = [1] * dim
        shape[d] = solver.grid_shape[d]
        sigma = np.maximum(sigma, prof.reshape(shape))
    sigma = rate * sigma
    nv = solver.n_vars if n_wave is None else int(n_wave)
    mask = np.asarray([1.0] * nv + [0.0] * (solver.n_vars - nv))
    n_vars, grid = solver.n_vars, tuple(solver.grid_shape)
    cache = {}

    def source(q, var_axis):
        # q may carry a leading time-node axis inside the predictor; the
        # trailing grid axes always line up.
        key = (q.dtype, q.device, q.dim(), var_axis)
        if key not in cache:
            s = torch.as_tensor(sigma, dtype=q.dtype, device=q.device)
            mshape = [1] * q.dim()
            mshape[var_axis] = n_vars
            m = torch.as_tensor(mask, dtype=q.dtype, device=q.device).reshape(mshape)
            cache[key] = s.reshape((1,) * (q.dim() - dim) + grid) * m
        return -cache[key] * q

    source.sponge = SpongeTag(float(width), float(rate), axes, nv, sigma)
    return source
