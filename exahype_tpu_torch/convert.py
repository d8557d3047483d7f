"""Carry configurations and states between the JAX package and the port.

The JAX side's "parameters" are the solver configuration and the state
array; both cross as plain numbers and NumPy arrays, so this module needs
no JAX import of its own.  Every function here puts its tensors on the CUDA
card unless given ``device`` (``device="cpu"`` for the CPU), and raises
where there is no card.
"""

from __future__ import annotations

import numpy as np
import torch

from exahype_tpu_torch.models.aderdg import (
    CALLBACK_OPTIONS,
    PORTED_OPTIONS,
    UNPORTED_OPTIONS,
    VISCOUS_OPTIONS,
    WALL_HOOKS,
    ADERDGSolver,
    euler_physics,
    euler_reflect,
    euler_reflect_flux,
)
from exahype_tpu_torch.models.curvilinear import curvilinear_physics, n_vars_curvilinear
from exahype_tpu_torch.models.elastic import (
    elastic,
    elastic3d,
    elastic3d_free_surface,
    elastic3d_free_surface_het,
    elastic3d_heterogeneous,
    elastic_free_surface,
    elastic_free_surface_het,
    elastic_heterogeneous,
    sponge_source,
)
from exahype_tpu_torch.models.navier_stokes import (
    navier_stokes,
    noslip_reflect,
    noslip_reflect_flux,
)
from exahype_tpu_torch.utils.device import resolve_device
from exahype_tpu_torch.utils.errors import SemanticError


_CALLBACKS = ("flux_fn", "max_eigenvalue_fn", *VISCOUS_OPTIONS)


#: The elastic systems whose constants the caller names (the homogeneous
#: ones and the curvilinear lift of the 2-D one): (dimension, variables,
#: the pair's maker).
_ELASTIC = {
    "elastic": (2, 5, elastic),
    "elastic3d": (3, 9, elastic3d),
    "curvilinear_elastic": (2, n_vars_curvilinear(5, 2),
                            lambda **mat: curvilinear_physics(*elastic(**mat), dim=2, n_wave=5)),
}
#: The heterogeneous elastic systems: their materials ride in the state.
_ELASTIC_HET = {"elastic3d_het": elastic3d_heterogeneous, "elastic_het": elastic_heterogeneous}
_PHYSICS_NAMES = ("'euler', 'navier_stokes', 'elastic', 'elastic3d', 'curvilinear_elastic', "
                  "'elastic_het', 'elastic3d_het'")


def _physics_callbacks(physics, gamma, mu, prandtl, dim: int, n_vars: int,
                       rho=None, lam=None) -> dict:
    """The port's physics callbacks named by ``physics``, by option name:
    the flux and eigenvalue, and for Navier–Stokes (or a 4-tuple) the
    viscous pair too."""
    if isinstance(physics, str) and physics in _ELASTIC:
        if gamma is not None or prandtl is not None or None in (rho, lam, mu):
            raise SemanticError(
                f"physics={physics!r} takes its material constants rho, lam and mu "
                "(the JAX pair is opaque), and no gamma or prandtl"
            )
        want_dim, want_vars, make = _ELASTIC[physics]
        if (dim, n_vars) != (want_dim, want_vars):
            raise SemanticError(
                f"physics={physics!r} is the {want_dim}-D system of {want_vars} "
                f"variables, got dim={dim}, n_vars={n_vars}"
            )
        return dict(zip(_CALLBACKS, make(rho=rho, lam=lam, mu=mu)))
    if rho is not None or lam is not None:
        raise SemanticError("rho and lam apply to physics='elastic', 'elastic3d' and "
                            "'curvilinear_elastic' only")
    if (mu is not None or prandtl is not None) and physics != "navier_stokes":
        raise SemanticError(
            "mu and prandtl apply to physics='navier_stokes' only (mu also to "
            "'elastic', 'elastic3d' and 'curvilinear_elastic', as the Lamé constant)"
        )
    if physics in ("euler", "navier_stokes"):
        if gamma is None:
            raise SemanticError(f"physics={physics!r} needs gamma")
        if physics == "euler":
            return dict(zip(_CALLBACKS, euler_physics(dim, n_real=n_vars, gamma=gamma)))
        if mu is None or prandtl is None or n_vars != dim + 2:
            raise SemanticError(
                "physics='navier_stokes' needs mu and prandtl (the JAX callbacks "
                f"are opaque) and dim + 2 variables, got n_vars={n_vars}"
            )
        return dict(zip(_CALLBACKS, navier_stokes(dim, mu=mu, prandtl=prandtl, gamma=gamma)))
    if gamma is not None:
        raise SemanticError("gamma applies to physics='euler' and 'navier_stokes' only")
    if isinstance(physics, tuple) and len(physics) in (2, 4):
        return dict(zip(_CALLBACKS, physics))
    if isinstance(physics, str) and physics in _ELASTIC_HET:
        pair = _ELASTIC_HET[physics]()
        tag = pair[0].physics
        if (dim, n_vars) != (tag.dim, tag.n_real):
            raise SemanticError(
                f"physics={physics!r} is the {tag.dim}-D system of {tag.n_real} "
                f"variables, got dim={dim}, n_vars={n_vars}"
            )
        return dict(zip(_CALLBACKS, pair))
    raise SemanticError(
        f"physics must be {_PHYSICS_NAMES}, a (flux_fn, max_eigenvalue_fn) pair or a (flux_fn, "
        f"max_eigenvalue_fn, visc_flux_fn, visc_eigenvalue_fn) 4-tuple, got {physics!r}"
    )


def _probe(name, dim: int, n_vars: int, var_axis: int):
    """A seeded float64 probe state that the physics ``name`` admits, in a
    layout of ``dim`` node axes, the var axis at ``var_axis`` and ``dim``
    grid axes (2 nodes and 3 cells an axis): positive density and pressure
    for Euler and Navier–Stokes, positive materials for the heterogeneous
    elasticity, J > 0 for a curvilinear lift (its J·a^k_i near J δ_ki);
    seeded normal values otherwise."""
    rng = np.random.default_rng(12)
    lead = (2,) * dim + (3,) * dim
    rows = [rng.standard_normal(lead) for _ in range(n_vars)]
    if name in ("euler", "navier_stokes") and n_vars >= dim + 2:
        rho = 1.0 + 0.5 * rng.random(lead)
        mom = [0.5 * rng.standard_normal(lead) for _ in range(dim)]
        kinetic = 0.5 * sum(m * m for m in mom) / rho
        rows[:dim + 2] = [rho, *mom, kinetic + 2.5 * (1.0 + rng.random(lead))]
    elif name in _ELASTIC_HET:
        first = n_vars - 3
        rows[first:] = [1.0 + rng.random(lead), 1.0 + 2.0 * rng.random(lead),
                        0.5 + rng.random(lead)]
    elif isinstance(name, str) and name.startswith("curvilinear_"):
        first = n_vars - 1 - dim * dim
        J = 0.8 + 0.4 * rng.random(lead)
        rows[first] = J
        for k in range(dim):
            for i in range(dim):
                rows[first + 1 + k * dim + i] = (J if k == i else 0.0) + 0.2 * rng.standard_normal(
                    lead)
    q = np.stack(rows, axis=0)
    return np.ascontiguousarray(np.moveaxis(q, 0, var_axis))


def _check_against_jax(what: str, fn_jax, fn_port, args_np, args_port, physics, *,
                       bar: float | None = None,
                       hint: str = "name the constants the JAX callbacks were built with"):
    """Raise ``SemanticError`` unless the port's ``fn_port(*args_port)`` and
    the JAX ``fn_jax(*args_np)`` agree to ``bar`` (by default a few
    roundings in the JAX value's precision) times the larger of 1 and the
    JAX value's largest magnitude; the error names ``physics`` and says
    ``hint``."""
    want = np.asarray(fn_jax(*args_np))
    got = fn_port(*args_port)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float("inf")
    if want.shape == got.shape:
        err = float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)), initial=0.0))
    eps = np.finfo(want.dtype if np.issubdtype(want.dtype, np.floating) else np.float64).eps
    bar = 16 * eps if bar is None else max(bar, 16 * eps)
    if not err <= bar * max(1.0, float(np.max(np.abs(want), initial=0.0))):
        name = physics if isinstance(physics, str) else "the port pair"
        raise SemanticError(
            f"physics={name!r} does not reproduce the JAX solver's {what} on a probe "
            f"state (max difference {err!r}; shapes {got.shape} and {want.shape}): {hint}"
        )


def _check_callbacks(jax_solver, callbacks: dict, physics, reflect=None):
    """Evaluate the JAX solver's callbacks and the port's on one probe state
    (:func:`_probe`) for every axis's normal, in float64: the flux and the
    wave speed, the viscous pair where the JAX solver carries one, and the
    named reflect pair ``reflect`` against the JAX ``reflect_fn`` and
    ``reflect_flux_fn``."""
    dim, va = jax_solver.dim, jax_solver.var_axis
    tag = getattr(callbacks["flux_fn"], "physics", None)
    name = tag.name if tag is not None else physics
    probe = _probe(name, dim, jax_solver.n_vars, va)
    grads = tuple(np.random.default_rng(13 + e).standard_normal(probe.shape) for e in range(dim))
    tp, tg = torch.from_numpy(probe), tuple(torch.from_numpy(g) for g in grads)
    pairs = [("flux_fn", (probe,), (tp,)), ("max_eigenvalue_fn", (probe,), (tp,))]
    if getattr(jax_solver, "visc_flux_fn", None) is not None:
        pairs += [("visc_flux_fn", (probe, grads), (tp, tg)),
                  ("visc_eigenvalue_fn", (probe,), (tp,))]
    for option, args_np, args_port in pairs:
        for d in range(dim):
            _check_against_jax(f"{option} along axis {d}", getattr(jax_solver, option),
                               callbacks[option], args_np + (d, va), args_port + (d, va), physics)
    if reflect is not None:
        for option, fn in zip(("reflect_fn", "reflect_flux_fn"), reflect):
            for d in range(dim):
                _check_against_jax(f"{option} along axis {d}", getattr(jax_solver, option), fn,
                                   (probe, d, va), (tp, d, va), physics)


#: The Z4 check's bar, relative to max(1, max|JAX|) in float64.  The port's
#: solver takes the ``impl="soa"`` callbacks whatever the JAX solver's
#: ``impl``, and the einsum and soa algebras agree to ~1e-13, not to a few
#: roundings (ROADMAP.md, Queue 3's converter caveat), so the bar of
#: :func:`_check_against_jax` is too tight here; a mis-named parameter moves
#: the probe's values by 1e-3 or more.
_Z4_BAR = 1e-12


def _z4_probe(n_vars: int, dim: int, var_axis: int):
    """A seeded float64 probe state of a Z4 system of ``n_vars`` variables
    and one seeded gradient an axis, in :func:`_probe`'s layout: the lapse
    off 1 (0.7 to 1.3), the metric δ_ij plus noise (positive definite),
    Θ, Z_i and every other Z4 slot (and the shifted system's β, B, b)
    noise; over it an admissible fluid (ρ, p > 0, v subluminal) and, for
    Z4+GRMHD, a field that is nowhere zero and ψ ≠ 0, so that each of the
    system's parameters moves the callbacks' values."""
    from exahype_tpu_torch.models.z4 import N_VARS as N_Z4
    from exahype_tpu_torch.models.z4_grmhd import N_VARS as N_GRMHD
    from exahype_tpu_torch.models.z4_grmhd import pack_matter_mhd
    from exahype_tpu_torch.models.z4_matter import N_VARS as N_GRHD
    from exahype_tpu_torch.models.z4_matter import pack_matter

    rng = np.random.default_rng(14)
    lead = (2,) * dim + (3,) * dim
    q = 0.1 * rng.standard_normal(lead + (n_vars,))
    q[..., 0] = 1.0 + 0.3 * rng.uniform(-1.0, 1.0, lead)
    q[..., [1, 4, 6]] += 1.0
    if n_vars in (N_GRHD, N_GRMHD):
        z4 = torch.from_numpy(q[..., :N_Z4])
        rho = torch.from_numpy(0.5 + 0.5 * rng.random(lead))
        p = torch.from_numpy(0.2 + 0.3 * rng.random(lead))
        v = torch.from_numpy(0.1 * rng.standard_normal(lead + (3,)))
        if n_vars == N_GRHD:
            q = pack_matter(z4, rho, v, p).numpy()
        else:
            sign = np.where(rng.random(lead + (4,)) < 0.5, -1.0, 1.0)
            mag = sign * (0.2 + 0.3 * rng.random(lead + (4,)))
            q = pack_matter_mhd(z4, rho, v, p, torch.from_numpy(mag[..., :3]),
                                psi_glm=torch.from_numpy(mag[..., 3])).numpy()
    grads = [0.1 * rng.standard_normal(lead + (n_vars,)) for _ in range(dim)]
    return tuple(np.ascontiguousarray(np.moveaxis(x, -1, var_axis)) for x in (q, *grads))


def _check_z4(jax_solver, solver, name: str, params: dict):
    """Evaluate the JAX Z4 solver's callbacks and the port's ``solver``'s
    on one probe state (:func:`_z4_probe`), in float64, to ``_Z4_BAR``:
    ``source_fn``, each axis's ``ncp_fn`` at a seeded gradient, flux and
    wave speed, and ``rhs_all_fn`` where the JAX solver sets one (the
    function a ``PallasRHS`` wraps); a mismatch raises ``SemanticError``
    naming ``params``."""
    dim, va = jax_solver.dim, jax_solver.var_axis
    q, *grads = _z4_probe(jax_solver.n_vars, dim, va)
    tq, tg = torch.from_numpy(q), [torch.from_numpy(g) for g in grads]
    checks = [("source_fn", jax_solver.source_fn, solver.source_fn, (q, va), (tq, va))]
    for d in range(dim):
        checks += [
            (f"ncp_fn along axis {d}", jax_solver.ncp_fn, solver.ncp_fn, (q, grads[d], d, va),
             (tq, tg[d], d, va)),
            *((f"{option} along axis {d}", getattr(jax_solver, option), getattr(solver, option),
               (q, d, va), (tq, d, va)) for option in ("flux_fn", "max_eigenvalue_fn")),
        ]
    rhs = jax_solver.rhs_all_fn
    if rhs is not None:
        rhs = rhs.inner if type(rhs).__name__ == "PallasRHS" else rhs
        checks.append(("rhs_all_fn", rhs, solver.rhs_all_fn, (q, tuple(grads), va),
                       (tq, tuple(tg), va)))
    named = ", ".join(f"{key}={value!r}" for key, value in params.items())
    for what, fn_jax, fn_port, args_np, args_port in checks:
        _check_against_jax(what, fn_jax, fn_port, args_np, args_port, name, bar=_Z4_BAR,
                           hint=f"the parameters named ({named}) are not the JAX solver's: "
                                "name the ones it was built with")


def _reflect_pair(walls, n_vars: int, dim: int):
    """The port's (reflect_fn, reflect_flux_fn) named by ``walls``."""
    if walls == "euler":
        return euler_reflect(dim, n_vars), euler_reflect_flux(dim, n_vars)
    if walls == "elastic3d_het_free_surface":
        return elastic3d_free_surface_het()
    if walls == "elastic_free_surface":
        return elastic_free_surface()
    if walls == "elastic_free_surface_het":
        return elastic_free_surface_het()
    if walls == "elastic3d_free_surface":
        return elastic3d_free_surface()
    if walls == "noslip":
        return noslip_reflect(dim), noslip_reflect_flux(dim)
    if isinstance(walls, tuple) and len(walls) == 2:
        return walls
    raise SemanticError(
        "walls must be 'euler', 'elastic_free_surface', 'elastic_free_surface_het', "
        "'elastic3d_free_surface', 'elastic3d_het_free_surface', 'noslip' or a (reflect_fn, "
        "reflect_flux_fn) "
        f"pair of the port's, got {walls!r}"
    )


def _dirichlet_rows(jax_solver):
    """The JAX solver's Dirichlet ghost rows as data: ``dirichlet_fn(d,
    side)`` of every wall, taken once as NumPy, behind a port
    ``dirichlet_fn`` that keeps the JAX function's ``basis`` stamp."""
    rows = {
        (d, side): np.asarray(jax_solver.dirichlet_fn(d, side))
        for d in range(jax_solver.dim) if jax_solver.is_wall(d)
        for side in (0, 1)
    }

    def dirichlet_fn(axis, side):
        return rows[(int(axis), int(side))]

    basis = getattr(jax_solver.dirichlet_fn, "basis", None)
    if basis is not None:
        dirichlet_fn.basis = basis
    return dirichlet_fn


def _options_from_jax(jax_solver, walls):
    """The JAX solver's option fields as the port's keyword options: the
    callbacks left out (the caller has checked them), the wall hooks
    replaced by the port's (outflow and farfield install their own; the
    Dirichlet rows cross as data; the reflect pair is named by ``walls``)."""
    options = {
        name: getattr(jax_solver, name)
        for name in (*UNPORTED_OPTIONS, *PORTED_OPTIONS)
        if name not in (*CALLBACK_OPTIONS, *VISCOUS_OPTIONS, *WALL_HOOKS)
    }
    boundary = jax_solver.boundary
    if walls is not None and boundary != "reflective":
        raise SemanticError(
            f"walls= names the reflect hooks of a reflective solver; this one's "
            f"boundary is {boundary!r}"
        )
    if boundary == "reflective":
        if walls is None:
            raise SemanticError(
                "the JAX solver's reflect_fn/reflect_flux_fn are JAX functions the "
                "port cannot call: name the port's pair with walls='euler', "
                "'elastic_free_surface', 'elastic_free_surface_het', 'elastic3d_free_surface', "
                "'elastic3d_het_free_surface', 'noslip' or (reflect_fn, reflect_flux_fn)"
            )
        options["reflect_fn"], options["reflect_flux_fn"] = _reflect_pair(
            walls, jax_solver.n_vars, jax_solver.dim)
    if boundary == "dirichlet":
        options["dirichlet_fn"] = _dirichlet_rows(jax_solver)
    return options


def _sponge_from_jax(jax_solver, solver, sponge: dict):
    """The port's :func:`sponge_source` for ``solver`` with the parameters
    ``sponge`` (``width``, ``rate``, ``axes``, ``n_wave``), checked against
    the JAX solver's ``source_fn`` on one probe state (seeded noise,
    float64): raises if they differ by more than a few roundings."""
    port = sponge_source(solver, **sponge)
    va = jax_solver.var_axis
    probe = np.random.default_rng(0).standard_normal(tuple(jax_solver.state_shape))
    want = np.asarray(jax_solver.source_fn(probe, va), dtype=np.float64)
    got = port(torch.from_numpy(probe), va).numpy()
    err = float(np.max(np.abs(got - want)))
    if not err <= 4 * np.finfo(np.float64).eps * max(1.0, float(np.max(np.abs(want)))):
        raise SemanticError(
            f"sponge={sponge!r} does not reproduce the JAX solver's source_fn (max "
            f"difference {err!r} on a probe state): name the parameters its "
            "sponge_source was built with"
        )
    return port


def aderdg_from_jax(jax_solver, *, gamma: float | None = None,
                    physics="euler", walls=None, mu: float | None = None,
                    prandtl: float | None = None, sponge: dict | None = None,
                    rho: float | None = None, lam: float | None = None, device=None,
                    dtype: torch.dtype = torch.float64):
    """The port's :class:`ADERDGSolver` for a JAX ``ADERDGSolver``, and
    :class:`~exahype_tpu_torch.models.aderdg_cuda.CudaADERDG` over it for a
    JAX ``PallasADERDG`` (the fused TPU kernel) over one.

    ``PallasADERDG``'s TPU knobs have no counterpart and are not read:
    ``tile0`` and ``vmem_limit_bytes`` (the VMEM tiling), ``picard_loop`` and
    ``slice_loop`` (Mosaic code-size workarounds at orders 5 and 7),
    ``interpret`` and ``dtype`` (the state's dtype is ``dtype`` here), and
    ``boundary_faces_only``; the kernels compute the same step.  Which
    (physics, dim, order) the kernels take is ``CudaADERDG``'s check.

    Reads the JAX solver's numeric fields (``dim``, ``order``, ``n_vars``,
    ``grid_shape``, ``dx``, ``basis``, ``picard_iters``) and its option
    fields (``predictor_mode``, ``ck_material_slots``, ``dissipation_mask``,
    ``boundary``, ``farfield_state`` and ``wall_axes`` carry over; an
    option the port does not carry yet raises ``SemanticError``).  The JAX
    physics callbacks are opaque, so the caller names the physics:
    ``"euler"`` with ``gamma`` (the default), ``"navier_stokes"`` with
    ``gamma``, ``mu`` and ``prandtl``
    (:func:`~exahype_tpu_torch.models.navier_stokes.navier_stokes`, the four
    callbacks of a viscous solver), ``"elastic"`` or ``"elastic3d"`` with
    the material constants ``rho``, ``lam`` and ``mu`` (the homogeneous 2-D
    and 3-D systems, :func:`~exahype_tpu_torch.models.elastic.elastic` and
    :func:`~exahype_tpu_torch.models.elastic.elastic3d`),
    ``"curvilinear_elastic"`` with ``rho``, ``lam``, ``mu`` (the curvilinear
    lift of the 2-D ``elastic`` pair over its 5 wave rows,
    :func:`~exahype_tpu_torch.models.curvilinear.curvilinear_physics`, 10
    variables), ``"elastic_het"`` and ``"elastic3d_het"`` (the 2-D and 3-D
    heterogeneous systems, whose materials ride in the state), or a
    (flux_fn, max_eigenvalue_fn) pair or (…, visc_flux_fn,
    visc_eigenvalue_fn) 4-tuple of the port's.

    The named pair is checked against the JAX solver's: both evaluate one
    seeded float64 probe state that the physics admits (positive density
    and pressure, positive materials, J > 0) along every axis's normal, the
    flux and the wave speed, the viscous pair where the JAX solver has one,
    and a reflective solver's named reflect pair against its ``reflect_fn``
    and ``reflect_flux_fn``; a difference beyond a few roundings (a wrong
    constant, another system) raises ``SemanticError``.  A JAX solver with
    ``source_fn``, ``ncp_fn`` or ``rhs_all_fn`` set raises ``SemanticError``
    (those are JAX functions; the Z4 systems cross through
    :func:`z4_solver_from_jax`, :func:`z4_shift_solver_from_jax`,
    :func:`z4_matter_solver_from_jax` and :func:`z4_grmhd_solver_from_jax`);
    so does one whose viscous callbacks the named physics does not replace,
    or the other way round.

    Walls: outflow and farfield need nothing more; a Dirichlet solver's
    rows cross as data (``dirichlet_fn(d, side)`` of each wall, as NumPy,
    with its ``basis`` stamp); a reflective solver's hooks are JAX
    functions, so the caller names them with ``walls``: ``"euler"``
    (:func:`~exahype_tpu_torch.models.aderdg.euler_reflect` and
    ``euler_reflect_flux``), ``"elastic_free_surface"``,
    ``"elastic3d_free_surface"``, ``"elastic3d_het_free_surface"`` (the
    traction-free walls of :mod:`~exahype_tpu_torch.models.elastic`;
    ``"elastic_free_surface_het"``, the 8-variable system's),
    ``"noslip"`` (:func:`~exahype_tpu_torch.models.navier_stokes.noslip_reflect`
    and ``noslip_reflect_flux``) or a (reflect_fn, reflect_flux_fn) pair of
    the port's.

    A JAX ``source_fn`` made by ``exahype_tpu.models.elastic.sponge_source``
    crosses when ``sponge`` names its parameters (``dict(width=..., rate=...,
    axes=..., n_wave=...)``; the JAX closure carries none): the port's
    :func:`~exahype_tpu_torch.models.elastic.sponge_source` is built with
    them on the port's solver and checked against the JAX closure on one
    probe state, and a mismatch raises ``SemanticError``.
    """
    if type(jax_solver).__name__ == "PallasADERDG":
        from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

        return CudaADERDG(aderdg_from_jax(
            jax_solver.solver, gamma=gamma, physics=physics, walls=walls, mu=mu,
            prandtl=prandtl, sponge=sponge, rho=rho, lam=lam, device=device,
            dtype=dtype))
    callbacks = _physics_callbacks(physics, gamma, mu, prandtl, jax_solver.dim,
                                   jax_solver.n_vars, rho, lam)
    if sponge is not None and jax_solver.source_fn is None:
        raise SemanticError("sponge= names a JAX solver's sponge_source, and this one has "
                            "no source_fn")
    for name in CALLBACK_OPTIONS:
        if getattr(jax_solver, name) is not None and not (
                name == "source_fn" and sponge is not None):
            raise SemanticError(
                f"the JAX solver's {name} is a JAX function the port cannot "
                "call; for the Z4 systems use z4_solver_from_jax, z4_shift_solver_from_jax, "
                "z4_matter_solver_from_jax or z4_grmhd_solver_from_jax"
            )
    viscous = getattr(jax_solver, "visc_flux_fn", None) is not None
    if viscous != ("visc_flux_fn" in callbacks):
        raise SemanticError(
            "the JAX solver's viscous callbacks are JAX functions the port cannot "
            "call: a viscous solver crosses with physics='navier_stokes' (and mu, "
            "prandtl, gamma) or a port 4-tuple, and only a viscous one does (see "
            "ROADMAP.md, Queue 1, done: item 3, the viscous fluxes)"
        )
    options = _options_from_jax(jax_solver, walls)
    reflect = options.get("reflect_fn"), options.get("reflect_flux_fn")
    _check_callbacks(jax_solver, callbacks, physics,
                     reflect if jax_solver.boundary == "reflective" else None)
    solver = ADERDGSolver(
        dim=jax_solver.dim,
        order=jax_solver.order,
        n_vars=jax_solver.n_vars,
        grid_shape=tuple(jax_solver.grid_shape),
        **callbacks,
        dx=jax_solver.dx,
        picard_iters=jax_solver.picard_iters,
        basis=jax_solver.basis,
        device=device,
        dtype=dtype,
        **options,
    )
    if sponge is not None:
        solver.source_fn = _sponge_from_jax(jax_solver, solver, sponge)
    return solver


def point_sources_from_jax(jax_sources, solver, *, f0: float, t_delay: float | None = None):
    """The port's :class:`~exahype_tpu_torch.models.point_source.PointSources`
    on ``solver`` (a port solver) for a JAX ``PointSources`` whose wavelet
    is ``ricker(f0, t_delay)``: its positions and amplitudes cross as
    NumPy, the wavelet by its parameters (the JAX function is opaque), and
    the two wavelets are compared at 33 times over [0, 4/f0]; a mismatch
    raises ``SemanticError``."""
    from exahype_tpu_torch.models.point_source import PointSources, ricker

    psi = ricker(f0, t_delay)
    t = np.linspace(0.0, 4.0 / f0, 33)
    want = np.asarray(jax_sources.wavelet(t), dtype=np.float64)
    got = psi(torch.from_numpy(t)).numpy()
    if not np.allclose(got, want, rtol=0, atol=1e-13):
        raise SemanticError(
            f"ricker(f0={f0!r}, t_delay={t_delay!r}) does not reproduce the JAX "
            "PointSources' wavelet: name its parameters"
        )
    return PointSources(solver, np.asarray(jax_sources.positions),
                        np.asarray(jax_sources.amplitudes), psi)


def limited_from_jax(jax_limited, *, gamma: float, walls=None, physics="euler",
                     mu: float | None = None, prandtl: float | None = None, device=None,
                     dtype: torch.dtype = torch.float64, **system):
    """The port's :class:`LimitedADERDG` for a JAX ``LimitedADERDG``, 2-D or
    3-D, periodic or walled, inviscid or viscous, or over the coupled
    Z4+GRHD system.

    Builds the base solver through :func:`aderdg_from_jax` (a reflective
    solver's hooks named by ``walls``, e.g. ``"euler"`` or ``"noslip"``;
    outflow, farfield and Dirichlet walls need nothing more, the Dirichlet
    rows cross as data; a viscous solver's physics named by ``physics=
    "navier_stokes"`` with ``mu`` and ``prandtl``) and reads the limiter's
    numbers and options (``dmp_delta0``, ``dmp_eps``, ``fallback``,
    ``fallback_order``, ``fallback_slope``, ``troubled_capacity``,
    ``troubled_granularity``, ``overflow_fallback``, ``post_step_guard``).
    ``physics="z4_matter"`` builds the base solver through
    :func:`z4_matter_solver_from_jax` with ``gamma`` and the system's other
    parameters given as keywords (``iters``, ``slicing``, ``f``, ``m``,
    ``kappa1``, ``kappa2``).  The JAX ``admissible`` callback is opaque:
    where it is set, the port's :func:`euler_admissible` with ``gamma``
    takes its place, or over Z4+GRHD
    :func:`~exahype_tpu_torch.models.z4_matter.z4_matter_admissible` with
    ``gamma`` and ``iters``.  A JAX ``PallasADERDG`` accelerator maps to
    :class:`CudaADERDG`, and ``subcell_pallas=True`` to
    ``subcell_cuda=True``.  An option outside the ported configurations
    raises ``SemanticError``; the JAX limiter's own errors are raised as it
    raises them.
    """
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.limiter import LimitedADERDG, euler_admissible

    if physics == "z4_matter":
        from exahype_tpu_torch.models.z4_matter import z4_matter_admissible

        if walls is not None or mu is not None or prandtl is not None:
            raise SemanticError("the Z4+GRHD system crosses periodic and inviscid only")
        solver = z4_matter_solver_from_jax(jax_limited.solver, gamma=gamma, device=device,
                                           dtype=dtype, **system)
        admissible = None
        if jax_limited.admissible is not None:
            admissible = z4_matter_admissible(gamma=gamma, iters=system.get("iters", 10))
    else:
        if system:
            raise SemanticError(f"{sorted(system)} are parameters of physics='z4_matter'")
        solver = aderdg_from_jax(jax_limited.solver, gamma=gamma, walls=walls, physics=physics,
                                 mu=mu, prandtl=prandtl, device=device, dtype=dtype)
        admissible = None
        if jax_limited.admissible is not None:
            admissible = euler_admissible(solver.dim, gamma=gamma)
    accelerator = None
    if jax_limited.accelerator is not None:
        accelerator = CudaADERDG(solver)
    return LimitedADERDG(
        solver,
        admissible,
        dmp_delta0=jax_limited.dmp_delta0,
        dmp_eps=jax_limited.dmp_eps,
        fallback=jax_limited.fallback,
        fallback_order=jax_limited.fallback_order,
        fallback_slope=jax_limited.fallback_slope,
        accelerator=accelerator,
        troubled_capacity=jax_limited.troubled_capacity,
        troubled_granularity=jax_limited.troubled_granularity,
        subcell_cuda=jax_limited.subcell_pallas,
        overflow_fallback=jax_limited.overflow_fallback,
        post_step_guard=jax_limited.post_step_guard,
        device=solver.weights.device,
    )


def grid_solver_from_jax(jax_solver, *, spec: str, gamma: float, device=None,
                         dtype: torch.dtype = torch.float64):
    """The port's Euler FV :class:`GridSolver` for a JAX ``GridSolver``.

    Reads the JAX solver's numbers duck-typed (``kernel.config``,
    ``grid.grid_shape``, ``grid.boundary``, ``dx``, ``cfl``, ``kernel_dt``).
    The JAX physics callbacks are opaque, so the caller names the spec
    (``"rusanov"``: :func:`build_rusanov_kernel`, ``"fv"``:
    :func:`build_fv_rusanov_kernel`) and γ; a JAX ``eigenvalue_fn`` becomes
    the port's Euler wave speed.  Both are checked: the JAX kernel's
    ``Flux`` and ``maxEigenvalue`` and its ``eigenvalue_fn`` are evaluated
    beside the port's on one seeded admissible float64 probe state along
    every normal, and a difference beyond a few roundings (another γ, a
    custom ``flux_impl``) raises ``SemanticError``.  The JAX solver must use the SoA-P
    ``TpuPatchGrid`` layout (``backend="pallas"``), the port's only one, so
    states cross unchanged through :func:`state_from_numpy`.

    The FV modules load SymPy, so they are imported here and not with this
    module (the ADER-DG entry stays free of it).
    """
    from exahype_tpu_torch.models import euler
    from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
    from exahype_tpu_torch.models.rusanov import build_rusanov_kernel
    from exahype_tpu_torch.parallel.grid import TpuPatchGrid
    from exahype_tpu_torch.parallel.solver import GridSolver

    builders = {"rusanov": build_rusanov_kernel, "fv": build_fv_rusanov_kernel}
    if spec not in builders:
        raise SemanticError(f"spec must be one of {sorted(builders)}, got {spec!r}")
    if getattr(jax_solver, "backend", None) != "pallas":
        raise SemanticError(
            "only the SoA-P TpuPatchGrid layout (backend='pallas') is ported; "
            "the AoS PatchGrid is not"
        )
    if getattr(jax_solver.grid, "reflect_fn", None) is not None:
        raise SemanticError("a reflective grid's reflect_fn is not ported")
    cfg = jax_solver.kernel.config
    kb = builders[spec](
        dim=cfg.dim, patch_size=cfg.patch_size, halo_size=cfg.halo_size,
        n_real=cfg.n_real, n_aux=cfg.n_aux, n_patches=cfg.n_patches,
        gamma=gamma,
    )
    grid = TpuPatchGrid(
        kb.config, tuple(jax_solver.grid.grid_shape),
        boundary=jax_solver.grid.boundary,
    )
    eigenvalue_fn = None
    if jax_solver.eigenvalue_fn is not None:
        eigenvalue_fn = euler.wave_speed_fn(dim=cfg.dim, gamma=gamma)
    # The JAX kernel's physics is opaque: probe its Flux and maxEigenvalue
    # (the SoA-P ``tpu_impl`` a TpuPatchGrid solver runs) and its
    # eigenvalue_fn against the port's Euler ones at γ, along every normal.
    probe = _probe("euler", cfg.dim, cfg.n_real + cfg.n_aux, cfg.dim)
    tp = torch.from_numpy(probe)
    checks = [(f"{fn} along axis {d}", jax_solver.kernel.functions[fn].tpu_impl,
               kb.functions[fn].torch_impl, (probe, d), (tp, d))
              for fn in ("Flux", "maxEigenvalue") for d in range(cfg.dim)]
    if eigenvalue_fn is not None:
        checks.append(("eigenvalue_fn", jax_solver.eigenvalue_fn, eigenvalue_fn, (probe,), (tp,)))
    for what, fn_jax, fn_port, args_np, args_port in checks:
        _check_against_jax(what, fn_jax, fn_port, args_np, args_port, f"euler, gamma={gamma!r}",
                           hint="the port's FV kernel is Euler's: name the gamma the JAX "
                                "kernel was built with (a custom flux_impl or eigenvalue_fn "
                                "is not ported)")
    return GridSolver(
        grid, kb, dx=jax_solver.dx, cfl=jax_solver.cfl,
        eigenvalue_fn=eigenvalue_fn, kernel_dt=jax_solver.kernel_dt,
        device=device, dtype=dtype,
    )


def _z4_from_jax(jax_solver, make, name: str, n_vars: int, other: str, params: dict,
                 device, dtype):
    """The port's solver for a JAX Z4 solver of ``n_vars`` variables through
    the port's constructor ``make`` (``make_z4_solver``,
    ``make_z4_shift_solver``, ``make_z4_matter_solver`` or
    ``make_z4_grmhd_solver``), with the hooks as they are set; see
    :func:`z4_solver_from_jax`."""
    from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
    from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs

    if type(jax_solver).__name__ == "PallasADERDG":
        return CudaADERDG(_z4_from_jax(jax_solver.solver, make, name, n_vars, other, params,
                                       device, dtype))
    if jax_solver.ncp_fn is None or jax_solver.source_fn is None:
        raise SemanticError(
            f"not a {name} solver: it needs {n_vars} variables, ncp_fn and source_fn"
        )
    if jax_solver.n_vars != n_vars:
        raise SemanticError(
            f"not a {name} solver: it needs {n_vars} variables, got "
            f"n_vars={jax_solver.n_vars} (cross it with {other})"
        )
    options = _options_from_jax(jax_solver, walls=None)
    rhs = jax_solver.rhs_all_fn
    solver = make(
        dim=jax_solver.dim,
        order=jax_solver.order,
        grid_shape=tuple(jax_solver.grid_shape),
        dx=jax_solver.dx,
        **params,
        fused_rhs="soa" if rhs is not None else False,
        impl="soa",
        picard_iters=jax_solver.picard_iters,
        basis=jax_solver.basis,
        device=device,
        dtype=dtype,
        **options,
    )
    _check_z4(jax_solver, solver, name, params)
    if type(rhs).__name__ == "PallasRHS":
        solver = with_cuda_rhs(solver)
    return solver


def z4_solver_from_jax(jax_solver, *, slicing: str = "harmonic", f: float = 1.0,
                       m: float = 2.0, kappa1: float = 0.0, kappa2: float = 0.0,
                       device=None, dtype: torch.dtype = torch.float64):
    """The port's vacuum Z4 solver for a JAX ``make_z4_solver`` solver.

    Reads the numeric fields as :func:`aderdg_from_jax` does and the
    options (an option the port does not carry yet raises
    ``SemanticError``).  The JAX Z4 callbacks are closures, so the caller
    names the system's parameters (``slicing``, ``f``, ``m``, ``kappa1``,
    ``kappa2``), and they are checked: the port's ``source_fn``, each
    axis's ``ncp_fn`` at a seeded gradient, flux, wave speed and, where the
    JAX solver sets one, ``rhs_all_fn`` are evaluated beside the JAX
    solver's on one seeded float64 probe state (the lapse off 1, noise in
    Θ, Z_i and every other slot; an admissible fluid, and a field nowhere
    zero with ψ ≠ 0, for the matter systems), and a difference beyond
    1e-12·max(1, max|JAX|) raises ``SemanticError`` (the same holds for
    the other Z4 converters and their own parameters; it wants the JAX
    package in float64).  The hooks cross as they are set: a JAX solver with
    ``rhs_all_fn`` gets the port's ``fused_rhs="soa"`` hook, one without it
    the per-axis NCP; the port's callbacks are the ``impl="soa"`` ones.  A
    ``PallasRHS`` hook (``with_pallas_rhs``) maps to
    :func:`~exahype_tpu_torch.models.rhs_cuda.with_cuda_rhs`.  A JAX
    ``PallasADERDG`` over a Z4 solver maps to
    :class:`~exahype_tpu_torch.models.aderdg_cuda.CudaADERDG` over the port's
    solver for the one it wraps (its step's kernels compile the algebra in):
    fused or per-axis in 3-D at order 2, and in 2-D at orders 2 and 3.
    A 53-variable (shifted), 43-variable (Z4+GRHD) or 47-variable (Z4+GRMHD)
    solver raises ``SemanticError``: it crosses through
    :func:`z4_shift_solver_from_jax`, :func:`z4_matter_solver_from_jax` or
    :func:`z4_grmhd_solver_from_jax`.  States cross through
    :func:`state_from_numpy`.
    """
    from exahype_tpu_torch.models.z4 import N_VARS, make_z4_solver

    params = dict(slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2)
    return _z4_from_jax(jax_solver, make_z4_solver, "vacuum Z4", N_VARS,
                        "z4_shift_solver_from_jax, z4_matter_solver_from_jax or "
                        "z4_grmhd_solver_from_jax", params, device, dtype)


def z4_shift_solver_from_jax(jax_solver, *, slicing: str = "harmonic", f: float = 1.0,
                             m: float = 2.0, kappa1: float = 0.0, kappa2: float = 0.0,
                             shift: str = "frozen", f_b: float = 0.75, eta: float = 1.0,
                             device=None, dtype: torch.dtype = torch.float64):
    """The port's shifted vacuum Z4 solver for a JAX ``make_z4_shift_solver``
    solver (53 variables): as :func:`z4_solver_from_jax`, the caller naming
    the system's parameters, the shift condition with them (``shift``,
    ``f_b``, ``eta``), each checked against the JAX callbacks on the probe
    state.  ``with_pallas_rhs`` of it maps to ``with_cuda_rhs`` (K5 c; K5 b's
    ``rhs_all_z4_shift_2d`` in 2-D), ``PallasADERDG`` of it to
    ``CudaADERDG`` (K1 d over the 53-variable system): fused or per-axis in
    3-D and in 2-D at order 2, so the JAX package's default build
    (``fused_rhs=False``, no ``rhs_all_fn``) gives a ``CudaADERDG`` with
    ``per_axis`` true.  A solver of another variable
    count raises ``SemanticError``: 38 crosses through
    :func:`z4_solver_from_jax`, 43 through :func:`z4_matter_solver_from_jax`,
    47 through :func:`z4_grmhd_solver_from_jax`."""
    from exahype_tpu_torch.models.z4 import N_VARS_SHIFT, make_z4_shift_solver

    params = dict(slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2, shift=shift,
                  f_b=f_b, eta=eta)
    return _z4_from_jax(jax_solver, make_z4_shift_solver, "shifted vacuum Z4", N_VARS_SHIFT,
                        "z4_solver_from_jax, z4_matter_solver_from_jax or "
                        "z4_grmhd_solver_from_jax", params, device, dtype)


def z4_matter_solver_from_jax(jax_solver, *, gamma: float = 5.0 / 3.0, iters: int = 10,
                              slicing: str = "harmonic", f: float = 1.0, m: float = 2.0,
                              kappa1: float = 0.0, kappa2: float = 0.0, device=None,
                              dtype: torch.dtype = torch.float64):
    """The port's coupled Z4+GRHD solver for a JAX ``make_z4_matter_solver``
    solver (43 variables): as :func:`z4_solver_from_jax`, the caller naming
    the system's parameters, the fluid's (``gamma``, ``iters``) with them,
    each checked against the JAX callbacks on the probe state (so
    ``limited_from_jax(..., physics="z4_matter")`` is checked too).
    ``with_pallas_rhs`` of it maps to ``with_cuda_rhs`` (K5 d; K5 b's
    ``rhs_all_z4_matter_2d`` in 2-D), ``PallasADERDG`` of it to
    ``CudaADERDG`` (K1 d's conservative-flux variant): fused or per-axis in
    3-D and in 2-D at order 2, so the JAX package's default build
    (``fused_rhs=False``, no ``rhs_all_fn``) gives a ``CudaADERDG`` with
    ``per_axis`` true.  A solver of another variable count raises ``SemanticError``:
    38 crosses through :func:`z4_solver_from_jax`, 53 through
    :func:`z4_shift_solver_from_jax`, 47 through
    :func:`z4_grmhd_solver_from_jax`."""
    from exahype_tpu_torch.models.z4_matter import N_VARS, make_z4_matter_solver

    params = dict(gamma=gamma, iters=iters, slicing=slicing, f=f, m=m, kappa1=kappa1,
                  kappa2=kappa2)
    return _z4_from_jax(jax_solver, make_z4_matter_solver, "Z4+GRHD", N_VARS,
                        "z4_grmhd_solver_from_jax, z4_solver_from_jax or "
                        "z4_shift_solver_from_jax", params, device, dtype)


def z4_grmhd_solver_from_jax(jax_solver, *, gamma: float = 5.0 / 3.0, iters: int = 20,
                             slicing: str = "harmonic", f: float = 1.0, m: float = 2.0,
                             kappa1: float = 0.0, kappa2: float = 0.0, c_h: float = 1.0,
                             glm_kappa: float = 0.0, device=None,
                             dtype: torch.dtype = torch.float64):
    """The port's coupled Z4+GRMHD solver for a JAX ``make_z4_grmhd_solver``
    solver (47 variables): as :func:`z4_solver_from_jax`, the caller naming
    the system's parameters, the fluid's (``gamma``, ``iters``) and the
    cleaning's (``c_h``, ``glm_kappa``) with them, each checked against
    the JAX callbacks on the probe state.  ``with_pallas_rhs`` of it maps
    to ``with_cuda_rhs`` (K5 e; K5 b's ``rhs_all_z4_grmhd_2d`` in 2-D),
    ``PallasADERDG`` of it to ``CudaADERDG`` (K1 d's conservative-flux
    variant over the 47-variable system): fused or per-axis in 3-D and in
    2-D at order 2, so the JAX package's default build (``fused_rhs=False``,
    no ``rhs_all_fn``) gives a ``CudaADERDG`` with ``per_axis`` true.  A
    solver of another variable count raises ``SemanticError``:
    38 crosses through :func:`z4_solver_from_jax`, 53 through
    :func:`z4_shift_solver_from_jax`, 43 through
    :func:`z4_matter_solver_from_jax`."""
    from exahype_tpu_torch.models.z4_grmhd import N_VARS, make_z4_grmhd_solver

    params = dict(gamma=gamma, iters=iters, slicing=slicing, f=f, m=m, kappa1=kappa1,
                  kappa2=kappa2, c_h=c_h, glm_kappa=glm_kappa)
    return _z4_from_jax(jax_solver, make_z4_grmhd_solver, "Z4+GRMHD", N_VARS,
                        "z4_solver_from_jax, z4_shift_solver_from_jax or "
                        "z4_matter_solver_from_jax", params, device, dtype)


def state_from_numpy(arr, *, device=None, dtype: torch.dtype | None = None):
    """A contiguous torch state from a NumPy (or JAX, via ``np.array``)
    array in the SoA-P layout, on the card unless ``device`` says
    otherwise.  It is a copy: the port's steps update states in place."""
    device = resolve_device(device)
    t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def state_to_numpy(t) -> np.ndarray:
    """A NumPy copy of a torch state (any device)."""
    return t.detach().cpu().numpy()
