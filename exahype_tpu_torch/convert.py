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
    UNPORTED_OPTIONS,
    ADERDGSolver,
    euler_physics,
)
from exahype_tpu_torch.utils.device import resolve_device
from exahype_tpu_torch.utils.errors import SemanticError


def aderdg_from_jax(jax_solver, *, gamma: float, device=None,
                    dtype: torch.dtype = torch.float64) -> ADERDGSolver:
    """The port's Euler :class:`ADERDGSolver` for a JAX ``ADERDGSolver``.

    Reads the JAX solver's numeric fields (``dim``, ``order``, ``n_vars``,
    ``grid_shape``, ``dx``, ``basis``, ``picard_iters``) and its option
    fields; an option the port does not carry yet raises ``SemanticError``.
    The JAX physics callbacks are opaque, so the caller names γ and the
    port builds its own tagged Euler pair.
    """
    flux, eig = euler_physics(
        jax_solver.dim, n_real=jax_solver.n_vars, gamma=gamma
    )
    options = {name: getattr(jax_solver, name) for name in UNPORTED_OPTIONS}
    return ADERDGSolver(
        dim=jax_solver.dim,
        order=jax_solver.order,
        n_vars=jax_solver.n_vars,
        grid_shape=tuple(jax_solver.grid_shape),
        flux_fn=flux,
        max_eigenvalue_fn=eig,
        dx=jax_solver.dx,
        picard_iters=jax_solver.picard_iters,
        basis=jax_solver.basis,
        device=device,
        dtype=dtype,
        **options,
    )


def grid_solver_from_jax(jax_solver, *, spec: str, gamma: float, device=None,
                         dtype: torch.dtype = torch.float64):
    """The port's Euler FV :class:`GridSolver` for a JAX ``GridSolver``.

    Reads the JAX solver's numbers duck-typed (``kernel.config``,
    ``grid.grid_shape``, ``grid.boundary``, ``dx``, ``cfl``, ``kernel_dt``).
    The JAX physics callbacks are opaque, so the caller names the spec
    (``"rusanov"``: :func:`build_rusanov_kernel`, ``"fv"``:
    :func:`build_fv_rusanov_kernel`) and γ; a JAX ``eigenvalue_fn`` becomes
    the port's Euler wave speed.  The JAX solver must use the SoA-P
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
    return GridSolver(
        grid, kb, dx=jax_solver.dx, cfl=jax_solver.cfl,
        eigenvalue_fn=eigenvalue_fn, kernel_dt=jax_solver.kernel_dt,
        device=device, dtype=dtype,
    )


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
