"""Carry configurations and states between the JAX package and the port.

The JAX side's "parameters" are the solver configuration and the state
array; both cross as plain numbers and NumPy arrays, so this module needs
no JAX import of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from exahype_tpu_torch.models.aderdg import (
    UNPORTED_OPTIONS,
    ADERDGSolver,
    euler_physics,
)


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


def state_from_numpy(arr, *, device=None, dtype: torch.dtype | None = None):
    """A contiguous torch state from a NumPy (or JAX, via ``np.asarray``)
    array in the SoA-P layout."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def state_to_numpy(t) -> np.ndarray:
    """A NumPy copy of a torch state (any device)."""
    return t.detach().cpu().numpy()
