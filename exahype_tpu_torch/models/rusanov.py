"""The canonical batched-stateless FV Rusanov kernel spec.

Port of ``exahype_tpu/models/rusanov.py::build_rusanov_kernel``, the spec
``__graft_entry__.py::entry`` builds: the same statement sequence, with
compressible-Euler physics as PyTorch (``torch_impl``) and CUDA
(``cuda_source``) bodies.

1. ``Q_copy = Q``                                   (copy patch)
2. per-axis ``Flux(Q_copy, normal, tmp_flux)``       (flux evaluation)
3. per-axis ``tmp_eigen = maxEigenvalue(Q_copy, n)`` (wave speeds)
4. per-axis ``Q_copy += 0.5*(tmp_flux[-1] - tmp_flux[+1])``
5. per-axis Rusanov dissipation with neighbour eigenvalues
6. ``Q = Q_copy`` interior write-back

It reproduces the reference example verbatim, so it is no integrator: the
flux difference has no ``dt/dx`` scaling and the dissipation has the
anti-dissipative sign (see :mod:`exahype_tpu_torch.models.fv`).
"""

from __future__ import annotations

import functools

from sympy.codegen.ast import integer, none, real

from exahype_tpu_torch.frontend.kernel_builder import KernelBuilder
from exahype_tpu_torch.models import euler


def register_euler_functions(kernel: KernelBuilder, gamma: float):
    """Register ``Flux``, ``maxEigenvalue`` and ``max`` (Euler, SoA-P) on
    ``kernel``; returns the three typed functions."""
    cfg = kernel.config
    Q = kernel.all_items[kernel.items[0]]
    Flux = kernel.function(
        "Flux",
        parameter_types=[Q, real, Q],
        return_type=integer,
        torch_impl=functools.partial(
            euler.flux, dim=cfg.dim, n_real=cfg.n_real, gamma=gamma
        ),
        out_param=2,
        cuda_source=euler.flux_cuda(cfg.dim, cfg.n_real, gamma),
    )
    Eigen = kernel.function(
        "maxEigenvalue",
        parameter_types=[Q, real],
        return_type=real,
        torch_impl=functools.partial(euler.max_eigenvalue, dim=cfg.dim, gamma=gamma),
        cuda_source=euler.max_eigenvalue_cuda(cfg.dim, gamma),
    )
    Max = kernel.function(
        "max",
        parameter_types=[Q, Q],
        return_type=none,
        torch_impl=euler.scalar_max,
        cuda_source=euler.SCALAR_MAX_CUDA,
    )
    return Flux, Eigen, Max


def build_rusanov_kernel(
    dim: int = 2,
    patch_size: int = 4,
    halo_size: int = 1,
    n_real: int = 5,
    n_aux: int = 5,
    n_patches: int = 1,
    gamma: float = euler.GAMMA,
) -> KernelBuilder:
    """Build the canonical Rusanov patch-update kernel spec.

    Defaults reproduce the reference test configuration
    (``Unit test/correctness_test.cpp:177-181``): 2-D, patch 4, halo 1,
    5 real + 5 aux variables, compressible Euler physics.
    """
    kernel = KernelBuilder(
        dim=dim,
        patch_size=patch_size,
        halo_size=halo_size,
        n_real=n_real,
        n_aux=n_aux,
        n_patches=n_patches,
    )

    Q = kernel.item("Q")
    Q_copy = kernel.item("Q_copy")
    tmp_flux = kernel.directional_item("tmp_flux")
    tmp_eig = kernel.directional_item("tmp_eigen", struct=False)

    dt = kernel.const("dt")
    kernel.directional_const("normal", list(range(dim)))
    normal = kernel.all_items["normal"]
    Flux, Eigen, Max = register_euler_functions(kernel, gamma)

    kernel.single(Q_copy[0], Q[0])
    kernel.directional(Flux(Q_copy[0], normal, tmp_flux[0]))
    kernel.directional(tmp_eig[0], Eigen(Q_copy[0], normal))
    kernel.directional(Q_copy[0], Q_copy[0] + 0.5 * (tmp_flux[-1] - tmp_flux[1]))

    left = -Max(tmp_eig[-1], tmp_eig[0]) * (Q[0] - Q[-1])
    right = -Max(tmp_eig[1], tmp_eig[0]) * (Q[0] - Q[1])
    kernel.directional(Q_copy[0], Q_copy[0] + 0.5 * dt * (left - right), struct=True)

    kernel.single(Q[0], Q_copy[0])
    return kernel
