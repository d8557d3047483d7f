"""Corrected, scaled FV Rusanov kernel for the solver layer.

Port of ``exahype_tpu/models/fv.py::build_fv_rusanov_kernel``.  The
canonical spec (:mod:`exahype_tpu_torch.models.rusanov`) reproduces the
reference example verbatim, including two prototype defects that make it
unusable as an integrator: the flux difference carries no ``dt/dx``
scaling, and the dissipation term's sign is anti-dissipative (and touches
variable 0 only).  This module builds the textbook scheme through the same
DSL:

    u_i += λ/2 (F_{i-1} - F_{i+1}) + λ/2 [s₊(u_{i+1}-u_i) - s₋(u_i-u_{i-1})]

with λ = dt/dx passed as the kernel's scalar argument (``GridSolver`` with
``kernel_dt="lambda"`` converts), the dissipative sign, and the dissipation
applied to all ``n_real`` variables via ``struct_override``.
"""

from __future__ import annotations

from exahype_tpu_torch.frontend.kernel_builder import KernelBuilder
from exahype_tpu_torch.models import euler
from exahype_tpu_torch.models.rusanov import register_euler_functions


def build_fv_rusanov_kernel(
    dim: int = 2,
    patch_size: int = 4,
    halo_size: int = 1,
    n_real: int = 5,
    n_aux: int = 0,
    n_patches: int = 1,
    gamma: float = euler.GAMMA,
) -> KernelBuilder:
    """Textbook FV Rusanov patch update (Euler); kernel scalar = λ = dt/dx."""
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
    lam = kernel.const("dt")  # λ = dt/dx
    kernel.directional_const("normal", list(range(dim)))
    normal = kernel.all_items["normal"]
    Flux, Eigen, Max = register_euler_functions(kernel, gamma)

    kernel.single(Q_copy[0], Q[0])
    kernel.directional(Flux(Q_copy[0], normal, tmp_flux[0]))
    kernel.directional(tmp_eig[0], Eigen(Q_copy[0], normal))

    # Central flux difference, λ-scaled.
    kernel.directional(
        Q_copy[0],
        Q_copy[0] + 0.5 * lam * (tmp_flux[-1] - tmp_flux[1]),
        struct_override=1,
    )

    # Rusanov viscosity with the correct (dissipative) sign, all n_real vars.
    up = Max(tmp_eig[1], tmp_eig[0]) * (Q[1] - Q[0])
    down = Max(tmp_eig[-1], tmp_eig[0]) * (Q[0] - Q[-1])
    kernel.directional(
        Q_copy[0],
        Q_copy[0] + 0.5 * lam * (up - down),
        struct_override=1,
    )

    kernel.single(Q[0], Q_copy[0])
    return kernel
