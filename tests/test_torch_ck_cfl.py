"""The default time step of the 3-D order-3 elastic ADER-DG step, in the
port and in the JAX package, on the CPU, in float64.

``cfl_dt`` with no ``cfl`` takes min(0.4, 1.5/(N + 2)) = 0.3 at order 3.
From seeded noise of 1e-3 on the 9 wave rows, the 12-variable
heterogeneous elastic step at that dt grows without bound in every
configuration below, in both packages alike: periodic and homogeneous,
with the free surface on axis 2, with the two layers of
``examples/seismic3d_layered.py``, with the free surface, the layers and
the example's sponge together (all four with the Cauchy–Kovalewski
predictor), and periodic and homogeneous with the Picard predictor.  So
neither the free surface, the material jump, the sponge nor the CK
predictor is the cause: the default is above the stable limit of this 3-D
scheme.  At half that dt (cfl 0.15, where the seismic path steps) the same
runs stay bounded.

``(6, 6, 4)`` cells (dx = 1/6, so the sponge's 0.12 reaches the edge
cells), 60 steps: the unstable runs grow more than 1e6-fold, the bounded
ones stay within 10 times the starting noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import elastic as jel
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu_torch.models import elastic as tel
from exahype_tpu_torch.models.aderdg import ADERDGSolver

torch.set_num_threads(1)

CELLS = (6, 6, 4)
STEPS = 60
SAFE_CFL = 0.15
UP, LO = (1.0, 2.0, 1.0), (1.2, 9.6, 4.8)  # ρ, λ, μ above and below half depth
SPONGE = dict(width=0.12, rate=40.0, axes=(0, 1), n_wave=9)

#: (free surface, layers, sponge, predictor)
CASES = {
    "periodic": (False, False, False, "ck"),
    "free_surface": (True, False, False, "ck"),
    "layers": (False, True, False, "ck"),
    "free_surface_layers_sponge": (True, True, True, "ck"),
    "periodic_picard": (False, False, False, "picard"),
}


def solvers(walls: bool, sponge: bool, mode: str):
    """The JAX solver and the port's, built alike."""
    kw = dict(dissipation_mask=(1,) * 9 + (0, 0, 0))
    if mode == "ck":
        kw.update(predictor_mode="ck", ck_material_slots=(9, 10, 11))
    out = []
    for el in (jel, tel):
        flux, eig = el.elastic3d_heterogeneous()
        k = dict(kw)
        if walls:
            reflect, reflect_flux = el.elastic3d_free_surface_het()
            k.update(boundary="reflective", wall_axes=(2,), reflect_fn=reflect,
                     reflect_flux_fn=reflect_flux)
        if el is jel:
            s = JaxSolver(dim=3, order=3, n_vars=12, grid_shape=CELLS,
                          flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
                          dx=1.0 / CELLS[0], **k)
        else:
            s = ADERDGSolver(3, 3, 12, CELLS, flux, eig, dx=1.0 / CELLS[0], device="cpu",
                             dtype=torch.float64, **k)
        if sponge:
            s.source_fn = el.sponge_source(s, **SPONGE)
        out.append(s)
    return out


def noisy_state(port, layers: bool):
    """Seeded noise of 1e-3 on the wave rows over the upper material, or
    over the example's two layers."""
    no_var = port.state_shape[:3] + port.state_shape[4:]
    zc = np.broadcast_to(np.squeeze(port.nodes_meshgrid()[2], 3), no_var)
    zmax = CELLS[2] * port._dxs[2]
    upper = zc > 0.5 * zmax if layers else np.ones(no_var, dtype=bool)
    mats = np.stack([np.where(upper, a, b) for a, b in zip(UP, LO)], axis=3)
    shape = port.state_shape[:3] + (9,) + port.state_shape[4:]
    noise = 1e-3 * np.random.default_rng(11).standard_normal(shape)
    return np.concatenate([noise, mats], axis=3)


@pytest.mark.parametrize("case", list(CASES))
def test_default_cfl_diverges_in_3d_in_both_packages(case):
    walls, layers, sponge, mode = CASES[case]
    js, ts = solvers(walls, sponge, mode)
    u0 = noisy_state(ts, layers)
    if sponge:
        assert ts.source_fn.sponge.sigma.max() > 0  # the sponge reaches cells here
    dt = float(js.cfl_dt(jnp.asarray(u0)))
    assert float(ts.cfl_dt(torch.from_numpy(u0))) == pytest.approx(dt, rel=1e-14, abs=0)

    def jax_run(u):
        return jax.lax.scan(lambda q, _: (js.step(q, dt), None), u, None, length=STEPS)[0]

    u_j = np.asarray(jax.jit(jax_run)(jnp.asarray(u0)))
    u_t = torch.from_numpy(u0)
    for _ in range(STEPS):
        u_t = ts.step(u_t, dt)
    u_t = u_t.numpy()
    peak = np.abs(u_j[:, :, :, :9]).max()
    assert peak > 1e3 and np.abs(u_t[:, :, :, :9]).max() > 1e3  # from 1e-3: unbounded
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=1e-9 * peak)

    u_s = torch.from_numpy(u0)
    dt_safe = float(ts.cfl_dt(u_s, cfl=SAFE_CFL))
    for _ in range(STEPS):
        u_s = ts.step(u_s, dt_safe)
    # bounded: within 10 times the starting noise, where the default's grew 1e6-fold
    assert np.abs(u_s.numpy()[:, :, :, :9]).max() < 10 * np.abs(u0[:, :, :, :9]).max()
