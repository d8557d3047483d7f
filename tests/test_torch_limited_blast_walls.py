"""``examples/limited_blast_walls.py``'s configuration on the port, on the
CPU: 2-D p3 Euler in a reflective box, the pressurised disc r < 0.1, the
whole-grid subcell fallback with the JAX limiter's ``PallasADERDG(tile0=2)``
accelerator, which ``limited_from_jax`` maps to ``CudaADERDG`` (its plain
path on the CPU).  The JAX side runs on its XLA path (jitted); the 2-D
Pallas kernel itself (interpret mode) is held against the port's plain
step, the twin of the 2-D CUDA kernels.  f64 at rtol=0, atol=1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
from exahype_tpu.models.limiter import euler_admissible as jax_admissible
from exahype_tpu_torch.convert import (
    aderdg_from_jax,
    limited_from_jax,
    state_from_numpy,
    state_to_numpy,
)
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.limiter import euler_admissible
from tests.test_torch_limiter_walls import centered_blast, close, jax_solver, run_both

torch.set_num_threads(1)

CELLS = 16
DT = 2.5e-4  # examples/limited_blast_walls.py:68


def blast_walls(cells):
    """``examples/limited_blast_walls.py:34-67``: 2-D p3 Euler in a
    reflective box, the pressurised disc r < 0.1; the JAX limiter with a
    ``PallasADERDG(tile0=2)`` accelerator (never stepped here), its XLA twin
    and the state."""
    js = jax_solver(cells=cells, order=3, boundary="reflective")
    accel = PallasADERDG(js, interpret=True, tile0=2)
    jl_accel = JaxLimited(js, admissible=jax_admissible(dim=2), accelerator=accel)
    jl = JaxLimited(js, admissible=jax_admissible(dim=2))
    x, y = js.nodes_meshgrid()
    r2 = (np.asarray(x) - 0.5) ** 2 + (np.asarray(y) - 0.5) ** 2
    inside = np.squeeze(r2 < 0.1**2, axis=js.var_axis)
    rho = np.where(inside, 1.0, 0.125)
    p = np.where(inside, 10.0, 0.1)
    z = np.zeros_like(rho)
    return jl_accel, jl, np.stack([rho, z, z, p / 0.4], axis=js.var_axis)


def test_limited_blast_walls_matches_jax():
    """The example's configuration at ``(16, 16)`` through
    ``limited_from_jax``: the accelerator maps to ``CudaADERDG`` (its plain
    path on the CPU), and 3 steps equal the JAX limiter's."""
    jl_accel, jl, Q = blast_walls(CELLS)
    pl = limited_from_jax(jl_accel, gamma=1.4, walls="euler", device="cpu")
    assert isinstance(pl.accelerator, CudaADERDG) and pl.troubled_capacity is None
    assert pl.accelerator.kernels[1:] == ("aderdg_face_flux_walls_2d",
                                          "aderdg_surface_update_walls_2d")
    states = run_both(jl, pl, Q, DT, 3)
    for k, (ref, got) in enumerate(states):
        close(got, ref, msg=f"step {k + 1}")
    assert all(v == 0 for v in pl.accelerator.launches.values())


def test_limited_blast_walls_gates_on_the_plain_path():
    """The example's gates over its 20 steps on the port's plain path
    (float64): admissible, mass and energy conserved, cells troubled on
    step 1."""
    jl_accel, _, Q = blast_walls(CELLS)
    pl = limited_from_jax(jl_accel, gamma=1.4, walls="euler", device="cpu")
    u0 = state_from_numpy(Q, device="cpu")
    frac = float(pl.troubled_mask(u0, pl.solver.step(u0, DT)).double().mean())
    u = pl.run(u0, 20, DT)
    assert u.is_contiguous()  # the CUDA kernels take the next step's state so
    m0, m1 = pl.solver.total_mass(u0), pl.solver.total_mass(u)
    assert bool(euler_admissible(2)(u, 2).all())
    assert abs(float(m1[0] - m0[0])) / float(m0[0]) < 1e-10
    assert abs(float(m1[3] - m0[3])) / float(m0[3]) < 1e-10
    assert frac > 0


@pytest.mark.parametrize("walled", [False, True], ids=["periodic", "reflective box"])
def test_pallas_2d_step_matches_the_plain_step(walled):
    """One step of the 2-D ``PallasADERDG(interpret=True, tile0=2)`` at
    ``(4, 4)`` against the port's plain step (the CUDA kernels' plain
    twin), periodic and in the example's reflective box."""
    js = jax_solver(cells=4, order=3, **(dict(boundary="reflective") if walled else {}))
    pallas = PallasADERDG(js, interpret=True, tile0=2)
    cu = aderdg_from_jax(pallas, gamma=1.4, walls="euler" if walled else None, device="cpu")
    assert isinstance(cu, CudaADERDG)
    rng = np.random.default_rng(11)
    Q = centered_blast(js) * (1.0 + 0.05 * rng.random(js.state_shape))
    ref = np.asarray(pallas.step(jnp.asarray(Q), 1e-3))
    close(state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), 1e-3)), ref)
