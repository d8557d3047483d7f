"""Domain walls on 3-D Euler ADER-DG at orders 4, 5 and 7 in the port
against the JAX package, on the CPU: the reflective box, reflective walls
on axes 1 and 2 (``wall_axes``), outflow and farfield channels on axis 0
and a Dirichlet box, each stepped by both plain solvers; then
``aderdg_from_jax``'s map of a walled ``PallasADERDG`` onto ``CudaADERDG``'s
walled face pair at that order (``aderdg_face_flux_walls_pN`` +
``aderdg_surface_update_walls_pN``).

Inputs are made with NumPy from a seed: ``examples/high_order_p5.py``'s
density wave with seeded noise on the density
(``tests/test_torch_aderdg_p5.py::wave_state``), the farfield state and the
Dirichlet rows of ``tests/test_torch_walls.py``.  f64 at rtol=0, atol=1e-12,
one step and 3 steps.  The walled kernels are held against these plain
versions on the card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu_torch.convert import aderdg_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from tests.test_torch_aderdg_p5 import GAMMA, wave_state
from tests.test_torch_walls import _ff, _port, assert_steps_match, jax_euler

torch.set_num_threads(1)

#: A small grid of each order, dx = 1/g0, every axis at least 2 cells (a
#: wall axis of one cell would put both walls on one row).
GRIDS = {4: (3, 2, 2), 5: (2, 2, 3), 7: (2, 2, 2)}
WALLS = {
    "reflective": dict(boundary="reflective"),
    "reflective_12": dict(boundary="reflective", wall_axes=(1, 2)),
    "outflow_0": dict(boundary="outflow", wall_axes=(0,)),
    "farfield_0": dict(boundary="farfield", farfield_state=_ff(3), wall_axes=(0,)),
    "dirichlet": dict(boundary="dirichlet"),
}
DT = 1e-3  # under cfl_dt of these states at every order (1.86e-3 at order 7)


def _solvers(order, name):
    js = jax_euler(3, order, GRIDS[order], **WALLS[name])
    return js, _port(js), wave_state(js, noise=0.05, seed=order)


@pytest.mark.parametrize("name", sorted(WALLS))
@pytest.mark.parametrize("order", [4, 5, 7])
def test_euler_walls_match_jax(order, name):
    js, ts, Q = _solvers(order, name)
    assert ts.boundary == js.boundary and ts.wall_axes == js.wall_axes
    assert_steps_match(js, ts, Q, dt=DT)


@pytest.mark.parametrize("name", sorted(WALLS))
@pytest.mark.parametrize("order", [4, 5, 7])
def test_aderdg_from_jax_maps_walled_pallas_to_cuda_aderdg(order, name):
    js, ts, Q = _solvers(order, name)
    walls = "euler" if js.boundary == "reflective" else None
    cu = aderdg_from_jax(PallasADERDG(js, tile0=1, dtype=np.float64), gamma=GAMMA,
                         walls=walls, device="cpu")
    p = f"_p{order}"
    assert isinstance(cu, CudaADERDG)
    assert cu.kernels == ("aderdg_predictor_volume" + p, "aderdg_face_flux_walls" + p,
                          "aderdg_surface_update_walls" + p)
    # The walled pair's occupancy indices (csrc/aderdg.cu, exahype_aderdg_kernel_info).
    assert [CudaADERDG.KERNELS.index(k) for k in cu.kernels[1:]] == {
        4: [39, 40], 5: [34, 35], 7: [44, 45]}[order]
    axes = [d for d in range(3) if ts.is_wall(d)]
    assert cu.walls["mask"] == sum(1 << d for d in axes)
    assert (cu.walls["rows"] is not None) == (name == "dirichlet")
    u = state_from_numpy(Q, device="cpu")
    np.testing.assert_array_equal(state_to_numpy(cu.run(u, 2, DT)),
                                  state_to_numpy(ts.run(u, 2, DT)))
    assert cu.launches == {k: 0 for k in cu.kernels}
