"""The port's Cauchy–Kovalewski step (``predictor_mode="ck"``) against the
JAX package's, on the CPU: the predictor's q̄/F̄ and one step at orders 2
and 3, one step against the fused Pallas kernel's CK branch in interpret
mode, and the slice as a whole — ``bench.py::bench_ck``'s configuration at a
cut grid carried across with ``aderdg_from_jax``, 5 steps side by side.
Also what the port refuses: the CK callbacks the CUDA kernels do not
carry (``LoweringError`` naming Queue 2 K2 a; the plain solver runs them)
and the physics/mode pairs the CUDA kernels are not instantiated for
(``LoweringError``).

Inputs are made with NumPy from a seed (or the bench's recipe) and handed
to both packages.  f64 at rtol=0, atol=1e-12 (the repo's JAX↔Pallas bar);
the wave's values are ~1e-3, so this is ~1e-9 relative.  The material
slots are compared bit for bit.  The kernels themselves are held against
these plain versions on the card in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import elastic as jel
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
from exahype_tpu.models.aderdg import wrap_var_last
from exahype_tpu_torch.convert import aderdg_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models import elastic
from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

CK = dict(predictor_mode="ck", ck_material_slots=(9, 10, 11),
          dissipation_mask=(1,) * 9 + (0, 0, 0))
MAT = (slice(None),) * 3 + (slice(9, 12),)


def jax_ck_solver(order, grid, **kw):
    flux, eig = jel.elastic3d_heterogeneous()
    return JaxSolver(dim=3, order=order, n_vars=12, grid_shape=grid,
                     flux_fn=wrap_var_last(flux), max_eigenvalue_fn=wrap_var_last(eig),
                     dx=1.0 / grid[0], **{**CK, **kw})


def port_ck_solver(order, grid, dtype=torch.float64, **kw):
    flux, eig = elastic.elastic3d_heterogeneous()
    return ADERDGSolver(3, order, 12, grid, flux, eig, dx=1.0 / grid[0], device="cpu",
                        dtype=dtype, **{**CK, **kw})


def random_state(solver, seed=0):
    """A wave of amplitude ~1e-3 in every evolved row, and materials
    constant in each cell and random across cells: ρ in [0.8, 1.6), λ and μ
    in [1, 3).  (Materials that vary from node to node would extrapolate to
    faces with non-physical, even negative, values.)"""
    rng = np.random.default_rng(seed)
    va = solver.var_axis
    no_var = solver.state_shape[:va] + solver.state_shape[va + 1:]
    grid = solver.grid_shape
    rows = [1e-3 * rng.standard_normal(no_var) for _ in range(9)]
    rows += [np.broadcast_to(m, no_var) for m in (
        0.8 + 0.8 * rng.random(grid), 1.0 + 2.0 * rng.random(grid),
        1.0 + 2.0 * rng.random(grid))]
    return np.stack(rows, axis=va)


CASES = [(2, (4, 4, 4)), (3, (4, 4, 4)), (2, (8, 2, 4)), (3, (8, 2, 4))]
DT = 1e-3  # under the CFL limit (~2e-3 at dx = 1/8 on these states)


@pytest.mark.parametrize("order,grid", CASES)
def test_ck_predictor_parity(order, grid):
    js, ts = jax_ck_solver(order, grid), port_ck_solver(order, grid)
    Q = random_state(ts, seed=order)
    qbar_j, fbar_j = js.predictor(jnp.asarray(Q), DT)
    qbar_t, fbar_t = ts.predictor(state_from_numpy(Q, device="cpu"), DT)
    np.testing.assert_allclose(state_to_numpy(qbar_t), np.asarray(qbar_j), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(state_to_numpy(qbar_t)[MAT], Q[MAT])
    assert len(fbar_t) == 3
    for d in range(3):
        np.testing.assert_allclose(state_to_numpy(fbar_t[d]), np.asarray(fbar_j[d]),
                                   rtol=0, atol=1e-12, err_msg=f"fbar[{d}]")


@pytest.mark.parametrize("order,grid", CASES)
def test_ck_step_parity_f64(order, grid):
    js, ts = jax_ck_solver(order, grid), port_ck_solver(order, grid)
    Q = random_state(ts, seed=10 + order)
    ref = np.asarray(js.step(jnp.asarray(Q), DT))
    got = state_to_numpy(ts.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[MAT], Q[MAT])
    assert np.isfinite(got).all()
    assert np.abs(ref - Q).max() > 1e-6  # the step did something


def test_ck_step_parity_f32():
    """The port's float32 step against the JAX float64 step: the wave's
    values are ~1e-3 and one step is ~100 dependent operations deep, so
    two precisions differ by ~1e-10 (atol 1e-8 leaves a wide margin); the
    materials stay the float32 input's bits."""
    js, ts = jax_ck_solver(3, (8, 2, 4)), port_ck_solver(3, (8, 2, 4), torch.float32)
    Q = random_state(ts, seed=7)
    ref = np.asarray(js.step(jnp.asarray(Q), DT))
    u = state_from_numpy(Q, device="cpu", dtype=torch.float32)
    got = ts.step(u, DT)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(state_to_numpy(got)[:, :, :, :9], ref[:, :, :, :9],
                               rtol=0, atol=1e-8)
    assert torch.equal(got[MAT], u[MAT])


def test_ck_cfl_dt_parity():
    js, ts = jax_ck_solver(3, (8, 2, 4)), port_ck_solver(3, (8, 2, 4))
    Q = random_state(ts, seed=3)
    np.testing.assert_allclose(float(ts.cfl_dt(state_from_numpy(Q, device="cpu"))),
                               float(js.cfl_dt(jnp.asarray(Q))), rtol=1e-14, atol=0)


def test_ck_step_matches_pallas_interpret():
    """One step against the TPU kernel's CK branch itself, in interpret
    mode, at the shape of ``tests/test_ck.py::
    test_ck_fused_pallas_materials_parity`` (order 2, 4³ cells)."""
    from exahype_tpu.models.aderdg_pallas import PallasADERDG

    js = jax_ck_solver(2, (4, 4, 4))
    fused = PallasADERDG(js, interpret=True)
    ts = port_ck_solver(2, (4, 4, 4))
    coords = js.nodes_meshgrid()
    no_var = js.state_shape[:3] + js.state_shape[4:]
    X = np.broadcast_to(np.squeeze(np.asarray(coords[0]), 3), no_var)
    Z = np.broadcast_to(np.squeeze(np.asarray(coords[2]), 3), no_var)
    wave = np.moveaxis(jel.plane_p_wave_3d(X, 0.0), -1, 3)
    mats = np.stack([np.where(Z < 0.5, 1.0, 1.5), np.where(Z < 0.5, 2.0, 4.0),
                     np.where(Z < 0.5, 1.0, 2.0)], axis=3)
    Q = np.concatenate([wave, mats], axis=3)
    ref = np.asarray(fused.step(jnp.asarray(Q), DT))
    got = state_to_numpy(ts.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[MAT], Q[MAT])
    np.testing.assert_array_equal(ref[MAT], Q[MAT])


def test_slice_bench_ck_five_steps_match_jax():
    """``bench.py::bench_ck``'s configuration at a cut grid: the same
    physical problem (x in [0, 1], z in [0, 1/2], the layer at z = 1/4) at
    dx = 1/8, carried across with ``aderdg_from_jax``, its dt scaled with
    dx (2e-4 · 64/8, the bench's CFL fraction), 5 steps side by side."""
    grid = (8, 2, 4)
    js = jax_ck_solver(3, grid)
    port = CudaADERDG(aderdg_from_jax(js, physics="elastic3d_het", device="cpu"))
    assert (port.solver.predictor_mode, port.solver.ck_material_slots) == ("ck", (9, 10, 11))
    assert port.solver.dissipation_mask == (1.0,) * 9 + (0.0,) * 3
    Q, mat = elastic.two_layer_state(port.solver)
    dt = 2e-4 * 64 / grid[0]
    ref, u = jnp.asarray(Q), state_from_numpy(Q, device="cpu")
    for k in range(5):
        ref, u = js.step(ref, dt), port.step(u, dt)
        np.testing.assert_allclose(state_to_numpy(u), np.asarray(ref), rtol=0, atol=1e-12,
                                   err_msg=f"step {k + 1}")
    np.testing.assert_array_equal(state_to_numpy(u)[MAT], mat)
    np.testing.assert_array_equal(np.asarray(ref)[MAT], mat)
    e0 = float(elastic.seismic_energy(state_from_numpy(Q, device="cpu"), 3))
    e_port = float(elastic.seismic_energy(u, 3)) / e0
    e_jax = float(elastic.seismic_energy(state_from_numpy(ref, device="cpu"), 3)) / e0
    np.testing.assert_allclose(e_port, e_jax, rtol=1e-12, atol=0)
    assert 1.0 <= e_port < 1.02  # bench.py's gate
    assert port.launches == {"aderdg_ck_predictor_volume": 0, "aderdg_face_flux": 0,
                             "aderdg_surface_update": 0}


def test_cuda_wrapper_takes_plain_ck_path_on_cpu():
    ts = port_ck_solver(3, (4, 2, 4))
    cu = CudaADERDG(ts)
    u = state_from_numpy(random_state(ts), device="cpu")
    out = cu.step(u, DT)
    assert torch.equal(out, ts.step(u, DT))
    new, faces, _ = cu.predictor_volume(u, DT)
    assert faces.shape == ts.face_shape == (3, 4, 16, 12, 4, 2, 4)
    assert cu.face_surface(new, faces, DT) is new  # in place, as the kernel
    assert torch.equal(new, out)
    assert cu.kernels == ("aderdg_ck_predictor_volume", "aderdg_face_flux",
                          "aderdg_surface_update")
    assert cu.launches == {"aderdg_ck_predictor_volume": 0, "aderdg_face_flux": 0,
                           "aderdg_surface_update": 0}


# ------------------------------------------------------------- refusals


def _noop_source(q, va):
    return 0.0 * q


@pytest.mark.parametrize(
    "options",
    [
        {"source_fn": _noop_source},
        {"ncp_fn": lambda q, dq, d, va: dq},
        {"rhs_all_fn": lambda q, grads, va: q},
        {"boundary": "reflective"},
        {"boundary": "outflow", "wall_axes": (2,)},
        {"visc_flux_fn": lambda q, g, d, va: q},
    ],
    ids=["source", "ncp", "rhs_all", "reflective", "free_surface_axis", "viscous"],
)
def test_unported_ck_combinations_raise(options):
    if "boundary" in options:
        # Ported with the walls: the CK free surface (reflective with the
        # free-surface hooks) and an outflow axis, accepted, the JAX step, and
        # the kernels.
        _assert_ck_walls_match_jax(options)
        return
    if "visc_flux_fn" in options:
        # Ported with the viscous fluxes (Picard only): CK refuses them with
        # JAX's words, as JAX refuses a lone visc_flux_fn first.
        with pytest.raises(SemanticError, match="must be set together"):
            port_ck_solver(3, (2, 2, 2), **options)
        with pytest.raises(SemanticError, match="Cauchy–Kovalewski"):
            port_ck_solver(3, (2, 2, 2), **options,
                           visc_eigenvalue_fn=lambda q, d, va: 0.0 * q.select(va, 0))
        return
    # Ported with CK's source, NCP and fused right-hand side (the plain
    # solver; tests/test_torch_ck_source.py holds them to JAX): the CUDA
    # kernels refuse them, naming the K2 a instances still to port.
    sol = port_ck_solver(3, (2, 2, 2), **options)
    with pytest.raises(LoweringError, match=r"ROADMAP.md, Queue 2 K2 a"):
        CudaADERDG(sol)


def _assert_ck_walls_match_jax(walls):
    hooks, named = {}, None
    if walls["boundary"] == "reflective":
        refl, refl_flux = jel.elastic3d_free_surface_het()
        hooks, named = dict(reflect_fn=refl, reflect_flux_fn=refl_flux), (
            "elastic3d_het_free_surface")
    js = jax_ck_solver(3, (4, 2, 4), **walls, **hooks)
    ts = aderdg_from_jax(js, physics="elastic3d_het", walls=named, device="cpu")
    Q = random_state(ts, seed=9)
    ref = np.asarray(js.step(jnp.asarray(Q), DT))
    got = state_to_numpy(ts.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[MAT], Q[MAT])
    assert CudaADERDG(ts).walls is not None


@pytest.mark.parametrize(
    "options,match",
    [
        ({"predictor_mode": "taylor"}, "predictor_mode"),
        ({"predictor_mode": "picard"}, "only applies"),  # slots without CK
        ({"ck_material_slots": (9, 12)}, r"\[0, 12\)"),
        ({"dissipation_mask": (1.0,) * 9}, "one entry per variable"),
    ],
    ids=["mode", "slots_without_ck", "slot_range", "mask_length"],
)
def test_ck_configuration_errors(options, match):
    with pytest.raises(SemanticError, match=match):
        port_ck_solver(3, (2, 2, 2), **options)


@pytest.mark.parametrize(
    "build,match",
    [
        (lambda: port_ck_solver(3, (2, 2, 2), predictor_mode="picard",
                                ck_material_slots=None), "predictor_mode='ck'"),
        (lambda: port_ck_solver(3, (2, 2, 2), ck_material_slots=(9, 10)),
         "ck_material_slots"),
        (lambda: port_ck_solver(3, (2, 2, 2), ck_material_slots=None), "ck_material_slots"),
        (lambda: port_ck_solver(3, (2, 2, 2), dissipation_mask=None), "dissipation_mask"),
        (lambda: port_ck_solver(3, (2, 2, 2), dissipation_mask=(1,) * 12),
         "dissipation_mask"),
        (lambda: port_ck_solver(2, (2, 2, 2), boundary="reflective", wall_axes=(2,),
                                reflect_fn=elastic.elastic3d_free_surface_het()[0],
                                reflect_flux_fn=elastic.elastic3d_free_surface_het()[1]),
         "at order 2 is periodic only"),
        (lambda: ADERDGSolver(3, 3, 5, (2, 2, 2), *euler_physics(3), device="cpu",
                              predictor_mode="ck"), "predictor_mode='picard'"),
        (lambda: ADERDGSolver(3, 3, 5, (2, 2, 2), *euler_physics(3), device="cpu",
                              dissipation_mask=(1, 1, 1, 1, 0)), "dissipation_mask"),
        (lambda: ADERDGSolver(3, 3, 12, (2, 2, 2), elastic.elastic3d_heterogeneous()[0],
                              euler_physics(3)[1], device="cpu", **CK), "Euler"),
    ],
    ids=["elastic_picard", "other_slots", "no_slots", "no_mask", "other_mask",
         "order2", "euler_ck", "euler_mask", "mixed_pair"],
)
def test_cuda_wrapper_refuses_uninstantiated_pairs(build, match):
    with pytest.raises(LoweringError, match=match):
        CudaADERDG(build())


def test_convert_names_the_physics():
    js = jax_ck_solver(2, (2, 2, 2))
    pair = elastic.elastic3d_heterogeneous()
    by_pair = aderdg_from_jax(js, physics=pair, device="cpu")
    assert by_pair.flux_fn is pair[0] and by_pair.predictor_mode == "ck"
    assert aderdg_from_jax(js, physics="elastic3d_het", device="cpu").n_vars == 12
    with pytest.raises(SemanticError, match="gamma"):
        aderdg_from_jax(js, physics="elastic3d_het", gamma=1.4, device="cpu")
    with pytest.raises(SemanticError, match="physics must be"):
        aderdg_from_jax(js, physics="acoustic", device="cpu")
    flux, eig = jax_euler_physics(dim=2, n_real=4)
    je = JaxSolver(dim=2, order=2, n_vars=4, grid_shape=(2, 2), flux_fn=flux,
                   max_eigenvalue_fn=eig)
    with pytest.raises(SemanticError, match="needs gamma"):
        aderdg_from_jax(je, device="cpu")
    assert aderdg_from_jax(je, gamma=1.4, device="cpu").flux_fn.physics.gamma == 1.4


def test_limiter_refuses_a_ck_solver():
    """A CK solver builds a limiter since ROADMAP Queue 1 item 9.4 (its
    fallback reads the physics callbacks and the dissipation mask;
    ``tests/test_torch_limiter_ncp.py`` holds its step to JAX); what stays
    refused is the sweep kernel for its masked physics, Queue 2 K3 a."""
    from exahype_tpu_torch.models import subcell_cuda
    from exahype_tpu_torch.models.limiter import LimitedADERDG

    lim = LimitedADERDG(port_ck_solver(3, (2, 2, 2)), troubled_capacity=2,
                        troubled_granularity="row", subcell_cuda=True, device="cpu")
    assert lim.solver.predictor_mode == "ck"
    with pytest.raises(LoweringError, match=r"dissipation mask.*ROADMAP.md, Queue 2 K3 a"):
        subcell_cuda.check_physics(lim)
