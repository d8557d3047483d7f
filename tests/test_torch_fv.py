"""The port's spec front end and printers against the JAX package's, on the
CPU.

The front end (``KernelBuilder``, bounds, dataflow) is a copy; the plain
PyTorch printer is held against ``PallasPrinter`` in interpret mode and
against ``JAXPrinter`` through the layout transpose, on the canonical
Rusanov spec and the corrected FV spec, in the 3-D ``n_aux=0``
configuration of the port's main path and the reference's own 2-D
``n_aux=5`` one.  Inputs are made with NumPy from a seed and handed to
both.  f64 at rtol=0, atol=1e-13: the bar ``tests/test_pallas_backend.py``
holds the Pallas kernel to (the same operations in the same order).

The generated CUDA kernel runs only on a card
(``tests/test_torch_cuda.py``); here its printer's CPU-side behaviour is
checked: tile sizes, refusals, a deterministic source, and the wrapper's
plain path.
"""

import itertools
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import sympy
import torch

from exahype_tpu.backends.jax_backend import JAXPrinter
from exahype_tpu.backends.pallas_backend import PallasPrinter, to_tpu_layout
from exahype_tpu.frontend.kernel_builder import KernelBuilder as JaxKernelBuilder
from exahype_tpu.models.fv import build_fv_rusanov_kernel as jax_fv
from exahype_tpu.models.rusanov import build_rusanov_kernel as jax_rusanov
from exahype_tpu.utils.errors import LoweringError as JaxLoweringError
from exahype_tpu_torch.backends.cuda_backend import (
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    SMEM_RESERVED,
    TILE_BYTES,
    CudaPrinter,
)
from exahype_tpu_torch.backends.torch_backend import TorchPrinter
from exahype_tpu_torch.frontend.kernel_builder import KernelBuilder
from exahype_tpu_torch.models import euler
from exahype_tpu_torch.models.fv import build_fv_rusanov_kernel
from exahype_tpu_torch.models.rusanov import build_rusanov_kernel
from exahype_tpu_torch.utils.errors import LoweringError

torch.set_num_threads(1)

SPECS = {"rusanov": (jax_rusanov, build_rusanov_kernel), "fv": (jax_fv, build_fv_rusanov_kernel)}
#: (dim, patch_size, n_aux, patch grid): the port's main-path width, and the
#: reference's 2-D test configuration (``rusanov.py:41-43``).
CONFIGS = {
    "3d_aux0": (3, 4, 0, (2, 1, 2)),
    "2d_aux5": (2, 4, 5, (2, 3)),
}


def euler_state(kb, seed):
    """``__graft_entry__._example_state``'s recipe in f64, AoS layout."""
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0.1, 1.0, size=kb.item_shape("Q"))
    Q[..., 0] += 1.0
    Q[..., kb.config.dim + 1] += 5.0
    return Q


def both(spec, config):
    dim, patch, n_aux, grid = CONFIGS[config]
    kw = dict(dim=dim, patch_size=patch, halo_size=1, n_real=5, n_aux=n_aux,
              n_patches=int(np.prod(grid)))
    jax_build, port_build = SPECS[spec]
    return jax_build(**kw), port_build(**kw), grid


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_torch_backend_matches_pallas_and_jax(spec, config):
    jkb, kb, grid = both(spec, config)
    Q = euler_state(jkb, seed=len(grid))
    soa = np.asarray(to_tpu_layout(jnp.asarray(Q)))  # [*extent, V, patch]
    soa_grid = soa.reshape(soa.shape[:-1] + grid)
    pallas = PallasPrinter(jkb, interpret=True, patch_grid_shape=grid).build()
    want_pallas = np.asarray(pallas(jnp.asarray(soa_grid), 0.01))
    want_jax = np.asarray(to_tpu_layout(JAXPrinter(jkb).build()(jnp.asarray(Q), 0.01)))

    got = TorchPrinter(kb).build()(torch.from_numpy(soa_grid.copy()), 0.01).numpy()
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-13)
    np.testing.assert_allclose(got.reshape(soa.shape), want_jax, rtol=0, atol=1e-13)
    assert np.abs(got - soa_grid).max() > 1e-4  # the update did something
    # On a CPU tensor the CUDA wrapper is the plain version, in place.
    fn = CudaPrinter(kb).build()
    Qt = torch.from_numpy(soa_grid.copy())
    assert fn(Qt, torch.tensor(0.01, dtype=torch.float64)) is Qt
    np.testing.assert_array_equal(Qt.numpy(), got)
    assert fn.launches == 0


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_front_end_copy_matches_jax(spec):
    """The copied KernelBuilder, bounds and dataflow give the JAX package's
    statements, regions and temps."""
    from exahype_tpu.frontend.bounds import statement_ranges as jax_ranges
    from exahype_tpu_torch.frontend.bounds import statement_ranges

    jkb, kb, _ = both(spec, "3d_aux0")
    assert [str(s.lhs) for s in kb.statements] == [str(s.lhs) for s in jkb.statements]
    assert [str(s.rhs) for s in kb.statements] == [str(s.rhs) for s in jkb.statements]
    assert kb.temp_items() == jkb.temp_items()
    assert kb.item_struct == jkb.item_struct
    assert kb.literal_values == jkb.literal_values
    assert kb.inputs == jkb.inputs
    for s, js in zip(kb.statements, jkb.statements):
        if s.kind.value != "loop":
            continue
        for last in (False, True):
            assert statement_ranges(kb.config, s, kb.item_struct) == jax_ranges(
                jkb.config, js, jkb.item_struct, policy="sound", is_last_lhs=last
            )


def _chained_reach_spec(builder_cls):
    """A two-stage stencil whose chained reach (2) exceeds halo_size=1."""
    kb = builder_cls(dim=2, patch_size=4, halo_size=1, n_real=1, n_aux=0)
    Q = kb.item("Q")
    A = kb.directional_item("A")
    kb.directional(A[0], Q[-1] + Q[1])
    B = kb.item("B")
    kb.directional(B[0], A[-1] - A[1])
    kb.single(Q[0], B[0])
    return kb


def test_dataflow_refusal_matches_jax():
    from exahype_tpu.frontend.dataflow import validate_dataflow as jax_validate
    from exahype_tpu_torch.frontend.dataflow import validate_dataflow

    with pytest.raises(JaxLoweringError):
        jax_validate(_chained_reach_spec(JaxKernelBuilder))
    with pytest.raises(LoweringError, match="halo_size=1"):
        validate_dataflow(_chained_reach_spec(KernelBuilder))
    with pytest.raises(LoweringError):
        CudaPrinter(_chained_reach_spec(KernelBuilder))


# ---------------------------------------------------------------- CUDA printer


def test_cuda_printer_tile_from_byte_count():
    """A patch needs shared memory for each item over the box of the cells
    it touches; a tile is one 32-byte sector of patches a row where it
    fits, and two tiles of the main-path spec fit one SM."""
    kb = build_fv_rusanov_kernel(dim=3, patch_size=4, halo_size=1, n_real=5,
                                 n_aux=0, n_patches=8)
    pr = CudaPrinter(kb)
    # Q over the padded patch (6^3 cells, 5 vars), Q_copy over the interior
    # (4^3, 5), each axis's tmp_flux (5 vars) and tmp_eigen (1) over the
    # interior and the two face halos along it (6 * 4 * 4 cells).
    values = 6**3 * 5 + 4**3 * 5 + 3 * 6 * 4 * 4 * (5 + 1)
    assert values == 3128
    assert pr.bytes_per_patch(torch.float32) == values * 4 == 12512
    assert pr.bytes_per_patch(torch.float64) == values * 8
    assert pr.tiles == {torch.float32: 8, torch.float64: 4}
    for dtype, tile in pr.tiles.items():
        assert tile * torch.empty((), dtype=dtype).element_size() == TILE_BYTES
        assert tile * pr.bytes_per_patch(dtype) <= SMEM_PER_BLOCK
        assert 2 * (tile * pr.bytes_per_patch(dtype) + SMEM_RESERVED) <= SMEM_PER_SM
    assert {pr.min_blocks(dtype) for dtype in pr.tiles} == {2}
    assert "__launch_bounds__(kThreads, MB)" in pr.code
    assert "launch<float, 8, 2>" in pr.code and "launch<double, 4, 2>" in pr.code
    small = CudaPrinter(build_fv_rusanov_kernel(dim=2, patch_size=4, n_patches=4))
    assert small.tiles == {torch.float32: 8, torch.float64: 4}
    with pytest.raises(LoweringError, match="shared memory"):
        CudaPrinter(build_fv_rusanov_kernel(dim=3, patch_size=12, halo_size=1))


@pytest.mark.parametrize("patch,tiles", [(6, (4, 2)), (8, (2, 1))])
def test_cuda_printer_large_patches_take_smaller_tiles(patch, tiles):
    """Where a 32-byte tile does not fit, the tile is the largest power of
    two that does: a spec is refused only if one patch does not fit, and
    every patch size the whole-patch layout took (each item over the
    padded patch) still prints."""
    pr = CudaPrinter(build_fv_rusanov_kernel(dim=3, patch_size=patch, halo_size=1))
    assert (pr.tiles[torch.float32], pr.tiles[torch.float64]) == tiles
    for dtype, tile in pr.tiles.items():
        itemsize = torch.empty((), dtype=dtype).element_size()
        per_patch = pr.bytes_per_patch(dtype)
        assert per_patch <= (patch + 2) ** 3 * 28 * itemsize  # the whole-patch layout's
        assert tile * per_patch <= SMEM_PER_BLOCK < 2 * tile * per_patch
        assert pr.min_blocks(dtype) == 1
        assert f"launch<{'float' if itemsize == 4 else 'double'}, {tile}, 1>" in pr.code


#: (spec, dim, n_aux) of the demand-analysis tests: both specs, 2-D and 3-D,
#: without and with auxiliary variables.
DEMAND_CASES = [(spec, dim, n_aux) for spec in sorted(SPECS) for dim in (2, 3)
                for n_aux in (0, 5)]


def _printer(spec, dim, n_aux, n_patches=1):
    return CudaPrinter(SPECS[spec][1](dim=dim, patch_size=4, halo_size=1, n_real=5,
                                      n_aux=n_aux, n_patches=n_patches))


@pytest.mark.parametrize("spec,dim,n_aux", DEMAND_CASES)
def test_demand_read_and_write_sets_match_hand_count(spec, dim, n_aux):
    """The kernel loads the interior and the 2·dim face halos (every
    variable, which the flux calls gather) and stores the interior; each
    axis's flux and wave speed run on the interior and the two face halos
    along that axis."""
    p, n_vars = 4, 5 + n_aux
    pr = _printer(spec, dim, n_aux)
    interior = set(itertools.product(range(1, p + 1), repeat=dim))
    faces = {c[:d] + (h,) + c[d + 1:] for c in interior for d in range(dim)
             for h in (0, p + 1)}
    assert len(interior | faces) == p**dim + 2 * dim * p ** (dim - 1)
    assert pr.read_cells == {(c, v) for c in interior | faces for v in range(n_vars)}
    assert pr.write_cells == {(c, v) for c in interior for v in range(n_vars)}
    if (spec, dim) == ("fv", 3):
        assert len({c for c, _ in pr.read_cells}) == 160
        assert len({c for c, _ in pr.write_cells}) == 64
    demanded = {lp.target: sum(math.prod(hi - lo for lo, hi in box) for box, _ in lp.pieces)
                for lp in pr.plan.loops if lp.target.startswith("tmp_")}
    assert len(demanded) == 2 * dim
    assert set(demanded.values()) == {(p + 2) * p ** (dim - 1)}
    assert pr.moved_bytes(10, torch.float32) == 10 * 4 * n_vars * (
        len(interior | faces) + len(interior))


@pytest.mark.parametrize("spec,dim,n_aux", DEMAND_CASES)
def test_demand_probe_through_the_plain_version(spec, dim, n_aux):
    """NaN in every state value outside the read set leaves the plain
    version's output on the write set bitwise equal to the clean run's, and
    the clean run leaves every value outside the write set as it was."""
    pr = _printer(spec, dim, n_aux, n_patches=3)
    jkb = SPECS[spec][0](dim=dim, patch_size=4, halo_size=1, n_real=5, n_aux=n_aux,
                         n_patches=3)
    Q = np.asarray(to_tpu_layout(jnp.asarray(euler_state(jkb, seed=dim + n_aux))))
    read = np.zeros(Q.shape[:-1], dtype=bool)
    write = np.zeros(Q.shape[:-1], dtype=bool)
    for cell, v in pr.read_cells:
        read[cell + (v,)] = True
    for cell, v in pr.write_cells:
        write[cell + (v,)] = True
    plain = TorchPrinter(pr.kernel()).build()
    clean = plain(torch.from_numpy(Q.copy()), 0.01).numpy()
    probed = Q.copy()
    probed[~read] = np.nan
    got = plain(torch.from_numpy(probed), 0.01).numpy()
    np.testing.assert_array_equal(got[write], clean[write])
    assert np.isfinite(got[write]).all()
    np.testing.assert_array_equal(clean[~write], Q[~write])
    assert (clean[write] != Q[write]).any()  # the update did something


#: The function bodies each package's ``kernel.function`` takes.
IMPL = {
    JaxKernelBuilder: dict(jax_impl=lambda q: q, tpu_impl=lambda q: q),
    KernelBuilder: dict(torch_impl=lambda q: q, cuda_source="spec_F"),
}


def _self_stencil(builder):
    kb = builder(dim=2, patch_size=4, halo_size=1, n_real=1, n_aux=0)
    Q = kb.item("Q")
    kb.directional(Q[0], Q[-1] + Q[1])
    return kb


def _pointer_call_in_var_loop(builder):
    kb = builder(dim=2, patch_size=4, halo_size=1, n_real=3, n_aux=0)
    Q = kb.item("Q")
    Q_copy = kb.item("Q_copy")
    F = kb.function("F", parameter_types=[Q], **IMPL[builder])
    kb.single(Q_copy[0], Q[0])
    kb.single(Q_copy[0], Q_copy[0] + F(Q[0]), struct_override=1)
    kb.single(Q[0], Q_copy[0])
    return kb


@pytest.mark.parametrize(
    "make", [_self_stencil, _pointer_call_in_var_loop],
    ids=["self_referencing_stencil", "pointer_call_in_var_loop"],
)
def test_cuda_printer_refuses_what_pallas_refuses(make):
    jkb, kb = make(JaxKernelBuilder), make(KernelBuilder)
    shape = (6, 6, jkb.config.n_vars, jkb.config.n_patches)
    with pytest.raises(JaxLoweringError):
        PallasPrinter(jkb, interpret=True).build()(jnp.zeros(shape))
    with pytest.raises(LoweringError):
        CudaPrinter(kb)
    with pytest.raises(LoweringError):
        TorchPrinter(kb).build()(torch.zeros(shape, dtype=torch.float64))


def test_cuda_printer_needs_cuda_source():
    kb = KernelBuilder(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=0)
    Q = kb.item("Q")
    Q_copy = kb.item("Q_copy")
    Eig = kb.function("maxEigenvalue", parameter_types=[Q, sympy.Symbol("n")],
                      torch_impl=lambda q, n: euler.max_eigenvalue(q, n, dim=2))
    kb.single(Q_copy[0], Q[0])
    kb.single(Q_copy[0], Q_copy[0] + Eig(Q[0], 0), struct_override=0)
    kb.single(Q[0], Q_copy[0])
    TorchPrinter(kb).build()  # the plain version needs only torch_impl
    with pytest.raises(LoweringError, match="cuda_source"):
        CudaPrinter(kb)


def test_cuda_printer_source_is_deterministic():
    def source():
        kb = build_fv_rusanov_kernel(dim=3, patch_size=4, halo_size=1, n_real=5,
                                     n_aux=0, n_patches=64)
        return CudaPrinter(kb).code

    a, b = source(), source()
    assert a == b
    assert "exahype_spec_time_step_f32" in a and "exahype_spec_time_step_f64" in a
    assert "exahype_spec_time_step_info" in a
    assert "launch<float, 8, 2>" in a and "launch<double, 4, 2>" in a
    assert "spec_Flux<T>" in a and "spec_maxEigenvalue<T>" in a and "spec_max<T>" in a
    # Literals are cast to the kernel's type: no bare double in a float kernel.
    assert "T(0.5)" in a and " 0.5 " not in a and "(0.5 *" not in a
    # 20 statements, 6 of them directional constants, 14 loops; Q_copy = Q
    # feeds nothing once the flux calls and the first update read Q, so 13
    # run, in 3 barrier phases (the 6 flux and wave-speed evaluations; the
    # 6 updates, fused, each element's values in its thread; the write-back),
    # plus the barrier after the load.
    assert a.count("__syncthreads();") == 4
    run = re.findall(r"// \[(\d+)\] ", a)
    assert len(run) == 13 and "0" not in run
    # Only the read set is loaded (160 cells) and only the write set stored
    # (64), a thread a cell and patch, its 5 variables in turn.
    assert "e < 160 * PT" in a and "e < 64 * PT" in a
    assert "for (int v = 0; v < 5; ++v)" in a
    canonical = CudaPrinter(build_rusanov_kernel(dim=3, n_aux=0, n_patches=64)).code
    assert canonical != a
