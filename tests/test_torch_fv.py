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
    kb = build_fv_rusanov_kernel(dim=3, patch_size=4, halo_size=1, n_real=5,
                                 n_aux=0, n_patches=8)
    pr = CudaPrinter(kb)
    # Q, Q_copy (5 vars), 3 tmp_flux (5), 3 tmp_eigen (1): 28 values per cell.
    assert pr.bytes_per_patch(torch.float32) == 6 ** 3 * 28 * 4 == 24192
    assert pr.bytes_per_patch(torch.float64) == 48384
    assert pr.tiles == {torch.float32: 8, torch.float64: 4}
    for dtype, tile in pr.tiles.items():
        assert tile * pr.bytes_per_patch(dtype) <= SMEM_PER_BLOCK
        assert 2 * tile * pr.bytes_per_patch(dtype) > SMEM_PER_BLOCK
    small = CudaPrinter(build_fv_rusanov_kernel(dim=2, patch_size=4, n_patches=4))
    assert small.tiles == {torch.float32: 32, torch.float64: 32}
    with pytest.raises(LoweringError, match="shared memory"):
        CudaPrinter(build_fv_rusanov_kernel(dim=3, patch_size=12, halo_size=1))


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
    assert "launch<float, 8>" in a and "launch<double, 4>" in a
    assert "spec_Flux<T>" in a and "spec_maxEigenvalue<T>" in a and "spec_max<T>" in a
    # Literals are cast to the kernel's type: no bare double in a float kernel.
    assert "T(0.5)" in a and " 0.5 " not in a and "(0.5 *" not in a
    # 20 statements, 6 of them directional constants: 14 loops, 14 barriers
    # (+1 after the load).
    assert a.count("__syncthreads();") == 15
    canonical = CudaPrinter(build_rusanov_kernel(dim=3, n_aux=0, n_patches=64)).code
    assert canonical != a
