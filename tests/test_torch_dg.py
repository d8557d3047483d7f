"""The port's DG operators equal the JAX package's, bitwise.

Both are float64 NumPy built by the same arithmetic; the port keeps a copy
(``exahype_tpu_torch/models/dg.py``) because importing the JAX package's
``models`` loads JAX.
"""

import numpy as np
import pytest
import torch

from exahype_tpu.models import dg as jdg
from exahype_tpu_torch.models import dg as tdg

torch.set_num_threads(1)

_FIELDS = ("nodes", "weights", "D", "phi0", "phi1", "K1inv", "Kvol")


@pytest.mark.parametrize("basis", ["legendre", "lobatto"])
@pytest.mark.parametrize("order", range(1, 8))
def test_dg_operators_bitwise(order, basis):
    ref = jdg.DGOperators(order, basis=basis)
    got = tdg.DGOperators(order, basis=basis)
    assert got.n_nodes == ref.n_nodes == order + 1
    for name in _FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name), getattr(ref, name), err_msg=name
        )


@pytest.mark.parametrize("basis", ["legendre", "lobatto"])
@pytest.mark.parametrize("order", [1, 3, 5])
def test_subcell_and_refinement_operators_bitwise(order, basis):
    for fn, args in (
        ("subcell_projection", (order, None, basis)),
        ("subcell_reconstruction", (order, None, basis)),
        ("refine_interpolation", (order, 3, basis)),
        ("refine_restriction", (order, 3, basis)),
    ):
        np.testing.assert_array_equal(
            getattr(tdg, fn)(*args), getattr(jdg, fn)(*args), err_msg=fn
        )
