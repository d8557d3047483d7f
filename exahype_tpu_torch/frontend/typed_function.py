"""Typed external functions for kernel specs.

Port of ``exahype_tpu/frontend/typed_function.py``.  The user-facing
contract is the same (``kernel.function(...)`` returns a callable usable
inside SymPy expressions, with the reference's ``returnType()`` /
``parameterTypes()`` accessors), and a function carries the two bodies the
port's printers inline in place of the JAX package's ``jax_impl`` /
``tpu_impl``:

- ``torch_impl``: a PyTorch callable in the SoA-P layout, the plain version
  that :class:`exahype_tpu_torch.backends.torch_backend.TorchPrinter`
  evaluates;
- ``cuda_source``: CUDA C++ that the generated kernel of
  :class:`exahype_tpu_torch.backends.cuda_backend.CudaPrinter` includes.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import sympy
from sympy.codegen.ast import none


class TypedFunction:
    """Factory for a typed sympy function with PyTorch and CUDA bodies.

    Instances behave like ``sympy.Function('name')``: calling them builds a
    SymPy applied-function node.  Type metadata is available both on the
    factory and (for reference API parity) via ``returnType()`` /
    ``parameterTypes()`` accessors on the produced function class.
    """

    def __init__(
        self,
        name: str,
        parameter_types: Sequence[Any] = (),
        return_type: Any = none,
        torch_impl: Callable | None = None,
        out_param: int | None = None,
        cuda_source: str | None = None,
    ):
        self.name = name
        self.parameter_types = list(parameter_types)
        self.return_type = return_type
        #: PyTorch callable in the SoA-P layout: struct pointer parameters
        #: arrive as ``[*spatial, var, *patch_tail]`` tensors (variable axis
        #: at position ``dim``), scalar-field pointers as
        #: ``[*spatial, *patch_tail]``, scalars as Python floats.  It returns
        #: a tensor with or without the variable axis.
        self.torch_impl = torch_impl
        #: Index of an output-pointer parameter, if the function writes its
        #: result through an argument instead of returning it (the reference's
        #: ``Flux(Q, normal, F)`` convention, ``Unit test/Functions.cpp:9-37``).
        self.out_param = out_param
        #: CUDA C++ placed at file scope of the generated kernel source.  It
        #: defines ``template <typename T> __device__ ... spec_<name>(...)``,
        #: called once per cell: a struct pointer parameter is ``const T*``
        #: to the cell's variable vector, a scalar field or scalar is ``T``,
        #: the output parameter is ``T*`` with room for the output item's
        #: variables (all of which the function writes).  It may
        #: ``#include`` the port's ``csrc/*.cuh`` headers.
        self.cuda_source = cuda_source

        fn = sympy.Function(name)
        # Reference-compatible accessors (``exahype/TypedFunction.py:26-34``):
        # with no argument they read, with an argument they set.
        typed = self

        def returnType(arg=None):
            if arg is not None:
                typed.return_type = arg
            return typed.return_type

        def parameterTypes(arg=None):
            if arg is not None:
                typed.parameter_types = list(arg)
            return typed.parameter_types

        fn.returnType = staticmethod(returnType)
        fn.parameterTypes = staticmethod(parameterTypes)
        fn._typed = typed
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return f"TypedFunction({self.name!r})"


def typed_of(expr: sympy.Basic) -> TypedFunction | None:
    """Return the TypedFunction registry entry for an applied function node."""
    return getattr(expr.func, "_typed", None)
