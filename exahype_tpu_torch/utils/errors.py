"""Error types of the port.

The same names and meanings as ``exahype_tpu/utils/errors.py``, defined
here so that the port imports nothing of the JAX package (whose
``__init__`` loads its SymPy front end).
"""


class SemanticError(Exception):
    """A solver or kernel specification is invalid, or asks for an option
    the port does not carry yet (user error)."""


class LoweringError(Exception):
    """A solver could not be lowered to the requested backend (here: the
    CUDA kernels)."""


__all__ = ["LoweringError", "SemanticError"]
