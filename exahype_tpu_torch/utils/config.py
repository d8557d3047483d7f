"""Kernel configuration.

Copy of ``exahype_tpu/utils/config.py`` (the port imports nothing of the
JAX package).

The reference's entire configuration surface is the ``KernelBuilder.__init__``
keyword set (``exahype/KernelBuilder.py:51``) plus C++ literal defines
(``:86-90``).  Here that surface is a frozen dataclass so that configs hash,
compare, and can key jit caches.
"""

from __future__ import annotations

import dataclasses

from exahype_tpu_torch.utils.errors import SemanticError

#: Names of the spatial loop indices, outermost-first, per dimension count.
#: The reference uses ``patch, i, j[, k], var`` (``exahype/KernelBuilder.py:61-64``).
SPATIAL_INDEX_NAMES = ("i", "j", "k")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Static shape/config of a patch-update kernel.

    Mirrors the reference constructor arguments
    (``exahype/KernelBuilder.py:51-59``):

    - ``dim``: spatial dimensionality, 2 or 3.
    - ``patch_size``: interior cells per spatial axis of one patch.
    - ``halo_size``: ghost layers per side (stored padding is ``2*halo_size``).
    - ``n_real``: evolved (conserved) variables per cell.
    - ``n_aux``: auxiliary (material parameter) variables per cell.
    - ``n_patches``: number of patches batched in the leading axis.
    """

    dim: int
    patch_size: int
    halo_size: int
    n_real: int
    n_aux: int
    n_patches: int = 1

    def __post_init__(self):
        # Reference viability rules (``exahype/KernelBuilder.py:41-48``),
        # extended with the variable/patch-count checks the reference omits.
        if self.dim not in (2, 3):
            raise SemanticError(f"dim must be 2 or 3, got {self.dim}")
        if self.patch_size < 1:
            raise SemanticError(f"patch_size must be >= 1, got {self.patch_size}")
        if self.halo_size < 0:
            raise SemanticError(f"halo_size must be >= 0, got {self.halo_size}")
        if self.n_real < 1:
            raise SemanticError(f"n_real must be >= 1, got {self.n_real}")
        if self.n_aux < 0:
            raise SemanticError(f"n_aux must be >= 0, got {self.n_aux}")
        if self.n_patches < 1:
            raise SemanticError(f"n_patches must be >= 1, got {self.n_patches}")

    @property
    def n_vars(self) -> int:
        """Total variables per cell (``n_real + n_aux``)."""
        return self.n_real + self.n_aux

    @property
    def extent(self) -> int:
        """Stored cells per spatial axis including halo padding.

        The reference computes this as the default index range
        ``patch_size + 2*halo_size`` (``exahype/KernelBuilder.py:76-78``).
        """
        return self.patch_size + 2 * self.halo_size

    @property
    def interior(self) -> tuple[int, int]:
        """Half-open interior range along a spatial axis: ``[halo, patch+halo)``."""
        return (self.halo_size, self.patch_size + self.halo_size)

    @property
    def spatial_index_names(self) -> tuple[str, ...]:
        return SPATIAL_INDEX_NAMES[: self.dim]

    @property
    def index_names(self) -> tuple[str, ...]:
        """All loop-index names, outermost first: patch, spatial..., var."""
        return ("patch",) + self.spatial_index_names + ("var",)

    def shape(self, struct: int) -> tuple[int, ...]:
        """Array shape for an item with the given struct level.

        struct levels follow the reference's ``item_struct`` encoding
        (``exahype/KernelBuilder.py:74``): 0 = scalar field (no var axis),
        1 = ``n_real`` variables, 2 = ``n_real + n_aux`` variables.
        """
        base = (self.n_patches,) + (self.extent,) * self.dim
        if struct == 0:
            return base
        if struct == 1:
            return base + (self.n_real,)
        if struct == 2:
            return base + (self.n_vars,)
        raise SemanticError(f"invalid struct level {struct}")

    def dofs(self) -> int:
        """Interior degrees of freedom across all patches (real vars only)."""
        return self.n_patches * self.patch_size**self.dim * self.n_real
