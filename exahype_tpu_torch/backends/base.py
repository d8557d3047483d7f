"""Abstract backend base (parity with ``exahype/printers/CodePrinter.py:46-71``).

Copy of ``exahype_tpu/backends/base.py`` (the port imports nothing of the
JAX package).

A backend consumes a populated :class:`KernelBuilder` and produces an
artifact: generated source text (C++ backend) or a compiled callable
(JAX/Pallas backends, where ``code`` holds a textual rendering — the jaxpr —
for inspection and golden tests).
"""

from __future__ import annotations

import abc
import pathlib

from exahype_tpu_torch.frontend.kernel_builder import KernelBuilder


class CodePrinter(abc.ABC):
    def __init__(self, kernel: KernelBuilder, function_name: str = "time_step"):
        self._kernel = kernel
        self._function_name = function_name
        self.code: str = ""

    # Reference-style accessors (``CodePrinter.py:52-60``).
    def kernel(self) -> KernelBuilder:
        return self._kernel

    def functionName(self) -> str:
        return self._function_name

    def file(self, file_name: str, header_file_name: str | None = None) -> None:
        """Write the generated source to ``file_name`` (``CodePrinter.py:62-64``)."""
        pathlib.Path(file_name).write_text(self.code)

    def here(self) -> None:
        """Dump the generated source to stdout (``CodePrinter.py:66-67``)."""
        print(self.code)
