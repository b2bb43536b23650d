"""Lazy re-exports for the subpackages' `__init__`s.

A subpackage exports the JAX package's public names for it, but loads the
module that defines a name only when the name is first read (PEP 562).
Importing one submodule therefore imports no sibling: the exported
serving artifact's loader (`infer/export.py`) stays free of
`infer.engine` and `train`, and nothing imports more than it uses.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Sequence


def lazy_exports(package: str, exports: Dict[str, Sequence[str]]) -> Callable[[str], Any]:
    """A module `__getattr__` for `package` that resolves each name of
    `exports` ({module: names}) from its module; a name equal to the
    module's last component is the module itself (`models.shapes`, and
    `ops.edt`, whose JAX counterpart is the function edt shadowing its
    own submodule)."""
    where = {name: module for module, names in exports.items() for name in names}

    def __getattr__(name: str) -> Any:
        if name not in where:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(where[name])
        return module if where[name].rsplit(".", 1)[-1] == name else getattr(module, name)

    return __getattr__
