"""Lazy package exports: a package's names imported at their first use.

The fleet's balancer process imports ``dwt_tpu_torch.fleet``,
``dwt_tpu_torch.serve.http`` and ``dwt_tpu_torch.resilience.inject`` and
must import no torch (it holds no CUDA context), while those packages'
other modules need torch.  Their ``__init__`` therefore names each export's
module in a table and resolves it through :func:`lazy_exports`.
"""

import importlib
from typing import Callable, Dict


def lazy_exports(package: str, exports: Dict[str, str]) -> Callable[[str], object]:
    """The module-level ``__getattr__`` of ``package``: ``name`` is read
    from the submodule ``exports[name]``, imported on first use."""

    def __getattr__(name: str) -> object:
        if name in exports:
            module = importlib.import_module(f"{package}.{exports[name]}")
            return getattr(module, name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    return __getattr__
