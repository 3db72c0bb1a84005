"""Provisioning modules of GPU pools: the H100 twins of the reference's
TPU-bound modules (``gcp_gpu``), as render functions and as registered
:class:`Module` classes the port's executor applies, beside the manager
module its documents name (``bare_metal``). The registry resolves a
document's ``source`` to its class, as the reference's does.
"""

from .base import DriverContext, Module, ModuleError, Resource
from .registry import REGISTRY, get_module, module_name_from_source, register

# Import provider modules for registration side effects.
from . import bare_metal  # noqa: E402
from . import gcp_gpu  # noqa: E402

__all__ = [
    "DriverContext",
    "Module",
    "ModuleError",
    "REGISTRY",
    "Resource",
    "get_module",
    "module_name_from_source",
    "register",
]
