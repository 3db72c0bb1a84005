"""Provisioning modules (the port's copy of the reference's ``modules``
package): the three rancher families -- manager, cluster, host
(``family``) -- for aws, azure, triton, vsphere, bare-metal and gcp, the
hosted clusters (gke, aks), and the H100 twins of the reference's
TPU-bound modules (``gcp_gpu``), as render functions and as registered
:class:`Module` classes the port's executor applies. The registry
resolves a document's ``source`` to its class, as the reference's does.
The reference's backup module is not ported.
"""

from .base import DriverContext, Module, ModuleError, Resource
from .registry import REGISTRY, get_module, module_name_from_source, register

# Import provider modules for registration side effects.
from . import bare_metal  # noqa: E402
from . import triton  # noqa: E402
from . import aws  # noqa: E402
from . import gcp  # noqa: E402
from . import azure  # noqa: E402
from . import vsphere  # noqa: E402
from . import gke  # noqa: E402
from . import aks  # noqa: E402
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
