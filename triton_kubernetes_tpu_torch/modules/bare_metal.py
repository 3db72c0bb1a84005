"""The bare-metal cluster manager: the manager module the port's GPU
documents name (``module.cluster-manager``). The port's copy of the
reference's ``BareMetalManager`` (``modules/bare_metal.py`` over
``modules/family.py``'s ``ManagerModule``): it adopts an existing host
and bootstraps the control plane's credentials on it. The reference's
bare-metal cluster and host modules are not ported: GPU capacity comes
from GKE node pools (``gcp_gpu``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .base import DriverContext, Module, Resource, Variable
from .registry import register


@register
class BareMetalManager(Module):
    SOURCE = "modules/bare-metal-manager"
    ALIASES = ("bare-metal-rancher",)
    OUTPUTS = ["manager_url", "manager_access_key", "manager_secret_key"]
    VARIABLES = [
        Variable("name", required=True),
        Variable("manager_image", default="tk8s/manager:2.0"),
        Variable("agent_image", default="tk8s/agent:2.0"),
        Variable("admin_password", default=""),
        Variable("host", required=True),
        Variable("ssh_user", default="root"),
        Variable("key_path", default="~/.ssh/id_rsa"),
        Variable("bastion_host", default=""),
    ]

    def apply(self, config: Dict[str, Any], ctx: DriverContext
              ) -> Tuple[Dict[str, Any], List[Resource]]:
        # No VM creation: adopt the named host (remote-exec analog).
        name = config["name"]
        ctx.cloud.create_resource(
            "bare-metal_instance", f"{name}-manager",
            ip=config["host"], role="manager", adopted=True)
        url = f"https://{config['host']}"
        creds = ctx.cloud.bootstrap_manager(name, url)
        ctx.cloud.create_resource("manager", name, url=url)
        resources = [Resource("bare-metal_instance", f"{name}-manager"),
                     Resource("manager", name)]
        return ({"manager_url": creds["url"],
                 "manager_access_key": creds["access_key"],
                 "manager_secret_key": creds["secret_key"]}, resources)
