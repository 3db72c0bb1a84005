"""Bare-metal modules: existing hosts driven over SSH (the port's copy of
the reference's ``modules/bare_metal.py``).

* ``bare-metal-manager`` -- the manager the port's GPU documents name
  (``module.cluster-manager``): it adopts an existing host and bootstraps
  the control plane's credentials on it;
* ``bare-metal-k8s`` -- a cluster registration (API call only);
* ``bare-metal-k8s-host`` -- one adopted host that joins its cluster.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .base import DriverContext, Resource, Variable
from .family import ClusterModule, HostModule, ManagerModule
from .registry import register


@register
class BareMetalManager(ManagerModule):
    SOURCE = "modules/bare-metal-manager"
    ALIASES = ("bare-metal-rancher",)
    PROVIDER = "bare-metal"
    VARIABLES = ManagerModule.VARIABLES + [
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


@register
class BareMetalCluster(ClusterModule):
    SOURCE = "modules/bare-metal-k8s"
    ALIASES = ("bare-metal-rancher-k8s",)
    PROVIDER = "bare-metal"


@register
class BareMetalHost(HostModule):
    SOURCE = "modules/bare-metal-k8s-host"
    ALIASES = ("bare-metal-rancher-k8s-host",)
    PROVIDER = "bare-metal"
    VARIABLES = HostModule.VARIABLES + [
        Variable("host", required=True),
        Variable("ssh_user", default="root"),
        Variable("key_path", default="~/.ssh/id_rsa"),
        Variable("bastion_host", default=""),
    ]

    def instance_attrs(self, config: Dict[str, Any]) -> Dict[str, Any]:
        return {"ip": config["host"], "adopted": True}
