"""Triton (Joyent) modules: the port's copy of the reference's
``modules/triton.py``.

Reference analog: modules/triton-rancher (triton_machine with CNS + role
anti-affinity, main.tf:20-38), modules/triton-rancher-k8s (API only, 15 LoC),
modules/triton-rancher-k8s-host. HCL twins exist for the real path
(terraform/modules/triton-*, targeting the archived joyent/triton
provider for private Triton installations).
"""

from __future__ import annotations

from typing import Any, Dict, List

from .base import DriverContext, Resource, Variable
from .family import ClusterModule, HostModule, ManagerModule
from .registry import register


@register
class TritonManager(ManagerModule):
    SOURCE = "modules/triton-manager"
    ALIASES = ("triton-rancher",)
    PROVIDER = "triton"
    VARIABLES = ManagerModule.VARIABLES + [
        Variable("triton_account", required=True),
        Variable("triton_key_path", required=True),
        Variable("triton_key_id", required=True),
        Variable("triton_url", default="https://us-east-1.api.joyent.com"),
        Variable("triton_image_name", default="ubuntu-certified-16.04"),
        Variable("triton_machine_package", default="k4-highcpu-kvm-1.75G"),
        Variable("triton_network_names", default=["Joyent-SDC-Public"]),
    ]

    def network_resources(self, config: Dict[str, Any], ctx: DriverContext
                          ) -> List[Resource]:
        res = []
        for net in config.get("triton_network_names", []):
            ctx.cloud.create_resource("triton_network", net, adopted=True)
            res.append(Resource("triton_network", net))
        return res


@register
class TritonCluster(ClusterModule):
    SOURCE = "modules/triton-k8s"
    ALIASES = ("triton-rancher-k8s",)
    PROVIDER = "triton"
    VARIABLES = ClusterModule.VARIABLES + [
        Variable("triton_account", required=True),
        Variable("triton_key_path", required=True),
        Variable("triton_key_id", required=True),
        Variable("triton_url", default="https://us-east-1.api.joyent.com"),
    ]


@register
class TritonHost(HostModule):
    SOURCE = "modules/triton-k8s-host"
    ALIASES = ("triton-rancher-k8s-host",)
    PROVIDER = "triton"
    VARIABLES = HostModule.VARIABLES + [
        Variable("triton_account", required=True),
        Variable("triton_key_path", required=True),
        Variable("triton_key_id", required=True),
        Variable("triton_image_name", default="ubuntu-certified-16.04"),
        Variable("triton_ssh_user", default="ubuntu"),
        Variable("triton_machine_package", default="k4-highcpu-kvm-1.75G"),
        Variable("triton_network_names", default=["Joyent-SDC-Public"]),
    ]

    def instance_attrs(self, config: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "image": config.get("triton_image_name"),
            "package": config.get("triton_machine_package"),
            "networks": config.get("triton_network_names"),
        }
