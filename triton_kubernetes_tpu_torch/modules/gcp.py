"""GCP VM modules (the rancher family on GCE VMs): the port's copy of the
reference's ``modules/gcp.py``.

Reference analog: modules/gcp-rancher (network + firewall 22/80/443 +
google_compute_instance, main.tf:14-28), modules/gcp-rancher-k8s (network +
firewall with the full RKE port matrix, main.tf:23-51; outputs network name +
firewall tag for hosts), modules/gcp-rancher-k8s-host (instance with
startup-script registration; disk support existed but was commented out —
enabled here).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .base import DriverContext, Resource, Variable
from .family import ClusterModule, HostModule, ManagerModule
from .registry import register

RKE_PORTS = [22, 80, 443, 2376, 2379, 2380, 6443, 10250, 10251, 10252, 10256]


@register
class GcpManager(ManagerModule):
    SOURCE = "modules/gcp-manager"
    ALIASES = ("gcp-rancher",)
    PROVIDER = "gcp"
    VARIABLES = ManagerModule.VARIABLES + [
        Variable("gcp_path_to_credentials", required=True),
        Variable("gcp_project_id", required=True),
        Variable("gcp_compute_region", default="us-central1"),
        Variable("gcp_zone", default="us-central1-a"),
        Variable("gcp_machine_type", default="n1-standard-2"),
        Variable("gcp_image", default="ubuntu-os-cloud/ubuntu-2204-lts"),
    ]

    def network_resources(self, config: Dict[str, Any], ctx: DriverContext
                          ) -> List[Resource]:
        name = config["name"]
        ctx.cloud.create_resource("gcp_compute_network", f"{name}-network")
        ctx.cloud.create_resource("gcp_compute_firewall", f"{name}-firewall",
                                  ports=[22, 80, 443])
        return [Resource("gcp_compute_network", f"{name}-network"),
                Resource("gcp_compute_firewall", f"{name}-firewall")]


@register
class GcpCluster(ClusterModule):
    SOURCE = "modules/gcp-k8s"
    ALIASES = ("gcp-rancher-k8s",)
    PROVIDER = "gcp"
    OUTPUTS = ClusterModule.OUTPUTS + ["gcp_compute_network_name", "gcp_firewall_tag"]
    VARIABLES = ClusterModule.VARIABLES + [
        Variable("gcp_path_to_credentials", required=True),
        Variable("gcp_project_id", required=True),
        Variable("gcp_compute_region", default="us-central1"),
    ]

    def network_resources(self, config: Dict[str, Any], ctx: DriverContext
                          ) -> Tuple[List[Resource], Dict[str, Any]]:
        name = config["name"]
        net = f"{name}-network"
        ctx.cloud.create_resource("gcp_compute_network", net)
        ctx.cloud.create_resource("gcp_compute_firewall", f"{name}-rke",
                                  ports=RKE_PORTS, tag=f"{name}-node")
        res = [Resource("gcp_compute_network", net),
               Resource("gcp_compute_firewall", f"{name}-rke")]
        return res, {"gcp_compute_network_name": net,
                     "gcp_firewall_tag": f"{name}-node"}


@register
class GcpHost(HostModule):
    SOURCE = "modules/gcp-k8s-host"
    ALIASES = ("gcp-rancher-k8s-host",)
    PROVIDER = "gcp"
    VARIABLES = HostModule.VARIABLES + [
        Variable("gcp_path_to_credentials", required=True),
        Variable("gcp_project_id", required=True),
        Variable("gcp_zone", default="us-central1-a"),
        Variable("gcp_machine_type", default="n1-standard-2"),
        Variable("gcp_image", default="ubuntu-os-cloud/ubuntu-2204-lts"),
        Variable("gcp_compute_network_name", default=""),
        Variable("gcp_firewall_tag", default=""),
        # Optional disk (present-but-commented-out in the reference,
        # create/node_gcp.go:252-351 — first-class here).
        Variable("gcp_disk_type", default=""),
        Variable("gcp_disk_size", default=0),
        Variable("gcp_disk_mount_path", default=""),
    ]

    def instance_attrs(self, config: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "zone": config.get("gcp_zone"),
            "machine_type": config.get("gcp_machine_type"),
            "network": config.get("gcp_compute_network_name"),
            "tags": [config.get("gcp_firewall_tag")] if config.get("gcp_firewall_tag") else [],
        }

    def extra_resources(self, config: Dict[str, Any], ctx: DriverContext
                        ) -> List[Resource]:
        if not config.get("gcp_disk_type"):
            return []
        name = f"{config['hostname']}-disk"
        ctx.cloud.create_resource("gcp_compute_disk", name,
                                  type=config["gcp_disk_type"],
                                  size=config.get("gcp_disk_size"),
                                  mount=config.get("gcp_disk_mount_path"))
        return [Resource("gcp_compute_disk", name)]
