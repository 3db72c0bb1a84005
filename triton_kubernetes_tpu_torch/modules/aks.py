"""AKS hosted-cluster module: the port's copy of the reference's
``modules/aks.py``.

Reference analog: modules/aks-rancher-k8s — ``azurerm_kubernetes_cluster``
(main.tf:25-52) + the same import-into-manager pattern via ``az aks
get-credentials`` (main.tf:58+).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .base import (
    DriverContext, Module, Resource, Variable, agent_import_manifest)
from .registry import register


@register
class AksCluster(Module):
    SOURCE = "modules/aks-k8s"
    ALIASES = ("aks-rancher-k8s",)
    OUTPUTS = ["cluster_id", "endpoint"]
    VARIABLES = [
        Variable("name", required=True),
        Variable("manager_url", required=True),
        Variable("manager_access_key", required=True),
        Variable("manager_secret_key", required=True),
        Variable("azure_subscription_id", required=True),
        Variable("azure_client_id", required=True),
        Variable("azure_client_secret", required=True),
        Variable("azure_tenant_id", required=True),
        Variable("azure_location", default="West US 2"),
        Variable("azure_size", default="Standard_D2s_v3"),
        Variable("azure_ssh_user", default="azureuser"),
        Variable("azure_public_key_path", default="~/.ssh/id_rsa.pub"),
        Variable("k8s_version", default="1.29"),
        Variable("node_count", default=3),
    ]

    def apply(self, config: Dict[str, Any], ctx: DriverContext
              ) -> Tuple[Dict[str, Any], List[Resource]]:
        name = config["name"]
        hosted = ctx.cloud.create_hosted_cluster(
            "aks", name,
            location=config.get("azure_location"),
            k8s_version=config.get("k8s_version"),
        )
        ctx.cloud.create_node_pool(
            "aks", name, "default-pool",
            node_count=int(config.get("node_count", 3)),
            vm_size=config.get("azure_size"),
        )
        imported = ctx.cloud.create_or_get_cluster(
            config["manager_url"], name, imported=True, kind="aks")
        ctx.cloud.apply_manifest(
            imported["id"],
            agent_import_manifest(str(config.get("rancher_agent_image",
                                                 "tk8s/agent:2.0"))))
        ctx.cloud.create_resource("cluster", imported["id"], cluster_name=name)
        resources = [Resource("aks_cluster", name), Resource("cluster", imported["id"])]
        return ({"cluster_id": imported["id"],
                 "endpoint": hosted["endpoint"]}, resources)
