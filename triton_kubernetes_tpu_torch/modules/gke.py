"""GKE hosted-cluster module: provider-managed control plane, imported into
the manager (the port's copy of the reference's ``modules/gke.py``).

Reference analog: modules/gke-rancher-k8s — ``google_container_cluster``
(main.tf:18-43) followed by the import dance (get-credentials, ``curl
.../v3/import/<token>.yaml | kubectl apply``, main.tf:50-82; registration via
files/rancher_cluster_import.sh, create-or-get with no RKE config). Hosted
clusters have no agent-host modules; nodes come from node pools.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .base import (
    DriverContext, Module, Resource, Variable, agent_import_manifest)
from .registry import register


@register
class GkeCluster(Module):
    SOURCE = "modules/gke-k8s"
    ALIASES = ("gke-rancher-k8s",)
    OUTPUTS = ["cluster_id", "endpoint"]
    VARIABLES = [
        Variable("name", required=True),
        Variable("manager_url", required=True),
        Variable("manager_access_key", required=True),
        Variable("manager_secret_key", required=True),
        Variable("gcp_path_to_credentials", required=True),
        Variable("gcp_project_id", required=True),
        Variable("gcp_zone", default="us-central1-a"),
        Variable("gcp_additional_zones", default=[]),
        Variable("gcp_machine_type", default="n1-standard-2"),
        Variable("k8s_version", default="1.29"),
        Variable("node_count", default=3),
        Variable("master_password", default=""),
    ]

    def apply(self, config: Dict[str, Any], ctx: DriverContext
              ) -> Tuple[Dict[str, Any], List[Resource]]:
        name = config["name"]
        hosted = ctx.cloud.create_hosted_cluster(
            "gke", name,
            project=config["gcp_project_id"],
            zone=config.get("gcp_zone"),
            additional_zones=config.get("gcp_additional_zones", []),
            k8s_version=config.get("k8s_version"),
        )
        ctx.cloud.create_node_pool(
            "gke", name, "default-pool",
            node_count=int(config.get("node_count", 3)),
            machine_type=config.get("gcp_machine_type"),
        )
        # Import into the manager (rancher_cluster_import.sh analog): a
        # create-or-get registration with imported=True, no RKE config.
        imported = ctx.cloud.create_or_get_cluster(
            config["manager_url"], name, imported=True, kind="gke")
        ctx.cloud.apply_manifest(
            imported["id"],
            agent_import_manifest(str(config.get("rancher_agent_image",
                                                 "tk8s/agent:2.0"))))
        resources = [Resource("gke_cluster", name),
                     Resource("cluster", imported["id"])]
        ctx.cloud.create_resource("cluster", imported["id"], cluster_name=name)
        return ({"cluster_id": imported["id"],
                 "endpoint": hosted["endpoint"]}, resources)
