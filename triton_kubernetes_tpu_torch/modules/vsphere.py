"""vSphere modules (cluster registration + template-clone hosts): the
port's copy of the reference's ``modules/vsphere.py``.

Reference analog: modules/vsphere-rancher-k8s (API only) and
modules/vsphere-rancher-k8s-host (VM cloned from a template, SSH remote-exec
agent install). The reference has no vSphere manager module; parity kept.
"""

from __future__ import annotations

from typing import Any, Dict

from .base import Variable
from .family import ClusterModule, HostModule
from .registry import register

_VSPHERE_CRED_VARS = [
    Variable("vsphere_user", required=True),
    Variable("vsphere_password", required=True),
    Variable("vsphere_server", required=True),
    Variable("vsphere_datacenter_name", required=True),
    Variable("vsphere_datastore_name", required=True),
    Variable("vsphere_resource_pool_name", required=True),
    Variable("vsphere_network_name", required=True),
]


@register
class VsphereCluster(ClusterModule):
    SOURCE = "modules/vsphere-k8s"
    ALIASES = ("vsphere-rancher-k8s",)
    PROVIDER = "vsphere"
    VARIABLES = ClusterModule.VARIABLES + _VSPHERE_CRED_VARS


@register
class VsphereHost(HostModule):
    SOURCE = "modules/vsphere-k8s-host"
    ALIASES = ("vsphere-rancher-k8s-host",)
    PROVIDER = "vsphere"
    VARIABLES = HostModule.VARIABLES + _VSPHERE_CRED_VARS + [
        Variable("vsphere_template_name", required=True),
        Variable("ssh_user", default="root"),
        Variable("key_path", default="~/.ssh/id_rsa"),
    ]

    def instance_attrs(self, config: Dict[str, Any]) -> Dict[str, Any]:
        return {"template": config.get("vsphere_template_name"),
                "datastore": config.get("vsphere_datastore_name")}
