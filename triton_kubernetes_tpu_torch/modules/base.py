"""Module base class, resource records, and the driver context: the port's
copy of the reference's ``modules/base.py``.

A module declares variables (with required/default semantics matching HCL
``variable`` blocks, e.g. modules/triton-rancher/variables.tf) and outputs
(``outputs.tf``), and implements ``apply``/``destroy`` against the driver
context. Apply must be **idempotent** — the reference leaned on terraform +
create-or-get bash for this (rancher_cluster.sh:3-5); here idempotency is a
stated contract of every module.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple


class ModuleError(ValueError):
    pass


@dataclass
class Variable:
    name: str
    default: Any = None
    required: bool = False


@dataclass
class Resource:
    """One provisioned resource (VM, network, node pool, k8s object...)."""

    type: str
    name: str
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"type": self.type, "name": self.name, "attrs": self.attrs}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Resource":
        return Resource(d["type"], d["name"], d.get("attrs", {}))


@dataclass
class DriverContext:
    """What a module gets to act on: the in-process cloud/control-plane driver
    and a scratch workdir (analog of terraform's temp run dir,
    shell/run_terraform.go:71-80)."""

    cloud: Any  # CloudSimulator or a real-provider adapter with the same API
    workdir: str
    module_key: str = ""


class Module(abc.ABC):
    """One provisioning module. Subclasses set SOURCE, VARIABLES, OUTPUTS."""

    SOURCE: str = ""  # e.g. "modules/triton-rancher"
    VARIABLES: List[Variable] = []
    OUTPUTS: List[str] = []

    def validate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Check required variables, fill defaults; returns effective config."""
        out = dict(config)
        for var in self.VARIABLES:
            if var.name not in out or out[var.name] in (None, ""):
                if var.required:
                    raise ModuleError(
                        f"{self.SOURCE}: required variable {var.name!r} not set"
                    )
                if var.default is not None:
                    out[var.name] = var.default
        return out

    @abc.abstractmethod
    def apply(
        self, config: Dict[str, Any], ctx: DriverContext
    ) -> Tuple[Dict[str, Any], List[Resource]]:
        """Provision (idempotently); return (outputs, resources)."""

    def destroy(self, applied: Dict[str, Any], ctx: DriverContext) -> None:
        """Tear down this module's resources. Default: release each recorded
        resource through the driver."""
        for rdict in reversed(applied.get("resources", [])):
            r = Resource.from_dict(rdict)
            ctx.cloud.delete_resource(r.type, r.name)


def agent_import_manifest(agent_image: str = "tk8s/agent:2.0"):
    """The in-cluster import agent Deployment hosted clusters apply
    (reference: curl /v3/import/<token>.yaml | kubectl apply — the
    cattle-cluster-agent), as a real schema-valid Deployment."""
    labels = {"app": "cattle-cluster-agent"}
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "cattle-cluster-agent",
                     "namespace": "cattle-system", "labels": dict(labels)},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": dict(labels)},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {"containers": [{
                    "name": "cluster-agent", "image": agent_image,
                }]},
            },
        },
    }
