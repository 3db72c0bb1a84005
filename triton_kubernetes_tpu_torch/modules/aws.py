"""AWS modules: the port's copy of the reference's ``modules/aws.py``.

Reference analog: modules/aws-rancher (VPC/IGW/subnet/route/SG 22,80,443 +
keypair + instance, main.tf:1-133), modules/aws-rancher-k8s (VPC/subnet/SG
envelope), modules/aws-rancher-k8s-host (instance + optional EBS volume,
main.tf:47-62).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .base import DriverContext, Resource, Variable
from .family import ClusterModule, HostModule, ManagerModule
from .registry import register


def _vpc_envelope(prefix: str, config: Dict[str, Any], ctx: DriverContext
                  ) -> List[Resource]:
    res = []
    for rtype, rname, attrs in [
        ("aws_vpc", f"{prefix}-vpc", {"cidr": config.get("aws_vpc_cidr", "10.0.0.0/16")}),
        ("aws_internet_gateway", f"{prefix}-igw", {}),
        ("aws_subnet", f"{prefix}-subnet", {"cidr": config.get("aws_subnet_cidr", "10.0.2.0/24")}),
        ("aws_security_group", f"{prefix}-sg", {"ingress": [22, 80, 443]}),
    ]:
        ctx.cloud.create_resource(rtype, rname, **attrs)
        res.append(Resource(rtype, rname))
    return res


@register
class AwsManager(ManagerModule):
    SOURCE = "modules/aws-manager"
    ALIASES = ("aws-rancher",)
    PROVIDER = "aws"
    VARIABLES = ManagerModule.VARIABLES + [
        Variable("aws_access_key", required=True),
        Variable("aws_secret_key", required=True),
        Variable("aws_region", default="us-east-1"),
        Variable("aws_vpc_cidr", default="10.0.0.0/16"),
        Variable("aws_subnet_cidr", default="10.0.2.0/24"),
        Variable("aws_instance_type", default="t2.medium"),
        Variable("aws_public_key_path", default="~/.ssh/id_rsa.pub"),
        Variable("aws_key_name", default=""),
    ]

    def network_resources(self, config: Dict[str, Any], ctx: DriverContext
                          ) -> List[Resource]:
        return _vpc_envelope(config["name"], config, ctx)


@register
class AwsCluster(ClusterModule):
    SOURCE = "modules/aws-k8s"
    ALIASES = ("aws-rancher-k8s",)
    PROVIDER = "aws"
    VARIABLES = ClusterModule.VARIABLES + [
        Variable("aws_access_key", required=True),
        Variable("aws_secret_key", required=True),
        Variable("aws_region", default="us-east-1"),
        Variable("aws_vpc_cidr", default="10.0.0.0/16"),
        Variable("aws_subnet_cidr", default="10.0.2.0/24"),
        Variable("aws_public_key_path", default="~/.ssh/id_rsa.pub"),
        Variable("aws_key_name", default=""),
    ]

    def network_resources(self, config: Dict[str, Any], ctx: DriverContext
                          ) -> Tuple[List[Resource], Dict[str, Any]]:
        res = _vpc_envelope(config["name"], config, ctx)
        return res, {
            "aws_subnet_id": f"{config['name']}-subnet",
            "aws_security_group_id": f"{config['name']}-sg",
        }


@register
class AwsHost(HostModule):
    SOURCE = "modules/aws-k8s-host"
    ALIASES = ("aws-rancher-k8s-host",)
    PROVIDER = "aws"
    VARIABLES = HostModule.VARIABLES + [
        Variable("aws_access_key", required=True),
        Variable("aws_secret_key", required=True),
        Variable("aws_region", default="us-east-1"),
        Variable("aws_ami_id", default="ami-ubuntu-lts"),
        Variable("aws_instance_type", default="t2.medium"),
        Variable("aws_subnet_id", default=""),
        Variable("aws_security_group_id", default=""),
        # Optional EBS volume (reference: aws-rancher-k8s-host/main.tf:47-62).
        Variable("ebs_volume_device_name", default=""),
        Variable("ebs_volume_mount_path", default=""),
        Variable("ebs_volume_type", default="standard"),
        Variable("ebs_volume_iops", default=0),
        Variable("ebs_volume_size", default=0),
    ]

    def instance_attrs(self, config: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "ami": config.get("aws_ami_id"),
            "instance_type": config.get("aws_instance_type"),
            "subnet": config.get("aws_subnet_id"),
        }

    def extra_resources(self, config: Dict[str, Any], ctx: DriverContext
                        ) -> List[Resource]:
        if not config.get("ebs_volume_device_name"):
            return []
        name = f"{config['hostname']}-ebs"
        ctx.cloud.create_resource(
            "aws_ebs_volume", name,
            device=config["ebs_volume_device_name"],
            mount=config.get("ebs_volume_mount_path"),
            type=config.get("ebs_volume_type"),
            size=config.get("ebs_volume_size"),
        )
        return [Resource("aws_ebs_volume", name)]
