"""DaemonSet manifests for GPU node pools: the H100 twin of the
reference's ``topology/daemonsets.py`` (its libtpu runtime, TPU device
plugin and slice-health sets).

Three sets, each keyed as the reference keys them, by (machine type, GPU
grant), so pools of different shapes coexist:

* the CUDA runtime: the torch/CUDA image
  (``images/torch-cuda-runtime.yaml``) with the NVIDIA libraries GKE
  installs on the node and ``/dev`` mounted, on the host network (NCCL
  and the ``torch.distributed`` rendezvous across hosts);
* NVIDIA's device plugin, which advertises ``nvidia.com/gpu``;
* the health probe, whose readiness is ``torch.cuda.device_count()`` equal
  to the host's grant.
"""

from __future__ import annotations

from typing import Any, Dict

from .gpus import GpuPoolSpec
from .labels import GKE_ACCELERATOR_LABEL, LABEL_PREFIX

DEFAULT_RUNTIME_IMAGE = "tk8s/torch-cuda-runtime:0.1.0"
DEFAULT_DEVICE_PLUGIN_IMAGE = "nvcr.io/nvidia/k8s-device-plugin:v0.15.0"
# Where GKE installs the NVIDIA libraries on a GPU node, and where
# containers expect them.
NVIDIA_HOST_PATH = "/home/kubernetes/bin/nvidia"
NVIDIA_MOUNT_PATH = "/usr/local/nvidia"


def _gpu_node_selector(spec: GpuPoolSpec) -> Dict[str, str]:
    """The hosts of this shape and grant: every manifest here embeds the
    per-host GPU count, so it must land only on matching hosts (a cluster
    can mix a3-highgpu-8g and smaller A3 shapes)."""
    return {GKE_ACCELERATOR_LABEL: spec.generation.gke_accelerator,
            "node.kubernetes.io/instance-type": spec.machine_type,
            f"{LABEL_PREFIX}/gpus-per-host": str(spec.gpus_per_host)}


def _gpu_variant(name: str, spec: GpuPoolSpec) -> str:
    """Per-(machine shape, GPU grant) manifest name
    (``gpu-torch-runtime-a3-highgpu-8g-8g``)."""
    return f"{name}-{spec.machine_type}-{spec.gpus_per_host}g"


def health_command(gpus: int) -> list:
    """The health probe's command: exits 0 when torch sees ``gpus`` GPUs."""
    return ["python", "-c",
            f"import torch; assert torch.cuda.device_count() == {gpus}"]


def render_gpu_runtime_daemonset(spec: GpuPoolSpec,
                                 image: str = DEFAULT_RUNTIME_IMAGE,
                                 namespace: str = "kube-system"
                                 ) -> Dict[str, Any]:
    """The torch/CUDA runtime DaemonSet (the libtpu runtime's twin)."""
    name = _gpu_variant("gpu-torch-runtime", spec)
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "nodeSelector": _gpu_node_selector(spec),
                    "hostNetwork": True,  # NCCL/rendezvous across hosts
                    "containers": [{
                        "name": "runtime",
                        "image": image,
                        "securityContext": {"privileged": True},
                        "volumeMounts": [
                            {"name": "nvidia",
                             "mountPath": NVIDIA_MOUNT_PATH},
                            {"name": "dev", "mountPath": "/dev"},
                        ],
                        "env": [
                            {"name": "GPUS_PER_HOST",
                             "value": str(spec.gpus_per_host)},
                        ],
                    }],
                    "volumes": [
                        {"name": "nvidia",
                         "hostPath": {"path": NVIDIA_HOST_PATH}},
                        {"name": "dev", "hostPath": {"path": "/dev"}},
                    ],
                },
            },
        },
    }


def render_gpu_device_plugin(spec: GpuPoolSpec,
                             image: str = DEFAULT_DEVICE_PLUGIN_IMAGE,
                             namespace: str = "kube-system"
                             ) -> Dict[str, Any]:
    """NVIDIA's device plugin, advertising ``nvidia.com/gpu`` (the TPU
    device plugin's twin); it fails its start when the node cannot
    enumerate the GPUs, so a broken host shows as a failed pod."""
    name = _gpu_variant("gpu-device-plugin", spec)
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "nodeSelector": _gpu_node_selector(spec),
                    "priorityClassName": "system-node-critical",
                    "containers": [{
                        "name": "device-plugin",
                        "image": image,
                        "env": [{"name": "FAIL_ON_INIT_ERROR",
                                 "value": "true"}],
                        "volumeMounts": [{
                            "name": "device-plugin-sock",
                            "mountPath": "/var/lib/kubelet/device-plugins",
                        }],
                    }],
                    "volumes": [{
                        "name": "device-plugin-sock",
                        "hostPath": {"path": "/var/lib/kubelet/device-plugins"},
                    }],
                },
            },
        },
    }


def render_gpu_health_daemonset(spec: GpuPoolSpec,
                                image: str = DEFAULT_RUNTIME_IMAGE,
                                namespace: str = "kube-system"
                                ) -> Dict[str, Any]:
    """Readiness = torch sees every GPU the host was granted (the
    slice-health probe's twin)."""
    name = _gpu_variant("gpu-health", spec)
    command = health_command(spec.gpus_per_host)
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "nodeSelector": _gpu_node_selector(spec),
                    "containers": [{
                        "name": "probe",
                        "image": image,
                        "command": list(command),
                        "readinessProbe": {
                            "exec": {"command": list(command)},
                            "periodSeconds": 60,
                        },
                    }],
                },
            },
        },
    }
