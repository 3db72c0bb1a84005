"""GPU pool topology: the H100 twins of the reference's TPU-bound
``topology`` renderers.

It owns the GPU generation table and pool-shape arithmetic (``gpus``), the
node labels of a pool (``labels``), the host-software DaemonSets
(``daemonsets``: the CUDA runtime, NVIDIA's device plugin, the health
probe), the training JobSet (``jobset``) and the serving Deployments
(``serving``), each returning plain dicts (Kubernetes manifests); ``python
-m triton_kubernetes_tpu_torch.topology`` renders them for ``kubectl
apply`` and the HCL modules ``terraform/modules/gcp-gpu-nodepool`` and
``gpu-jobset``. None of it imports torch.
"""

from .gpus import GPU_GENERATIONS, GpuGeneration, GpuPoolSpec, \
    parse_accelerator
from .labels import (
    GKE_ACCELERATOR_LABEL,
    LABEL_PREFIX,
    host_labels_for_pool,
    selector_for_pool,
    verify_pool_labels,
)
from .daemonsets import (
    render_gpu_device_plugin,
    render_gpu_health_daemonset,
    render_gpu_runtime_daemonset,
)
from .jobset import render_headless_service, render_jobset, resize_jobset
from .serving import (
    render_disaggregated_deployments,
    render_operator_deployment,
    render_operator_service,
    render_router_deployment,
    render_router_service,
    render_serving_deployment,
    render_serving_service,
)

__all__ = [
    "GKE_ACCELERATOR_LABEL",
    "GPU_GENERATIONS",
    "GpuGeneration",
    "GpuPoolSpec",
    "LABEL_PREFIX",
    "host_labels_for_pool",
    "parse_accelerator",
    "render_disaggregated_deployments",
    "render_gpu_device_plugin",
    "render_gpu_health_daemonset",
    "render_gpu_runtime_daemonset",
    "render_headless_service",
    "render_jobset",
    "render_operator_deployment",
    "render_operator_service",
    "render_router_deployment",
    "render_router_service",
    "render_serving_deployment",
    "render_serving_service",
    "resize_jobset",
    "selector_for_pool",
    "verify_pool_labels",
]
