"""Deployment and Service rendering for serving on GPU pools: the H100
twin of the reference's ``topology/serving.py``.

The serve, route and operator Deployments and their Services are the
reference's, with three differences: a replica runs ``python -m
triton_kubernetes_tpu_torch.tools.serve`` and the router ``python -m
triton_kubernetes_tpu_torch.tools.route`` (the reference's run its CLI's
``serve``/``route`` verbs), a replica requests one ``nvidia.com/gpu``
(``tools.serve`` drives one card, so a host of g GPUs holds g replicas),
and replicas pin to a GPU pool through ``selector_for_pool``. The operator is
the reference's own (``triton-kubernetes-tpu operate``): the port has
none. The ports come from the port's ``constants``, never from
``serve/``: rendering does not import the serving stack.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..constants import OPERATOR_PORT, ROUTE_PORT, SERVE_PORT
from .gpus import GpuPoolSpec
from .labels import selector_for_pool

APP_LABEL = "serve.tk8s.io/name"
MODEL_LABEL = "serve.tk8s.io/model"
ROLE_LABEL = "serve.tk8s.io/role"
# Disaggregated serving (docs/guide/serving.md §Disaggregation): which
# phase pool a replica belongs to — "prefill", "decode", or "colocated"
# (the classic both-phases replica). The router's two rings select
# endpoints by this label's Deployments.
POOL_LABEL = "serve.tk8s.io/pool"
POOLS = ("colocated", "prefill", "decode")
# GPUs a serving replica is granted: ``tools.serve`` drives one card.
GPUS_PER_REPLICA = 1


def default_serve_command(model: str, port: int = SERVE_PORT,
                          pool: str = "colocated") -> List[str]:
    """A replica's container command: the port's serving entry point,
    bound to all interfaces for the pod network."""
    cmd = ["python", "-m", "triton_kubernetes_tpu_torch.tools.serve",
           "--model", model, "--serve-host", "0.0.0.0", "--port", str(port)]
    if pool != "colocated":
        cmd += ["--pool", pool]
    return cmd


def render_serving_deployment(
    name: str,
    spec: GpuPoolSpec,
    slice_id: str,
    image: str,
    model: str,
    replicas: int = 1,
    namespace: str = "default",
    env: Optional[Dict[str, str]] = None,
    command: Optional[List[str]] = None,
    pool: str = "colocated",
) -> Dict[str, Any]:
    """A Deployment of serving replicas on one labeled GPU pool.

    Each replica is one engine on one GPU (:data:`GPUS_PER_REPLICA`;
    serving scales out in replicas behind the Service, up to
    ``spec.gpus`` of them on the pool). ``pool`` stamps
    the disaggregation phase label ("prefill"/"decode" replicas refuse
    the other phase's work; "colocated" runs both).
    """
    if pool not in POOLS:
        raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
    labels = {APP_LABEL: name, MODEL_LABEL: model, POOL_LABEL: pool}
    container = {
        "name": "server",
        "image": image,
        "command": command or default_serve_command(model, pool=pool),
        "env": [{"name": k, "value": v} for k, v in sorted(
            (env or {}).items())],
        "ports": [{"containerPort": SERVE_PORT, "name": "http"}],
        "resources": {"limits": {"nvidia.com/gpu": str(GPUS_PER_REPLICA)}},
        # One endpoint serves liveness and readiness: the engine loop
        # answers /healthz as long as it can schedule at all.
        "readinessProbe": {
            "httpGet": {"path": "/healthz", "port": SERVE_PORT},
            "periodSeconds": 5,
        },
        "livenessProbe": {
            "httpGet": {"path": "/healthz", "port": SERVE_PORT},
            "initialDelaySeconds": 30,
            "periodSeconds": 10,
        },
    }
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": dict(labels)},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {APP_LABEL: name}},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {
                    "nodeSelector": selector_for_pool(spec, slice_id),
                    "containers": [container],
                },
            },
        },
    }


def render_disaggregated_deployments(
    name: str,
    spec: GpuPoolSpec,
    slice_id: str,
    image: str,
    model: str,
    prefill_replicas: int = 1,
    decode_replicas: int = 1,
    namespace: str = "default",
    env: Optional[Dict[str, str]] = None,
) -> List[Dict[str, Any]]:
    """The disaggregated pair: ``{name}-prefill`` and ``{name}-decode``
    Deployments on the same labeled GPU pool, distinguished by the
    POOL_LABEL their pods carry and the ``--pool`` flag their servers
    run with. Front them with two headless Services (one per
    Deployment) and a router built with ``--decode-replica`` endpoints
    — sessions then prefill on one pool and migrate their KV pages to
    the other for the decode tail (docs/guide/serving.md
    §Disaggregation). Scale the pools independently: prefill replicas
    track *arrival* rate, decode replicas track *resident sessions*.
    """
    return [
        render_serving_deployment(
            f"{name}-prefill", spec, slice_id, image, model,
            replicas=prefill_replicas, namespace=namespace, env=env,
            pool="prefill"),
        render_serving_deployment(
            f"{name}-decode", spec, slice_id, image, model,
            replicas=decode_replicas, namespace=namespace, env=env,
            pool="decode"),
    ]


def render_serving_service(
    name: str,
    namespace: str = "default",
    service_type: str = "ClusterIP",
    headless: bool = False,
) -> Dict[str, Any]:
    """The VIP in front of the serving replicas. ``/metrics`` rides the
    same port, so a Prometheus scrape of the Service endpoints covers
    every replica with no extra wiring.

    ``headless=True`` renders ``clusterIP: None`` — per-pod DNS instead
    of one VIP, which is what the session-affine router needs: affinity
    only means something when the router can address a *specific*
    replica's KV pages, not whatever endpoint kube-proxy picks.
    """
    spec: Dict[str, Any] = {
        "type": service_type,
        "selector": {APP_LABEL: name},
        "ports": [{"name": "http", "port": SERVE_PORT,
                   "targetPort": SERVE_PORT}],
    }
    if headless:
        spec["clusterIP"] = "None"
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": {APP_LABEL: name}},
        "spec": spec,
    }


def default_route_command(replica_urls: List[str],
                          port: int = ROUTE_PORT,
                          decode_urls: Optional[List[str]] = None,
                          ) -> List[str]:
    """The router container command: the port's routing entry point
    bound to all interfaces, one ``--replica`` per serving endpoint (and
    one ``--decode-replica`` per decode-pool endpoint in disaggregated
    mode, where ``--replica`` names the prefill pool)."""
    cmd = ["python", "-m", "triton_kubernetes_tpu_torch.tools.route",
           "--route-host", "0.0.0.0", "--port", str(port)]
    for url in replica_urls:
        cmd += ["--replica", url]
    for url in decode_urls or []:
        cmd += ["--decode-replica", url]
    return cmd


def render_router_deployment(
    name: str,
    image: str,
    replica_urls: List[str],
    replicas: int = 1,
    namespace: str = "default",
    env: Optional[Dict[str, str]] = None,
    command: Optional[List[str]] = None,
    decode_urls: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """The router Deployment beside the replica set.

    No GPU limits and no node selector: the router is pure CPU HTTP
    plumbing and schedules anywhere. ``replica_urls`` are the serving
    endpoints it fronts — with the replicas behind a headless Service
    (``render_serving_service(..., headless=True)``) these are the
    per-pod DNS names, which is what makes session affinity land on the
    pod actually holding the KV pages.
    """
    if not replica_urls:
        raise ValueError("router needs at least one replica URL")
    labels = {APP_LABEL: name, ROLE_LABEL: "router"}
    container = {
        "name": "router",
        "image": image,
        "command": command or default_route_command(
            replica_urls, decode_urls=decode_urls),
        "env": [{"name": k, "value": v} for k, v in sorted(
            (env or {}).items())],
        "ports": [{"containerPort": ROUTE_PORT, "name": "http"}],
        # Readiness ONLY: /healthz reflects REPLICA health (503 when
        # every replica is unreachable), which parks the router out of
        # its Service during a fleet outage. A liveness probe on the
        # same endpoint would have kubelet restart-loop perfectly
        # healthy router processes through that outage — restarting the
        # router cannot resurrect replicas.
        "readinessProbe": {
            "httpGet": {"path": "/healthz", "port": ROUTE_PORT},
            "periodSeconds": 5,
        },
    }
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": dict(labels)},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {APP_LABEL: name,
                                         ROLE_LABEL: "router"}},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {"containers": [container]},
            },
        },
    }


def render_router_service(
    name: str,
    namespace: str = "default",
    service_type: str = "ClusterIP",
) -> Dict[str, Any]:
    """The fleet's single front door: one VIP over the router pods
    (the routers are stateless — any of them hashes a session to the
    same replica, so scaling routers never splits affinity)."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": {APP_LABEL: name, ROLE_LABEL: "router"}},
        "spec": {
            "type": service_type,
            "selector": {APP_LABEL: name, ROLE_LABEL: "router"},
            "ports": [{"name": "http", "port": ROUTE_PORT,
                       "targetPort": ROUTE_PORT}],
        },
    }


def default_operate_command(manager: str,
                            scrape_urls: Optional[List[str]] = None,
                            port: int = OPERATOR_PORT) -> List[str]:
    """The operator container command: the CLI's ``operate`` verb with
    its /metrics endpoint bound to all interfaces, scraping the fleet's
    per-replica endpoints. ``--non-interactive`` and ``--set`` are
    ROOT-parser flags and must precede the subcommand — and a pod has
    no TTY to answer prompts on."""
    cmd = ["triton-kubernetes-tpu", "--non-interactive",
           "--set", f"cluster_manager={manager}", "operate",
           "--operator-host", "0.0.0.0", "--operator-port", str(port)]
    for url in scrape_urls or []:
        cmd += ["--scrape", url]
    return cmd


def render_operator_deployment(
    name: str,
    image: str,
    manager: str,
    scrape_urls: Optional[List[str]] = None,
    namespace: str = "default",
    env: Optional[Dict[str, str]] = None,
    command: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """The reconcile operator Deployment.

    Exactly one replica, by design: the reconcile loop is a single
    writer against the state document (two operators would race the
    backend's state lock every tick and fight over scale decisions) —
    ``replicas: 1`` plus Recreate strategy is the poor-k8s leader
    election that matches the backend's locking model. CPU-only, no
    node selector: like the router, the operator is control-plane
    plumbing and schedules anywhere.
    """
    labels = {APP_LABEL: name, ROLE_LABEL: "operator"}
    container = {
        "name": "operator",
        "image": image,
        "command": command or default_operate_command(manager, scrape_urls),
        "env": [{"name": k, "value": v} for k, v in sorted(
            (env or {}).items())],
        "ports": [{"containerPort": OPERATOR_PORT, "name": "http"}],
        # Liveness (not readiness): /healthz goes 503 when the
        # reconcile loop thread died, and restarting the pod is exactly
        # the fix — the loop is the workload, there is no traffic to
        # park away.
        "livenessProbe": {
            "httpGet": {"path": "/healthz", "port": OPERATOR_PORT},
            "initialDelaySeconds": 10,
            "periodSeconds": 10,
        },
    }
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": dict(labels)},
        "spec": {
            "replicas": 1,
            "strategy": {"type": "Recreate"},
            "selector": {"matchLabels": {APP_LABEL: name,
                                         ROLE_LABEL: "operator"}},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {"containers": [container]},
            },
        },
    }


def render_operator_service(
    name: str,
    namespace: str = "default",
) -> Dict[str, Any]:
    """A ClusterIP over the operator pod — the Prometheus scrape target
    for the ``tk8s_operator_*`` families."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": {APP_LABEL: name, ROLE_LABEL: "operator"}},
        "spec": {
            "type": "ClusterIP",
            "selector": {APP_LABEL: name, ROLE_LABEL: "operator"},
            "ports": [{"name": "http", "port": OPERATOR_PORT,
                       "targetPort": OPERATOR_PORT}],
        },
    }
