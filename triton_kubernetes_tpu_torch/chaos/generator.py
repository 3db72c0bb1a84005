"""Seeded scenario generation for the workload profiles -- the port of
``triton_kubernetes_tpu/chaos/generator.py``'s ``workload`` and
``workload-train`` profiles.

One scenario is a JSON-able *spec*: the runner drives it, the shrinker
reduces it, and the corpus pins it. Same seed, same spec, byte for byte,
and the same spec as the reference's generator: the only randomness source
is ``random.Random(seed)`` and every draw -- the infra topology, fault
rules, latency model, kill fraction and operator preemption included --
is made in the reference's order. The port carries the infra parts of a
spec unchanged and runs only its ``workload`` fault (chaos/runner.py).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

SPEC_VERSION = 1

#: The cluster manager providers (``executor/dagspec.MANAGER_PROVIDERS``
#: of the reference: every provider with a manager module, sorted).
MANAGER_PROVIDERS = ("aws", "azure", "bare-metal", "gcp", "triton")

# Cluster shapes a profile draws from. Weights are draw multiplicities.
_RANCHER = ("aws", "azure", "triton", "vsphere", "bare-metal", "gcp")
_HOSTED = ("gke", "aks")

#: Generation profiles: (knobs the drawing loop reads). Workload faults
#: on a deliberately small infra DAG; workload_weight 1.0 -- every
#: scenario draws one.
PROFILES: Dict[str, Dict[str, Any]] = {
    "workload": {"clusters": (0, 1), "nodes": (0, 1), "tpu_weight": 0.0,
                 "hosted_weight": 0.2, "parallelism": (1, 2),
                 "fault_rules": (0, 1), "latency_weight": 0.1,
                 "kill_weight": 0.1, "operator_weight": 0.0,
                 "workload_weight": 1.0,
                 "workload_kinds": (("engine-preempt", 0.3),
                                    ("torn-checkpoint", 0.2),
                                    ("sigterm-flush", 0.15),
                                    ("kv-migration-torn", 0.15),
                                    ("replica-death", 0.15),
                                    ("reshard-torn-checkpoint", 0.05))},
    # Training-plane workload faults (multi-process launches -- seconds
    # per arm, so sweeps keep the run counts small).
    "workload-train": {"clusters": (0, 1), "nodes": (0, 1),
                       "tpu_weight": 0.0, "hosted_weight": 0.2,
                       "parallelism": (1, 2), "fault_rules": (0, 1),
                       "latency_weight": 0.1, "kill_weight": 0.1,
                       "operator_weight": 0.0, "workload_weight": 1.0,
                       "workload_kinds": (("rank-death", 0.6),
                                          ("coordinator-loss", 0.4))},
}

# Ops each module family is known to issue -- rules target these.
_FAMILY_OPS = {
    "manager": ("bootstrap_manager", "create_resource"),
    "rancher-cluster": ("create_or_get_cluster", "create_resource"),
    "rancher-host": ("register_node", "create_resource"),
    "hosted-cluster": ("create_hosted_cluster", "create_node_pool",
                       "apply_manifest"),
    "tpu-cluster": ("create_hosted_cluster", "create_or_get_cluster"),
    "tpu-pool": ("create_node_pool", "apply_manifest"),
    "jobset": ("apply_manifest",),
}


def _draw_topology(rng: random.Random, prof: Dict[str, Any]
                   ) -> Dict[str, Any]:
    topo: Dict[str, Any] = {
        "manager": {"provider": rng.choice(MANAGER_PROVIDERS), "name": "m1"},
        "clusters": [],
    }
    lo, hi = prof["clusters"]
    for ci in range(rng.randint(lo, hi)):
        roll = rng.random()
        if roll < prof["tpu_weight"]:
            pools = [{"name": f"pool{pi}", "accelerator": "v5e-16"}
                     for pi in range(rng.randint(1, 2))]
            cl: Dict[str, Any] = {"provider": "gcp-tpu",
                                  "name": f"tpu{ci}", "pools": pools}
            if rng.random() < 0.7:
                cl["jobsets"] = [{"name": f"job{ci}",
                                  "pool": rng.choice(pools)["name"]}]
            topo["clusters"].append(cl)
        elif roll < prof["tpu_weight"] + prof["hosted_weight"]:
            topo["clusters"].append({"provider": rng.choice(_HOSTED),
                                     "name": f"hosted{ci}"})
        else:
            prov = rng.choice(_RANCHER)
            nlo, nhi = prof["nodes"]
            nodes = [f"c{ci}-w{ni}" for ni in range(rng.randint(nlo, nhi))]
            topo["clusters"].append({"provider": prov, "name": f"c{ci}",
                                     "nodes": nodes})
    return topo


def _module_sites(topo: Dict[str, Any]) -> List[Dict[str, str]]:
    """Every module key the topology will materialize, with its family --
    the anchor vocabulary fault rules draw from."""
    sites = [{"key": "cluster-manager", "family": "manager"}]
    for cl in topo["clusters"]:
        prov, cname = cl["provider"], cl["name"]
        if prov == "gcp-tpu":
            sites.append({"key": f"cluster_{prov}_{cname}",
                          "family": "tpu-cluster"})
            for pool in cl.get("pools", []):
                sites.append({"key": f"node_{prov}_{cname}_{pool['name']}",
                              "family": "tpu-pool",
                              "slice_id": f"{cname}-{pool['name']}"})
            for job in cl.get("jobsets", []):
                sites.append({"key": f"job_{cname}_{job['name']}",
                              "family": "jobset",
                              "slice_id": f"{cname}-{job['pool']}"})
        elif prov in _HOSTED:
            sites.append({"key": f"cluster_{prov}_{cname}",
                          "family": "hosted-cluster"})
        else:
            sites.append({"key": f"cluster_{prov}_{cname}",
                          "family": "rancher-cluster"})
            for host in cl.get("nodes", []):
                sites.append({"key": f"node_{prov}_{cname}_{host}",
                              "family": "rancher-host"})
    return sites


def _draw_faults(rng: random.Random, prof: Dict[str, Any],
                 topo: Dict[str, Any]) -> List[Dict[str, Any]]:
    sites = _module_sites(topo)
    jobset_sites = [s for s in sites if s["family"] == "jobset"]
    lo, hi = prof["fault_rules"]
    rules: List[Dict[str, Any]] = []
    for _ in range(rng.randint(lo, hi)):
        kind_roll = rng.random()
        if kind_roll < 0.35 and jobset_sites:
            site = rng.choice(jobset_sites)
            rule: Dict[str, Any] = {"op": "preempt",
                                    "slice_id": site["slice_id"],
                                    "module": site["key"],
                                    "at_module_op": 1}
            if rng.random() < 0.5:
                rule.update({"mode": "graceful-warning",
                             "grace_ops": rng.randint(0, 1),
                             "notify_pid": 0})
            rules.append(rule)
            continue
        site = rng.choice(sites)
        ops = _FAMILY_OPS[site["family"]]
        if kind_roll < 0.55:
            rules.append({"op": rng.choice(ops), "module": site["key"],
                          "times": rng.randint(1, 2),
                          "error": rng.choice((
                              "503 service unavailable",
                              "instance boot failed",
                              "429 too many requests"))})
        elif kind_roll < 0.75:
            rules.append({"op": rng.choice(ops), "module": site["key"],
                          "kind": "fatal", "times": 1,
                          "error": "quota exceeded"})
        else:
            rules.append({"op": "*", "module": site["key"],
                          "at_module_op": rng.randint(1, 3), "times": 1,
                          "error": "injected at module op"})
    return rules


def _draw_latency(rng: random.Random, prof: Dict[str, Any]
                  ) -> Optional[Any]:
    if rng.random() >= prof["latency_weight"]:
        return None
    scale = prof.get("latency_scale", 0.002)
    if rng.random() < 0.5:
        return round(rng.uniform(0.2, 1.0) * scale, 6)
    return {"register_node": round(rng.uniform(0.5, 2.0) * scale, 6),
            "create_node_pool": round(rng.uniform(0.5, 2.0) * scale, 6),
            "*": round(rng.uniform(0.05, 0.5) * scale, 6)}


def _tpu_slices(topo: Dict[str, Any]) -> List[Dict[str, str]]:
    """Every TPU slice a topology declares (slice id ``<cluster>-<pool>``)."""
    return [{"cluster": cl["name"], "pool": pool["name"],
             "slice_id": f"{cl['name']}-{pool['name']}",
             "accelerator": pool.get("accelerator", "v5e-16")}
            for cl in topo.get("clusters", [])
            if cl.get("provider") == "gcp-tpu"
            for pool in cl.get("pools", [])]


def _draw_operator(rng: random.Random, prof: Dict[str, Any],
                   topo: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The preempt-mid-reconcile draw: a slice dies between a reconcile
    tick's observe and its act. One rng draw even at weight 0, as in the
    reference."""
    if rng.random() >= prof.get("operator_weight", 0.0):
        return None
    slices = _tpu_slices(topo)
    if not slices:
        return None
    row = rng.choice(slices)
    return {"slice_id": row["slice_id"], "at_tick": rng.randint(1, 2)}


def _draw_workload(rng: random.Random, prof: Dict[str, Any]
                   ) -> Optional[Dict[str, Any]]:
    """The workload fault dimension, drawn LAST. Consumes zero rng draws
    for a profile without a ``workload_weight``."""
    w = prof.get("workload_weight", 0.0)
    if w <= 0.0:
        return None
    if rng.random() >= w:
        return None
    kinds = prof["workload_kinds"]
    roll = rng.random() * sum(weight for _, weight in kinds)
    kind = kinds[-1][0]
    for name, weight in kinds:
        if roll < weight:
            kind = name
            break
        roll -= weight
    fault: Dict[str, Any] = {"kind": kind}
    if kind == "replica-death":
        fault["replicas"] = rng.randint(2, 3)
        fault["die_after_tokens"] = rng.randint(1, 4)
        fault["prompt_len"] = rng.randint(4, 8)
        fault["max_new_tokens"] = rng.randint(6, 10)
    elif kind == "engine-preempt":
        fault["prefix_cache"] = rng.random() < 0.5
        fault["spec_k"] = rng.choice((0, 3))
        fault["long_windows"] = rng.randint(4, 5)
        fault["requests"] = rng.randint(2, 3)
        fault["abort_after_steps"] = (rng.randint(2, 6)
                                      if rng.random() < 0.3 else None)
    elif kind == "torn-checkpoint":
        fault["corruption"] = rng.choice(
            ("truncate", "bitflip", "torn-manifest"))
        fault["torn_step"] = rng.randint(1, 2)
        fault["keep_steps"] = rng.randint(2, 3)
    elif kind in ("rank-death", "coordinator-loss"):
        fault["crash_step"] = rng.randint(1, 3)
        fault["steps"] = 4
    elif kind == "sigterm-flush":
        fault["process"] = "route"
        fault["after_requests"] = rng.randint(1, 3)
    elif kind == "kv-migration-torn":
        # Anywhere in the frame: header, payload, or the trailing digest.
        fault["cut"] = rng.choice(("truncate", "bitflip"))
        fault["offset_frac"] = round(rng.uniform(0.0, 1.0), 3)
        fault["prompt_len"] = rng.randint(8, 16)
        fault["max_new_tokens"] = rng.randint(4, 8)
    elif kind == "reshard-torn-checkpoint":
        # Anywhere in the manifest short of its whole length.
        fault["offset_frac"] = round(rng.uniform(0.0, 0.95), 3)
        fault["torn_step"] = rng.randint(1, 2)
        fault["keep_steps"] = rng.randint(2, 3)
    return fault


def scenario_seed(base: int, i: int) -> int:
    """Per-scenario seed of sweep step ``i``."""
    return (base * 1_000_003 + i) % (2 ** 31 - 1)


def generate_spec(seed: int, profile: str = "workload") -> Dict[str, Any]:
    """One scenario spec, fully determined by (seed, profile)."""
    if profile not in PROFILES:
        raise ValueError(
            f"unknown chaos profile {profile!r} (choices: {sorted(PROFILES)})")
    prof = PROFILES[profile]
    rng = random.Random(seed)
    parallelism = rng.choice(prof["parallelism"])
    topo = _draw_topology(rng, prof)
    spec: Dict[str, Any] = {
        "version": SPEC_VERSION,
        "seed": seed,
        "profile": profile,
        "parallelism": parallelism,
        "op_latency": _draw_latency(rng, prof),
        "topology": topo,
        "faults": _draw_faults(rng, prof, topo),
        "kill_fraction": (round(rng.uniform(0.2, 0.9), 3)
                          if rng.random() < prof["kill_weight"] else None),
        "mutation": None,
    }
    spec["operator_preempt"] = _draw_operator(rng, prof, topo)
    spec["workload"] = _draw_workload(rng, prof)
    return spec
