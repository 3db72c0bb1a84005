"""Seeded scenario generation: DAGs, latency models, fault plans -- the
port of ``triton_kubernetes_tpu/chaos/generator.py``, every profile.

One scenario is a JSON-able *spec* -- the unit the whole harness shares:
the runner materializes it (executor/dagspec.py), the shrinker reduces it
structurally, and the corpus pins it. Same seed, same spec, byte for byte,
and the same spec as the reference's generator: the only randomness
source is ``random.Random(seed)`` and every draw is made in the
reference's order. A spec keeps the reference's vocabulary -- ``gcp-tpu``
clusters of ``v5e-16`` pools, the profile name ``tpu`` -- so the committed
corpus replays unchanged; :func:`twin_spec` gives the GPU twin the runner
applies (``gcp-gpu`` clusters of ``h100-16`` pools).

Spec shape::

    {"version": 1, "seed": 7, "profile": "default",
     "parallelism": 2,                  # the non-serial parity arm
     "op_latency": None | 0.002 | {"register_node": 0.01, "*": 0.0},
     "topology": {...},                 # executor/dagspec.py shape
     "faults": [...],                   # cloudsim FaultPlan rules
     "kill_fraction": None | 0.4,       # arms the kill-resume invariant
     "mutation": None | "unfaulted-reference",   # harness self-test
     "operator_preempt": None | {"slice_id": ..., "at_tick": 1},
     "workload": None | {"kind": "engine-preempt", ...}}

Every generated fault rule is **module-anchored** (``module`` /
``at_module_op``) -- the interleaving-safe form, valid at any parallelism.
Global-clock ``at_op`` preemption anchors are not drawn (the safe tick
depends on op counts the generator cannot know a priori); a hand-written
serial corpus entry pins that shape
(``tests/chaos_corpus/tpu-at-op-preempt-serial.json``). Preempt rules
anchor on a module that *depends on* the pool (the jobset), so the pool
exists by the time the reclaim fires.
"""

from __future__ import annotations

import copy
import io
import random
from typing import Any, Dict, List, Optional

from ..executor.dagspec import MANAGER_PROVIDERS, DagSpecError

SPEC_VERSION = 1

#: The TPU accelerator the reference's generator draws (every corpus pool
#: too) and its GPU twin: two A3 hosts of eight H100s.
TWIN_ACCELERATORS = {"v5e-16": "h100-16"}

#: Mutations a reference TPU pool issues that its GPU twin does not: after
#: its manifests it deletes three fixed-name DaemonSets (``tpu-jax-runtime``,
#: ``tpu-device-plugin``, ``tpu-health``) left by clusters provisioned
#: before its per-shape names. The GPU pool never had fixed names.
TPU_POOL_EXTRA_OPS = 3

# Cluster shapes a profile draws from. Weights are draw multiplicities.
_RANCHER = ("aws", "azure", "triton", "vsphere", "bare-metal", "gcp")
_HOSTED = ("gke", "aks")

#: Generation profiles: (knobs the drawing loop reads).
PROFILES: Dict[str, Dict[str, Any]] = {
    # Small mixed DAGs, cheap faults — the CI sweep workhorse.
    "quick": {"clusters": (1, 2), "nodes": (0, 2), "tpu_weight": 0.0,
              "hosted_weight": 0.2, "parallelism": (1, 2),
              "fault_rules": (0, 2), "latency_weight": 0.15,
              "kill_weight": 0.2, "operator_weight": 0.0},
    # The full matrix: every provider family, widths 1/2/8, all fault
    # kinds, occasional latency models and kills.
    "default": {"clusters": (1, 3), "nodes": (0, 3), "tpu_weight": 0.25,
                "hosted_weight": 0.25, "parallelism": (1, 2, 8),
                "fault_rules": (0, 3), "latency_weight": 0.25,
                "kill_weight": 0.3, "operator_weight": 0.25},
    # TPU-pool DAGs with preemption/graceful-warning faults — the
    # apply -> preempt -> repair -> resume loop.
    "tpu": {"clusters": (1, 2), "nodes": (0, 1), "tpu_weight": 1.0,
            "hosted_weight": 0.0, "parallelism": (1, 2, 8),
            "fault_rules": (1, 3), "latency_weight": 0.25,
            "kill_weight": 0.25, "operator_weight": 0.4},
    # The long soak: TPU loops under a heavy simulated latency model so
    # every round advances the mutation clock by minutes of simulated
    # time (the sleeper is a recorder — no wall-clock cost).
    "soak": {"clusters": (1, 2), "nodes": (0, 1), "tpu_weight": 1.0,
             "hosted_weight": 0.0, "parallelism": (1, 2, 8),
             "fault_rules": (1, 2), "latency_weight": 1.0,
             "latency_scale": 60.0, "kill_weight": 0.2,
             "operator_weight": 0.3},
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

# Ops each module family is known to issue -- rules target these so a
# drawn fault actually lands somewhere interesting.
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


def generate_spec(seed: int, profile: str = "default") -> Dict[str, Any]:
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


def _twin_module_key(key: str) -> str:
    """A module key in the twin's scheme: ``gcp-gpu`` in the provider slot
    of a cluster or pool key (``cluster_gcp-tpu_ml``,
    ``node_gcp-tpu_ml_pool0``); every other key unchanged."""
    for prefix in ("cluster_", "node_"):
        if key.startswith(prefix + "gcp-tpu_"):
            return prefix + "gcp-gpu_" + key[len(prefix + "gcp-tpu_"):]
    return key


def twin_spec(spec: Dict[str, Any]) -> Dict[str, Any]:
    """The GPU twin of a reference spec: every ``gcp-tpu`` cluster becomes
    ``gcp-gpu``, each of its ``v5e-16`` pools ``h100-16`` (two A3 hosts),
    and every fault rule's module key names the twin's cluster and pool
    modules. A global-clock ``at_op`` anchor moves to the twin's tick of
    the same operation (:func:`_twin_at_op`). Pool (slice) ids, ``job_*``
    keys and everything else stay. Raises :class:`~..executor.dagspec.DagSpecError` naming any other TPU
    accelerator. A spec that is already a twin comes back unchanged."""
    out = copy.deepcopy(spec)
    for cl in out.get("topology", {}).get("clusters", []):
        if cl.get("provider") != "gcp-tpu":
            continue
        cl["provider"] = "gcp-gpu"
        for pool in cl.get("pools", []):
            if "accelerator" not in pool:
                continue
            accel = pool["accelerator"]
            if accel not in TWIN_ACCELERATORS:
                raise DagSpecError(
                    f"pool {cl.get('name')}/{pool.get('name')}: TPU "
                    f"accelerator {accel!r} has no GPU twin (twins: "
                    f"{TWIN_ACCELERATORS})")
            pool["accelerator"] = TWIN_ACCELERATORS[accel]
    pools = [f"node_gcp-gpu_{cl.get('name')}_{pool.get('name')}"
             for cl in spec.get("topology", {}).get("clusters", [])
             if cl.get("provider") == "gcp-tpu"
             for pool in cl.get("pools", [])]
    for rule in out.get("faults") or []:
        if isinstance(rule.get("module"), str):
            rule["module"] = _twin_module_key(rule["module"])
        if pools and "at_op" in rule:
            rule["at_op"] = _twin_at_op(out["topology"], pools,
                                        int(rule["at_op"]))
    return out


def _twin_at_op(topology: Dict[str, Any], pools: List[str],
                at_op: int) -> int:
    """The twin's global mutation-clock tick for the reference's ``at_op``.

    Each twin pool in ``pools`` issues :data:`TPU_POOL_EXTRA_OPS` fewer
    mutations than its TPU original, so a global anchor names another
    operation on the twin. A fault-free serial apply of the twin records
    which module issues each tick; walking it on the reference's clock
    (the extra deletes after each pool's last operation) gives the twin
    tick of the same operation, or of the next one where ``at_op`` falls
    on a delete. An anchor past the apply keeps its distance from the
    apply's end."""
    from ..executor.cloudsim import CloudSimulator
    from ..executor.dagspec import document_from_spec
    from ..executor.engine import _MEMORY_STATES, LocalExecutor
    from ..utils.logging import Logger

    issued: List[str] = []

    def factory(doc, state):
        sim = CloudSimulator(state or {})
        sim.kill_hook = lambda op, module, module_op: issued.append(module)
        return sim

    name = "twin-at-op"
    _MEMORY_STATES.pop(name, None)
    try:
        LocalExecutor(log=lambda m: None, logger=Logger(stream=io.StringIO()),
                      driver_factory=factory).apply(
            document_from_spec(topology, name))
    finally:
        _MEMORY_STATES.pop(name, None)
    last = {m: i for i, m in enumerate(issued) if m in pools}
    ref_tick = 0
    for i, module in enumerate(issued):
        ref_tick += 1
        if ref_tick >= at_op:
            return i + 1
        if last.get(module) == i:
            ref_tick += TPU_POOL_EXTRA_OPS
    return len(issued) + max(1, at_op - ref_tick)
