"""In-process cloud + control-plane simulator: the port's copy of the
reference's ``executor/cloudsim.py``, over GPU pools.

Modules provision against it, the operator reconciles against it, and its
state round-trips through the executor state file so targeted destroys
and repairs work across invocations. It models, deterministically (no
wall clock, no randomness):

* generic cloud resources (networks, firewalls, instances);
* a Rancher-style control plane: manager bootstrap mints API credentials,
  cluster create-or-get returns ``(cluster_id, registration_token,
  ca_checksum)`` idempotently, nodes join with roles + labels
  (``manager/protocol.py``);
* hosted GKE control planes whose node pools are **GPU pools**
  (``modules/gcp_gpu.py``): one node a GPU host, each labelled with its
  pool (slice) id and worker id (``topology/labels.host_labels_for_pool``);
* applied Kubernetes manifests per cluster (DaemonSets, Jobs, Services);
* the loss of a whole GPU pool (:meth:`CloudSimulator.preempt_slice`):
  its hosts form one JobSet world, so losing one host ends the world as
  a slice reclaim does on a TPU fleet. The method keeps the reference's
  name, so the fault plan's ``preempt`` rules and the preemption history
  read the same.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import os
import signal as _signal
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from ..manager import protocol
from ..utils import metrics


def _token(*parts: str) -> str:
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:40]


class CloudSimError(RuntimeError):
    pass


class TransientFaultError(CloudSimError):
    """An injected fault a real fleet would retry through: a flaked
    control-plane call (429/503), a boot that fails and succeeds on the
    next attempt. The engine's retry/backoff loop consumes this type."""


class FatalFaultError(CloudSimError):
    """An injected fault retries cannot fix: quota exhausted, a config the
    provider permanently rejects. The engine fails fast on this type."""


class FaultPlanError(ValueError):
    """A fault-rule spec is malformed (unknown op/kind/mode, a preempt
    rule with no slice, a floating at_module_op anchor). Raised at plan
    *construction*, uniformly for every rule shape — a generated or
    hand-written plan must fail loudly before the first op, not fire
    nothing (or the wrong thing) mid-apply."""


class SimulatedKillError(BaseException):
    """An injected process death (the kill-mid-wave fault class).

    Derives from BaseException on purpose: the engine's retry loop
    catches ``Exception``, so a kill rides past retry/backoff exactly
    like a real SIGKILL would — the module is NOT retried, the wavefront
    unwinds, and whatever state was saved per completed module is what
    the resumed run starts from."""


class FaultPlan:
    """Deterministic fault injection for the simulator.

    No wall clock, no randomness: faults fire on exact operation matches
    and a monotonic mutation counter (``ops``), so a seeded plan produces
    the identical failure sequence on every run — and, because remaining
    fire-counts serialize with the cloud state, across executor
    invocations too (a re-run after a failed apply sees the plan exactly
    where the failed run left it).

    Spec format (JSON-able; see docs/guide/fault-tolerance.md)::

        {"faults": [
          # Fail an operation N times, then let it succeed (boot flake):
          {"op": "create_resource", "match": {"name": "c1-worker-1"},
           "times": 2, "kind": "transient", "error": "instance boot failed"},
          # Drop/5xx any control-plane call once:
          {"op": "register_node", "times": 1, "kind": "transient",
           "error": "503 service unavailable"},
          # Hard-fail (no retry can help):
          {"op": "create_node_pool", "match": {"pool": "huge"},
           "kind": "fatal", "error": "quota exceeded"},
          # Reclaim a named GPU pool when the mutation clock reaches 7:
          {"op": "preempt", "slice_id": "ml-pool0", "at_op": 7},
          # Graceful-warning preemption: deliver the SIGTERM a spot
          # reclaim sends to the trainer process at the warning tick,
          # reclaim the pool grace_ops mutations later (0 = same tick):
          {"op": "preempt", "slice_id": "ml-pool0", "at_op": 7,
           "mode": "graceful-warning", "notify_pid": 12345,
           "signal": "SIGTERM", "grace_ops": 3},
        ]}

    ``match`` values substring-match the operation's info fields (type,
    name, cluster, pool, hostname, ...); an absent ``match`` matches every
    call of that op; ``op: "*"`` matches every mutating operation.

    **Per-module anchors (interleaving-safe).** Under the wavefront apply
    scheduler the *global* mutation clock interleaves differently at every
    ``--parallelism``, so rules anchored on it (``at_op``) are only
    deterministic for serial applies. Each rule may instead carry:

    * ``module`` — substring-match against the module key the engine has
      scoped around the current apply (``CloudSimulator.module_scope``);
    * ``at_module_op`` — the 1-based index of the operation *within that
      module's own op sequence* (op rules: fire exactly at that index;
      preempt rules: fire once the scoped module's counter reaches it).

    A module's own op sequence is fixed by its config, so per-module
    anchors fire identically at any parallelism — the property the
    parallel-vs-serial bitwise-equality tests pin. ``at_module_op``
    requires ``module`` (an anchor that floats to whichever module gets
    there first would defeat the point; rejected at plan build).

    As with the global clock, a pending preemption (and a
    graceful-warning reclaim in particular) only fires when its
    anchoring clock next *advances*: a ``grace_ops`` window that
    extends past the anchored module's (or, for ``at_op``, the whole
    apply's) last mutation never fires — budget grace windows inside
    the ops the run will actually make.
    """

    #: Every mutating operation the simulator exposes — the closed set an
    #: op rule may name. Kept in sync with the ``_mutate`` call sites
    #: below; a rule naming anything else is a typo that would silently
    #: never fire, so it is rejected at construction instead.
    MUTATING_OPS = frozenset({
        "create_resource", "delete_resource", "bootstrap_manager",
        "create_or_get_cluster", "register_node", "deregister_node",
        "set_node_health", "create_hosted_cluster", "create_node_pool",
        "apply_manifest", "delete_manifest",
    })

    # Key vocabularies per rule shape: a misspelled key ("slice" for
    # "slice_id") is as silently inert as a misspelled op. ``fired`` /
    # ``warned`` are the serialized live-state keys, accepted so a
    # persisted plan round-trips through its own to_dict().
    _OP_RULE_KEYS = frozenset({
        "op", "times", "kind", "error", "match", "module", "at_module_op",
        "fired"})
    _PREEMPT_RULE_KEYS = frozenset({
        "op", "slice_id", "at_op", "at_module_op", "module", "mode",
        "notify_pid", "signal", "grace_ops", "times", "kind", "fired",
        "warned"})

    def __init__(self, spec: Optional[Dict[str, Any]] = None):
        self.rules: List[Dict[str, Any]] = []
        for i, rule in enumerate((spec or {}).get("faults", [])):
            self.rules.append(self._validated(i, rule))

    @classmethod
    def _validated(cls, i: int, rule: Any) -> Dict[str, Any]:
        """One rule, checked and normalized. Every malformed shape raises
        the same typed :class:`FaultPlanError` naming the rule index and
        the offending field — the uniform error path the generated-plan
        machinery (chaos harness) and hand-written docs plans share."""
        def bad(msg: str) -> FaultPlanError:
            return FaultPlanError(f"fault rule #{i}: {msg} (got {rule!r})")

        if not isinstance(rule, dict):
            raise bad("must be a mapping")
        op = rule.get("op")
        if not isinstance(op, str) or not op:
            raise bad("must name its 'op'")
        r = dict(rule)
        r.setdefault("times", 1)
        r.setdefault("kind", "transient")
        r.setdefault("fired", 0)
        if "at_module_op" in r and not r.get("module"):
            # Without a module anchor the per-module op index matches
            # whichever module reaches it first — exactly the
            # interleaving-dependence this anchor exists to remove.
            raise bad("fault rule with at_module_op must name its module")
        for key in ("times", "fired", "at_op", "at_module_op", "grace_ops",
                    "notify_pid", "warned"):
            if key in r and not isinstance(r[key], int):
                raise bad(f"{key!r} must be an integer")
            if key in r and r[key] < 0:
                raise bad(f"{key!r} must be >= 0")
        if r["times"] < 1:
            raise bad("'times' must be >= 1")
        if "at_module_op" in r and r["at_module_op"] < 1:
            raise bad("'at_module_op' is a 1-based op index, must be >= 1")
        # kind is checked for EVERY rule shape (preempt rules carry the
        # serialized default too): a typo'd kind silently firing with
        # transient semantics is the exact class this validation kills.
        if r["kind"] not in ("transient", "fatal"):
            raise bad(f"unknown kind {r['kind']!r} "
                      "(choices: transient, fatal)")
        if op == "preempt":
            unknown = set(r) - cls._PREEMPT_RULE_KEYS
            if unknown:
                raise bad(f"unknown preempt-rule keys {sorted(unknown)}")
            if not isinstance(r.get("slice_id"), str) or not r["slice_id"]:
                raise bad("preempt rules must name their 'slice_id'")
            if r.get("mode") not in (None, "graceful-warning"):
                raise bad(f"unknown preempt mode {r.get('mode')!r} "
                          "(only 'graceful-warning')")
            return r
        unknown = set(r) - cls._OP_RULE_KEYS
        if unknown:
            raise bad(f"unknown rule keys {sorted(unknown)} "
                      "(mode/slice_id/grace_ops are preempt-rule keys)")
        if op != "*" and op not in cls.MUTATING_OPS:
            raise bad(f"unknown op {op!r} (choices: '*', 'preempt', "
                      f"{sorted(cls.MUTATING_OPS)})")
        if "match" in r and not isinstance(r["match"], dict):
            raise bad("'match' must be a mapping of info-field substrings")
        return r

    def to_dict(self) -> Dict[str, Any]:
        return {"faults": [dict(r) for r in self.rules]}

    @staticmethod
    def _matches(rule: Dict[str, Any], op: str, info: Dict[str, Any],
                 module: str, module_op: int) -> bool:
        if rule.get("op") not in ("*", op):
            return False
        if "module" in rule and str(rule["module"]) not in module:
            return False
        if "at_module_op" in rule and int(rule["at_module_op"]) != module_op:
            return False
        for key, want in (rule.get("match") or {}).items():
            if str(want) not in str(info.get(key, "")):
                return False
        return True

    @staticmethod
    def _preempt_due(rule: Dict[str, Any], sim: "CloudSimulator",
                     module: str, module_op: int, grace: int = 0) -> bool:
        """Whether a preempt rule's anchor (+grace window) has passed —
        the global mutation clock by default, the scoped module's own op
        counter when the rule carries ``at_module_op``."""
        if "at_module_op" in rule:
            if str(rule.get("module", "")) not in module:
                return False
            return module_op >= int(rule["at_module_op"]) + grace
        return sim.ops >= int(rule.get("at_op", 0)) + grace

    def check(self, sim: "CloudSimulator", op: str, info: Dict[str, Any],
              module: str = "", module_op: int = 0) -> None:
        """Called by the simulator before each mutating operation (the
        mutation clock has already ticked). Fires due preemptions, then
        raises if an armed fault rule matches this call. ``module`` /
        ``module_op`` identify the engine-scoped module issuing the call
        and its per-module op index (0 when unscoped)."""
        for rule in self.rules:
            if rule.get("op") != "preempt" or rule["fired"]:
                continue
            if rule.get("mode") == "graceful-warning":
                # The spot-reclaim contract: SIGTERM lands first, the reclaim
                # follows after the grace window. Both anchors are
                # deterministic clock ticks, so the sequence repeats
                # exactly and the warned/fired flags serialize.
                if not rule.get("warned") and self._preempt_due(
                        rule, sim, module, module_op):
                    rule["warned"] = 1
                    sim.warn_preemption(rule["slice_id"],
                                        pid=rule.get("notify_pid"),
                                        sig=rule.get("signal", "SIGTERM"))
                if self._preempt_due(rule, sim, module, module_op,
                                     grace=int(rule.get("grace_ops", 0))):
                    rule["fired"] = 1
                    sim.preempt_slice(rule["slice_id"])
            elif self._preempt_due(rule, sim, module, module_op):
                rule["fired"] = 1
                sim.preempt_slice(rule["slice_id"])
        for rule in self.rules:
            if rule.get("op") == "preempt" or rule["fired"] >= rule["times"]:
                continue
            if self._matches(rule, op, info, module, module_op):
                rule["fired"] += 1
                metrics.counter("tk8s_cloudsim_faults_total").inc(
                    kind=rule["kind"])
                msg = rule.get("error") or f"injected fault on {op}"
                exc = (FatalFaultError if rule["kind"] == "fatal"
                       else TransientFaultError)
                raise exc(f"{msg} (op={op}, "
                          f"attempt {rule['fired']}/{rule['times']})")


class CloudSimulator:
    def __init__(self, state: Optional[Dict[str, Any]] = None,
                 fault_plan: Optional[Dict[str, Any]] = None,
                 op_latency: Optional[Any] = None,
                 sleep: Callable[[float], None] = time.sleep):
        s = state or {}
        # Injectable sleeper (the executor/serve-engine pattern): tests
        # assert latency *accounting* against a recorder instead of
        # wall-clock thresholds that flake under concurrent machine load.
        # Not serialized — a timing implementation, not timing model.
        self._sleep = sleep
        self.resources: Dict[str, Dict[str, Any]] = s.get("resources", {})
        self.managers: Dict[str, Dict[str, Any]] = s.get("managers", {})
        self.clusters: Dict[str, Dict[str, Any]] = s.get("clusters", {})
        self.manifests: Dict[str, List[Dict[str, Any]]] = s.get("manifests", {})
        self.serial: int = s.get("serial", 0)
        # Mutation clock: every state-changing call ticks it exactly once.
        # It anchors at_op preemptions and lets tests assert the zero-
        # mutation no-op contract without wrapping the driver.
        self.ops: int = s.get("ops", 0)
        # Per-module op counters (ticked only inside an engine
        # ``module_scope``): the interleaving-independent clock that
        # per-module fault anchors fire on. Serialized with the state so
        # module-scoped fault sequences survive round-trips like the
        # global clock does.
        self.module_ops: Dict[str, int] = s.get("module_ops", {})
        # Lifetime preemption count per slice id. The live "preempted"
        # pool flag is consumed by repair (the replacement pool comes
        # back clean), so without this record past reclaims are
        # invisible — and the operator's preemption-risk weighting needs
        # exactly that history. Serialized with the state.
        self.preempt_history: Dict[str, int] = s.get("preempt_history", {})
        # One re-entrant lock makes every mutating operation atomic, so
        # the wavefront apply scheduler can drive modules concurrently:
        # clock tick + fault check + state mutation are indivisible.
        self._lock = threading.RLock()
        self._scope = threading.local()
        # Injectable process-death hook (the chaos harness's kill-mid-wave
        # fault): called after every mutation's clock tick + fault check
        # but BEFORE the op's state mutation lands, outside the lock; may
        # raise :class:`SimulatedKillError`. The death therefore leaves
        # the current op not-yet-applied (like an injected fault would) —
        # half-applied *modules* and mid-wave sibling commits are the
        # states it exercises, not a torn individual op. Never
        # serialized — a kill is an event, not state.
        self.kill_hook: Optional[Callable[[str, str, int], None]] = None
        # Opt-in deterministic per-op simulated latency (seconds): a float
        # applied to every mutating op, or an {op: seconds} map with "*"
        # as the default. Off (0) unless configured; serialized with the
        # sim so a reloaded state keeps the same timing model. The sleep
        # happens OUTSIDE the lock, so concurrent modules overlap their
        # latency — which is exactly what makes apply concurrency
        # measurable without a real cloud.
        self.op_latency: Optional[Any] = (
            op_latency if op_latency is not None else s.get("op_latency"))
        # Persisted plan state (with decremented fire-counts) wins over the
        # UNCHANGED spec it came from, so fault sequences stay deterministic
        # across the save/load round-trip of the executor state — but a
        # *different* spec in the driver config re-arms fresh (the operator
        # swapped injection scenarios on a live doc).
        self._fault_spec: Optional[Dict[str, Any]] = s.get("fault_plan_spec")
        if fault_plan and fault_plan != self._fault_spec:
            self.fault_plan: Optional[FaultPlan] = FaultPlan(fault_plan)
            self._fault_spec = fault_plan
        elif "fault_plan" in s:
            self.fault_plan = FaultPlan(s["fault_plan"])
        else:
            self.fault_plan = None

    @contextlib.contextmanager
    def module_scope(self, module_key: str) -> Iterator[None]:
        """Attribute this thread's mutations to one module: ticks that
        module's own op counter and lets fault rules anchor on it
        (``module`` / ``at_module_op``). The engine wraps each module
        apply/destroy in this scope; the scope is thread-local, so
        concurrent modules never see each other's attribution."""
        prev = getattr(self._scope, "module", "")
        self._scope.module = module_key
        try:
            yield
        finally:
            self._scope.module = prev

    def _op_latency_s(self, op: str) -> float:
        spec = self.op_latency
        if not spec:
            return 0.0
        if isinstance(spec, dict):
            return float(spec.get(op, spec.get("*", 0.0)))
        return float(spec)

    def _mutate(self, op: str, **info: Any) -> None:
        """Tick the mutation clock and give the fault plan its shot. Every
        mutating operation calls this first, before touching state, so an
        injected failure always leaves the op not-yet-applied (the module
        retries it via its own idempotent create-or-get)."""
        module = getattr(self._scope, "module", "")
        with self._lock:
            self.ops += 1
            module_op = 0
            if module:
                module_op = self.module_ops.get(module, 0) + 1
                self.module_ops[module] = module_op
            metrics.counter("tk8s_cloudsim_ops_total").inc(op=op)
            if self.fault_plan is not None:
                if module:
                    info = dict(info, module=module)
                self.fault_plan.check(self, op, info, module=module,
                                      module_op=module_op)
        if self.kill_hook is not None:
            self.kill_hook(op, module, module_op)
        latency = self._op_latency_s(op)
        if latency > 0:
            self._sleep(latency)

    # ------------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "resources": self.resources,
                "managers": self.managers,
                "clusters": self.clusters,
                "manifests": self.manifests,
                "serial": self.serial,
                "ops": self.ops,
            }
            if self.module_ops:
                out["module_ops"] = self.module_ops
            if self.preempt_history:
                out["preempt_history"] = self.preempt_history
            if self.op_latency:
                out["op_latency"] = self.op_latency
            if self.fault_plan is not None:
                out["fault_plan"] = self.fault_plan.to_dict()
                if self._fault_spec is not None:
                    out["fault_plan_spec"] = self._fault_spec
            return out

    def snapshot(self) -> Dict[str, Any]:
        """A deep, point-in-time copy of :meth:`to_dict` taken under the
        lock — what the engine persists after each completed module while
        sibling modules may still be mutating the live dicts."""
        with self._lock:
            return copy.deepcopy(self.to_dict())

    # ---------------------------------------------------------------- resources
    def _rkey(self, rtype: str, name: str) -> str:
        return f"{rtype}:{name}"

    def create_resource(self, rtype: str, name: str, **attrs: Any) -> Dict[str, Any]:
        """Idempotent create-or-get of a generic cloud resource."""
        self._mutate("create_resource", type=rtype, name=name)
        with self._lock:
            return self._create_resource_record(rtype, name, **attrs)

    def _create_resource_record(self, rtype: str, name: str,
                                **attrs: Any) -> Dict[str, Any]:
        """The create-or-get body, clock-free — for compound ops that have
        already ticked the mutation clock once for the whole call.

        Generated ids and ips are **content-addressed** (derived from the
        resource key, not a global creation counter), so the applied state
        is byte-identical no matter how concurrent modules interleave
        their creations — the wavefront scheduler's bitwise-parity
        contract rests on this.
        """
        key = self._rkey(rtype, name)
        if key not in self.resources:
            self.serial += 1
            rec = {"type": rtype, "name": name,
                   "id": f"{rtype}-{_token('id', rtype, name)[:8]}", **attrs}
            if rtype.endswith("instance") or rtype.endswith("machine"):
                addr = int(_token("ip", rtype, name)[:6], 16)
                rec.setdefault("ip", f"10.{(addr >> 16) & 255}."
                                     f"{(addr >> 8) & 255}.{addr & 255}")
            self.resources[key] = rec
        else:
            self.resources[key].update(attrs)
        return self.resources[key]

    def get_resource(self, rtype: str, name: str) -> Optional[Dict[str, Any]]:
        return self.resources.get(self._rkey(rtype, name))

    def delete_resource(self, rtype: str, name: str) -> None:
        self._mutate("delete_resource", type=rtype, name=name)
        with self._lock:
            self.resources.pop(self._rkey(rtype, name), None)
            if rtype == "manager":
                self.managers.pop(name, None)
            if rtype == "cluster":
                # "cluster" resources are keyed by cluster *id*, so deleting
                # one module's registration can never hit a same-named
                # cluster under another manager/provider.
                if name in self.clusters:
                    del self.clusters[name]
                    self.manifests.pop(name, None)

    # ------------------------------------------------------- control plane (mgr)
    def bootstrap_manager(self, name: str, url: str) -> Dict[str, str]:
        """Manager bootstrap: mints API credentials, idempotently.

        Reference analog: null_resource.setup_rancher_k8s + data.external
        rancher_server (modules/triton-rancher/main.tf:103-137) — the SSH'd
        bash that logs into a fresh Rancher, mints a token and stores it in
        ``~/rancher_api_key``.
        """
        self._mutate("bootstrap_manager", name=name, url=url)
        with self._lock:
            if name not in self.managers:
                self.managers[name] = {
                    "name": name,
                    "url": url,
                    # Shared credential derivation with the real control
                    # plane (manager/protocol.py); empty salt keeps tests
                    # deterministic.
                    **protocol.mint_credentials(name),
                    "clusters": [],
                }
            self.managers[name]["url"] = url
            return {k: self.managers[name][k]
                    for k in ("url", "access_key", "secret_key")}

    def _find_manager(self, url: str) -> Dict[str, Any]:
        for m in self.managers.values():
            if m["url"] == url:
                return m
        raise CloudSimError(f"no manager at {url!r} (apply the manager module first)")

    def create_or_get_cluster(self, manager_url: str, cluster_name: str,
                              **attrs: Any) -> Dict[str, Any]:
        """Create-or-get a cluster registration (idempotent).

        Reference analog: files/rancher_cluster.sh:17-100 — POST /v3/cluster
        if absent, then mint a clusterregistrationtoken and read the CA
        checksum from /v3/settings/cacerts.
        """
        self._mutate("create_or_get_cluster", name=cluster_name,
                     url=manager_url)
        with self._lock:
            mgr = self._find_manager(manager_url)
            # Shared semantic core with the real control plane: same
            # idempotency, same id/token/CA-checksum derivation
            # (manager/protocol.py).
            cluster = protocol.create_or_get_cluster(
                self.clusters, mgr["name"], cluster_name, **attrs)
            if cluster["id"] not in mgr["clusters"]:
                # Kept sorted, not append-ordered: parallel cluster modules
                # register in whatever order they finish, and the persisted
                # state must not depend on that race.
                mgr["clusters"].append(cluster["id"])
                mgr["clusters"].sort()
            return cluster

    def register_node(self, registration_token: str, hostname: str,
                      roles: List[str], labels: Optional[Dict[str, str]] = None,
                      ca_checksum: str = "") -> Dict[str, Any]:
        """Agent self-registration: a booted host joins its cluster.

        Reference analog: install_rancher_agent.sh.tpl:44 (``docker run
        rancher/rancher-agent --server ... --token ... --ca-checksum ...
        --worker|--etcd|--controlplane``). Token+checksum pinning enforced.
        """
        self._mutate("register_node", hostname=hostname)
        with self._lock:
            try:
                return protocol.register_node(
                    self.clusters, registration_token, hostname, roles,
                    labels, ca_checksum)
            except protocol.ProtocolError as e:
                raise CloudSimError(str(e)) from e

    def deregister_node(self, hostname: str) -> None:
        """Remove a host's registration (and its recorded health) from
        whichever cluster holds it — the node-module destroy path.
        Hostnames are unique per state doc (the create-node numbering
        contract), so a plain scan is unambiguous."""
        self._mutate("deregister_node", hostname=hostname)
        with self._lock:
            for c in self.clusters.values():
                c["nodes"].pop(hostname, None)

    def cluster_by_id(self, cluster_id: str) -> Dict[str, Any]:
        if cluster_id not in self.clusters:
            raise CloudSimError(f"no such cluster {cluster_id!r}")
        return self.clusters[cluster_id]

    # ------------------------------------------------------------ node health
    def set_node_health(self, cluster_id: str, hostname: str, ready: bool,
                        reason: str = "") -> None:
        """Record a health transition (what the slice-health probe's
        readiness flip or a failed agent heartbeat reports)."""
        self._mutate("set_node_health", cluster=cluster_id,
                     hostname=hostname)
        with self._lock:
            c = self.cluster_by_id(cluster_id)
            if hostname not in c["nodes"]:
                raise CloudSimError(f"no node {hostname!r} in {cluster_id!r}")
            c["nodes"][hostname]["health"] = {"ready": ready, "reason": reason}

    def node_health(self, cluster_id: str) -> Dict[str, Dict[str, Any]]:
        """{node: {ready, reason}} — the consumer side of the health story
        (SURVEY.md §5: slice-health readiness + node-repair surfacing).
        Registered agents default Ready; the real local driver overrides
        this with actual kubelet conditions."""
        c = self.cluster_by_id(cluster_id)
        return {h: dict(n.get("health", {"ready": True, "reason": ""}))
                for h, n in c["nodes"].items()}

    # --------------------------------------------------------------- hosted k8s
    def create_hosted_cluster(self, kind: str, name: str, **attrs: Any) -> Dict[str, Any]:
        """Hosted control plane (GKE/AKS analog): no agent registration —
        nodes come from provider-managed node pools. Re-creates update attrs
        in place (k8s_version bumps etc.), preserving node pools."""
        self._mutate("create_hosted_cluster", type=kind, name=name)
        with self._lock:
            key = self._rkey(f"{kind}_cluster", name)
            if key not in self.resources:
                # Clock-free inner create: this compound op already ticked
                # once.
                self._create_resource_record(
                    f"{kind}_cluster", name,
                    endpoint=f"https://{name}.{kind}.local",
                    node_pools={}, **attrs)
            else:
                self.resources[key].update(attrs)
            return self.resources[key]

    def create_node_pool(self, kind: str, cluster_name: str, pool_name: str,
                         node_count: int, node_labels: Optional[List[Dict[str, str]]] = None,
                         **attrs: Any) -> Dict[str, Any]:
        """Node pool on a hosted cluster; each node gets the provided labels
        (this is where a GPU pool's slice-id/worker-id labels land)."""
        self._mutate("create_node_pool", type=kind, cluster=cluster_name,
                     pool=pool_name)
        with self._lock:
            cluster = self.get_resource(f"{kind}_cluster", cluster_name)
            if cluster is None:
                raise CloudSimError(f"no {kind} cluster {cluster_name!r}")
            nodes = []
            for i in range(node_count):
                labels = (dict(node_labels[i])
                          if node_labels and i < len(node_labels) else {})
                nodes.append({"name": f"{cluster_name}-{pool_name}-{i}",
                              "labels": labels})
            pool = {"name": pool_name, "node_count": node_count,
                    "nodes": nodes, **attrs}
            cluster["node_pools"][pool_name] = pool
            return pool

    # ---------------------------------------------------------------- manifests
    def apply_manifest(self, cluster_id: str, manifest: Dict[str, Any]) -> None:
        """kubectl-apply analog, idempotent on (kind, metadata.name).

        Rejects an object without ``apiVersion``, ``kind`` or
        ``metadata.name``, as any API server would (the reference's full
        schema check, ``topology/validate.py``, is not ported)."""
        self._mutate("apply_manifest", cluster=cluster_id,
                     kind=manifest.get("kind", ""),
                     name=manifest.get("metadata", {}).get("name", ""))
        for key in ("apiVersion", "kind"):
            if not isinstance(manifest.get(key), str) or not manifest[key]:
                raise CloudSimError(f"manifest without {key}: {manifest!r}")
        if not (manifest.get("metadata") or {}).get("name"):
            raise CloudSimError(
                f"manifest {manifest['kind']} without metadata.name")
        with self._lock:
            objs = self.manifests.setdefault(cluster_id, [])
            ident = (manifest.get("kind"),
                     manifest.get("metadata", {}).get("name"))
            for i, existing in enumerate(objs):
                if (existing.get("kind"),
                        existing.get("metadata", {}).get("name")) == ident:
                    objs[i] = manifest
                    return
            objs.append(manifest)
            # Kept sorted by (kind, name), not append-ordered: parallel
            # modules installing into the same cluster must leave the
            # same manifest list no matter which finished first.
            objs.sort(key=lambda m: (str(m.get("kind", "")),
                                     str(m.get("metadata", {}).get("name", ""))))

    def delete_manifest(self, cluster_id: str, kind: str, name: str) -> bool:
        """kubectl-delete analog; returns True if the object existed."""
        self._mutate("delete_manifest", cluster=cluster_id, kind=kind,
                     name=name)
        with self._lock:
            objs = self.manifests.get(cluster_id, [])
            for i, m in enumerate(objs):
                if (m.get("kind"),
                        m.get("metadata", {}).get("name")) == (kind, name):
                    del objs[i]
                    return True
            return False

    def get_manifests(self, cluster_id: str, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        objs = self.manifests.get(cluster_id, [])
        if kind is None:
            return objs
        return [o for o in objs if o.get("kind") == kind]

    # --------------------------------------------------------- pool preemption
    def _slice_pools(self, slice_id: str):
        """(cluster_resource, pool) pairs for a pool id: matched by the
        slice-id node label, or — for already-preempted pools whose labels
        are gone — by the "<cluster>-<pool>" naming contract
        (modules/gcp_gpu.py)."""
        from ..topology.labels import LABEL_PREFIX

        label = f"{LABEL_PREFIX}/slice-id"
        for rec in self.resources.values():
            for pool_name, pool in (rec.get("node_pools") or {}).items():
                if (any(n.get("labels", {}).get(label) == slice_id
                        for n in pool.get("nodes", []))
                        or f"{rec.get('name')}-{pool_name}" == slice_id):
                    yield rec, pool

    def warn_preemption(self, slice_id: str, pid: Optional[int] = None,
                        sig: Any = "SIGTERM") -> List[str]:
        """Graceful preemption warning: a spot reclaim sends the workload
        SIGTERM ~30 s before it takes a GPU pool's hosts (the JobSet
        termination grace period). The simulator marks the pool
        ``preempt_warning`` and -- when ``pid`` names a live trainer
        process -- delivers the real signal, so a test drives the
        trainer's preemption-aware emergency-checkpoint path with an
        actual SIGTERM, not a mock. Like :meth:`preempt_slice`, this IS
        the fault event: no clock tick, no fault-plan re-entry."""
        hit: List[str] = []
        with self._lock:
            for _, pool in self._slice_pools(slice_id):
                pool["preempt_warning"] = True
                hit.extend(n["name"] for n in pool.get("nodes", []))
        if not hit:
            raise CloudSimError(f"no node pool carries slice {slice_id!r}")
        metrics.counter("tk8s_cloudsim_preempt_warnings_total").inc()
        if pid:
            signum = getattr(_signal, sig) if isinstance(sig, str) else sig
            try:
                os.kill(int(pid), signum)
            except ProcessLookupError:
                pass  # workload already gone; the warning outlived it
        return hit

    def preempt_slice(self, slice_id: str) -> List[str]:
        """Preempt a GPU pool: every host VM in its node pool is
        reclaimed (a spot reclaim; one host lost ends the pool's JobSet
        world, so the pool is the unit). The pool stays on record but its
        nodes lose their labels — what a real reclaim leaves behind:
        capacity gone, stale pool object, scheduler labels meaningless. Mutates state directly (it
        IS the fault), so it never ticks the mutation clock or re-enters
        the fault plan."""
        hit: List[str] = []
        with self._lock:
            for _, pool in self._slice_pools(slice_id):
                pool["preempted"] = True
                for node in pool.get("nodes", []):
                    node["preempted"] = True
                    node["labels"] = {}
                    hit.append(node["name"])
            if hit:
                self.preempt_history[slice_id] = \
                    self.preempt_history.get(slice_id, 0) + 1
        if not hit:
            raise CloudSimError(f"no node pool carries slice {slice_id!r}")
        metrics.counter("tk8s_cloudsim_preemptions_total").inc()
        return hit

    def cordon_slice(self, slice_id: str) -> List[str]:
        """Mark a pool's surviving node objects unschedulable before
        replacement (kubectl cordon analog) — repair must stop new pods
        landing on a half-dead pool before it tears the pool down."""
        hit: List[str] = []
        with self._lock:
            for _, pool in self._slice_pools(slice_id):
                for node in pool.get("nodes", []):
                    node["cordoned"] = True
                    hit.append(node["name"])
        return hit

    def preempted_slices(self) -> Dict[str, Dict[str, Any]]:
        """{slice_id: {cluster, pool, nodes}} for every pool currently
        marked preempted — what the slice-aware repair loop scans."""
        out: Dict[str, Dict[str, Any]] = {}
        for rec in self.resources.values():
            for pool_name, pool in (rec.get("node_pools") or {}).items():
                if not pool.get("preempted"):
                    continue
                # The label is gone post-preemption; reconstruct the pool
                # id from the naming contract (modules/gcp_gpu.py):
                # slice_id = "<cluster>-<pool>".
                slice_id = f"{rec['name']}-{pool_name}"
                out[slice_id] = {
                    "cluster": rec["name"],
                    "pool": pool_name,
                    "nodes": [n["name"] for n in pool.get("nodes", [])],
                }
        return out
