"""Greedy structural shrinking of failing scenario specs -- the port of
``triton_kubernetes_tpu/chaos/shrink.py``.

A raw failing seed is rarely a good regression test: it carries modules,
fault rules, and latency noise that have nothing to do with the bug. The
shrinker reduces the spec while the *same invariant* keeps failing,
using deterministic, structure-aware moves:

* drop a whole cluster (and with it its nodes/pools/jobsets);
* drop one node / pool / jobset (pools take their dependent jobsets);
* drop one fault rule;
* lower the parallelism (8 -> 2 -> 1);
* drop the latency model, drop the kill, drop the operator draw;
* reduce the workload fault -- drop it whole, walk each field back to
  its kind default, halve ints toward the default;
* rebisect anchors -- halve ``at_op`` / ``at_module_op`` / the kill
  fraction toward the origin, so the repro fires as early as possible.

Greedy fixpoint: candidates are tried in a fixed order; the first one
that still reproduces is accepted and the scan restarts. The result is
1-minimal with respect to these moves (no single move keeps the
failure), which in practice lands on specs of a couple modules and at
most a rule or two -- small enough to read in a corpus diff. Specs stay
in the reference's vocabulary throughout (the runner twins each one).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..utils import metrics
from .corpus import WORKLOAD_DEFAULTS

_MAX_ACCEPTED = 200  # hard stop; generated specs are far smaller


def _candidates(spec: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    """Every single-move reduction of a spec, deterministically ordered
    (coarsest first: whole clusters before single nodes before knobs)."""
    topo = spec["topology"]
    clusters = topo.get("clusters", [])
    # 1. drop a whole cluster
    for i in range(len(clusters)):
        s = copy.deepcopy(spec)
        del s["topology"]["clusters"][i]
        yield s
    # 2. drop one node / jobset / pool (a pool drags its jobsets along —
    # a jobset interpolating a dropped pool would not even validate)
    for i, cl in enumerate(clusters):
        for key in ("nodes", "jobsets", "pools"):
            for j in range(len(cl.get(key, []))):
                s = copy.deepcopy(spec)
                scl = s["topology"]["clusters"][i]
                dropped = scl[key].pop(j)
                if key == "pools":
                    scl["jobsets"] = [jb for jb in scl.get("jobsets", [])
                                      if jb.get("pool") != dropped["name"]]
                    if not scl["jobsets"]:
                        scl.pop("jobsets", None)
                if not scl.get(key):
                    scl.pop(key, None)
                yield s
    # 3. drop one fault rule
    for i in range(len(spec.get("faults", []))):
        s = copy.deepcopy(spec)
        del s["faults"][i]
        yield s
    # 4. lower parallelism
    for width in (2, 1):
        if spec.get("parallelism", 1) > width:
            s = copy.deepcopy(spec)
            s["parallelism"] = width
            yield s
    # 5. drop the latency model / the kill
    if spec.get("op_latency") is not None:
        s = copy.deepcopy(spec)
        s["op_latency"] = None
        yield s
    if spec.get("kill_fraction") is not None:
        s = copy.deepcopy(spec)
        s["kill_fraction"] = None
        yield s
    if spec.get("operator_preempt") is not None:
        s = copy.deepcopy(spec)
        s["operator_preempt"] = None
        yield s
    # 5b. reduce the workload fault: drop it whole, then walk each
    # field back to its kind default (coarse to fine — a field at its
    # default is not part of the repro), then halve ints toward the
    # default so e.g. die_after_tokens lands as early as possible.
    workload = spec.get("workload")
    if workload is not None:
        s = copy.deepcopy(spec)
        s["workload"] = None
        yield s
        defaults = WORKLOAD_DEFAULTS.get(workload.get("kind"), {})
        for name in sorted(defaults):
            v, dv = workload.get(name), defaults[name]
            if name not in workload or v == dv:
                continue
            s = copy.deepcopy(spec)
            s["workload"][name] = dv
            yield s
            if isinstance(v, int) and not isinstance(v, bool) \
                    and isinstance(dv, int) and v > dv + 1:
                s = copy.deepcopy(spec)
                s["workload"][name] = dv + (v - dv) // 2
                yield s
    # 6. rebisect anchors toward the origin
    for i, rule in enumerate(spec.get("faults", [])):
        for anchor in ("at_op", "at_module_op"):
            v = rule.get(anchor)
            if isinstance(v, int) and v > 1:
                s = copy.deepcopy(spec)
                s["faults"][i][anchor] = v // 2
                yield s
    kf = spec.get("kill_fraction")
    if isinstance(kf, float) and kf > 0.1:
        s = copy.deepcopy(spec)
        s["kill_fraction"] = round(kf / 2, 3)
        yield s


def spec_size(spec: Dict[str, Any]) -> Tuple[int, int]:
    """(modules, fault rules) — the two counts the acceptance bars use."""
    topo = spec["topology"]
    n = 1  # manager
    for cl in topo.get("clusters", []):
        n += 1 + len(cl.get("nodes", [])) + len(cl.get("pools", [])) \
            + len(cl.get("jobsets", []))
    return n, len(spec.get("faults", []))


def workload_fault_fields(spec: Dict[str, Any]) -> int:
    """How many workload fault fields differ from their kind defaults -- the
    minimality bar ("shrunk to <= 2 fault fields"). A spec without a
    workload fault counts 0."""
    workload = spec.get("workload")
    if not workload:
        return 0
    defaults = WORKLOAD_DEFAULTS.get(workload.get("kind"), {})
    return sum(1 for name, dv in defaults.items()
               if name in workload and workload[name] != dv)


def shrink_spec(spec: Dict[str, Any], result=None,
                run: Optional[Callable[[Dict[str, Any]], Any]] = None,
                log: Optional[Callable[[str], None]] = None,
                device: str = "cuda"):
    """Reduce a failing spec to a 1-minimal repro of the same invariant.

    Returns ``(minimal_spec, minimal_result)``. ``run`` defaults to
    :func:`~.runner.run_scenario` on ``device``; injectable for the
    shrinker's own tests. A spec whose failure does not reproduce up front
    is returned unchanged (flaky findings must not be 'minimized' into
    noise).
    """
    from .runner import run_scenario

    runner = run or (lambda s: run_scenario(s, ns="shrink", device=device))
    if result is None:
        result = runner(spec)
    if result.passed:
        return spec, result
    target = result.violations[0]["invariant"]
    best, best_result = copy.deepcopy(spec), result
    accepted = 0
    progress = True
    while progress and accepted < _MAX_ACCEPTED:
        progress = False
        for cand in _candidates(best):
            cand_result = runner(cand)
            still_fails = cand_result.violated(target)
            metrics.counter("tk8s_chaos_shrink_steps_total").inc(
                outcome="accepted" if still_fails else "rejected")
            if still_fails:
                best, best_result = cand, cand_result
                accepted += 1
                if log:
                    mods, rules = spec_size(best)
                    log(f"shrink: accepted -> {mods} modules, "
                        f"{rules} rules "
                        f"({len(json.dumps(best))} bytes)")
                progress = True
                break
    return best, best_result
