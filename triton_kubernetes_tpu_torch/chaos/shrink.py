"""Greedy shrinking of a failing spec's workload fault -- the workload
moves of ``triton_kubernetes_tpu/chaos/shrink.py``.

The shrinker reduces the spec while the *same invariant* keeps failing:

* drop the workload fault whole;
* walk each field back to its kind default;
* halve an integer field toward its default, so e.g. ``die_after_tokens``
  lands as early as possible.

Greedy fixpoint: candidates are tried in a fixed order; the first one that
still reproduces is accepted and the scan restarts. The result is 1-minimal
with respect to these moves. The reference's infra moves (drop clusters,
nodes, rules, lower the parallelism, rebisect anchors) reduce the parts of
a spec that the port's runner does not run, so the port leaves them as
they are.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Callable, Dict, Iterator, Optional

from ..utils import metrics
from .corpus import WORKLOAD_DEFAULTS

_MAX_ACCEPTED = 200  # hard stop; generated specs are far smaller


def _candidates(spec: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    """Every single-move reduction of a spec's workload fault, coarsest
    first: the whole fault, then each field to its default, then halving."""
    workload = spec.get("workload")
    if workload is None:
        return
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
    is returned unchanged. A candidate the runner refuses
    (:class:`~.runner.ChaosHarnessError`) counts as not reproducing."""
    from .runner import ChaosHarnessError, run_scenario

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
            try:
                cand_result = runner(cand)
            except ChaosHarnessError:
                # A candidate the port cannot run (the fault dropped whole
                # leaves an infra-only spec) does not reproduce anything.
                cand_result = None
            still_fails = (cand_result is not None
                           and cand_result.violated(target))
            metrics.counter("tk8s_chaos_shrink_steps_total").inc(
                outcome="accepted" if still_fails else "rejected")
            if still_fails:
                best, best_result = cand, cand_result
                accepted += 1
                if log:
                    log(f"shrink: accepted -> "
                        f"{workload_fault_fields(best)} workload fields "
                        f"({len(json.dumps(best))} bytes)")
                progress = True
                break
    return best, best_result
