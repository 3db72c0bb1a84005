"""Scenario execution for the workload fault arms -- the workload half of
``triton_kubernetes_tpu/chaos/runner.py``.

A scenario spec (chaos/generator.py) carries an infra half -- a module DAG
with fault rules, run by the reference's cluster manager against its cloud
simulator -- and, for the workload profiles, one ``workload`` fault. The
port runs the workload fault only: one arm of chaos/workload.py against
the port's engines, router, migration, checkpoints and trainer, each
checked by the workload invariants (``engine-parity``, ``reland-parity``,
``pool-convergence``, ``trace-valid``, ``ckpt-fallback``,
``train-resume``, ``flush-clean``, ``migration-integrity``,
``reshard-fallback``).

A spec with no workload fault, and the ``unfaulted-reference`` mutation
(which breaks an infra invariant), raise :class:`ChaosHarnessError`: there
is nothing here to run them, and a vacuous pass would claim coverage that
does not exist.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..utils import metrics

#: The workload invariants (the reference's INVARIANTS from
#: ``engine-parity`` on; its infra ids -- parity, kill-resume,
#: trace-journal, metrics-journal, repair, destroy-clean,
#: operator-converge -- belong to the cluster manager).
INVARIANTS = ("engine-parity", "reland-parity", "pool-convergence",
              "trace-valid", "ckpt-fallback", "train-resume",
              "flush-clean", "migration-integrity", "reshard-fallback")

#: Deliberate invariant breakages (mutation testing of the harness itself),
#: one workload invariant each: ``dropped-reland`` truncates the re-landed
#: response before the parity compare, ``leaked-pages`` skips the page-pool
#: release before the convergence check, ``swallowed-abort`` drops the
#: abort flush so lifecycles end terminal-less, ``accepted-torn`` pretends
#: the destination imported a torn KV payload, ``adopt-torn-step`` pretends
#: restore landed the half-committed reshard step.
MUTATIONS = ("dropped-reland", "leaked-pages", "swallowed-abort",
             "accepted-torn", "adopt-torn-step")

#: The reference's infra mutation: the cluster manager's to run.
INFRA_MUTATIONS = ("unfaulted-reference",)


class ChaosHarnessError(RuntimeError):
    """The harness itself could not run a scenario to a verdict (as
    opposed to a scenario that ran and violated an invariant)."""


@dataclass
class ScenarioResult:
    spec: Dict[str, Any]
    violations: List[Dict[str, str]] = field(default_factory=list)
    checked: List[str] = field(default_factory=list)
    stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def passed(self) -> bool:
        return not self.violations

    def violated(self, invariant: str) -> bool:
        return any(v["invariant"] == invariant for v in self.violations)

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.spec.get("seed"), "passed": self.passed,
                "checked": self.checked, "violations": self.violations,
                "stats": self.stats}


@dataclass
class SweepReport:
    profile: str
    seed: int
    runs: int = 0
    passed: int = 0
    results: List[ScenarioResult] = field(default_factory=list)
    corpus_written: List[str] = field(default_factory=list)
    simulated_seconds: float = 0.0

    @property
    def failed(self) -> int:
        return self.runs - self.passed

    def to_dict(self) -> Dict[str, Any]:
        return {"profile": self.profile, "seed": self.seed,
                "runs": self.runs, "passed": self.passed,
                "failed": self.failed,
                "simulated_seconds": self.simulated_seconds,
                "corpus_written": self.corpus_written,
                "failures": [r.to_dict() for r in self.results
                             if not r.passed]}


def _check(res: ScenarioResult, invariant: str, ok: bool,
           detail: str) -> None:
    res.checked.append(invariant)
    metrics.counter("tk8s_chaos_invariant_checks_total").inc(
        invariant=invariant, status="ok" if ok else "violated")
    if not ok:
        res.violations.append({"invariant": invariant, "detail": detail})


def run_scenario(spec: Dict[str, Any], ns: str = "chaos",
                 device: str = "cuda") -> ScenarioResult:
    """Run one scenario's workload arm on ``device`` and check its
    invariants. ``stats["simulated_seconds"]`` is the simulated time the
    arm booked (engine clocks, trainer walls). ``ns`` names the scenario
    in logs, as in the reference."""
    mutation = spec.get("mutation")
    if mutation in INFRA_MUTATIONS:
        raise ChaosHarnessError(
            f"mutation {mutation!r} breaks an infra invariant: the cluster "
            f"manager's harness (triton_kubernetes_tpu.chaos) runs it, "
            f"not the port")
    if mutation is not None and mutation not in MUTATIONS:
        raise ChaosHarnessError(f"unknown mutation {mutation!r} "
                                f"(choices: {MUTATIONS})")
    if not spec.get("workload"):
        raise ChaosHarnessError(
            f"spec {ns}-s{spec.get('seed', 0)} carries no workload fault: "
            f"its infra DAG is the cluster manager's to run "
            f"(triton_kubernetes_tpu.chaos), the port runs workload arms "
            f"only")
    from .workload import run_workload_arm

    res = ScenarioResult(spec=spec)
    slept: List[float] = []
    try:
        run_workload_arm(spec, res, _check, slept.append, device=device)
    finally:
        res.stats["simulated_seconds"] = round(sum(slept), 6)
    status = "ok" if res.passed else "violated"
    metrics.counter("tk8s_chaos_scenarios_total").inc(status=status)
    return res


def run_sweep(seed: int, runs: int, profile: str = "workload",
              shrink: bool = True, corpus_dir: Optional[str] = None,
              log: Optional[Callable[[str], None]] = None,
              device: str = "cuda") -> SweepReport:
    """N seeded scenarios; failing seeds are shrunk to minimal specs and
    (when ``corpus_dir`` is set) serialized as corpus entries."""
    from .corpus import entry_for_failure, save_entry
    from .generator import generate_spec, scenario_seed
    from .shrink import shrink_spec

    report = SweepReport(profile=profile, seed=seed)
    for i in range(runs):
        spec = generate_spec(scenario_seed(seed, i), profile)
        result = run_scenario(spec, device=device)
        report.runs += 1
        report.simulated_seconds += result.stats.get("simulated_seconds", 0)
        if result.passed:
            report.passed += 1
            continue
        report.results.append(result)
        if log:
            log(f"seed {spec['seed']}: violated "
                f"{[v['invariant'] for v in result.violations]}")
        if shrink:
            spec, result = shrink_spec(spec, result, device=device)
        if corpus_dir is not None:
            path = save_entry(entry_for_failure(spec, result), corpus_dir)
            report.corpus_written.append(path)
    return report
