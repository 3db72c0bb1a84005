"""The chaos harness -- the port of ``triton_kubernetes_tpu/chaos``, both
halves.

A seeded generator draws scenario specs (``generator.py``, every profile
of the reference, spec for spec the reference's), and the runner
(``runner.py``) runs each spec's GPU twin (``twin_spec``: ``gcp-gpu``
clusters of ``h100-16`` pools):

* **the infra half** -- the module DAG applied serially, at the spec's
  parallelism and killed mid-wave against the simulated cloud with its
  fault plan, latency model and kill hook, the preempted pools repaired,
  the reconcile operator hit between observe and act, everything
  destroyed: the invariants ``parity``, ``kill-resume``,
  ``trace-journal``, ``metrics-journal``, ``repair``,
  ``operator-converge`` and ``destroy-clean``. Host code: no device;
* **the workload half** -- a spec's ``workload`` fault through its arm
  (``workload.py``: a replica killed mid-decode behind the router, page
  pressure that preempts mid-chunked-prefill, a KV migration torn at a
  byte offset, torn and reshard-torn checkpoints, a rank or the
  coordinator killed mid-run, a SIGTERM to ``tools.route``) against the
  port's engines, router, migration, checkpoints and trainer on the
  device asked for, checked by the workload invariants.

Failing specs shrink to minimal ones (``shrink.py``) and become corpus
entries (``corpus.py``); the committed corpus under
``tests/chaos_corpus/`` replays through the port, every entry. The
soak round (``soak.py``) closes apply -> train -> preempt -> repair ->
resume. ``python -m triton_kubernetes_tpu_torch.tools.chaos`` is the
command line.
"""

from .corpus import (
    CORPUS_DIR,
    CorpusError,
    load_entries,
    save_entry,
    validate_entry,
)
from .generator import PROFILES, generate_spec, scenario_seed, twin_spec
from .runner import (
    ChaosHarnessError,
    ScenarioResult,
    SweepReport,
    run_scenario,
    run_sweep,
)
from .shrink import shrink_spec, spec_size

__all__ = [
    "CORPUS_DIR",
    "ChaosHarnessError",
    "CorpusError",
    "PROFILES",
    "ScenarioResult",
    "SweepReport",
    "generate_spec",
    "load_entries",
    "run_scenario",
    "run_sweep",
    "save_entry",
    "scenario_seed",
    "shrink_spec",
    "spec_size",
    "twin_spec",
    "validate_entry",
]
