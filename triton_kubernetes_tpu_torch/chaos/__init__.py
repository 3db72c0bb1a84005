"""The workload half of the chaos harness -- the port of
``triton_kubernetes_tpu/chaos``'s workload fault arms.

A seeded generator draws scenario specs (``generator.py``, the
``workload`` and ``workload-train`` profiles, spec for spec the
reference's), the runner drives each spec's workload fault through its arm
(``workload.py``: a replica killed mid-decode behind the router, page
pressure that preempts mid-chunked-prefill, a KV migration torn at a byte
offset, torn and reshard-torn checkpoints, a rank or the coordinator
killed mid-run, a SIGTERM to ``tools.route``) against the port's engines,
router, migration, checkpoints and trainer, and checks the workload
invariants (``runner.py``). Failing specs shrink to minimal ones
(``shrink.py``) and become corpus entries (``corpus.py``); the committed
corpus under ``tests/chaos_corpus/`` replays through the port.
``python -m triton_kubernetes_tpu_torch.tools.chaos`` is the command line.

The infra half of a spec (the cluster manager's module DAG against its
cloud simulator) stays with the reference: the port carries it unchanged
and does not run it.
"""

from .corpus import (
    CORPUS_DIR,
    CorpusError,
    load_entries,
    save_entry,
    validate_entry,
)
from .generator import PROFILES, generate_spec, scenario_seed
from .runner import (
    ChaosHarnessError,
    ScenarioResult,
    SweepReport,
    run_scenario,
    run_sweep,
)
from .shrink import shrink_spec

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
    "validate_entry",
]
