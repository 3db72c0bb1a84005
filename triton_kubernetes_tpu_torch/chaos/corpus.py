"""The shrunk-counterexample corpus -- the port of
``triton_kubernetes_tpu/chaos/corpus.py``, schema and all.

A corpus entry is one JSON file under ``tests/chaos_corpus/`` holding a
(usually shrunk) scenario spec plus the verdict it must reproduce:

* ``expect: "pass"`` -- a scenario that once failed (or a curated
  coverage scenario); replay asserts every invariant now holds;
* ``expect: "violated"`` + ``invariant`` -- a harness self-test: the spec
  carries a ``mutation`` that deliberately breaks an invariant, and
  replay asserts the harness still *catches* it.

The port reads the same files with the same schema, and :func:`replay`
runs every entry: its infra half on the GPU twin of the spec, its
workload arm (if any) on the device asked for.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

ENTRY_VERSION = 1
ENTRY_KIND = "tk8s-chaos-corpus"
#: Repo-relative home of the pinned corpus.
CORPUS_DIR = os.path.join("tests", "chaos_corpus")

_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9-]*$")

_REQUIRED_KEYS = ("version", "kind", "name", "expect", "spec")
_ALLOWED_KEYS = _REQUIRED_KEYS + ("invariant", "notes", "shrunk_from")
_SPEC_KEYS = ("version", "seed", "profile", "parallelism", "op_latency",
              "topology", "faults", "kill_fraction", "mutation",
              "operator_preempt", "workload")

#: The CLOSED set of workload fault kinds a scenario may draw. Every name
#: here has an arm in chaos/workload.py (``_ARMS``), defaults below, and a
#: generator profile that can draw it.
WORKLOAD_FAULT_KINDS = (
    "replica-death",      # kill a replica mid-decode; router re-lands
    "engine-preempt",     # page pressure preempts mid-chunked-prefill
    "torn-checkpoint",    # corrupt a step's files; resume falls back
    "rank-death",         # one worker dies at a step offset
    "coordinator-loss",   # rank 0 dies at a step offset
    "sigterm-flush",      # SIGTERM the route process; flush must land
    "kv-migration-torn",  # KV-page transfer torn mid-flight; digest bites
    "reshard-torn-checkpoint",  # manifest torn mid elastic reshard;
                                # fallback restores the older intact
                                # step at ITS recorded shape
)

#: Per-kind fault-field defaults. A spec's workload dict may override any
#: subset; shrinking walks fields back toward these, and
#: ``workload_fault_fields`` (shrink.py) counts the distance.
WORKLOAD_DEFAULTS = {
    "replica-death": {"replicas": 2, "die_after_tokens": 1,
                      "prompt_len": 4, "max_new_tokens": 6},
    "engine-preempt": {"prefix_cache": False, "spec_k": 0,
                       "long_windows": 4, "requests": 2,
                       "abort_after_steps": None},
    "torn-checkpoint": {"corruption": "truncate", "torn_step": 1,
                        "keep_steps": 2},
    "rank-death": {"crash_step": 1, "steps": 4},
    "coordinator-loss": {"crash_step": 1, "steps": 4},
    "sigterm-flush": {"process": "route", "after_requests": 1},
    "kv-migration-torn": {"cut": "bitflip", "offset_frac": 0.5,
                          "prompt_len": 12, "max_new_tokens": 6},
    "reshard-torn-checkpoint": {"offset_frac": 0.5, "torn_step": 2,
                                "keep_steps": 2},
}


class CorpusError(ValueError):
    """A corpus entry does not match the schema (or failed to parse)."""


def validate_entry(entry: Any) -> List[str]:
    """Schema problems of one entry (empty list = valid)."""
    problems: List[str] = []
    if not isinstance(entry, dict):
        return ["entry must be a JSON object"]
    for key in _REQUIRED_KEYS:
        if key not in entry:
            problems.append(f"missing required key {key!r}")
    unknown = set(entry) - set(_ALLOWED_KEYS)
    if unknown:
        problems.append(f"unknown keys {sorted(unknown)}")
    if entry.get("version") != ENTRY_VERSION:
        problems.append(f"version must be {ENTRY_VERSION}")
    if entry.get("kind") != ENTRY_KIND:
        problems.append(f"kind must be {ENTRY_KIND!r}")
    name = entry.get("name")
    if not isinstance(name, str) or not _NAME_RE.match(name or ""):
        problems.append("name must be a kebab-case slug")
    expect = entry.get("expect")
    if expect not in ("pass", "violated"):
        problems.append("expect must be 'pass' or 'violated'")
    if expect == "violated" and not isinstance(entry.get("invariant"), str):
        problems.append("a 'violated' entry must name its invariant")
    spec = entry.get("spec")
    if not isinstance(spec, dict):
        problems.append("spec must be an object")
        return problems
    for key in ("seed", "parallelism", "topology", "faults"):
        if key not in spec:
            problems.append(f"spec missing {key!r}")
    unknown = set(spec) - set(_SPEC_KEYS)
    if unknown:
        problems.append(f"spec has unknown keys {sorted(unknown)}")
    if not isinstance(spec.get("topology"), dict) \
            or "manager" not in (spec.get("topology") or {}):
        problems.append("spec.topology must declare a manager")
    if not isinstance(spec.get("faults"), list):
        problems.append("spec.faults must be a list")
    if expect == "violated" and not spec.get("mutation"):
        problems.append("a 'violated' entry's spec must carry the mutation "
                        "that breaks it (otherwise the failure was real — "
                        "fix it and flip the entry to expect: pass)")
    problems.extend(validate_workload(spec.get("workload")))
    return problems


def validate_workload(workload: Any) -> List[str]:
    """Schema problems of a spec's workload fault (empty list = valid;
    ``None`` means the scenario drew no workload fault). Kind from the
    closed set, field names from that kind's defaults -- an unknown field
    would silently never inject."""
    if workload is None:
        return []
    if not isinstance(workload, dict):
        return ["spec.workload must be an object or null"]
    kind = workload.get("kind")
    if kind not in WORKLOAD_FAULT_KINDS:
        return [f"spec.workload.kind must be one of "
                f"{list(WORKLOAD_FAULT_KINDS)}, got {kind!r}"]
    unknown = set(workload) - {"kind"} - set(WORKLOAD_DEFAULTS[kind])
    if unknown:
        return [f"spec.workload has unknown fields {sorted(unknown)} "
                f"for kind {kind!r}"]
    return []


def entry_for_failure(spec: Dict[str, Any], result) -> Dict[str, Any]:
    """A corpus entry from a (shrunk) failing scenario. Mutated specs are
    harness self-tests (``expect: violated``); real failures are committed
    as ``expect: pass`` once fixed -- until then the replay fails."""
    invariant = result.violations[0]["invariant"] if result.violations \
        else None
    mutated = bool(spec.get("mutation"))
    name = f"{'mutation' if mutated else 'seed'}-{spec['seed']}-" \
           f"{invariant or 'unknown'}"
    entry: Dict[str, Any] = {
        "version": ENTRY_VERSION,
        "kind": ENTRY_KIND,
        "name": name,
        "expect": "violated" if mutated else "pass",
        "spec": spec,
        "notes": "; ".join(f"{v['invariant']}: {v['detail']}"
                           for v in result.violations),
    }
    if invariant:
        entry["invariant"] = invariant
    return entry


def save_entry(entry: Dict[str, Any], corpus_dir: str) -> str:
    problems = validate_entry(entry)
    if problems:
        raise CorpusError(f"refusing to save invalid corpus entry: "
                          f"{problems}")
    os.makedirs(corpus_dir, exist_ok=True)
    path = os.path.join(corpus_dir, f"{entry['name']}.json")
    with open(path, "w") as f:
        json.dump(entry, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_entries(corpus_dir: str) -> List[Tuple[str, Dict[str, Any]]]:
    """Every ``*.json`` entry under a corpus dir, validated, sorted by
    filename. Raises :class:`CorpusError` on the first invalid file."""
    out: List[Tuple[str, Dict[str, Any]]] = []
    if not os.path.isdir(corpus_dir):
        return out
    for fn in sorted(os.listdir(corpus_dir)):
        if not fn.endswith(".json"):
            continue
        path = os.path.join(corpus_dir, fn)
        try:
            with open(path) as f:
                entry = json.load(f)
        except ValueError as e:
            raise CorpusError(f"{path}: not valid JSON: {e}") from e
        problems = validate_entry(entry)
        if problems:
            raise CorpusError(f"{path}: {problems}")
        out.append((path, entry))
    return out


def replay(entry: Dict[str, Any], ns: Optional[str] = None,
           device: str = "cuda"):
    """Run a corpus entry's spec through the port's runner (its workload
    arm, if any, on ``device``); returns the ScenarioResult. The caller asserts the verdict against
    ``entry['expect']``."""
    from .runner import run_scenario

    return run_scenario(entry["spec"], ns=ns or f"corpus-{entry['name']}",
                        device=device)
