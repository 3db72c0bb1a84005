"""The port's chaos harness against the reference's, on the CPU.

* **generation** -- ``generate_spec`` and ``scenario_seed`` give the
  reference's specs, whole dicts, for every profile;
* **schema** -- ``validate_workload`` / ``validate_entry`` give the
  reference's problems on every committed entry and on malformed ones;
* **shrinking** -- the moves reach the reference's minimal spec under the
  reference test's injected runner;
* **corpus replay** -- every workload-bearing corpus entry replays through
  the port to its pinned verdict (a mutation caught on exactly the
  invariant it names);
* **the harness's edges** -- a skip is an outcome, the arm table matches
  the kind set, ``accepted-torn`` is caught;
* **the command line** -- ``tools.chaos`` prints the reference's summary.
"""

from __future__ import annotations

import copy
import os

import pytest

from triton_kubernetes_tpu.chaos import corpus as jcorpus
from triton_kubernetes_tpu.chaos import generator as jgenerator
from triton_kubernetes_tpu.chaos import shrink as jshrink
from triton_kubernetes_tpu.chaos.runner import ScenarioResult as JResult
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu_torch.chaos import corpus, generator, shrink
from triton_kubernetes_tpu_torch.chaos import workload as wl
from triton_kubernetes_tpu_torch.chaos.runner import (
    INVARIANTS,
    MUTATIONS,
    ChaosHarnessError,
    ScenarioResult,
    run_scenario,
)
from triton_kubernetes_tpu_torch.utils import metrics

_CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chaos_corpus")
_ENTRIES = corpus.load_entries(_CORPUS)
_WORKLOAD_ENTRIES = [(p, e) for p, e in _ENTRIES if e["spec"].get("workload")]
#: The workload invariants: the reference's ids from ``engine-parity`` on.
_WORKLOAD_IDS = INVARIANTS[INVARIANTS.index("engine-parity"):]


@pytest.fixture(autouse=True)
def fresh_registries():
    metrics.configure()
    jmetrics.configure()
    yield
    metrics.configure()
    jmetrics.configure()


# ------------------------------------------------------------ generation
@pytest.mark.parametrize("profile", ["workload", "workload-train", "quick",
                                     "default", "tpu", "soak"])
def test_generated_specs_equal_the_reference(profile):
    for seed in range(30):
        assert generator.generate_spec(seed, profile) == \
            jgenerator.generate_spec(seed, profile), seed
        got = generator.generate_spec(seed, profile)
        assert corpus.validate_workload(got["workload"]) == []
        assert (got["workload"] is None) == (profile not in (
            "workload", "workload-train"))


def test_scenario_seeds_and_profiles_equal_the_reference():
    for base in (0, 1, 7, 123456, 2 ** 31):
        for i in range(5):
            assert generator.scenario_seed(base, i) == \
                jgenerator.scenario_seed(base, i)
    assert generator.PROFILES == jgenerator.PROFILES
    assert generator.generate_spec(4) == jgenerator.generate_spec(4)
    assert generator.generate_spec(4)["profile"] == "default"
    with pytest.raises(ValueError, match="unknown chaos profile"):
        generator.generate_spec(0, "exhaustive")


def test_workload_vocabulary_equals_the_reference():
    assert corpus.WORKLOAD_FAULT_KINDS == jcorpus.WORKLOAD_FAULT_KINDS
    assert corpus.WORKLOAD_DEFAULTS == jcorpus.WORKLOAD_DEFAULTS
    assert set(wl._ARMS) == set(corpus.WORKLOAD_FAULT_KINDS)
    from triton_kubernetes_tpu.chaos.runner import \
        INVARIANTS as JINVARIANTS
    from triton_kubernetes_tpu.chaos.runner import MUTATIONS as JMUTATIONS
    assert INVARIANTS == JINVARIANTS
    assert MUTATIONS == JMUTATIONS


# ---------------------------------------------------------------- schema
def _malformed():
    (good,) = [copy.deepcopy(e) for _, e in _WORKLOAD_ENTRIES
               if e["name"] == "workload-prefill-gap"]
    cases = [None, [], "entry", {}, dict(good, version=2),
             dict(good, kind="other"), dict(good, name="Bad Name"),
             dict(good, expect="maybe"), dict(good, extra=1),
             dict(good, expect="violated"), dict(good, spec=[])]
    for key in ("seed", "parallelism", "topology", "faults"):
        bad = copy.deepcopy(good)
        del bad["spec"][key]
        cases.append(bad)
    for spec_edit in ({"topology": {}}, {"faults": {}}, {"rogue": 1},
                      {"workload": "engine-preempt"},
                      {"workload": {"kind": "meteor-strike"}},
                      {"workload": {"kind": "engine-preempt",
                                    "die_after_tokens": 2}}):
        bad = copy.deepcopy(good)
        bad["spec"].update(spec_edit)
        cases.append(bad)
    return cases


def test_schema_agrees_with_the_reference():
    for _, entry in _ENTRIES:
        assert corpus.validate_entry(entry) == [] == \
            jcorpus.validate_entry(entry)
    for bad in _malformed():
        got = corpus.validate_entry(bad)
        assert got and got == jcorpus.validate_entry(bad), bad
    for kind in corpus.WORKLOAD_FAULT_KINDS:
        for w in ({"kind": kind},
                  dict(corpus.WORKLOAD_DEFAULTS[kind], kind=kind),
                  dict(corpus.WORKLOAD_DEFAULTS[kind], kind=kind, rogue=1)):
            assert corpus.validate_workload(w) == \
                jcorpus.validate_workload(w)
    for w in (None, "replica-death", {"kind": "meteor-strike"}, []):
        assert corpus.validate_workload(w) == jcorpus.validate_workload(w)


def test_corpus_save_load_round_trip_and_failures(tmp_path):
    _, entry = _WORKLOAD_ENTRIES[0]
    out = corpus.save_entry(entry, str(tmp_path))
    assert corpus.load_entries(str(tmp_path)) == [(out, entry)]
    with pytest.raises(corpus.CorpusError, match="refusing"):
        corpus.save_entry({"version": 99}, str(tmp_path))
    (tmp_path / "broken.json").write_text("{not json")
    with pytest.raises(corpus.CorpusError, match="not valid JSON"):
        corpus.load_entries(str(tmp_path))
    res = ScenarioResult(spec=dict(entry["spec"], mutation="leaked-pages"))
    res.violations.append({"invariant": "pool-convergence",
                           "detail": "3 pages"})
    jres = JResult(spec=res.spec, violations=list(res.violations))
    assert corpus.entry_for_failure(res.spec, res) == \
        jcorpus.entry_for_failure(jres.spec, jres)


# ------------------------------------------------------------- shrinking
def _fake_run(result_cls):
    def run(s):
        res = result_cls(spec=s)
        res.checked.append("trace-valid")
        w = s.get("workload") or {}
        if w.get("kind") == "engine-preempt" and w.get("abort_after_steps"):
            res.violations.append({"invariant": "trace-valid",
                                   "detail": "synthetic"})
        return res
    return run


def test_shrink_reaches_the_reference_minimal_workload():
    spec = generator.generate_spec(3, "workload")
    spec["workload"] = {"kind": "engine-preempt", "prefix_cache": True,
                        "long_windows": 5, "requests": 3,
                        "spec_k": 3, "abort_after_steps": 6}
    minimal, result = shrink.shrink_spec(copy.deepcopy(spec),
                                         run=_fake_run(ScenarioResult))
    jminimal, jresult = jshrink.shrink_spec(copy.deepcopy(spec),
                                            run=_fake_run(JResult))
    assert result.violated("trace-valid") and jresult.violated("trace-valid")
    assert minimal == jminimal
    assert shrink.workload_fault_fields(minimal) == \
        jshrink.workload_fault_fields(jminimal) <= 2
    # The infra half shrinks as the reference's does: to the manager.
    assert minimal["topology"] == {"manager": spec["topology"]["manager"],
                                   "clusters": []}
    assert shrink.spec_size(minimal) == jshrink.spec_size(jminimal) == \
        (1, 0)


def test_workload_fault_fields_and_candidates_agree():
    base = generator.generate_spec(0, "workload")
    for w in (None, {"kind": "engine-preempt"},
              {"kind": "engine-preempt", "prefix_cache": False,
               "long_windows": 5, "requests": 3},
              {"kind": "replica-death", "replicas": 3,
               "die_after_tokens": 4}):
        spec = dict(base, workload=w)
        assert shrink.workload_fault_fields(spec) == \
            jshrink.workload_fault_fields(spec)
    spec = dict(base, workload={"kind": "replica-death", "replicas": 3,
                                "die_after_tokens": 4})
    assert list(shrink._candidates(spec)) == list(jshrink._candidates(spec))
    mine = [c["workload"] for c in shrink._candidates(spec)
            if c["topology"] == spec["topology"]
            and c["faults"] == spec["faults"]
            and c["workload"] != spec["workload"]]
    assert None in mine and {"kind": "replica-death", "replicas": 3,
                             "die_after_tokens": 2} in mine


# --------------------------------------------------------- corpus replay
#: The reference's slow replay kinds, less the two replays the port keeps
#: in tier-1 (workload-replica-death, workload-rank-death).
_SLOW_REPLAYS = ("workload-coordinator-loss", "mutation-dropped-reland")


def _replay_params():
    return [pytest.param(entry, id=entry["name"],
                         marks=([pytest.mark.slow]
                                if entry["name"] in _SLOW_REPLAYS else []))
            for _, entry in _WORKLOAD_ENTRIES]


def test_the_workload_corpus_is_the_reference_one():
    names = sorted(e["name"] for _, e in _WORKLOAD_ENTRIES)
    assert len(names) == 13, names
    kinds = {e["spec"]["workload"]["kind"] for _, e in _WORKLOAD_ENTRIES}
    assert kinds == set(corpus.WORKLOAD_FAULT_KINDS)
    assert {e["spec"].get("mutation") for _, e in _WORKLOAD_ENTRIES} \
        - {None} == set(MUTATIONS) - {"accepted-torn", "unfaulted-reference"}


@pytest.mark.parametrize("entry", _replay_params())
def test_corpus_entry_replays_through_the_port(entry):
    result = corpus.replay(entry, device="cpu")
    kind = entry["spec"]["workload"]["kind"]
    assert result.stats["workload_kind"] == kind
    assert "workload_skipped" not in result.stats
    if entry["expect"] == "pass":
        assert result.passed, result.violations
    else:
        assert [v["invariant"] for v in result.violations] == \
            [entry["invariant"]], result.to_dict()
        assert shrink.workload_fault_fields(entry["spec"]) <= 2


# -------------------------------------------------- the harness's edges
def test_unknown_mutation_raises():
    spec = dict(generator.generate_spec(1, "workload"), mutation="meteor")
    with pytest.raises(ChaosHarnessError, match="unknown mutation"):
        run_scenario(spec, device="cpu")


def test_workload_skip_is_an_outcome_not_silence(monkeypatch):
    def skipping_arm(cfg, spec, res, check, recorder, device):
        raise wl.WorkloadArmSkipped("no multihost backend")

    monkeypatch.setitem(wl._ARMS, "engine-preempt", skipping_arm)
    spec = generator.generate_spec(16, "workload")
    spec["workload"] = {"kind": "engine-preempt"}
    res = run_scenario(spec, device="cpu")
    assert res.passed
    assert res.stats["workload_skipped"] == "no multihost backend"
    fam = metrics.get_registry().render_prometheus()
    assert 'tk8s_chaos_workload_arms_total{kind="engine-preempt",' \
           'status="skipped"} 1' in fam


def test_accepted_torn_is_caught_on_migration_integrity():
    (entry,) = [e for _, e in _ENTRIES
                if e["name"] == "workload-kv-migration-torn"]
    spec = copy.deepcopy(entry["spec"])
    spec["mutation"] = "accepted-torn"
    res = run_scenario(spec, device="cpu")
    assert [v["invariant"] for v in res.violations] == \
        ["migration-integrity"], res.to_dict()
    assert "engine-parity" in res.checked


def test_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    (entry,) = [e for _, e in _ENTRIES if e["name"] == "workload-prefill-gap"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        corpus.replay(entry)


# ---------------------------------------------------------- command line
def test_tools_chaos_sweep_prints_the_summary(capsys):
    from triton_kubernetes_tpu_torch.tools import chaos as chaos_tool

    rc = chaos_tool.main(["--profile", "workload", "--runs", "3",
                          "--seed", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.startswith("chaos sweep: 3/3 scenarios passed "
                          "(profile=workload, seed=0, simulated "), out


def test_tools_chaos_refuses_shrink_without_a_corpus_dir(capsys):
    from triton_kubernetes_tpu_torch.tools import chaos as chaos_tool

    assert chaos_tool.main(["--shrink", "--device", "cpu"]) == 2
    assert "--corpus-dir" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        chaos_tool.main(["--profile", "exhaustive"])


def test_train_arms_skip_typed_where_ranks_would_share_a_card(monkeypatch):
    """Two NCCL ranks cannot share one card: the launcher's capability
    check says so with the typed reason, and the train arms report it as
    their skip -- no launch, no check, no silent pass."""
    import torch
    import torch.distributed as dist

    from triton_kubernetes_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert multihost.support_report("cuda")["ok"]
    rep = multihost.support_report("cuda", n_processes=2)
    assert rep["reason"] == multihost.REASON_RANKS_SHARE_CARD == \
        "ranks-share-a-card"
    with pytest.raises(multihost.MultiHostUnavailable) as err:
        multihost.launch_trainers(["--device", "cuda"], n_processes=2,
                                  run_dir="unused")
    assert err.value.reason == "ranks-share-a-card"

    def no_launch(*a, **k):
        raise AssertionError("the arm launched a fleet it cannot host")

    monkeypatch.setattr(multihost, "launch_trainers", no_launch)
    for name in ("workload-rank-death", "workload-coordinator-loss"):
        (entry,) = [e for _, e in _ENTRIES if e["name"] == name]
        res = run_scenario(entry["spec"], device="cuda")
        assert res.passed and not set(res.checked) & set(_WORKLOAD_IDS)
        assert res.stats["workload_skipped"] == "ranks-share-a-card"
