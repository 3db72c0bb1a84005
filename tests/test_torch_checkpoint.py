"""The port's verified checkpoints (``train/checkpoint.py``) against the
reference's behaviour and files, on the CPU.

Mirrors the checkpoint cases of ``tests/test_resilience.py`` (manifest
commit, async close, quarantine and fallback on truncation and bit flips,
missing and torn manifests, all-corrupt, cross-directory resume, no
adoption of an earlier run's step) and ``tests/test_elastic.py:53-140``
(manifest format 2's mesh section, format-1 compatibility, peeking across
directories, shape negotiation), on the same fake states. Against the
JAX package: its ``peek_newest_manifest`` and ``_manifest_digest`` read a
port-written directory and return the same step, digest and ``mesh``
section as the port's; the one-card ``mesh`` section equals the
reference's ``mesh_spec_of`` for a one-device mesh; and
``negotiate_mesh_config`` gives the reference's axis sizes and refusals.
The port's own: a ``TrainState`` at ``llama-test`` round-trips bitwise
(f32 masters, both moments, the counts; a bf16 leaf as its bytes), an
asynchronous save holds the state as it was when ``save`` returned even
when the live tensors change after, two managers sharing one staging
save in turn, and a mismatched target raises ``MeshMismatchError``
before anything is quarantined. Every comparison is exact: no tolerance.
"""

import json
import os

import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.train import checkpoint as jckpt
from triton_kubernetes_tpu.train import resilience as jres
from triton_kubernetes_tpu_torch.models import get_config
from triton_kubernetes_tpu_torch.train import checkpoint as ckpt_mod
from triton_kubernetes_tpu_torch.train.checkpoint import (
    MANIFEST_FORMAT,
    MANIFEST_FORMATS,
    MANIFEST_NAME,
    QUARANTINE_DIR,
    CheckpointIntegrityError,
    CheckpointManager,
    HostStaging,
    MeshMismatchError,
    ReshapeError,
    _manifest_digest,
    mesh_spec_of,
    peek_newest_manifest,
    restore_newest_verified,
)
from triton_kubernetes_tpu_torch.train.resilience import negotiate_mesh_config
from triton_kubernetes_tpu_torch.train.trainer import (
    init_state, make_optimizer, make_train_step)
from triton_kubernetes_tpu_torch.train.data import synthetic_batches
from triton_kubernetes_tpu_torch.utils import metrics as metrics_mod


@pytest.fixture()
def fresh_registry():
    old = metrics_mod.get_registry()
    reg = metrics_mod.configure()
    yield reg
    metrics_mod.configure(old)


def _fake_state(step=0, w=0.0):
    return {"step": np.asarray(step, np.int32),
            "w": np.asarray(w, np.float32)}


SPEC_8 = {"axes": {"data": 2, "stage": 1, "fsdp": 4, "seq": 1,
                   "expert": 1, "tensor": 1},
          "n_processes": 2, "n_devices": 8, "global_batch": 16}


def _state(step=1, n=16):
    return {"step": np.asarray(step, np.int32),
            "w": np.arange(n, dtype=np.float32)}


def _data_files(step_dir):
    return sorted(os.path.join(step_dir, f) for f in os.listdir(step_dir)
                  if f != MANIFEST_NAME)


def _corrupt(step_dir, mode):
    target = max(_data_files(step_dir), key=os.path.getsize)
    if mode == "truncate":
        with open(target, "r+b") as f:
            f.truncate(max(os.path.getsize(target) // 2, 1))
    elif mode == "bitflip":
        with open(target, "r+b") as f:
            f.seek(os.path.getsize(target) // 2)
            byte = f.read(1)
            f.seek(os.path.getsize(target) // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
    else:
        raise AssertionError(mode)
    return target


# ------------------------------------------------- manifest commit marker

def test_constants_are_the_reference_constants():
    assert (MANIFEST_NAME, QUARANTINE_DIR, MANIFEST_FORMAT,
            MANIFEST_FORMATS) == (jckpt.MANIFEST_NAME, jckpt.QUARANTINE_DIR,
                                  jckpt.MANIFEST_FORMAT,
                                  jckpt.MANIFEST_FORMATS)
    assert issubclass(MeshMismatchError, ReshapeError)


def test_metric_families_are_the_references():
    from triton_kubernetes_tpu.utils import metrics as jmetrics

    for name in ("checkpoint_save_duration_seconds", "checkpoint_bytes_total",
                 "checkpoint_verify_failures_total",
                 "checkpoint_emergency_saves_total",
                 "checkpoint_fallback_restores_total",
                 "anomaly_rollbacks_total", "anomaly_aborts_total",
                 "prefetch_wait_seconds"):
        kind, help_, labels, buckets = metrics_mod.CATALOG[
            "tk8s_train_" + name]
        jkind, jhelp, jlabels, jbuckets = jmetrics.CATALOG["tk8s_train_"
                                                           + name]
        # One process: the reference's process_id label is dropped.
        assert (kind, help_, buckets) == (jkind, jhelp, jbuckets)
        assert labels == tuple(l for l in jlabels if l != "process_id")


def test_save_writes_manifest_and_verifies(tmp_path, fresh_registry):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, _fake_state(1), wait=True)
    sdir = tmp_path / "ckpt" / "1"
    manifest = json.loads((sdir / MANIFEST_NAME).read_text())
    assert manifest["step"] == 1 and manifest["kind"] == "scheduled"
    assert manifest["files"] and manifest["digest"]
    assert any(leaf["path"].endswith("['w']") for leaf in manifest["tree"])
    mgr.verify_step(1)  # no raise
    assert mgr.latest_verified_step() == 1
    assert {rel: (m["bytes"], m["sha256"]) for rel, m in
            manifest["files"].items()} == ckpt_mod._scan_files(str(sdir))
    assert metrics_mod.histogram(
        "tk8s_train_checkpoint_save_duration_seconds").count(
        kind="scheduled") == 1
    assert metrics_mod.counter(
        "tk8s_train_checkpoint_bytes_total").value(kind="scheduled") > 0
    mgr.close()


def test_async_save_finalized_by_idempotent_close(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, _fake_state(3), wait=False)
    assert mgr.all_steps() == []  # pending: no committed-looking step yet
    mgr.close()
    assert (tmp_path / "ckpt" / "3" / MANIFEST_NAME).exists()
    mgr.close()  # second close: no-op, no raise
    with pytest.raises(Exception, match="closed"):
        mgr.save(4, _fake_state(4))

    mgr2 = CheckpointManager(str(tmp_path / "ckpt2"))
    mgr2.save(1, _fake_state(1), wait=False)
    mgr2._atexit_guard()  # what atexit would run on process exit
    assert (tmp_path / "ckpt2" / "1" / MANIFEST_NAME).exists()


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_latest_quarantined_restore_falls_back(tmp_path, mode,
                                                       fresh_registry):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, _fake_state(1, w=10.0), wait=True)
    mgr.save(2, _fake_state(2, w=20.0), wait=True)
    _corrupt(str(tmp_path / "ckpt" / "2"), mode)

    restored = mgr.restore(_fake_state())
    assert mgr.last_restored_step == 1
    assert float(restored["w"]) == 10.0
    quarantined = os.listdir(tmp_path / "ckpt" / "quarantine")
    assert len(quarantined) == 1 and quarantined[0].startswith("2-")
    assert quarantined[0] == ("2-truncated" if mode == "truncate"
                              else "2-checksum-mismatch")
    assert mgr.all_steps() == [1]
    reasons = {s["labels"]["reason"]: s["value"] for s in
               metrics_mod.counter(
                   "tk8s_train_checkpoint_verify_failures_total").samples()}
    assert sum(reasons.values()) >= 1
    assert metrics_mod.counter(
        "tk8s_train_checkpoint_fallback_restores_total").value() == 1
    mgr.close()


def test_missing_manifest_means_uncommitted(tmp_path, fresh_registry):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, _fake_state(1, w=1.0), wait=True)
    mgr.save(2, _fake_state(2, w=2.0), wait=True)
    os.remove(tmp_path / "ckpt" / "2" / MANIFEST_NAME)
    with pytest.raises(CheckpointIntegrityError) as e:
        mgr.verify_step(2)
    assert e.value.reason == "missing-manifest"
    restored = mgr.restore(_fake_state())
    assert mgr.last_restored_step == 1 and float(restored["w"]) == 1.0
    mgr.close()


@pytest.mark.parametrize("damage,reason", [
    ("remove-file", "missing-file"), ("edit-manifest", "digest-mismatch"),
    ("tear-manifest", "torn-manifest"), ("no-step", "missing-step")])
def test_every_verify_reason_is_the_references(tmp_path, fresh_registry,
                                               damage, reason):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, _state(1), wait=True)
    sdir = tmp_path / "ckpt" / "1"
    mpath = sdir / MANIFEST_NAME
    if damage == "remove-file":
        os.remove(_data_files(str(sdir))[0])
    elif damage == "edit-manifest":
        man = json.loads(mpath.read_text())
        man["kind"] = "emergency"
        mpath.write_text(json.dumps(man))
    elif damage == "tear-manifest":
        mpath.write_text(mpath.read_text()[:20])
    with pytest.raises(CheckpointIntegrityError) as e:
        mgr.verify_step(2 if damage == "no-step" else 1)
    assert e.value.reason == reason
    assert metrics_mod.counter(
        "tk8s_train_checkpoint_verify_failures_total").value(
        reason=reason) == 1
    mgr.close()


def test_all_steps_corrupt_is_typed_error(tmp_path, fresh_registry):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, _fake_state(1), wait=True)
    _corrupt(str(tmp_path / "ckpt" / "1"), "bitflip")
    with pytest.raises(CheckpointIntegrityError, match="no checkpoint"):
        mgr.restore(_fake_state())
    mgr.close()


def test_corrupt_emergency_falls_back_to_scheduled_dir(tmp_path,
                                                       fresh_registry):
    sched = CheckpointManager(str(tmp_path / "ckpt"))
    em = CheckpointManager(str(tmp_path / "emergency"))
    sched.save(4, _fake_state(4, w=4.0), wait=True)
    em.save(6, _fake_state(6, w=6.0), wait=True, kind="emergency")
    _corrupt(str(tmp_path / "emergency" / "6"), "bitflip")

    restored, best, step = restore_newest_verified(_fake_state(), sched, em)
    assert best is sched and step == 4
    assert float(restored["w"]) == 4.0
    assert os.listdir(tmp_path / "emergency" / "quarantine")

    _corrupt(str(tmp_path / "ckpt" / "4"), "truncate")
    with pytest.raises(CheckpointIntegrityError, match="any directory"):
        restore_newest_verified(_fake_state(), sched, em)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        restore_newest_verified(_fake_state(), sched, em)
    sched.close()
    em.close()


def test_torn_manifest_detected(tmp_path, fresh_registry):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, _fake_state(1), wait=True)
    mpath = tmp_path / "ckpt" / "1" / MANIFEST_NAME
    mpath.write_text(mpath.read_text()[:20])  # torn mid-write
    with pytest.raises(CheckpointIntegrityError) as e:
        mgr.verify_step(1)
    assert e.value.reason == "torn-manifest"
    mgr.close()


def test_restore_mismatch_is_typed_and_quarantines_nothing(tmp_path):
    """A target whose leaves differ from the saved ones (shape, dtype or
    the tree itself) raises MeshMismatchError naming the leaf, before
    any verify or quarantine; the checkpoint stays intact."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"w": torch.arange(64, dtype=torch.float32)}, wait=True)
    for bad in ({"w": torch.zeros(32)},
                {"w": torch.zeros(64, dtype=torch.bfloat16)},
                {"v": torch.zeros(64)}):
        with pytest.raises(MeshMismatchError, match="cannot restore"):
            mgr.restore(bad)
        with pytest.raises(MeshMismatchError):
            restore_newest_verified(bad, mgr)
    assert mgr.latest_verified_step() == 1
    assert not (tmp_path / "ckpt" / QUARANTINE_DIR).exists()
    mgr.close()


def test_resave_never_adopts_a_previous_runs_step(tmp_path, fresh_registry):
    old = CheckpointManager(str(tmp_path / "ckpt"))
    old.save(2, _fake_state(2, w=111.0), wait=True)
    old.close()

    fresh = CheckpointManager(str(tmp_path / "ckpt"))
    fresh.save(2, _fake_state(2, w=222.0), wait=True)
    restored = fresh.restore(_fake_state())
    assert float(restored["w"]) == 222.0
    assert any(d.startswith("2-superseded")
               for d in os.listdir(tmp_path / "ckpt" / "quarantine"))
    fresh.save(2, _fake_state(2, w=333.0), wait=True, kind="emergency")
    assert float(fresh.restore(_fake_state())["w"]) == 222.0
    fresh.close()


def test_cross_dir_resume_prefers_newest_verified_anywhere(tmp_path,
                                                           fresh_registry):
    sched = CheckpointManager(str(tmp_path / "ckpt"))
    em = CheckpointManager(str(tmp_path / "emergency"))
    em.save(5, _fake_state(5, w=5.0), wait=True, kind="emergency")
    sched.save(10, _fake_state(10, w=10.0), wait=True)
    em.save(12, _fake_state(12, w=12.0), wait=True, kind="emergency")
    _corrupt(str(tmp_path / "emergency" / "12"), "bitflip")

    restored, best, step = restore_newest_verified(_fake_state(), sched, em)
    assert (best, step) == (sched, 10)
    assert float(restored["w"]) == 10.0
    assert em.all_steps() == [5]  # 12 quarantined, 5 untouched
    sched.close()
    em.close()


def test_max_to_keep_deletes_the_oldest_committed_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=1)
    for s in (2, 4, 6):
        mgr.save(s, _fake_state(s, w=float(s)))
    mgr.close()
    assert mgr.all_steps() == [6]
    assert mgr.latest_step() == 6


# ---------------------------------------- the port's tree, on the train state

def _train_state(seed=0):
    cfg = get_config("llama-test")
    opt = make_optimizer(learning_rate=1e-2, warmup_steps=1, decay_steps=10)
    state = init_state(cfg, opt, seed=seed, device="cpu")
    step = make_train_step(cfg, opt)
    batch = next(synthetic_batches(cfg.vocab_size, 2, 16))
    state, _ = step(state, batch)
    return cfg, opt, state, step, batch


def _flat(state):
    return ([state.step, state.opt_state.count]
            + [p.detach().clone() for p in state.model.parameters()]
            + [m.clone() for m in state.opt_state.mu]
            + [v.clone() for v in state.opt_state.nu])


def _equal(a, b):
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b)) and len(a) == len(b)


def test_train_state_round_trips_bitwise_and_names_its_leaves(tmp_path):
    _, _, state, step, batch = _train_state()
    saved = _flat(state)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(int(state.step), state, wait=True)
    man = mgr.manifest(1)
    paths = [leaf["path"] for leaf in man["tree"]]
    names = [n for n, _ in state.model.named_parameters()]
    assert paths == ([".step"] + [f".model.{n}" for n in names]
                     + [".opt_state.count"]
                     + [f".opt_state.mu.{n}" for n in names]
                     + [f".opt_state.nu.{n}" for n in names])
    assert {leaf["dtype"] for leaf in man["tree"][1:]} == {"float32", "int"}
    assert man["files"][man["tree"][0]["file"]]["bytes"] == 8
    # Train on, then restore in place: the state is the saved one again.
    for _ in range(2):
        state, _ = step(state, batch)
    assert not _equal(_flat(state), saved)
    params_before = list(state.model.parameters())
    restored = mgr.restore(state)
    assert restored is state and state.step == 1
    assert all(p is q for p, q in zip(params_before,
                                      state.model.parameters()))
    assert _equal(_flat(state), saved)
    mgr.close()


def test_async_save_holds_the_state_of_its_call(tmp_path):
    """The trap of a literal port: the step updates tensors in place, so
    an async save must have copied them before it returned."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    b = torch.arange(8, dtype=torch.float32).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"w": w, "b": b}, wait=False)
    w.mul_(-1.0)
    b.add_(1.0)
    target = {"w": torch.zeros_like(w), "b": torch.zeros_like(b)}
    mgr.restore(target)
    assert torch.equal(target["w"], torch.arange(1 << 16,
                                                 dtype=torch.float32))
    assert torch.equal(target["b"], torch.arange(8, dtype=torch.float32)
                       .to(torch.bfloat16))
    man = mgr.manifest(1)
    assert [leaf["dtype"] for leaf in man["tree"]] == ["bfloat16", "float32"]
    assert man["files"][man["tree"][0]["file"]]["bytes"] == 16
    mgr.close()


def test_restore_into_another_config_is_a_mesh_mismatch(tmp_path):
    _, _, state, _, _ = _train_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, wait=True)
    cfg3 = get_config("llama-test", num_layers=3)
    other = init_state(cfg3, make_optimizer(), device="cpu")
    with pytest.raises(MeshMismatchError, match="leaves differ"):
        mgr.restore(other)
    cfg_wide = get_config("llama-test", mlp_dim=2 * cfg3.mlp_dim,
                          num_layers=2)
    wide = init_state(cfg_wide, make_optimizer(), device="cpu")
    with pytest.raises(MeshMismatchError, match="saved as float32"):
        mgr.restore(wide)
    assert mgr.latest_verified_step() == 1
    mgr.close()


def _vm_flags(addr):
    """The kernel's VmFlags of the mapping holding ``addr`` (Linux)."""
    lo = hi = None
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split()[0]
            if "-" in head and ":" not in head:
                lo, hi = (int(x, 16) for x in head.split("-"))
            elif line.startswith("VmFlags:") and lo <= addr < hi:
                return line.split()[1:]
    return None


@pytest.mark.skipif(not os.path.exists("/proc/self/smaps"),
                    reason="reads the mapping's flags from /proc")
def test_host_arena_has_its_own_pages_and_no_fork_copy():
    """Fault F11: the staging arena that the card copies into is an
    anonymous mapping of its own -- page-aligned, zeroed, exactly the
    bytes asked for -- marked so a forked child does not inherit it
    (``dc``), so a fork never turns its pages copy-on-write under a
    pending device-to-host copy."""
    import mmap

    arena = ckpt_mod.host_arena(3 * mmap.PAGESIZE + 5)
    assert arena.numel() == 3 * mmap.PAGESIZE + 5
    assert arena.dtype == torch.uint8 and not bool(arena.any())
    assert arena.data_ptr() % mmap.PAGESIZE == 0
    assert "dc" in _vm_flags(arena.data_ptr())
    arena[-1] = 7  # writable, to its last byte
    assert int(arena[-1]) == 7


def test_shared_staging_serializes_saves(tmp_path):
    """Two managers on one staging: the second save waits for the first
    one's writer (its wait is recorded), and each save keeps its times."""
    staging = HostStaging()
    a = CheckpointManager(str(tmp_path / "a"), staging=staging)
    b = CheckpointManager(str(tmp_path / "b"), staging=staging)
    w = torch.ones(1 << 20)
    a.save(1, {"w": w})
    b.save(1, {"w": w * 2}, kind="emergency")  # waits for a's writer
    a.save(2, {"w": w * 3}, wait=True)
    assert [s["step"] for s in a.save_stats] == [1, 2]
    for s in a.save_stats + b.save_stats:
        assert s["bytes"] == 4 << 20 and s["pin_s"] == 0.0  # no card
        assert min(s["write_s"], s["sha256_s"], s["stage_wait_s"]) >= 0
    assert float(b.restore({"w": torch.zeros(1 << 20)})["w"][0]) == 2.0
    assert not staging._busy
    a.close()
    b.close()


# ------------------------------------------- manifest format 2 (test_elastic)

def test_manifest_v2_records_and_reads_back_the_mesh(tmp_path):
    mgr = CheckpointManager(str(tmp_path), mesh_spec=dict(SPEC_8))
    mgr.save(3, _state(3), wait=True)
    mgr.close()
    man = mgr.manifest(3)
    assert man["format"] == MANIFEST_FORMAT == 2
    assert man["mesh"] == SPEC_8
    assert mgr.saved_mesh_spec(3) == SPEC_8
    mpath = os.path.join(str(tmp_path), "3", MANIFEST_NAME)
    man["mesh"]["n_devices"] = 4
    with open(mpath, "w") as f:
        json.dump(man, f)
    assert peek_newest_manifest(str(tmp_path)) is None


def test_manifest_v2_without_mesh_spec_writes_null_mesh(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(), wait=True)
    mgr.close()
    assert mgr.manifest(1)["mesh"] is None
    assert mgr.saved_mesh_spec(1) is None


def test_format1_manifest_still_verifies_restores_and_peeks(tmp_path):
    mgr = CheckpointManager(str(tmp_path), mesh_spec=dict(SPEC_8))
    mgr.save(2, _state(2), wait=True)
    mgr.close()
    mpath = os.path.join(str(tmp_path), "2", MANIFEST_NAME)
    with open(mpath) as f:
        man = json.load(f)
    man.pop("mesh")
    man["format"] = 1
    man.pop("digest")
    man["digest"] = _manifest_digest(man)
    with open(mpath, "w") as f:
        json.dump(man, f)
    mgr2 = CheckpointManager(str(tmp_path))
    mgr2.verify_step(2)
    assert mgr2.saved_mesh_spec(2) is None
    restored = mgr2.restore(_state(0))
    np.testing.assert_array_equal(restored["w"], _state(2)["w"])
    step, peeked = peek_newest_manifest(str(tmp_path))
    assert step == 2 and "mesh" not in peeked
    mgr2.close()


def test_peek_newest_manifest_skips_torn_and_spans_directories(tmp_path):
    sched, emerg = tmp_path / "sched", tmp_path / "emerg"
    m1 = CheckpointManager(str(sched), mesh_spec=dict(SPEC_8))
    m1.save(1, _state(1), wait=True)
    m1.save(4, _state(4), wait=True)
    m1.close()
    m2 = CheckpointManager(str(emerg), mesh_spec=dict(SPEC_8))
    m2.save(6, _state(6), wait=True)
    m2.close()
    step, _ = peek_newest_manifest(str(sched), str(emerg))
    assert step == 6
    mpath = os.path.join(str(emerg), "6", MANIFEST_NAME)
    body = open(mpath).read()
    with open(mpath, "w") as f:
        f.write(body[: len(body) // 2])
    step, man = peek_newest_manifest(str(sched), str(emerg), None)
    assert step == 4 and man["mesh"] == SPEC_8


def test_reference_reads_a_port_written_directory(tmp_path,
                                                  cpu_mesh_devices):
    """The JAX package's peek and digest over the port's files: the same
    step, digest and mesh section; the one-card mesh section is what the
    reference writes for a one-device mesh."""
    from triton_kubernetes_tpu.parallel import MeshConfig, create_mesh

    mesh1 = create_mesh(MeshConfig(), devices=cpu_mesh_devices[:1])
    spec = mesh_spec_of(None, n_processes=1, global_batch=4)
    assert spec == jckpt.mesh_spec_of(mesh1, 1, 4)
    _, _, state, _, _ = _train_state()
    sched, emerg = tmp_path / "sched", tmp_path / "emerg"
    m1 = CheckpointManager(str(sched), mesh_spec=spec)
    m1.save(1, state, wait=True)
    m2 = CheckpointManager(str(emerg), mesh_spec=spec)
    m2.save(3, _state(3), wait=True, kind="emergency")
    for dirs in ((str(sched),), (str(sched), str(emerg))):
        ours, theirs = peek_newest_manifest(*dirs), \
            jckpt.peek_newest_manifest(*dirs)
        assert theirs is not None and ours[0] == theirs[0]
        assert ours[1] == theirs[1]
        assert jckpt._manifest_digest(theirs[1]) == theirs[1]["digest"] \
            == _manifest_digest(ours[1])
        assert theirs[1]["mesh"] == spec
    m1.close()
    m2.close()


# ----------------------------------------------------- shape negotiation

@pytest.mark.parametrize("saved,n_processes,n_devices", [
    (SPEC_8, 1, 4), (SPEC_8, 2, 8), (SPEC_8, 1, 3), (SPEC_8, 1, 1),
    (mesh_spec_of(None, 1, 4), 1, 1),
    (mesh_spec_of({"data": 2}, 2, 8), 1, 1),
    (mesh_spec_of({"tensor": 2}, 1, 8), 1, 1),
    ({"n_devices": 8}, 1, 4), (None, 1, 1)])
def test_negotiation_matches_the_reference(saved, n_processes, n_devices):
    def attempt(fn):
        try:
            got = fn(saved, n_processes=n_processes, n_devices=n_devices)
        except (ReshapeError, jckpt.ReshapeError) as e:
            return ("ReshapeError", str(e))
        return tuple(getattr(got, a) for a in ckpt_mod.MESH_AXES)

    assert attempt(negotiate_mesh_config) == \
        attempt(jres.negotiate_mesh_config)


def test_negotiate_keeps_ici_block_and_resizes_data():
    down = negotiate_mesh_config(SPEC_8, n_processes=1, n_devices=4)
    assert (down.data, down.fsdp, down.stage) == (1, 4, 1)
    up = negotiate_mesh_config(SPEC_8, n_processes=2, n_devices=8)
    assert (up.data, up.fsdp) == (2, 4)
    one = negotiate_mesh_config(mesh_spec_of({"data": 4}, 4, 4),
                                n_processes=1, n_devices=1)
    assert one.data == 1
    with pytest.raises(ReshapeError, match="cannot negotiate"):
        negotiate_mesh_config(SPEC_8, n_processes=1, n_devices=1)
