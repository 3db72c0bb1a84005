"""Verified checkpoints of the train state -- the port of
``triton_kubernetes_tpu/train/checkpoint.py`` with its public surface,
written with torch and the standard library instead of orbax.

**Format.** A step is a directory ``<dir>/<step>/`` holding one raw file
per leaf of the saved tree (its bytes in the leaf's dtype, little-endian:
a bf16 tensor's bytes as they sit in memory) and a sidecar
``manifest.json``: the reference's manifest format 2 -- ``format``,
``step``, ``kind``, ``tree`` (each leaf's path, shape and dtype, plus the
file holding it), ``mesh``, ``files`` (each file's bytes and sha256) and
``digest`` (sha256 of the rest). A torn or truncated leaf is a file-level
fault, so :meth:`CheckpointManager.verify_step` reports it with the
reference's reasons (``missing-manifest``, ``torn-manifest``,
``digest-mismatch``, ``missing-file``, ``truncated``,
``checksum-mismatch``), and the reference's ``peek_newest_manifest`` and
``_manifest_digest`` read a port-written directory unchanged.

**Commit.** Leaf files are written into ``<step>.tmp/``, renamed to
``<step>/`` once every file is written and fsync'd, and the manifest is
written last (tmp + rename + fsync): its presence is the commit bit. A
step without one is a save the process died inside; ``restore``
quarantines it (renames it into ``quarantine/``, never deletes it) and
falls back to the newest earlier step that verifies.

**The saved tree.** For the port's :class:`.trainer.TrainState`: ``.step``,
the f32 master parameters by their ``nn.Module`` names
(``.model.<name>``), and ``.opt_state.count``, ``.opt_state.mu.<name>``
and ``.opt_state.nu.<name>``. Any other tree of dicts, lists and tuples
over tensors, numpy arrays and Python scalars saves too (paths in the
reference's ``keystr`` form, ``['w']``), which is what the tests hold
against the reference; so does a :class:`HostTree`, a list of (path,
leaf) pairs taken as it is, which is how a state sharded over ranks is
written with the paths, shapes and order of the one-device state
(``parallel/multihost.CoordinatedCheckpoint``).

**Asynchronous saves, and why the copy is not.** JAX arrays are
immutable, so the reference's async save can hold the state while the
next step runs. The port's step updates parameters and moments *in place*
(``train/trainer.py``), so :meth:`CheckpointManager.save` copies every
leaf into host buffers before it returns -- on the card into **pinned**
buffers with ``non_blocking`` copies on the current stream, then one
synchronize of that stream, which also drains the steps queued before the
save (a SIGTERM can land while steps are in flight). Only then does a
writer thread write, fsync and hash the host copies (the sha256 of each
leaf runs in a small thread pool while the next leaf is written);
``_finalize`` commits the manifest. The pinned buffers belong to a
:class:`HostStaging` that managers may share (the trainer's scheduled and
emergency managers do), reused save after save and held by one save at a
time, so a process pins one checkpoint's bytes at most.

**Mesh.** The manifest's ``mesh`` section is the reference's for the run
that wrote it: every axis's size, ``n_processes``, ``n_devices`` and the
global batch (:func:`mesh_spec_of`), so ``peek_newest_manifest`` and
``--elastic`` read it as the reference would. Under several processes
one rank writes, through ``parallel/multihost.CoordinatedCheckpoint``.
Restore copies into the tensors of an existing tree with ``copy_`` and
raises :class:`MeshMismatchError` -- before verifying or quarantining
anything -- when a leaf's path, shape or dtype differs from the manifest.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import dataclasses
import hashlib
import json
import mmap
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import metrics as _metrics
from .trainer import TrainState

MANIFEST_NAME = "manifest.json"
QUARANTINE_DIR = "quarantine"
#: Current manifest schema; format 2 added the ``mesh`` section.
MANIFEST_FORMAT = 2
#: Formats this reader accepts (restore/verify are format-agnostic; the
#: only format-2 addition is *extra* data older readers ignore).
MANIFEST_FORMATS = (1, 2)
#: The reference's mesh axes, outermost first
#: (``triton_kubernetes_tpu/parallel/mesh.py`` ``MESH_AXES``).
MESH_AXES = ("data", "stage", "fsdp", "seq", "expert", "tensor")
_TMP_SUFFIX = ".tmp"
# Threads hashing leaves while the writer writes the next one.
_HASH_WORKERS = 4
# Bytes a hash read or a restore's pinned chunk takes at a time.
_CHUNK = 1 << 26


class CheckpointError(RuntimeError):
    """Base type for checkpoint-subsystem failures."""


class CheckpointIntegrityError(CheckpointError):
    """A step failed manifest verification (uncommitted save, torn
    manifest, truncated or bit-flipped file). ``reason`` is the bounded
    machine-readable label fed to
    ``tk8s_train_checkpoint_verify_failures_total``."""

    def __init__(self, message: str, reason: str = "corrupt"):
        super().__init__(message)
        self.reason = reason


class ReshapeError(CheckpointError):
    """Elastic shape negotiation failed: the surviving fleet cannot hold
    the recorded mesh, or the manifest carries no shape at all when one
    is required. The message names the recorded shape and the fleet."""


class MeshMismatchError(ReshapeError):
    """The restore target cannot hold the saved arrays: a leaf's path,
    shape or dtype differs from the manifest's. Raised before anything is
    verified, read or quarantined, with the leaf named."""


# ---------------------------------------------------------------- the tree

def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, (np.ndarray, np.generic)):
        return str(leaf.dtype)
    return type(leaf).__name__  # a Python scalar: "int", "float", "bool"


_SCALAR_NP = {"int": np.int64, "float": np.float64, "bool": np.bool_}


@dataclasses.dataclass
class HostTree:
    """A saved tree given as its (path, leaf) pairs, in order."""

    leaves: List[Tuple[str, Any]]


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in a fixed order: the TrainState's named layout,
    else dict keys sorted and sequences in order (jax's flatten order)."""
    if isinstance(tree, HostTree):
        return list(tree.leaves)
    if isinstance(tree, TrainState):
        named = list(tree.model.named_parameters())
        opt = tree.opt_state
        return ([(".step", tree.step)]
                + [(f".model.{n}", p) for n, p in named]
                + [(".opt_state.count", opt.count)]
                + [(f".opt_state.mu.{n}", m)
                   for (n, _), m in zip(named, opt.mu)]
                + [(f".opt_state.nu.{n}", v)
                   for (n, _), v in zip(named, opt.nu)])
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _rebuild(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    """``tree`` with its leaves replaced by ``values`` (path -> value).
    Tensors were already filled in place; scalars and numpy leaves are
    new objects."""
    if isinstance(tree, HostTree):
        return HostTree([(path, values[path]) for path, _ in tree.leaves])
    if isinstance(tree, TrainState):
        tree.step = values[".step"]
        tree.opt_state.count = values[".opt_state.count"]
        return tree
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return values[prefix]


def _leaf_meta(tree: Any) -> List[Dict[str, Any]]:
    """Per-leaf (path, shape, dtype, file) -- the manifest's ``tree``."""
    return [{"path": path,
             "shape": [int(d) for d in getattr(leaf, "shape", ())],
             "dtype": _dtype_name(leaf),
             "file": f"leaf{i:05d}.bin"}
            for i, (path, leaf) in enumerate(_leaves(tree))]


def _scan_files(step_dir: str) -> Dict[str, Tuple[int, str]]:
    """{relpath: (bytes, sha256)} over every file of a step directory,
    the manifest itself excluded."""
    out: Dict[str, Tuple[int, str]] = {}
    for root, _, files in os.walk(step_dir):
        for name in files:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, step_dir)
            if rel in (MANIFEST_NAME, MANIFEST_NAME + ".tmp"):
                continue
            out[rel] = (os.path.getsize(full), _sha256_file(full))
    return out


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_digest(manifest: Dict[str, Any]) -> str:
    """Whole-checkpoint digest over the manifest body (everything but the
    digest field itself) -- the last thing written, i.e. the commit bit."""
    body = {k: v for k, v in manifest.items() if k != "digest"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()


def mesh_spec_of(mesh: Any = None, n_processes: int = 1,
                 global_batch: int = 0) -> Dict[str, Any]:
    """The manifest-v2 ``mesh`` section: every axis of the reference's
    mesh (sizes from ``mesh`` -- a ``parallel.mesh.Mesh``, or a mapping of
    axis name to size -- 1 for the rest), the fleet size, and the global
    batch the data stream was cut for."""
    sizes = getattr(mesh, "shape", mesh) or {}
    axes = {name: int(sizes.get(name, 1)) for name in MESH_AXES}
    n_devices = 1
    for size in axes.values():
        n_devices *= size
    return {"axes": axes, "n_processes": int(n_processes),
            "n_devices": n_devices, "global_batch": int(global_batch)}


def peek_newest_manifest(*directories: Optional[str],
                         ) -> Optional[Tuple[int, Dict[str, Any]]]:
    """``(step, manifest)`` of the newest digest-intact manifest across
    checkpoint directories -- pure file I/O. What elastic startup reads
    before it settles its shape; a torn or digest-broken manifest is
    skipped (restore proper will quarantine it)."""
    candidates: List[Tuple[int, str]] = []
    for directory in directories:
        if not directory or not os.path.isdir(directory):
            continue
        for name in os.listdir(directory):
            if name.isdigit():
                candidates.append((int(name),
                                   os.path.join(directory, name)))
    for step, sdir in sorted(candidates, reverse=True):
        mpath = os.path.join(sdir, MANIFEST_NAME)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            continue
        if manifest.get("digest") != _manifest_digest(manifest):
            continue
        return step, manifest
    return None


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ------------------------------------------------------------ host staging

def host_arena(nbytes: int) -> torch.Tensor:
    """``nbytes`` of zeroed host memory to page-lock: an anonymous mapping
    of its own (page-aligned, no other object on its pages) that a forked
    child does not inherit (``MADV_DONTFORK``). A page the card copies
    into must keep its physical frame: a fork marks the parent's pages
    copy-on-write, and a CPU write to such a page while the child lives
    (an object beside a small arena on the heap, say) moves the parent to
    a new frame the card never writes, so the bytes a save writes are
    stale (fault F11: trainer processes started beside a saving process).
    The tensor keeps the mapping alive."""
    region = mmap.mmap(-1, max(nbytes, 1))
    if hasattr(mmap, "MADV_DONTFORK"):
        region.madvise(mmap.MADV_DONTFORK)
    return torch.frombuffer(region, dtype=torch.uint8, count=nbytes)


class HostStaging:
    """Host memory that checkpoint copies land in, held by one save at a
    time: a second :meth:`acquire` waits until the first save's writer
    has released it. Leaves on a card land in one **pinned arena**, so the
    device-to-host copies run asynchronously on the stream at full rate:
    an anonymous mapping of its own (:func:`host_arena`), its pages first
    touched by torch's threaded ``zero_`` and then page-locked with
    ``cudaHostRegister`` -- exactly
    the bytes asked for, where torch's pinned allocator rounds every
    block up to a power of two (a 23 GB checkpoint would pin 32 GB).
    Page-locking costs about half a second a GB, so the arena outlives a
    save and grows only when a save needs more; share one staging between
    managers and a process pins one checkpoint's bytes at most. Leaves on
    the CPU get plain buffers of their own."""

    _ALIGN = 4096

    def __init__(self):
        self._cond = threading.Condition()
        self._busy = False
        self._arena: Optional[torch.Tensor] = None
        self.pin_seconds = 0.0  # spent page-locking, all saves together

    def acquire(self) -> float:
        """Take the staging; returns the seconds waited for it."""
        t0 = time.perf_counter()
        with self._cond:
            while self._busy:
                self._cond.wait()
            self._busy = True
        return time.perf_counter() - t0

    def buffers(self, sizes: List[Tuple[int, bool]]) -> List[torch.Tensor]:
        """Flat uint8 host buffers, one for each ``(nbytes, pinned)``; the
        pinned ones are views into the arena (grown first if need be).
        Call between :meth:`acquire` and :meth:`release`."""
        align = self._ALIGN
        offsets, total = [], 0
        for nbytes, pinned in sizes:
            offsets.append(total if pinned else None)
            if pinned:
                total += -(-nbytes // align) * align
        if total and (self._arena is None or self._arena.numel() < total):
            self._drop_arena()
            t0 = time.perf_counter()
            arena = host_arena(total)
            arena.zero_()  # fault the pages in on every core first
            torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
                arena.data_ptr(), total, 0))
            self._arena = arena
            self.pin_seconds += time.perf_counter() - t0
        return [self._arena[off:off + nbytes] if off is not None
                else torch.empty(nbytes, dtype=torch.uint8)
                for (nbytes, _), off in zip(sizes, offsets)]

    def release(self) -> None:
        with self._cond:
            self._busy = False
            self._cond.notify_all()

    def _drop_arena(self) -> None:
        if self._arena is not None:
            torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(
                self._arena.data_ptr()))
            self._arena = None

    def clear(self) -> None:
        """Unpin and free the arena (its memory goes back to the host)."""
        with self._cond:
            while self._busy:
                self._cond.wait()
            self._drop_arena()


def _staged(leaves: List[Tuple[str, Any]], staging: HostStaging
            ) -> Tuple[List[memoryview], float]:
    """Host copies of every leaf's bytes, the copies complete on return;
    and the seconds the device-to-host copy took (0 off the card)."""
    srcs = [leaf.detach().reshape(-1).view(torch.uint8)
            if isinstance(leaf, torch.Tensor) else None
            for _, leaf in leaves]
    bufs = iter(staging.buffers([(src.numel(), src.device.type == "cuda")
                                 for src in srcs if src is not None]))
    t0 = time.perf_counter()
    out: List[memoryview] = []
    streams = set()
    for (_, leaf), src in zip(leaves, srcs):
        if src is not None:
            on_card = src.device.type == "cuda"
            buf = next(bufs)
            buf.copy_(src, non_blocking=on_card)
            if on_card:
                streams.add(torch.cuda.current_stream(src.device))
            out.append(memoryview(buf.numpy()))
        elif isinstance(leaf, (np.ndarray, np.generic)):
            out.append(memoryview(np.ascontiguousarray(leaf).tobytes()))
        else:
            out.append(memoryview(np.asarray(
                leaf, _SCALAR_NP[_dtype_name(leaf)]).tobytes()))
    # Drain: the copies are queued behind every step issued before the
    # save, so this waits for those too -- the state the bytes show is
    # the state at ``step``.
    for stream in streams:
        stream.synchronize()
    return out, (time.perf_counter() - t0) if streams else 0.0


@dataclasses.dataclass
class _Save:
    """One save between :meth:`CheckpointManager.save` and its commit."""

    kind: str
    tree: List[Dict[str, Any]]
    mesh: Optional[Dict[str, Any]]
    t0: float
    stats: Dict[str, Any]
    thread: Optional[threading.Thread] = None
    files: Dict[str, Tuple[int, str]] = dataclasses.field(
        default_factory=dict)
    error: Optional[BaseException] = None


class CheckpointManager:
    """Manifest commit/verify/quarantine/fallback over one directory.

    Save kinds (the ``kind`` metric label): ``scheduled`` (cadenced saves
    from the training loop), ``emergency`` (the synchronous save on a
    preemption warning), ``final`` (end of run). An asynchronous save is
    *pending* until its manifest commits -- ``close()`` (idempotent, also
    registered with ``atexit``) commits every pending save or quarantines
    it, so a crash between an async save and exit never leaves a
    half-written step looking like ``latest_step()``.

    ``max_to_keep`` committed steps stay in the directory (the reference's
    orbax default, 3); older ones are deleted after each commit.
    ``staging`` is the :class:`HostStaging` the copies land in (default:
    one of the manager's own). ``save_stats`` and ``restore_stats`` keep
    each save's and restore's seconds and bytes: the device-to-host copy,
    the write, the sha256, the commit; the verify, the read, the
    host-to-device copy.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 mesh_spec: Optional[Dict[str, Any]] = None,
                 staging: Optional[HostStaging] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # The manifest-v2 mesh section (mesh_spec_of); assignable after
        # construction too. None keeps a format-2 manifest with
        # "mesh": null, which the elastic path treats like format 1.
        self.mesh_spec = mesh_spec
        self.max_to_keep = max_to_keep
        self.staging = staging if staging is not None else HostStaging()
        self._own_staging = staging is None
        self._closed = False
        self._pending: Dict[int, _Save] = {}
        # Steps whose manifest THIS instance committed: only these may be
        # silently skipped on re-save -- a same-numbered step from an
        # earlier run is a different state and must never be adopted.
        self._committed: set = set()
        self.last_restored_step: Optional[int] = None
        self.save_stats: List[Dict[str, Any]] = []
        self.restore_stats: List[Dict[str, Any]] = []
        atexit.register(self._atexit_guard)

    # ------------------------------------------------------------------ save
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _known_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isdir(os.path.join(self.directory, name)))

    def save(self, step: int, state: Any, wait: bool = False,
             kind: str = "scheduled") -> None:
        """Schedule (or, with ``wait``/``kind="emergency"``, complete) a
        save. The state's bytes are on the host when this returns; the
        write, fsync and hash run on a writer thread. Emergency saves are
        always synchronous. Re-saving a step this instance already
        committed is a no-op (an emergency save landing on a scheduled
        boundary); a same-numbered step left by an *earlier run* is
        quarantined first, never adopted."""
        if self._closed:
            raise CheckpointError(
                f"CheckpointManager for {self.directory} is closed")
        if kind == "emergency":
            _metrics.counter(
                "tk8s_train_checkpoint_emergency_saves_total").inc()
            wait = True
        if step not in self._pending and step not in self._committed:
            if step in self._known_steps():
                self.quarantine(step, "superseded-by-resave")
            t0 = time.perf_counter()
            leaves = _leaves(state)
            tree = _leaf_meta(state)
            stage_wait = self.staging.acquire()
            pinned_before = self.staging.pin_seconds
            try:
                host, d2h_s = _staged(leaves, self.staging)
            except BaseException:
                self.staging.release()
                raise
            nbytes = sum(len(b) for b in host)
            save = _Save(kind=kind, tree=tree, mesh=self.mesh_spec, t0=t0,
                         stats=dict(step=step, kind=kind, bytes=nbytes,
                                    stage_wait_s=stage_wait,
                                    pin_s=(self.staging.pin_seconds
                                           - pinned_before),
                                    d2h_s=d2h_s,
                                    save_call_s=time.perf_counter() - t0))
            tmp = self._step_dir(step) + _TMP_SUFFIX
            shutil.rmtree(tmp, ignore_errors=True)  # a dead save's leftovers
            os.makedirs(tmp)
            save.thread = threading.Thread(
                target=self._write, args=(save, tmp, host),
                name=f"tk8s-ckpt-{step}", daemon=True)
            self._pending[step] = save
            save.thread.start()
        if wait:
            self._finalize()

    def _write(self, save: _Save, tmp: str, host: List[memoryview]) -> None:
        """Writer thread: every leaf to its file (fsync'd), hashed in a
        pool while the next leaf is written; then the staging is free."""
        write_s = 0.0
        hash_s = [0.0]
        lock = threading.Lock()

        def digest(buf: memoryview) -> str:
            t = time.perf_counter()
            h = hashlib.sha256(buf).hexdigest()
            with lock:
                hash_s[0] += time.perf_counter() - t
            return h

        t_start = time.perf_counter()
        try:
            with concurrent.futures.ThreadPoolExecutor(
                    _HASH_WORKERS, thread_name_prefix="tk8s-sha") as pool:
                hashes = []
                for meta, buf in zip(save.tree, host):
                    hashes.append(pool.submit(digest, buf))
                    t = time.perf_counter()
                    with open(os.path.join(tmp, meta["file"]), "wb") as f:
                        f.write(buf)
                        f.flush()
                        os.fsync(f.fileno())
                    write_s += time.perf_counter() - t
                save.files = {meta["file"]: (len(buf), h.result())
                              for meta, buf, h in zip(save.tree, host,
                                                      hashes)}
            _fsync_dir(tmp)
        except BaseException as e:  # raised by _finalize on the caller
            save.error = e
        finally:
            self.staging.release()
        save.stats.update(write_s=write_s, sha256_s=hash_s[0],
                          writer_s=time.perf_counter() - t_start)

    def _finalize(self) -> None:
        """Wait out pending saves and commit their manifests; a failed
        save quarantines whatever it left behind and raises."""
        if not self._pending:
            return
        pending, self._pending = self._pending, {}
        for save in pending.values():
            save.thread.join()
        failed = {s: p for s, p in pending.items() if p.error is not None}
        for step in sorted(failed):
            tmp = self._step_dir(step) + _TMP_SUFFIX
            if os.path.isdir(tmp):
                os.rename(tmp, self._step_dir(step))
                self.quarantine(step, "async-save-failed")
        for step, save in sorted(pending.items()):
            if step in failed:
                continue
            sdir = self._step_dir(step)
            os.rename(sdir + _TMP_SUFFIX, sdir)
            _fsync_dir(self.directory)
            manifest: Dict[str, Any] = {
                "format": MANIFEST_FORMAT,
                "step": step,
                "kind": save.kind,
                "tree": save.tree,
                "mesh": save.mesh,
                "files": {rel: {"bytes": size, "sha256": digest}
                          for rel, (size, digest) in sorted(
                              save.files.items())},
            }
            manifest["digest"] = _manifest_digest(manifest)
            tmp = os.path.join(sdir, MANIFEST_NAME + ".tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(sdir, MANIFEST_NAME))
            _fsync_dir(sdir)
            self._committed.add(step)
            seconds = time.perf_counter() - save.t0
            _metrics.histogram(
                "tk8s_train_checkpoint_save_duration_seconds").observe(
                seconds, kind=save.kind)
            _metrics.counter("tk8s_train_checkpoint_bytes_total").inc(
                save.stats["bytes"], kind=save.kind)
            self.save_stats.append(dict(save.stats, commit_s=seconds))
        self._collect()
        if failed:
            step, save = min(failed.items())
            raise CheckpointError(
                f"async save of step {step} in {self.directory} failed: "
                f"{save.error}") from save.error

    def _collect(self) -> None:
        """Delete committed steps past ``max_to_keep`` (oldest first)."""
        if self.max_to_keep is None or self.max_to_keep <= 0:
            return
        for step in self._known_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(step))
            self._committed.discard(step)

    # ---------------------------------------------------------------- verify
    def verify_step(self, step: int) -> None:
        """Raise :class:`CheckpointIntegrityError` unless ``step`` is a
        committed, byte-intact checkpoint. Every failure is counted. Files
        are hashed in the manifest's order, several at a time; the first
        bad one in that order is the one reported."""

        def fail(message: str, reason: str) -> None:
            _metrics.counter(
                "tk8s_train_checkpoint_verify_failures_total").inc(
                reason=reason)
            raise CheckpointIntegrityError(
                f"step {step} in {self.directory}: {message}", reason=reason)

        sdir = self._step_dir(step)
        if not os.path.isdir(sdir):
            fail("no step directory", "missing-step")
        mpath = os.path.join(sdir, MANIFEST_NAME)
        if not os.path.exists(mpath):
            fail("no manifest -- the save never committed",
                 "missing-manifest")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except ValueError as e:
            fail(f"torn manifest ({e})", "torn-manifest")
        if manifest.get("digest") != _manifest_digest(manifest):
            fail("manifest digest mismatch", "digest-mismatch")
        files = list(manifest.get("files", {}).items())
        with concurrent.futures.ThreadPoolExecutor(
                _HASH_WORKERS, thread_name_prefix="tk8s-verify") as pool:
            hashes = {}
            for rel, _ in files:
                full = os.path.join(sdir, rel)
                if os.path.isfile(full):
                    hashes[rel] = pool.submit(_sha256_file, full)
            try:
                for rel, meta in files:
                    full = os.path.join(sdir, rel)
                    if rel not in hashes:
                        fail(f"file {rel} missing", "missing-file")
                    size = os.path.getsize(full)
                    if size != int(meta["bytes"]):
                        fail(f"file {rel} is {size} bytes, manifest says "
                             f"{meta['bytes']} (truncated or torn)",
                             "truncated")
                    if hashes[rel].result() != meta["sha256"]:
                        fail(f"file {rel} content checksum mismatch (bit "
                             f"rot or partial overwrite)",
                             "checksum-mismatch")
            finally:
                for h in hashes.values():
                    h.cancel()

    def quarantine(self, step: int, reason: str = "corrupt") -> str:
        """Move a bad step aside (rename, never delete -- it is postmortem
        evidence)."""
        src = self._step_dir(step)
        qdir = os.path.join(self.directory, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        slug = "".join(c if c.isalnum() or c in "._-" else "-"
                       for c in reason)[:64] or "corrupt"
        dst = os.path.join(qdir, f"{step}-{slug}")
        n = 1
        while os.path.exists(dst):
            dst = os.path.join(qdir, f"{step}-{slug}.{n}")
            n += 1
        os.rename(src, dst)
        self._pending.pop(step, None)
        self._committed.discard(step)
        return dst

    # --------------------------------------------------------------- restore
    def reload(self) -> None:
        """Re-scan the directory for steps other writers committed. The
        port lists the directory on every query, so there is nothing to
        refresh; kept for the reference's interface."""

    def latest_step(self) -> Optional[int]:
        steps = self._known_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return self._known_steps()

    def latest_verified_step(self) -> Optional[int]:
        """Newest step that passes manifest verification (read-only: bad
        steps are reported by counter but not quarantined here)."""
        for step in sorted(self._known_steps(), reverse=True):
            try:
                self.verify_step(step)
                return step
            except CheckpointIntegrityError:
                continue
        return None

    def manifest(self, step: int) -> Optional[Dict[str, Any]]:
        """The committed manifest of ``step`` (None when the step or its
        manifest is missing/torn)."""
        mpath = os.path.join(self._step_dir(step), MANIFEST_NAME)
        try:
            with open(mpath) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def saved_mesh_spec(self, step: int) -> Optional[Dict[str, Any]]:
        """The ``mesh`` section ``step`` was saved under, or None for a
        format-1 manifest / missing step."""
        manifest = self.manifest(step)
        return manifest.get("mesh") if manifest else None

    @staticmethod
    def _check_fits(manifest: Dict[str, Any], state_like: Any) -> None:
        """Typed, actionable error when the target tree cannot hold the
        saved leaves."""
        want = [(m["path"], list(m["shape"]), m["dtype"])
                for m in manifest.get("tree", [])]
        have = [(m["path"], m["shape"], m["dtype"])
                for m in _leaf_meta(state_like)]
        if [w[0] for w in want] != [h[0] for h in have]:
            missing = sorted({w[0] for w in want} - {h[0] for h in have})
            extra = sorted({h[0] for h in have} - {w[0] for w in want})
            raise MeshMismatchError(
                f"cannot restore step {manifest.get('step')}: the target "
                f"tree's leaves differ from the saved ones (saved only: "
                f"{missing[:4]}, target only: {extra[:4]}); restore into "
                f"a state built from the same model config")
        for (path, shape, dtype), (_, tshape, tdtype) in zip(want, have):
            if (shape, dtype) != (tshape, tdtype):
                raise MeshMismatchError(
                    f"cannot restore step {manifest.get('step')}: leaf "
                    f"'{path}' was saved as {dtype}{shape}, the target "
                    f"holds {tdtype}{tshape}; build the target from the "
                    f"config and precision policy the checkpoint was "
                    f"written under")

    def _load(self, step: int, state_like: Any) -> Any:
        """Read ``step``'s leaves into ``state_like`` (tensors with
        ``copy_``, on their device), return the restored tree. A CPU
        tensor is read straight into its memory; a card's through a ring
        of two pinned chunks, each chunk's host-to-device copy queued on
        the stream while the next is read."""
        manifest = self.manifest(step)
        if manifest is None:
            raise CheckpointIntegrityError(
                f"step {step} in {self.directory}: no readable manifest",
                reason="missing-manifest")
        self._check_fits(manifest, state_like)
        sdir = self._step_dir(step)
        t0 = time.perf_counter()
        stats = dict(step=step, read_s=0.0, h2d_wait_s=0.0, bytes=0)
        values: Dict[str, Any] = {}
        ring: List[Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = []
        turn = 0

        def read(f, view: memoryview, name: str) -> None:
            t = time.perf_counter()
            got = f.readinto(view)
            stats["read_s"] += time.perf_counter() - t
            if got != len(view):
                raise CheckpointIntegrityError(
                    f"step {step}: file {name} ended {len(view) - got} "
                    f"bytes early", reason="truncated")

        for meta, (path, leaf) in zip(manifest["tree"], _leaves(state_like)):
            full = os.path.join(sdir, meta["file"])
            nbytes = os.path.getsize(full)
            stats["bytes"] += nbytes
            with open(full, "rb") as f:
                if not isinstance(leaf, torch.Tensor):
                    raw = bytearray(nbytes)
                    read(f, memoryview(raw), meta["file"])
                    arr = np.frombuffer(bytes(raw), _SCALAR_NP.get(
                        meta["dtype"], meta["dtype"])).reshape(meta["shape"])
                    values[path] = (arr.item() if meta["dtype"] in _SCALAR_NP
                                    else arr.copy())
                    continue
                if not leaf.is_contiguous():
                    raise CheckpointError(
                        f"cannot restore {path} in place: the target "
                        f"tensor is not contiguous")
                dst = leaf.detach().reshape(-1).view(torch.uint8)
                values[path] = leaf
                if dst.numel() != nbytes:
                    raise CheckpointIntegrityError(
                        f"step {step}: file {meta['file']} holds {nbytes} "
                        f"bytes for a leaf of {dst.numel()}",
                        reason="truncated")
                if dst.device.type != "cuda":
                    read(f, memoryview(dst.numpy()), meta["file"])
                    continue
                if not ring:
                    ring = [(torch.empty(_CHUNK, dtype=torch.uint8,
                                         pin_memory=True), None)
                            for _ in range(2)]
                for off in range(0, nbytes, _CHUNK):
                    n = min(_CHUNK, nbytes - off)
                    buf, done = ring[turn]
                    if done is not None:  # its last copy must have landed
                        t = time.perf_counter()
                        done.synchronize()
                        stats["h2d_wait_s"] += time.perf_counter() - t
                    read(f, memoryview(buf.numpy())[:n], meta["file"])
                    with torch.no_grad():
                        dst[off:off + n].copy_(buf[:n], non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    ring[turn] = (buf, event)
                    turn ^= 1
        t = time.perf_counter()
        for _, done in ring:
            if done is not None:
                done.synchronize()
        stats["h2d_wait_s"] += time.perf_counter() - t
        stats["seconds"] = time.perf_counter() - t0
        self.restore_stats.append(stats)
        return _rebuild(state_like, values)

    def restore(self, state_like: Any, step: Optional[int] = None,
                verify: bool = True) -> Any:
        """Copy a saved step into ``state_like`` (a tree of the saved
        layout: tensors are filled in place with ``copy_``) and return it.

        Verifies the newest candidate first; a step that fails is
        quarantined and the next older step is tried. ``step`` bounds the
        search (newest verified step <= ``step``); the step restored lands
        in ``last_restored_step``."""
        self._finalize()  # a restore must see every scheduled save committed
        steps = self._known_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        candidates = [s for s in steps if step is None or s <= step]
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoint at or before step {step} in "
                f"{self.directory} (have {steps})")
        failures: List[str] = []
        for s in sorted(candidates, reverse=True):
            manifest = self.manifest(s)
            if (manifest is not None
                    and manifest.get("digest") == _manifest_digest(manifest)):
                self._check_fits(manifest, state_like)
            verify_s = 0.0
            if verify:
                t = time.perf_counter()
                try:
                    self.verify_step(s)
                except CheckpointIntegrityError as e:
                    where = self.quarantine(s, e.reason)
                    failures.append(f"{e} -> quarantined to {where}")
                    continue
                verify_s = time.perf_counter() - t
            restored = self._load(s, state_like)
            self.restore_stats[-1]["verify_s"] = verify_s
            if failures:
                _metrics.counter(
                    "tk8s_train_checkpoint_fallback_restores_total").inc()
            self.last_restored_step = s
            return restored
        raise CheckpointIntegrityError(
            f"no checkpoint in {self.directory} passed verification: "
            + "; ".join(failures), reason="all-quarantined")

    # ----------------------------------------------------------------- close
    def close(self) -> None:
        """Idempotent: commit (or quarantine) every pending save. Also
        runs at interpreter exit via ``atexit``, so a trainer that forgets
        close() still never leaves a committed-looking half-step."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self._atexit_guard)
        try:
            self._finalize()
        finally:
            if self._own_staging:
                self.staging.clear()

    def _atexit_guard(self) -> None:
        try:
            self.close()
        # atexit is the last resort: close() already quarantines torn
        # saves, and there is no caller left to notify.
        except Exception:  # pragma: no cover - best effort at exit
            pass


def restore_newest_verified(state_like: Any, *managers: Any,
                            ) -> Tuple[Any, Any, int]:
    """Cross-manager resume: restore the newest verified step across
    several checkpoint directories (the scheduled dir and the emergency
    dir). Candidate steps from every manager are tried globally
    newest-first; one that fails verification is quarantined by its
    owning manager and the next-newest step -- wherever it lives -- is
    tried. Returns ``(restored_state, manager, step)``. Raises
    ``FileNotFoundError`` when no manager holds any checkpoint, and
    :class:`CheckpointIntegrityError` when checkpoints exist but none
    verifies anywhere."""
    mgrs = [m for m in managers if m is not None]
    candidates = [(step, mgr) for mgr in mgrs for step in mgr.all_steps()]
    # Newest step first; ties keep the caller's manager order (scheduled
    # before emergency when both committed the same step).
    candidates.sort(key=lambda c: (-c[0], mgrs.index(c[1])))
    if not candidates:
        raise FileNotFoundError(
            "no checkpoints in any of: "
            + ", ".join(m.directory for m in mgrs))
    failures: List[str] = []
    for step, mgr in candidates:
        manifest = mgr.manifest(step)
        if (manifest is not None
                and manifest.get("digest") == _manifest_digest(manifest)):
            mgr._check_fits(manifest, state_like)
        t = time.perf_counter()
        try:
            mgr.verify_step(step)
        except CheckpointIntegrityError as e:
            where = mgr.quarantine(step, e.reason)
            failures.append(f"{e} -> quarantined to {where}")
            continue
        verify_s = time.perf_counter() - t
        # verify=False: this exact step was hashed end to end just above.
        restored = mgr.restore(state_like, step=step, verify=False)
        mgr.restore_stats[-1]["verify_s"] = verify_s
        if failures:
            _metrics.counter(
                "tk8s_train_checkpoint_fallback_restores_total").inc()
        return restored, mgr, step
    raise CheckpointIntegrityError(
        "no checkpoint passed verification in any directory: "
        + "; ".join(failures), reason="all-quarantined")
