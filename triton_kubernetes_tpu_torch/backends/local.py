"""Local-filesystem backend: one directory per manager under a root dir
(the port's copy of the reference's ``backends/local.py``).

Reference analog: backend/local/backend.go:15-132 — layout
``~/.triton-kubernetes/<name>/main.tf.json`` with the executor's own state kept
in the same directory. This rebuild adds an advisory file lock around persist
(the reference's acknowledged gap, backend/manta/backend.go:33) and atomic
write-rename so a crashed persist never leaves a torn document.
"""

from __future__ import annotations

import fcntl
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List

from ..state import StateDocument
from .base import Backend, StateLockedError, StateNotFoundError

DOC_FILENAME = "main.tf.json"
DEFAULT_ROOT = "~/.triton-kubernetes-tpu"


class LocalBackend(Backend):
    def __init__(self, root: str | Path = DEFAULT_ROOT):
        self.root = Path(os.path.expanduser(str(root)))

    def _dir(self, name: str) -> Path:
        return self.root / name

    def _doc_path(self, name: str) -> Path:
        return self._dir(name) / DOC_FILENAME

    def states(self) -> List[str]:
        if not self.root.is_dir():
            return []
        return sorted(
            p.name for p in self.root.iterdir() if (p / DOC_FILENAME).is_file()
        )

    def state(self, name: str) -> StateDocument:
        path = self._doc_path(name)
        if path.is_file():
            return StateDocument(name, path.read_bytes())
        return StateDocument(name)

    def persist(self, state: StateDocument) -> None:
        d = self._dir(state.name)
        d.mkdir(parents=True, exist_ok=True)
        lock_path = d / ".lock"
        with open(lock_path, "w") as lock:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError as e:
                raise StateLockedError(
                    f"state {state.name!r} is locked by another process"
                ) from e
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".main.tf.json.")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(state.to_bytes())
                os.replace(tmp, self._doc_path(state.name))
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                fcntl.flock(lock, fcntl.LOCK_UN)

    def delete(self, name: str) -> None:
        d = self._dir(name)
        if not self._doc_path(name).is_file():
            raise StateNotFoundError(name)
        for p in sorted(d.rglob("*"), reverse=True):
            p.unlink() if p.is_file() or p.is_symlink() else p.rmdir()
        d.rmdir()

    def executor_backend_config(self, name: str) -> Dict[str, Any]:
        """Executor state stays next to the doc (reference: terraform.backend.local,
        backend/local/backend.go:123-132)."""
        return {"local": {"path": str(self._dir(name) / "terraform.tfstate")}}
