"""Backend interface for state-document persistence: the port's copy of
``triton_kubernetes_tpu/backends/base.py``.

Reference analog: backend/backend.go:7-27. The five-method contract is kept
(list, load, persist, delete, plus the executor-backend config that tells the
execution layer where *its* state lives), with explicit error types instead of
error-string comparisons.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List

from ..state import StateDocument


class StateNotFoundError(KeyError):
    """No state document with that name exists in the backend."""


class StateExistsError(ValueError):
    """A state document with that name already exists (uniqueness check at
    manager create; reference: create/manager.go:86-101)."""


class StateLockedError(RuntimeError):
    """Another process holds the lock / the document changed under us.

    The reference had no locking at all (TODO at backend/manta/backend.go:33);
    this rebuild makes concurrent clobbering a detectable error instead.
    """


class Backend(abc.ABC):
    """Persistence for named state documents (one per cluster manager)."""

    @abc.abstractmethod
    def states(self) -> List[str]:
        """Names of all persisted state documents (reference: States())."""

    @abc.abstractmethod
    def state(self, name: str) -> StateDocument:
        """Load a document by name; a *new* (never-persisted) name returns an
        empty document (reference: State() returning state.New("{}"))."""

    @abc.abstractmethod
    def persist(self, state: StateDocument) -> None:
        """Atomically persist the document. Called only after a successful
        apply (commit-after-success; reference: create/manager.go:147-151)."""

    @abc.abstractmethod
    def delete(self, name: str) -> None:
        """Remove a document entirely (reference: DeleteState, used by
        destroy/manager.go:85-96 after full destroy)."""

    @abc.abstractmethod
    def executor_backend_config(self, name: str) -> Dict[str, Any]:
        """The ``terraform.backend``-style config block telling the executor
        where to keep its own applied-resource state for this document
        (reference: StateTerraformConfig; local path for the local backend,
        remote object path for object-store backends)."""

    def exists(self, name: str) -> bool:
        return name in self.states()
