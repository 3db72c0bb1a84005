"""In-memory backend for tests and dry runs (the port's copy of the
reference's ``backends/memory.py``).

Reference analog: backend/mocks/Backend.go (the testify mock that every
workflow guard-rail test stubs). A real in-memory implementation is more
useful than a mock: workflow integration tests can run a full
create→mutate→persist→reload cycle with zero filesystem access.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..state import StateDocument
from .base import Backend, StateNotFoundError


class MemoryBackend(Backend):
    def __init__(self, initial: Dict[str, bytes] | None = None):
        self._docs: Dict[str, bytes] = dict(initial or {})
        self.persist_count = 0

    def states(self) -> List[str]:
        return sorted(self._docs)

    def state(self, name: str) -> StateDocument:
        if name in self._docs:
            return StateDocument(name, self._docs[name])
        return StateDocument(name)

    def persist(self, state: StateDocument) -> None:
        self._docs[state.name] = state.to_bytes()
        self.persist_count += 1

    def delete(self, name: str) -> None:
        if name not in self._docs:
            raise StateNotFoundError(name)
        del self._docs[name]

    def executor_backend_config(self, name: str) -> Dict[str, Any]:
        return {"memory": {"name": name}}
