"""Persistence of the state document: the port's copy of the reference's
``backends`` package, holding the in-memory backend (tests, the chip
smoke) and the local-directory one (``tools.operate``). The reference's
object-store backends are not ported: the port's operator keeps its
document beside it.
"""

from .base import Backend, StateExistsError, StateLockedError, StateNotFoundError
from .local import LocalBackend
from .memory import MemoryBackend

__all__ = [
    "Backend",
    "LocalBackend",
    "MemoryBackend",
    "StateExistsError",
    "StateLockedError",
    "StateNotFoundError",
]
