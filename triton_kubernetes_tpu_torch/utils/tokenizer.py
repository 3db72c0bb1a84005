"""Byte-level BPE tokenizer -- the port's own copy of
``triton_kubernetes_tpu/utils/tokenizer.py`` (train, encode, decode,
save, load).

The text boundary of generation and serving, which work in token ids.
Byte-level with no pre-tokenization: any UTF-8 (or arbitrary binary)
round-trips exactly, and there is no regex or locale to keep in sync
across implementations.

Id space: ``0..255`` are raw bytes, ``256..255+n`` the merges in rank
order, then three reserved specials (bos, eos, pad). The model file is the
plain-text ``tkbpe v1`` format, which the native encoder reads too.

Encoding is the iterative lowest-rank merge. The native C++ encoder
(``native/tokenizer.cpp``, built into ``native/libtktok.so`` by ``make -C
native`` and bound with ctypes) is found where the JAX package finds it,
at the repository root, and gives the same ids as the Python path.
Auto-detection takes it when it is built and the tokenizer has a model
file (after :meth:`BpeTokenizer.save` or :meth:`BpeTokenizer.load`);
``native=True`` raises when it is missing. Host code: no tensor, no card.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Iterable, List, Optional, Tuple, Union

TextLike = Union[str, bytes]

_MAGIC = "tkbpe v1"


def _to_bytes(text: TextLike) -> bytes:
    return text.encode("utf-8") if isinstance(text, str) else text


def _find_native_lib() -> Optional[str]:
    """``native/libtktok.so`` at the repository root, when built."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cand = os.path.join(here, "native", "libtktok.so")
    return cand if os.path.isfile(cand) else None


class BpeTokenizer:
    def __init__(self, merges: List[Tuple[int, int]]):
        self.merges = list(merges)
        self.ranks: Dict[Tuple[int, int], int] = {
            pair: i for i, pair in enumerate(self.merges)}
        n = len(self.merges)
        self.bos_id = 256 + n
        self.eos_id = 257 + n
        self.pad_id = 258 + n
        self.vocab_size = 259 + n
        # id -> byte string (specials decode to nothing).
        self._bytes: List[bytes] = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])
        self._bytes += [b"", b"", b""]
        self._path: Optional[str] = None
        # None: not looked up yet; False: unavailable; else (lib, handle).
        self._native = None

    # ------------------------------------------------------------ training
    @classmethod
    def train(cls, corpus: Iterable[TextLike],
              vocab_size: int) -> "BpeTokenizer":
        """Learn merges by joining the most frequent adjacent pair until
        the vocabulary is full or no pair occurs twice (ties go to the
        smallest pair, so training is deterministic)."""
        if vocab_size < 259:
            raise ValueError(f"vocab_size must be >= 259, got {vocab_size}")
        seqs = [list(_to_bytes(t)) for t in corpus if len(_to_bytes(t)) > 1]
        merges: List[Tuple[int, int]] = []
        next_id = 256
        while next_id < vocab_size - 3:
            counts: Dict[Tuple[int, int], int] = {}
            for seq in seqs:
                for i in range(len(seq) - 1):
                    p = (seq[i], seq[i + 1])
                    counts[p] = counts.get(p, 0) + 1
            if not counts:
                break
            best = min(counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
            if counts[best] < 2:
                break
            merges.append(best)
            seqs = [_merge_pair(seq, best, next_id) for seq in seqs]
            next_id += 1
        return cls(merges)

    # ------------------------------------------------------- encode/decode
    def encode(self, text: TextLike, add_bos: bool = False,
               add_eos: bool = False,
               native: Optional[bool] = None) -> List[int]:
        """Token ids of ``text``: the native encoder when ``native`` is
        True (raises if unavailable) or None and it is available, else the
        Python path."""
        data = _to_bytes(text)
        lib = self._native_lib() if native is not False else None
        if native is True and lib is None:
            raise RuntimeError(
                "native tokenizer requested but native/libtktok.so is not "
                "built or the tokenizer has no model file (run `make -C "
                "native`, then save or load the tokenizer)")
        ids = (self._encode_native(lib, data) if lib is not None
               else self._encode_python(data))
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def _encode_python(self, data: bytes) -> List[int]:
        ids = list(data)
        while len(ids) > 1:
            best_rank, best_pair = None, None
            for i in range(len(ids) - 1):
                r = self.ranks.get((ids[i], ids[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_pair = r, (ids[i], ids[i + 1])
            if best_pair is None:
                break
            ids = _merge_pair(ids, best_pair, 256 + best_rank)
        return ids

    def decode(self, ids: Iterable[int], errors: str = "replace") -> str:
        return self.decode_bytes(ids).decode("utf-8", errors=errors)

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        out = bytearray()
        for i in ids:
            if not 0 <= i < self.vocab_size:
                raise ValueError(f"token id {i} out of range "
                                 f"(vocab_size {self.vocab_size})")
            out += self._bytes[i]
        return bytes(out)

    # ------------------------------------------------------------------ io
    def save(self, path: str) -> None:
        """Write the ``tkbpe v1`` model file; the tokenizer then reads it
        for the native encoder."""
        with open(path, "w", encoding="ascii") as f:
            f.write(f"{_MAGIC} {len(self.merges)}\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")
        self._path = path
        self._native = None

    @classmethod
    def load(cls, path: str) -> "BpeTokenizer":
        """Read a ``tkbpe v1`` model file. Each merge may reference only
        byte ids or earlier merges, as the native loader requires."""
        with open(path, "r", encoding="ascii") as f:
            header = f.readline().split()
            if header[:2] != _MAGIC.split() or len(header) != 3:
                raise ValueError(f"{path}: not a {_MAGIC} model file")
            merges = []
            for i in range(int(header[2])):
                line = f.readline()
                a, b = (int(x) for x in line.split())
                limit = 256 + i
                if not (0 <= a < limit and 0 <= b < limit):
                    raise ValueError(
                        f"{path}: merge {i} references id out of range "
                        f"[0, {limit}): {line.strip()!r}")
                merges.append((a, b))
        tok = cls(merges)
        tok._path = path
        return tok

    # -------------------------------------------------------------- native
    def _native_lib(self):
        """(library, model handle) of the native encoder, or None."""
        if self._native is not None:
            return self._native or None
        lib_path = _find_native_lib()
        if lib_path is None or self._path is None:
            self._native = False
            return None
        lib = ctypes.CDLL(lib_path)
        lib.tok_load.restype = ctypes.c_void_p
        lib.tok_load.argtypes = [ctypes.c_char_p]
        lib.tok_encode.restype = ctypes.c_int
        lib.tok_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        handle = lib.tok_load(self._path.encode())
        if not handle:
            self._native = False
            return None
        self._native = (lib, handle)
        return self._native

    def _encode_native(self, lib_handle, data: bytes) -> List[int]:
        lib, handle = lib_handle
        out = (ctypes.c_int32 * max(len(data), 1))()
        n = lib.tok_encode(handle, data, len(data), out, len(out))
        if n < 0:
            raise RuntimeError("native tok_encode failed")
        return list(out[:n])


def _merge_pair(ids: List[int], pair: Tuple[int, int],
                new_id: int) -> List[int]:
    """Replace non-overlapping occurrences of ``pair`` left to right."""
    out: List[int] = []
    i, n = 0, len(ids)
    while i < n:
        if i + 1 < n and ids[i] == pair[0] and ids[i + 1] == pair[1]:
            out.append(new_id)
            i += 2
        else:
            out.append(ids[i])
            i += 1
    return out
