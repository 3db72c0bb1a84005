"""Training data -- the port of ``triton_kubernetes_tpu/train/data.py``.

Sources, each yielding ``{"tokens": [B, S+1] int32}`` host batches (numpy
copies of the reference's: same seed, same files, same arrays):

- ``synthetic_batches`` -- order-2 Markov sequences, learnable, so a
  falling loss means something;
- ``PackedDataset`` -- a memory-mapped flat token file cut into fixed
  windows (``write_packed`` writes one);
- ``ShardedTokenPipeline`` -- a directory of ``*.bin`` int32 shards in the
  per-epoch order ``epoch_order`` gives, through the native library
  ``native/libtkdata.so`` (bound with ctypes; it sits outside both
  packages) or through the Python path, which is bit-identical.

Either source can be wrapped in :class:`DevicePrefetch`, the host-to-device
staging layer of the pipelined loop (``train/pipeline.py``): a background
thread assembles host batches into pinned tensors while the consumer keeps
the copy of the next ``buffer_size`` batches in flight on the current
stream, under the steps already queued.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


def synthetic_batches(
    vocab_size: int,
    batch_size: int,
    seq_len: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Order-2 Markov sequences: next = (a*prev + b*prev2 + noise) % V.
    Structured rather than uniform noise, so a model can learn them and a
    falling loss means something. Yields ``{"tokens": [B, S+1] int32}``."""
    rng = np.random.default_rng(seed)
    a, b = 31, 17
    while True:
        out = np.empty((batch_size, seq_len + 1), dtype=np.int32)
        prev = rng.integers(0, vocab_size, size=batch_size)
        prev2 = rng.integers(0, vocab_size, size=batch_size)
        for t in range(seq_len + 1):
            noise = rng.integers(0, 4, size=batch_size)
            cur = (a * prev + b * prev2 + noise) % vocab_size
            out[:, t] = cur
            prev2, prev = prev, cur
        yield {"tokens": out}


class PackedDataset:
    """Flat binary token file (little-endian int32 or uint16) -> windows
    of ``seq_len + 1`` tokens, ``seq_len`` apart."""

    def __init__(self, path: str, seq_len: int, dtype: str = "int32"):
        self.seq_len = seq_len
        self.tokens = np.memmap(path, dtype=np.dtype(dtype), mode="r")
        if len(self.tokens) < seq_len + 1:
            raise ValueError(
                f"{path}: {len(self.tokens)} tokens < window {seq_len + 1}")

    def __len__(self) -> int:
        return (len(self.tokens) - 1) // self.seq_len

    def batches(
        self, batch_size: int, seed: int = 0, shuffle: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Endless batches; each epoch a fresh permutation of the windows
        (``numpy.random.default_rng(seed)``, as the reference draws it)."""
        n = len(self)
        rng = np.random.default_rng(seed)
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                rows = [
                    np.asarray(
                        self.tokens[j * self.seq_len:
                                    j * self.seq_len + self.seq_len + 1],
                        dtype=np.int32)
                    for j in idx
                ]
                yield {"tokens": np.stack(rows)}


def write_packed(path: str, tokens: np.ndarray, dtype: str = "int32") -> None:
    """Write ``tokens`` as the flat file :class:`PackedDataset` reads."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.asarray(tokens, dtype=np.dtype(dtype)).tofile(path)


# --------------------------------------------------------------------------
# Sharded pipeline: the native library, and the Python path mirroring it.
# --------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_GOLD = 0x9E3779B97F4A7C15


def _xorshift64star(state: int):
    """One step of xorshift64*; returns (new_state, output). In lockstep
    with ``native/data_pipeline.cpp:xorshift64star``."""
    state ^= state >> 12
    state ^= (state << 25) & _M64
    state ^= state >> 27
    return state, (state * 0x2545F4914F6CDD1D) & _M64


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The per-epoch sequence order shared by the native and Python
    pipelines: Fisher-Yates driven by xorshift64* seeded with
    ``seed ^ epoch*GOLD`` (``native/data_pipeline.cpp:Pipeline::reshuffle``)."""
    order = list(range(n))
    s = (seed ^ ((epoch * _GOLD) & _M64)) & _M64
    if s == 0:
        s = _GOLD
    for i in range(n - 1, 0, -1):
        s, r = _xorshift64star(s)
        j = r % (i + 1)
        order[i], order[j] = order[j], order[i]
    return np.asarray(order, dtype=np.int64)


def _find_native_lib() -> Optional[str]:
    """``TK8S_NATIVE_LIB`` when it names a file, else the repository's
    ``native/libtkdata.so`` when built (``make native``)."""
    cand = os.environ.get("TK8S_NATIVE_LIB")
    if cand and os.path.isfile(cand):
        return cand
    here = os.path.dirname(os.path.abspath(__file__))
    cand = os.path.join(here, "..", "..", "native", "libtkdata.so")
    return cand if os.path.isfile(cand) else None


class ShardedTokenPipeline:
    """Batches from a directory of ``*.bin`` int32 token shards.

    Uses the native pipeline (``native/libtkdata.so``: shard indexing,
    epoch shuffle, batch assembly, background prefetch) when the library
    is present, else the Python path with bit-identical output.
    ``native=True`` requires the library, ``native=False`` forces the
    Python path, ``None`` auto-detects.

    ``next()`` returns ``(tokens[batch, seq_len+1] int32, epoch)``, the
    epoch the batch *started* in.
    """

    def __init__(self, directory: str, batch_size: int, seq_len: int,
                 seed: int = 0, native: Optional[bool] = None):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self._handle = None
        self._lib = None

        lib_path = _find_native_lib() if native is not False else None
        if native is True and lib_path is None:
            raise RuntimeError(
                "native pipeline requested but native/libtkdata.so not "
                "built (run `make native`)")
        if lib_path is not None:
            self._open_native(lib_path, directory)
        else:
            self._open_python(directory)

    # -------------------------------------------------------------- native
    def _open_native(self, lib_path: str, directory: str) -> None:
        import ctypes

        lib = ctypes.CDLL(lib_path)
        lib.dp_open.restype = ctypes.c_void_p
        lib.dp_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_uint64]
        lib.dp_next.restype = ctypes.c_int
        lib.dp_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int32)]
        lib.dp_num_sequences.restype = ctypes.c_long
        lib.dp_num_sequences.argtypes = [ctypes.c_void_p]
        lib.dp_close.argtypes = [ctypes.c_void_p]
        lib.dp_close.restype = None
        lib.dp_error.argtypes = []
        lib.dp_error.restype = ctypes.c_char_p

        handle = lib.dp_open(directory.encode(), self.batch_size,
                             self.seq_len, self.seed)
        if not handle:
            raise ValueError(lib.dp_error().decode() or
                             f"dp_open failed for {directory}")
        self._lib = lib
        self._handle = handle
        self._n = int(lib.dp_num_sequences(handle))
        self.native = True

    # -------------------------------------------------------------- python
    def _open_python(self, directory: str) -> None:
        width = self.seq_len + 1
        self._shards = []
        self._index = []  # (shard_i, offset)
        try:
            names = sorted(os.listdir(directory))
        except OSError as e:
            raise ValueError(f"cannot read directory: {directory}") from e
        for name in names:
            if not name.endswith(".bin"):
                continue
            toks = np.memmap(os.path.join(directory, name),
                             dtype=np.int32, mode="r")
            shard_i = len(self._shards)
            for k in range(len(toks) // width):
                self._index.append((shard_i, k * width))
            self._shards.append(toks)
        if not self._index:
            raise ValueError(
                "no sequences found (need *.bin shards each >= "
                "(seq_len+1)*4 bytes)")
        self._n = len(self._index)
        self._epoch = 0
        self._order = epoch_order(self._n, self.seed, 0)
        self._cursor = 0
        self.native = False

    def __len__(self) -> int:
        return self._n

    def next(self):
        width = self.seq_len + 1
        out = np.empty((self.batch_size, width), dtype=np.int32)
        if self._handle is not None:
            import ctypes

            epoch = self._lib.dp_next(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            return out, epoch
        batch_epoch = self._epoch
        for b in range(self.batch_size):
            if self._cursor >= self._n:
                self._epoch += 1
                self._order = epoch_order(self._n, self.seed, self._epoch)
                self._cursor = 0
            shard_i, off = self._index[int(self._order[self._cursor])]
            self._cursor += 1
            out[b] = self._shards[shard_i][off:off + width]
        return out, batch_epoch

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Trainer-compatible iterator view (drops the epoch tag)."""
        while True:
            tokens, _ = self.next()
            yield {"tokens": tokens}

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dp_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        # GC-time close: the interpreter may be tearing down, and raising
        # here would mask the real exit path.
        except Exception:
            pass


# --------------------------------------------------------------------------
# Device prefetch: the input half of the step-pipelined training loop.
# --------------------------------------------------------------------------

def _map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of a batch (dicts, lists and tuples of
    arrays or tensors)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class _Drained:
    """Queue sentinel: the producer finished the source."""


class _ProducerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchProducerError(RuntimeError):
    """The prefetch producer died mid-stream. Raised on the consumer side
    with the producer's original exception chained (``raise ... from``),
    so the generator frame that blew up, possibly on the background
    thread, stays visible in the traceback."""


class DevicePrefetch:
    """Host->device prefetch over a host-batch iterator.

    Two overlaps, both ahead of the step that will consume them:

    1. **Host batch assembly** -- a daemon thread drains ``source`` into a
       bounded queue (``buffer_size`` deep), turning every leaf into a
       tensor, **pinned** when the target is a CUDA device, so Python-side
       batch work (Markov generation, memmap gathers) runs while the card
       computes.
    2. **Host->device copy** -- each dequeued batch is staged with
       ``.to(device, non_blocking=True)`` on the *current* stream as soon
       as a buffer slot frees up, so the copy of batch i+1 is queued
       behind step i and the loop never waits on it. A batch is a few tens
       of KB (4 x 2049 int32 = 33 KB at the 8B training shape), so a side
       stream would buy no overlap worth its ``wait_stream`` /
       ``record_stream`` bookkeeping: one stream keeps every copy ordered
       before the step that reads it.

    A pinned host buffer is never reused before its copy has completed:
    each staged batch records a CUDA event after its copies and keeps its
    pinned tensors alive until that event has completed (checked without
    blocking at each ``__next__``; :meth:`close` waits for the rest).

    ``device`` takes the place of the reference's ``sharding``: the device
    every leaf lands on (``None``: torch tensors on the CPU, torch's
    default device). ``place(batch)`` is the custom staging hook instead
    (pass one or the other).

    The iterator yields whatever structure ``source`` yields, every leaf a
    tensor on the device. Finite sources end the iterator normally.

    Measurement: ``wait_seconds`` accumulates the time ``__next__`` spent
    blocked on the producer (the loop's only input stall), ``last_wait``
    the most recent such wait, ``batches_out`` the batches handed out. The
    pipelined loop mirrors ``wait_seconds`` into the
    ``tk8s_train_prefetch_wait_seconds`` gauge at each sync.
    ``threaded=False`` runs the producer inline (deterministic tests);
    staging still happens ahead of the consumer.
    """

    def __init__(self, source: Iterable[Any],
                 device: Optional[torch.device | str] = None,
                 buffer_size: int = 2, threaded: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 place: Optional[Callable[[Any], Any]] = None):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        if place is not None and device is not None:
            raise ValueError("pass either device or place, not both")
        self.device = torch.device(device) if device is not None else None
        self._place_fn = place
        self._pin = self.device is not None and self.device.type == "cuda"
        self.buffer_size = buffer_size
        self.threaded = threaded
        self.wait_seconds = 0.0
        self.last_wait = 0.0
        self.batches_out = 0
        self._clock = clock
        self._source = iter(source)
        self._staged: list = []  # device batches, oldest first
        # (event, pinned host batch) of copies that may still be running.
        self._in_copy: collections.deque = collections.deque()
        self._exhausted = False
        self._pending_error: Optional[BaseException] = None
        if threaded:
            self._queue: queue.Queue = queue.Queue(maxsize=buffer_size)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._produce, name="tk8s-prefetch", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ producer
    def _host(self, batch: Any) -> Any:
        """A source batch as host tensors, pinned for a CUDA target."""
        def leaf(x):
            t = torch.as_tensor(x)
            if self._pin and t.device.type == "cpu" and not t.is_pinned():
                return t.pin_memory()
            return t

        return _map(leaf, batch)

    def _produce(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                self._queue.put(self._host(item))
            self._queue.put(_Drained)
        except BaseException as e:  # surfaced on the consumer side
            self._queue.put(_ProducerError(e))

    def _next_host(self):
        """One host batch from the producer, or _Drained; blocks (timed).
        Producer failures surface as :class:`PrefetchProducerError` with
        the original exception as ``__cause__``."""
        if not self.threaded:
            try:
                item = next(self._source, _Drained)
                return item if item is _Drained else self._host(item)
            except Exception as e:
                raise PrefetchProducerError(
                    f"prefetch producer failed after {self.batches_out} "
                    f"batches: {e}") from e
        item = self._queue.get()
        if isinstance(item, _ProducerError):
            self._exhausted = True
            if isinstance(item.exc, Exception):
                raise PrefetchProducerError(
                    f"prefetch producer failed after {self.batches_out} "
                    f"batches: {item.exc}") from item.exc
            raise item.exc  # KeyboardInterrupt etc: pass through unwrapped
        return item

    # ------------------------------------------------------------ consumer
    def _place(self, host: Any) -> Any:
        if self._place_fn is not None:
            return self._place_fn(host)
        device = self.device or torch.device("cpu")
        out = _map(lambda t: t.to(device, non_blocking=self._pin), host)
        if self._pin:
            event = torch.cuda.Event()
            event.record()
            self._in_copy.append((event, host))
        return out

    def _release_copied(self) -> None:
        """Drop the pinned buffers whose copies have completed."""
        while self._in_copy and self._in_copy[0][0].query():
            self._in_copy.popleft()

    def _fill(self, block: bool) -> None:
        """Stage batches until the buffer is full. Only an *empty* buffer
        under ``block`` waits on the producer (and that wait is the
        measured input stall); top-ups are opportunistic."""
        while not self._exhausted and len(self._staged) < self.buffer_size:
            must_wait = block and not self._staged
            if self.threaded and not must_wait and self._queue.empty():
                return  # opportunistic top-up only; never block here
            t0 = self._clock()
            try:
                item = self._next_host()
            except BaseException as e:
                if not self._staged:
                    raise
                # Hand out the batches produced before the failure first;
                # re-raise once the buffer drains.
                self._pending_error = e
                self._exhausted = True
                return
            wait = self._clock() - t0
            if must_wait:
                self.last_wait = wait
                self.wait_seconds += wait
            if item is _Drained:
                self._exhausted = True
                return
            self._staged.append(self._place(item))

    def __iter__(self):
        return self

    def __next__(self):
        self._release_copied()
        self._fill(block=True)
        if not self._staged:
            self.close()
            if self._pending_error is not None:
                e, self._pending_error = self._pending_error, None
                raise e
            raise StopIteration
        out = self._staged.pop(0)
        self.batches_out += 1
        self._fill(block=False)  # queue the next copy before returning
        return out

    def close(self) -> None:
        self._exhausted = True
        if self.threaded:
            self._stop.set()
            # Unblock a producer parked on a full queue, and wait until it
            # has returned: a daemon producer still inside torch or numpy
            # when the interpreter finalizes is ended by pthread_exit,
            # whose unwind through C++ frames aborts the process
            # ("terminate called without an active exception", rc 134).
            while True:
                try:
                    while True:
                        self._queue.get_nowait()
                except queue.Empty:
                    pass
                self._thread.join(timeout=0.05)
                if not self._thread.is_alive():
                    break
        while self._in_copy:
            event, _ = self._in_copy.popleft()
            event.synchronize()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
