"""KV-page session migration: the serialized shipping protocol -- the port
of ``triton_kubernetes_tpu/serve/migration.py``, its wire format byte for
byte, so either package reads the other's payloads.

A live sequence's whole decoding state -- its KV pages (at whatever
``kv_dtype`` the pool runs), the anchored per-page quantization scales, and
the request and sampling state needed to keep emitting the same tokens --
packs into ONE self-describing unit that unpacks into another engine's pool
byte for byte.

Wire format::

    MAGIC (8 bytes) | header_len (4 bytes, big-endian) |
    header JSON (utf-8, sorted keys, compact separators) |
    page payload (each array's raw bytes, in sorted name order) |
    sha256 digest (32 bytes, over everything before it)

* **Byte-exact**: pages ship as their raw bytes and land by an indexed
  write -- no dequantize/requantize cycle, so a quantized pool migrates
  bitwise and ships fewer bytes.
* **Self-describing**: the header carries dtype and shape for every array
  plus the model and pool identity, so the receiver refuses an
  incompatible payload before touching its allocator.
* **Torn-transfer safe**: the trailing digest covers header and payload; a
  truncated body or one flipped bit raises :class:`TornPayloadError` and
  the destination pool is left untouched.

Dtypes travel by the names numpy gives them under ``ml_dtypes`` (the JAX
package's spelling): the port maps those names to torch dtypes itself
(:data:`DTYPES`), so it needs neither numpy's extension types nor
``ml_dtypes``. A bfloat16 or float8 tensor goes out as its bytes (a
same-size integer view); :class:`SessionPayload` holds CPU tensors that are
views over the received blob, never copies.
"""

from __future__ import annotations

import hashlib
import json
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

MAGIC = b"TK8SKV1\n"
VERSION = 1
DIGEST_BYTES = 32
#: Header keys every payload must carry (the compatibility gate reads
#: them before any bytes touch the destination pool).
HEADER_KEYS = ("version", "model", "kv_dtype", "block_size", "pages",
               "arrays", "request", "generated", "prefilled", "target",
               "preemptions")

#: Wire dtype name -> torch dtype. The names are ``np.dtype(...).name`` of
#: the JAX package's pool arrays (bfloat16 and float8_e4m3fn as ml_dtypes
#: names them).
DTYPES: Dict[str, torch.dtype] = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
# Same-size integer views: the dtype the raw bytes of each wire dtype are
# read and written through (numpy has no bfloat16 or float8).
_BYTES_AS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}

# One shipped component: a torch tensor, or raw bytes with their wire
# dtype name and shape.
ArrayLike = Union[torch.Tensor, Tuple[Any, str, Tuple[int, ...]]]


class MigrationError(ValueError):
    """A payload this engine cannot import (wrong model, wrong pool
    geometry, malformed header)."""


class TornPayloadError(MigrationError):
    """The digest rejected the payload: truncated body, cut transfer, or
    corrupted bytes. The destination pool was not touched."""


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a pool dtype (raises for one the format lacks)."""
    name = _NAMES.get(dtype)
    if name is None:
        raise MigrationError(f"dtype {dtype} has no wire name "
                             f"(known: {sorted(DTYPES)})")
    return name


def _as_bytes(arr: ArrayLike) -> Tuple[memoryview, str, List[int]]:
    """(raw bytes, wire dtype name, shape) of one component."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        name = dtype_name(t.dtype)
        raw = t.view(_BYTES_AS[t.element_size()]).reshape(-1).numpy()
        return memoryview(raw).cast("B"), name, list(t.shape)
    data, name, shape = arr
    if name not in DTYPES:
        raise MigrationError(f"unknown dtype name {name!r} "
                             f"(known: {sorted(DTYPES)})")
    raw, shape = memoryview(data).cast("B"), [int(d) for d in shape]
    count = DTYPES[name].itemsize
    for d in shape:
        count *= d
    if raw.nbytes != count:
        raise MigrationError(f"{raw.nbytes} bytes given for a {name} array "
                             f"of shape {shape} ({count} bytes)")
    return raw, name, shape


def pack_session(*, model: str, kv_dtype: str, block_size: int,
                 arrays: Dict[str, ArrayLike],
                 request: Dict[str, Any], generated: List[int],
                 prefilled: int, target: int, preemptions: int,
                 first_token_at: Optional[float] = None) -> bytes:
    """Serialize one session into the self-describing wire unit.

    ``arrays`` maps component name (``k``/``v`` and, for quantized pools,
    ``k_scale``/``v_scale``) to the gathered page slice, shaped ``[L,
    pages, ...]`` with the page axis in block-table order: a torch tensor
    (a CUDA one is copied to the host), or ``(bytes, dtype_name, shape)``.
    The digest is computed over the parts as they are joined, so the page
    bytes are copied once, into the blob.
    """
    names = sorted(arrays)
    parts = {n: _as_bytes(arrays[n]) for n in names}
    npages = {int(parts[n][2][1]) for n in names}
    if len(npages) != 1:
        raise MigrationError(
            f"array page counts disagree: "
            f"{ {n: parts[n][2][1] for n in names} }")
    header = {
        "version": VERSION,
        "model": model,
        "kv_dtype": kv_dtype,
        "block_size": int(block_size),
        "pages": npages.pop(),
        "arrays": {n: {"dtype": parts[n][1], "shape": parts[n][2]}
                   for n in names},
        "request": dict(request),
        "generated": [int(t) for t in generated],
        "prefilled": int(prefilled),
        "target": int(target),
        "preemptions": int(preemptions),
    }
    if first_token_at is not None:
        header["first_token_at"] = float(first_token_at)
    hdr = json.dumps(header, sort_keys=True,
                     separators=(",", ":")).encode("utf-8")
    chunks = [MAGIC, len(hdr).to_bytes(4, "big"), hdr]
    chunks += [parts[n][0] for n in names]
    digest = hashlib.sha256()
    for c in chunks:
        digest.update(c)
    chunks.append(digest.digest())
    return b"".join(chunks)


class SessionPayload:
    """A verified, decoded wire unit: the header dict plus one CPU tensor
    per shipped component (views over the blob, read-only in spirit: they
    share its bytes)."""

    def __init__(self, header: Dict[str, Any],
                 arrays: Dict[str, torch.Tensor], nbytes: int):
        self.header = header
        self.arrays = arrays
        self.nbytes = nbytes

    @property
    def request(self) -> Dict[str, Any]:
        return self.header["request"]

    @property
    def pages(self) -> int:
        return int(self.header["pages"])


def _view(blob: bytes, offset: int, count: int,
          dtype: torch.dtype) -> torch.Tensor:
    """A tensor of ``count`` elements over ``blob`` at byte ``offset``: no
    copy. The blob is immutable; torch warns about that once per call, and
    nothing here writes through the view."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        raw = torch.frombuffer(blob, dtype=torch.uint8,
                               count=count * dtype.itemsize, offset=offset)
    return raw.view(dtype)


def unpack_session(blob: bytes) -> SessionPayload:
    """Verify the digest and decode the unit. Any damage anywhere --
    truncation, a cut mid-payload, one flipped bit in header or pages --
    fails the sha256 check and raises :class:`TornPayloadError` before a
    single byte is interpreted."""
    if len(blob) < len(MAGIC) + 4 + DIGEST_BYTES:
        raise TornPayloadError(
            f"payload truncated: {len(blob)} bytes is shorter than the "
            f"fixed framing")
    view = memoryview(blob)
    body_len = len(blob) - DIGEST_BYTES
    if hashlib.sha256(view[:body_len]).digest() != bytes(view[body_len:]):
        raise TornPayloadError(
            "digest mismatch: payload was torn or corrupted in flight")
    if bytes(view[:len(MAGIC)]) != MAGIC:
        raise MigrationError(
            f"bad magic {bytes(view[:len(MAGIC)])!r}: not a tk8s KV "
            f"migration payload")
    hdr_len = int.from_bytes(view[len(MAGIC):len(MAGIC) + 4], "big")
    hdr_start = len(MAGIC) + 4
    try:
        header = json.loads(bytes(view[hdr_start:hdr_start + hdr_len]))
    except ValueError as e:
        raise MigrationError(f"unreadable header: {e}") from e
    missing = [k for k in HEADER_KEYS if k not in header]
    if missing:
        raise MigrationError(f"header missing keys {missing}")
    if header["version"] != VERSION:
        raise MigrationError(
            f"payload version {header['version']} != {VERSION}")
    arrays: Dict[str, torch.Tensor] = {}
    offset = hdr_start + hdr_len
    for name in sorted(header["arrays"]):
        meta = header["arrays"][name]
        dtype = DTYPES.get(meta["dtype"])
        if dtype is None:
            raise MigrationError(
                f"array {name!r}: unknown dtype {meta['dtype']!r} "
                f"(known: {sorted(DTYPES)})")
        shape = tuple(int(d) for d in meta["shape"])
        count = 1
        for d in shape:
            count *= d
        end = offset + count * dtype.itemsize
        if end > body_len:
            raise MigrationError(
                f"array {name!r} overruns the payload "
                f"({end} > {body_len} bytes)")
        arrays[name] = _view(blob, offset, count, dtype).reshape(shape)
        offset = end
    if offset != body_len:
        raise MigrationError(
            f"{body_len - offset} trailing bytes after the declared "
            f"arrays")
    return SessionPayload(header, arrays, len(blob))


def check_compatible(payload: SessionPayload, *, model: str,
                     kv_dtype: str, block_size: int,
                     expect_arrays: Tuple[str, ...]) -> None:
    """The import-side identity gate: pages are raw bytes, so they are
    only meaningful in a pool with the same model geometry, page size and
    dtype. Refuse anything else before touching the allocator."""
    h = payload.header
    if h["model"] != model:
        raise MigrationError(
            f"payload is for model {h['model']!r}, this pool serves "
            f"{model!r}")
    if h["kv_dtype"] != kv_dtype:
        raise MigrationError(
            f"payload pool dtype {h['kv_dtype']!r} != local "
            f"{kv_dtype!r} -- raw pages do not convert")
    if int(h["block_size"]) != block_size:
        raise MigrationError(
            f"payload block_size {h['block_size']} != local "
            f"{block_size}")
    if tuple(sorted(h["arrays"])) != tuple(sorted(expect_arrays)):
        raise MigrationError(
            f"payload components {sorted(h['arrays'])} != expected "
            f"{sorted(expect_arrays)}")


def corrupt(blob: bytes, *, mode: str, offset: int) -> bytes:
    """Damage a payload the way a torn transfer would. ``truncate`` cuts
    the body at ``offset``; ``bitflip`` flips one bit at ``offset`` (a
    corrupted frame that kept its length)."""
    offset = max(0, min(offset, len(blob) - 1))
    if mode == "truncate":
        return blob[:offset]
    if mode == "bitflip":
        b = bytearray(blob)
        b[offset] ^= 0x01
        return bytes(b)
    raise ValueError(f"unknown corruption mode {mode!r}")
