"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, on the machine with the card, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``triton_kubernetes_tpu_torch/_build/`` (listed in ``.gitignore``);
``-Xptxas -v`` puts each kernel's registers and spills in the build log.
The library name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. The library is
loaded with ``ctypes``: pointers and the stream are ``c_void_p``, ints
``c_int``. Each C entry returns ``cudaGetLastError()`` after its launch;
the binding raises if that is not 0, because a refused launch never runs
and a later synchronize would not report it.

Nothing here runs when the module is imported: the CPU tests import it on
machines without ``nvcc``. There, :func:`build` raises a ``RuntimeError``
that names ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("paged_decode", "paged_prefill")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argument types of its C entries (one per dtype suffix).
_SIGNATURES = {
    # q, k_pages, v_pages, block_tables, lengths, out,
    # B, Hkv, group, D, bs, T, scale, stream
    "paged_decode": (_P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k_pages, v_pages, block_table, out,
    # C, Hkv, group, D, bs, offset, scale, stream
    "paged_prefill": (_P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _F, _P),
}
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``, from PATH or the CUDA toolkit's usual home."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in "
        f"{candidate.parent}): the port's CUDA kernels in {CSRC} are "
        "compiled with nvcc on first use, so they need the CUDA toolkit")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes started together; returns {name: compiler log}. Raises
    ``RuntimeError`` with the compiler's output if a build fails."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        if name not in _SIGNATURES:
            raise ValueError(f"unknown kernel {name!r}; know {KERNELS}")
        out = _library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _library_path(name)
    if not path.exists():
        build([name])
    lib = ctypes.CDLL(str(path))
    for suffix in _SUFFIX.values():
        fn = getattr(lib, f"tk8s_{name}_{suffix}")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def _entry(name: str, dtype: torch.dtype):
    return getattr(library(name), f"tk8s_{name}_{_SUFFIX[dtype]}")


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({torch.cuda.get_device_name()})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_operands(what: str, q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor,
                    ints: Tuple[torch.Tensor, ...]) -> Tuple[int, int, int]:
    """Device, dtype, contiguity and page-shape checks shared by both
    kernels; returns (Hkv, bs, D) of the page pool."""
    if not q.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, "
                         f"got q on {q.device}")
    _require(q.dtype in _SUFFIX,
             f"{what}: dtype must be bfloat16 or float32, got {q.dtype}")
    for t, nm in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        _require(t.device == q.device and t.dtype == q.dtype,
                 f"{what}: {nm} must be {q.dtype} on {q.device}, got "
                 f"{t.dtype} on {t.device}")
        _require(t.is_contiguous(), f"{what}: {nm} must be contiguous")
        _require(t.dim() == 4, f"{what}: {nm} must be [N, Hkv, bs, D]")
    _require(k_pages.shape == v_pages.shape,
             f"{what}: k_pages {tuple(k_pages.shape)} != v_pages "
             f"{tuple(v_pages.shape)}")
    _require(q.is_contiguous(), f"{what}: q must be contiguous")
    for t in ints:
        _require(t.device == q.device and t.dtype == torch.int32
                 and t.is_contiguous(),
                 f"{what}: block tables and lengths must be contiguous "
                 f"int32 on {q.device}")
    _, hkv, bs, d = k_pages.shape
    # Pages are staged with 16-byte copies: rows and bases 16-byte aligned.
    _require(d % 8 == 0 and d <= 128,
             f"{what}: head_dim {d} must be a multiple of 8, at most 128")
    _require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
             f"{what}: page pools must start 16-byte aligned")
    return hkv, bs, d


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/paged_decode.cu`` on the current stream:
    [B, 1, Hq, D] in q's dtype."""
    hkv, bs, d = _check_operands("paged_decode", q, k_pages, v_pages,
                                 (block_tables, lengths))
    b, s, hq, dq = q.shape
    _require(s == 1 and dq == d, f"paged_decode: q must be [B, 1, Hq, {d}], "
             f"got {tuple(q.shape)}")
    _require(hq % hkv == 0 and hq // hkv <= 8,
             f"paged_decode: Hq {hq} must be Hkv {hkv} times a group <= 8")
    _require(bs <= 32 and 128 % bs == 0,
             f"paged_decode: block size {bs} must divide 128 and be <= 32")
    _require(block_tables.dim() == 2 and block_tables.shape[0] == b
             and lengths.shape == (b,),
             f"paged_decode: block_tables [B, T] and lengths [B] for B={b}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    rc = _entry("paged_decode", q.dtype)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hkv, hq // hkv, d, bs, block_tables.shape[1], d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(rc, "paged_decode")
    return out


def paged_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, block_table: torch.Tensor,
                  offset: int) -> torch.Tensor:
    """Launch ``csrc/paged_prefill.cu`` on the current stream:
    [1, C, Hq, D] in q's dtype."""
    hkv, bs, d = _check_operands("paged_prefill", q, k_pages, v_pages,
                                 (block_table,))
    one, c, hq, dq = q.shape
    _require(one == 1 and dq == d and c >= 1,
             f"paged_prefill: q must be [1, C, Hq, {d}], got {tuple(q.shape)}")
    _require(hq % hkv == 0, f"paged_prefill: Hq {hq} not a multiple of "
             f"Hkv {hkv}")
    _require(bs in (4, 8, 16, 32),
             f"paged_prefill: block size {bs} must be 4, 8, 16 or 32")
    _require(block_table.dim() == 1, "paged_prefill: block_table is [T]")
    offset = int(offset)
    _require(0 <= offset and offset + c <= block_table.shape[0] * bs,
             f"paged_prefill: window [{offset}, {offset + c}) outside the "
             f"table's {block_table.shape[0] * bs} slots")
    out = torch.empty_like(q)
    rc = _entry("paged_prefill", q.dtype)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), out.data_ptr(),
        c, hkv, hq // hkv, d, bs, offset, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(rc, "paged_prefill")
    return out

