"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, on the machine with the card, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``triton_kubernetes_tpu_torch/_build/`` (listed in ``.gitignore``),
with ``-DTK8S_PAGED_SPAN=`` :data:`PAGED_SPAN_KEYS`;
``-Xptxas -v`` puts each kernel's registers and spills in the build log.
A source listed in :data:`UNITS` is compiled as that many translation
units (``-c -DTK8S_UNIT=i``, each holding a share of its C entries) that
build in parallel with everything else, then linked into one library.
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

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# Keys of one span of the decode and verify kernels' tensor-core design:
# the key axis is cut into spans of this many keys fixed by position, one
# block a span, their softmax states merged in order. Defined here once;
# the kernels get it as -DTK8S_PAGED_SPAN, and the plain version
# (``ops.paged_attention``) restarts its running max at every span.
PAGED_SPAN_KEYS = 256
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DTK8S_PAGED_SPAN={PAGED_SPAN_KEYS}")
KERNELS = ("paged_decode", "paged_verify", "paged_prefill", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "decode_gemm", "rms_norm",
           "quantize_rows")
# Sources compiled as several translation units in parallel (their C
# entries split by ``TK8S_UNIT``): the decode GEMM's five entry groups,
# and the prefill and verify kernels' three page kinds, whose template
# instantiations take far longer to compile than any other source.
UNITS = {"decode_gemm": 5, "paged_prefill": 3, "paged_verify": 3}
PAGED_KERNELS = ("paged_decode", "paged_verify", "paged_prefill")
# What a serving engine launches: the paged kernels, the row-invariant
# GEMM and norm, and W8A8's quantizer.
SERVE_KERNELS = PAGED_KERNELS + ("decode_gemm", "rms_norm", "quantize_rows")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# Strides (batch, seq, head) of one [B, S, H, D] operand, in elements.
_STRIDES = (_L, _L, _L)
# name -> argument types of its C entries (one per dtype suffix).
_SIGNATURES = {
    # q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, out,
    # workspace, counters, B, Hkv, group, D, bs, T, scale, variant, stream
    "paged_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, out,
    # workspace, counters, B, S, Hkv, group, D, bs, T, scale, variant,
    # stream
    "paged_verify": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # q, k_pages, v_pages, k_scale, v_scale, block_table, out,
    # C, Hkv, group, D, bs, T, offset, scale, variant, stream
    "paged_prefill": (_P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, out, lse, B, S, Hq, Hkv, D, strides of q, k, v, scale,
    # variant, stream
    "flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  *_STRIDES * 3, _F, _I, _P),
    # q, k, v, dout, lse, dvec, dq, B, S, Hq, Hkv, D,
    # strides of q, k, v, dout, scale, variant, stream
    "flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     *_STRIDES * 4, _F, _I, _P),
    # q, k, v, dout, lse, dvec, dk, dv, B, S, Hq, Hkv, D,
    # strides of q, k, v, dout, scale, variant, stream
    "flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      *_STRIDES * 4, _F, _I, _P),
    # x, w0, w1, w2, y0, y1, y2, N0, N1, N2, count, M, K, tile_n, splits,
    # workspace, counters, stream (suffix: x's and w's dtype, then y's)
    "decode_gemm": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _I, _P, _P, _P),
    # x, scale, y, M, D, eps, stream
    "rms_norm": (_P, _P, _P, _I, _I, _F, _P),
    # x, xq, x_scale, M, K, stream (suffix: x's dtype, then xq's)
    "quantize_rows": (_P, _P, _P, _I, _I, _P),
}
# decode_gemm's W8A8 entries, tk8s_decode_gemm_<W8A8_SUFFIXES value>: xq,
# x_scale, w0, w1, w2, scale0, scale1, scale2, y0, y1, y2, N0, N1, N2,
# count, M, K, tile_n, splits, workspace, counters, stream.
_W8A8_SIGNATURE = (_P,) * 11 + (_I,) * 8 + (_P,) * 3
# decode_gemm's bit probe, tk8s_gemm_probe_<GEMM_PROBE_KINDS value>: a, b,
# c, d_mma, d_wgmma, steps, stream.
_PROBE_SIGNATURE = (_P,) * 5 + (_I, _P)
# C entries a library holds beside tk8s_<name>_<suffix>, one per suffix:
# {name: {entry stem: argument types}}.
_MORE_ENTRIES = {
    # x, delta (null: the entry above), scale, h, y, M, D, eps, stream
    "rms_norm": {"add_rms_norm": (_P, _P, _P, _P, _P, _I, _I, _F, _P)},
    # gate, up, xq, x_scale, M, F, stream
    "quantize_rows": {"swiglu_quant": (_P, _P, _P, _P, _I, _I, _P)},
}
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# Page dtypes of quantized pools -> the suffix the paged kernels' entries
# append to q's (``tk8s_paged_decode_bf16_int8``); also the quantized
# dtype of kernel A's entries.
_PAGE_SUFFIX = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
# Suffixes of kernel A's entries: the input's dtype, then the quantized
# one (``tk8s_quantize_rows_bf16_int8``).
_QUANT_SUFFIXES = tuple(f"{x}_{q}" for x in _SUFFIX.values()
                        for q in _PAGE_SUFFIX.values())
# rms_norm.cu's entries with kernel A as the epilogue, one per suffix of
# _QUANT_SUFFIXES: x, delta (null: the delta-null norm), scale, h (null
# with delta), xq, x_scale, M, D, eps, stream.
_NORM_QUANT_SIGNATURE = (_P,) * 6 + (_I, _I, _F, _P)
# quantize_rows.cu's SiLU probe, tk8s_silu_probe_bf16: x, y, n, stream.
_SILU_PROBE_SIGNATURE = (_P, _P, _I, _P)
# Most query rows (S * group) one verify block takes.
MAX_VERIFY_ROWS = 32

# The two designs of each paged kernel, by the code their C entries take
# as ``variant``: "tensor_core", mma.sync on bf16 operands -- for decode
# and verify the span walk (the key axis split into spans of
# PAGED_SPAN_KEYS, one launch that merges them), for prefill 64-row GQA
# tiles over a ring of 64-key stages; "cuda_core", f32 FMAs on the CUDA
# cores -- f32 queries, and shapes the first is not built for.
PAGED_VARIANTS = {"tensor_core": 1, "cuda_core": 0}
# The (q dtype, page dtype, block size, head_dim) the tensor-core designs
# take. Decode and verify look up the same entry for the same pool and
# queries, which is what keeps a verify row bitwise the decode row; the
# prefill kernel reads the same table. The choice is by shape alone:
# nothing is tried and retried.
PAGED_TENSOR_CORE = frozenset(
    (torch.bfloat16, pages, bs, d)
    for pages in (torch.bfloat16, torch.int8, torch.float8_e4m3fn)
    for bs in (16, 32) for d in (64, 128))


def paged_variant(dtype: torch.dtype, page_dtype: torch.dtype, bs: int,
                  head_dim: int) -> str:
    """Name (key of :data:`PAGED_VARIANTS`) of the design that the
    decode, verify and prefill kernels run for queries of ``dtype`` over
    pages of ``page_dtype`` (q's dtype on unquantized pools), block size
    ``bs`` and this head width."""
    return ("tensor_core"
            if (dtype, page_dtype, bs, head_dim) in PAGED_TENSOR_CORE
            else "cuda_core")


def paged_span(dtype: torch.dtype, page_dtype: torch.dtype, bs: int,
               head_dim: int) -> Optional[int]:
    """Keys of a span of the design :func:`paged_variant` picks (its plain
    version restarts the running max there), or None: one span."""
    return (PAGED_SPAN_KEYS if paged_variant(dtype, page_dtype, bs,
                                             head_dim) == "tensor_core"
            else None)


# Rows a decode_gemm block of the mma.sync kernel takes: a launch of at
# most this many rows reads each weight once from HBM; a larger M runs
# the wgmma kernel (GEMM_WGMMA_ROWS below).
MAX_GEMM_ROWS = 64
# Most products of one input one decode_gemm launch takes (wq, wk, wv).
MAX_GEMM_PROBLEMS = 3
# (operand dtype, output dtype) -> suffix of decode_gemm's C entry: bf16
# operands with bf16 out (projections) or f32 out (the lm head), and f32
# operands (a model served in f32).
GEMM_SUFFIXES = {(torch.bfloat16, torch.bfloat16): "bf16_bf16",
                 (torch.bfloat16, torch.float32): "bf16_f32",
                 (torch.float32, torch.float32): "f32_f32"}
# (operand dtype, output dtype) -> suffix of decode_gemm's W8A8 entries:
# int8 or fp8 operands (the activation quantized per row, the weight per
# column, stored [N, K]), bf16 or f32 out.
W8A8_SUFFIXES = {(torch.int8, torch.bfloat16): "s8_bf16",
                 (torch.int8, torch.float32): "s8_f32",
                 (torch.float8_e4m3fn, torch.bfloat16): "e4m3_bf16",
                 (torch.float8_e4m3fn, torch.float32): "e4m3_f32"}
# Rows past which a decode_gemm launch of bf16 or int8 operands runs the
# wgmma kernel (blocks of two warpgroups of 64 rows each) in place of the
# mma.sync one. A bf16 row is bitwise the row of a launch of at most
# MAX_GEMM_ROWS rows -- the same chains of k steps added in the same
# order -- because a wgmma k step rounds as an mma.sync step does (the
# bit probe, ``gemm_probe``, checks that on the card); int8 sums are
# exact. fp8 launches of every M run the wgmma kernel, its operands
# converted to f16: an e4m3 wgmma k step neither rounds as mma.sync's nor
# keeps f32's bits. f32 operands keep the CUDA-core kernel at every M.
GEMM_WGMMA_ROWS = MAX_GEMM_ROWS
# Operand dtype -> kind suffix of the bit probe's C entries.
GEMM_PROBE_KINDS = {torch.bfloat16: "bf16", torch.int8: "s8",
                    torch.float8_e4m3fn: "e4m3"}


def gemm_wgmma(dtype: torch.dtype, m: int) -> bool:
    """Whether a decode_gemm launch of ``m`` rows of ``dtype`` operands
    runs the wgmma kernel (as the C entries choose)."""
    return dtype == torch.float8_e4m3fn or (dtype != torch.float32
                                            and m > GEMM_WGMMA_ROWS)


# decode_gemm's tiles and K split, chosen by the group's shape alone
# (``scripts/bench_decode_gemm.py`` timed the choices on an H100; PERF.md,
# Findings). A block takes GEMM_TILE_N or, for groups at least
# GEMM_WIDE_TILES tiles of that width, GEMM_TILE_WIDE output columns (the
# lm head and w3+w1: fewer, longer blocks and half the x reads per weight
# byte), and walks K in tiles of GEMM_TILE_K. K is split only until the
# grid holds GEMM_BLOCKS_WANTED blocks (about three in four of the H100's
# 132 SMs): every split adds a merge at the end of each block, which cost
# more than the added blocks gained past that. Each range keeps at least
# GEMM_MIN_RANGE_TILES k tiles, so the block's cp.async ring still fills.
GEMM_TILE_N = 64
GEMM_TILE_WIDE = 128
GEMM_WIDE_TILES = 264
GEMM_TILE_K = 64
GEMM_BLOCKS_WANTED = 96
GEMM_MIN_RANGE_TILES = 8
GEMM_MAX_SPLITS = 8


def gemm_tile(n_total: int) -> int:
    """Output columns a ``decode_gemm`` block takes for a group of products
    whose widths sum to ``n_total``. Which columns a block takes changes
    no bit of a row: each column's sum is the same chain either way."""
    return (GEMM_TILE_WIDE if -(-n_total // GEMM_TILE_N) >= GEMM_WIDE_TILES
            else GEMM_TILE_N)


def gemm_splits(n_total: int, k: int) -> int:
    """How many contiguous ranges of whole k tiles ``decode_gemm`` cuts K
    into for a group of products whose widths sum to ``n_total``, reduced
    over ``k``. A function of the shape alone, never of the row count: a
    row's sum is its ranges' partial sums added in range order, so the
    same S for every M is what keeps a verify row bitwise the decode row.
    1 where the group's tiles already give GEMM_BLOCKS_WANTED blocks
    (wq+wk+wv, w3+w1, the lm head), or where K is too short to cut."""
    tiles = max(1, -(-n_total // gemm_tile(n_total)))
    k_tiles = -(-k // GEMM_TILE_K)
    return max(1, min(-(-GEMM_BLOCKS_WANTED // tiles),
                      k_tiles // GEMM_MIN_RANGE_TILES, GEMM_MAX_SPLITS))


class FlashVariant(NamedTuple):
    """One of the two hand-written designs of each flash kernel
    (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``): the code the C
    entries take as ``variant``, and the forward's key-tile width, which
    the plain forward must be given to repeat the kernel's arithmetic (p
    is rounded against the running max of its key tile; the backward
    kernels' tiles change only the order of f32 sums)."""
    code: int
    block_k: int


# "tensor_core": wgmma on 128-byte-swizzled bf16 tiles, key tiles of 128.
# "cuda_core": f32 FMAs on the CUDA cores, key tiles of 64 -- every f32
# operand (the tensor cores have no full-f32 product) and bf16 at head
# widths the first is not instantiated for.
FLASH_VARIANTS = {"tensor_core": FlashVariant(code=1, block_k=128),
                  "cuda_core": FlashVariant(code=0, block_k=64)}
# The (dtype, head_dim) pairs that go to the tensor cores; everything else
# the kernels take goes to the CUDA cores. The choice is by shape alone:
# nothing is tried and retried.
FLASH_TENSOR_CORE = frozenset({(torch.bfloat16, 64), (torch.bfloat16, 128)})


def flash_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Name (key of :data:`FLASH_VARIANTS`) of the design that all three
    flash kernels -- ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``
    -- run for this dtype and head width."""
    return ("tensor_core" if (dtype, head_dim) in FLASH_TENSOR_CORE
            else "cuda_core")

_loaded: Dict[str, ctypes.CDLL] = {}
# Serving replicas in one process run their engine loops on threads of their
# own: one builds and binds a library while the others wait for it.
_load_lock = threading.Lock()


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
    digest.update(repr(sorted(UNITS.items())).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _run(cmd) -> Tuple[int, str, float]:
    """A compiler command's exit code, output and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, every ``nvcc``
    process (each translation unit of :data:`UNITS`) started together;
    returns {name: compiler log}, each log ending in a line ``built NAME
    in S s`` (the longest unit's seconds, and the link's). Raises
    ``RuntimeError`` with the compiler's output if a build fails."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    unit_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
    jobs = {}
    for name in names:
        if name not in _SIGNATURES:
            raise ValueError(f"unknown kernel {name!r}; know {KERNELS}")
        out = _library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        src = str(CSRC / f"{name}.cu")
        if name in UNITS:
            objs = [f"{tmp}.{i}.o" for i in range(UNITS[name])]
            cmds = [[nvcc, *unit_flags, f"-DTK8S_UNIT={i}", "-o", obj, src]
                    for i, obj in enumerate(objs)]
        else:
            objs = []
            cmds = [[nvcc, *NVCC_FLAGS, "-o", tmp, src]]
        jobs[name] = (tmp, out, objs, cmds)
    flat = [(name, cmd) for name, (*_, cmds) in jobs.items() for cmd in cmds]
    with concurrent.futures.ThreadPoolExecutor(max(1, len(flat))) as pool:
        done = list(pool.map(lambda job: _run(job[1]), flat))
    logs: Dict[str, str] = {}
    failed = []
    for name, (tmp, out, objs, _) in jobs.items():
        mine = [r for (n, _), r in zip(flat, done) if n == name]
        log = "".join(text for _, text, _ in mine)
        seconds = max(s for _, _, s in mine)
        rc = max(code for code, _, _ in mine)
        if rc == 0 and objs:
            rc, text, s = _run([nvcc, *NVCC_FLAGS[:2], "-shared",
                                "-o", tmp, *objs])
            log += text
            seconds += s
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
        logs[name] = log + f"built {name} in {seconds:.1f} s\n"
        if rc != 0:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {rc}):\n{log}")
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
    with _load_lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = _library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        bind(lib, name)
        _loaded[name] = lib
    return lib


def bind(lib: ctypes.CDLL, name: str) -> None:
    """Set the argument and return types of every C entry of the kernel
    library ``name`` (a build of ``csrc/<name>.cu``, also an emulated one)."""
    stems = {name: _SIGNATURES[name], **_MORE_ENTRIES.get(name, {})}
    entries = [(f"tk8s_{stem}_{suffix}", argtypes)
               for stem, argtypes in stems.items()
               for suffix in _entry_suffixes(name)]
    if name == "rms_norm":
        entries += [(f"tk8s_add_rms_norm_quant_{suffix}",
                     _NORM_QUANT_SIGNATURE) for suffix in _QUANT_SUFFIXES]
    if name == "quantize_rows":
        entries.append(("tk8s_silu_probe_bf16", _SILU_PROBE_SIGNATURE))
    if name == "decode_gemm":
        entries += [(f"tk8s_decode_gemm_{suffix}", _W8A8_SIGNATURE)
                    for suffix in W8A8_SUFFIXES.values()]
        entries += [(f"tk8s_gemm_probe_{kind}", _PROBE_SIGNATURE)
                    for kind in (*GEMM_PROBE_KINDS.values(), "e4m3_f16")]
    for entry, argtypes in entries:
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def _entry_suffixes(name: str):
    """Suffixes of a kernel's C entries: one per q dtype, and for the paged
    kernels one more per (q dtype, quantized page dtype) pair."""
    if name == "decode_gemm":
        return list(GEMM_SUFFIXES.values())
    if name == "quantize_rows":
        return list(_QUANT_SUFFIXES)
    out = list(_SUFFIX.values())
    if name in PAGED_KERNELS:
        out += [f"{q}_{p}" for q in _SUFFIX.values()
                for p in _PAGE_SUFFIX.values()]
    return out


def _entry(name: str, dtype: torch.dtype,
           page_dtype: Optional[torch.dtype] = None):
    suffix = _SUFFIX[dtype]
    if page_dtype is not None and page_dtype != dtype:
        suffix += "_" + _PAGE_SUFFIX[page_dtype]
    return getattr(library(name), f"tk8s_{name}_{suffix}")


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({torch.cuda.get_device_name()})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_operands(what: str, q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, ints: Tuple[torch.Tensor, ...],
                    k_scale: Optional[torch.Tensor],
                    v_scale: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    """Device, dtype, contiguity and page-shape checks shared by the paged
    kernels; returns (Hkv, bs, D) of the page pool. Pages are q's dtype, or
    int8/float8_e4m3fn with both layer scales ([N, Hkv] f32) passed."""
    if not q.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, "
                         f"got q on {q.device}")
    _require(q.dtype in _SUFFIX,
             f"{what}: dtype must be bfloat16 or float32, got {q.dtype}")
    _require((k_scale is None) == (v_scale is None),
             f"{what}: pass both k_scale and v_scale, or neither")
    page_dtype = q.dtype if k_scale is None else k_pages.dtype
    if k_scale is not None:
        _require(page_dtype in _PAGE_SUFFIX,
                 f"{what}: scales come with int8 or float8_e4m3fn pages, "
                 f"got {page_dtype} pages")
    for t, nm in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        _require(t.device == q.device and t.dtype == page_dtype,
                 f"{what}: {nm} must be {page_dtype} on {q.device} (8-bit "
                 f"pages need their scales), got {t.dtype} on {t.device}")
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
    n, hkv, bs, d = k_pages.shape
    if k_scale is not None:
        for t in (k_scale, v_scale):
            _require(t.device == q.device and t.dtype == torch.float32
                     and t.is_contiguous() and t.shape == (n, hkv),
                     f"{what}: scales must be contiguous float32 [{n}, "
                     f"{hkv}] on {q.device}")
    # Pages are staged with 16-byte copies: rows and bases 16-byte aligned.
    vec = 16 // k_pages.element_size()
    _require(d % vec == 0 and d <= 128,
             f"{what}: head_dim {d} must be a multiple of {vec}, at most 128")
    _require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
             f"{what}: page pools must start 16-byte aligned")
    return hkv, bs, d


def _scale_ptrs(k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor]):
    if k_scale is None:
        return None, None
    return k_scale.data_ptr(), v_scale.data_ptr()


# Arrival counters of the span walk, one int32 per (sequence, KV head), a
# buffer per device, zeroed once when it is made: the last block of a
# (sequence, head) sets its counter back to 0, so no call zeroes them (that
# would be one more launch a call). Calls that share them must not run at
# once: the decode and verify kernels go on one stream at a time.
_span_counters: Dict[torch.device, torch.Tensor] = {}


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _span_buffers(q: torch.Tensor, page_dtype: torch.dtype, b: int,
                  hkv: int, rows: int, d: int, bs: int, tw: int):
    """(variant code, workspace, counters) of one decode or verify launch.
    The span walk gets an f32 workspace for its spans' partial (acc, m, l)
    of every row, [B, Hkv, spans, rows, D + 2], made here with
    ``torch.empty`` (the kernel allocates nothing). The caller holds both
    tensors until the launch is enqueued: freed before it, their memory
    could go to another thread's tensor ahead of the launch (two serving
    engines in one process)."""
    variant = paged_variant(q.dtype, page_dtype, bs, d)
    if variant != "tensor_core":
        return PAGED_VARIANTS[variant], None, None
    spans = max(1, -(-tw * bs // PAGED_SPAN_KEYS))
    ws = torch.empty(b * hkv * spans * rows * (d + 2), dtype=torch.float32,
                     device=q.device)
    counters = _span_counters.get(q.device)
    if counters is None or counters.numel() < b * hkv:
        counters = torch.zeros(max(b * hkv, 1024), dtype=torch.int32,
                               device=q.device)
        _span_counters[q.device] = counters
    return PAGED_VARIANTS[variant], ws, counters


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/paged_decode.cu`` on the current stream, the design
    :func:`paged_variant` names: [B, 1, Hq, D] in q's dtype."""
    hkv, bs, d = _check_operands("paged_decode", q, k_pages, v_pages,
                                 (block_tables, lengths), k_scale, v_scale)
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
    tw = block_tables.shape[1]
    variant, ws, counters = _span_buffers(q, k_pages.dtype, b, hkv,
                                          hq // hkv, d, bs, tw)
    rc = _entry("paged_decode", q.dtype, k_pages.dtype)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *_scale_ptrs(k_scale, v_scale),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _ptr(ws), _ptr(counters), b, hkv, hq // hkv, d, bs, tw, d ** -0.5,
        variant,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(rc, "paged_decode")
    return out


def paged_verify(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/paged_verify.cu`` on the current stream, the design
    :func:`paged_variant` names (the decode kernel's for the same pool and
    queries): [B, S, Hq, D] in q's dtype; S * group rows per block, at
    most :data:`MAX_VERIFY_ROWS`."""
    hkv, bs, d = _check_operands("paged_verify", q, k_pages, v_pages,
                                 (block_tables, lengths), k_scale, v_scale)
    b, s, hq, dq = q.shape
    _require(s >= 1 and dq == d, f"paged_verify: q must be [B, S, Hq, {d}],"
             f" got {tuple(q.shape)}")
    _require(hq % hkv == 0 and s * (hq // hkv) <= MAX_VERIFY_ROWS,
             f"paged_verify: Hq {hq} must be Hkv {hkv} times a group with "
             f"S * group <= {MAX_VERIFY_ROWS} rows, got S={s}")
    _require(bs <= 32 and 128 % bs == 0,
             f"paged_verify: block size {bs} must divide 128 and be <= 32")
    _require(block_tables.dim() == 2 and block_tables.shape[0] == b
             and lengths.shape == (b,),
             f"paged_verify: block_tables [B, T] and lengths [B] for B={b}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    tw = block_tables.shape[1]
    variant, ws, counters = _span_buffers(q, k_pages.dtype, b, hkv,
                                          s * (hq // hkv), d, bs, tw)
    rc = _entry("paged_verify", q.dtype, k_pages.dtype)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *_scale_ptrs(k_scale, v_scale),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _ptr(ws), _ptr(counters), b, s, hkv, hq // hkv, d, bs, tw,
        d ** -0.5, variant,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(rc, "paged_verify")
    return out


def paged_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, block_table: torch.Tensor,
                  offset: int, k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/paged_prefill.cu`` on the current stream, the design
    :func:`paged_variant` names: [1, C, Hq, D] in q's dtype."""
    hkv, bs, d = _check_operands("paged_prefill", q, k_pages, v_pages,
                                 (block_table,), k_scale, v_scale)
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
    variant = paged_variant(q.dtype, k_pages.dtype, bs, d)
    rc = _entry("paged_prefill", q.dtype, k_pages.dtype)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        *_scale_ptrs(k_scale, v_scale), block_table.data_ptr(),
        out.data_ptr(), c, hkv, hq // hkv, d, bs, block_table.shape[0],
        offset, d ** -0.5, PAGED_VARIANTS[variant],
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(rc, "paged_prefill")
    return out


def _check_flash(what: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *more: torch.Tensor
                 ) -> Tuple[int, int, int, int, int]:
    """Device, dtype, shape and layout checks shared by the three flash
    kernels; returns (B, S, Hq, Hkv, D). The kernels read every operand
    through its (batch, seq, head) strides with 16-byte copies, so the last
    dimension must be unit-stride and every row 16-byte aligned. Outputs
    and the f32 row statistics are contiguous."""
    if not q.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, "
                         f"got q on {q.device}")
    _require(q.dtype in _SUFFIX,
             f"{what}: dtype must be bfloat16 or float32, got {q.dtype}")
    b, s, hq, d = q.shape
    _require(k.dim() == 4 and k.shape[0] == b and k.shape[1] == s
             and k.shape[3] == d and v.shape == k.shape,
             f"{what}: k, v must be [{b}, {s}, Hkv, {d}], got "
             f"{tuple(k.shape)} and {tuple(v.shape)}")
    hkv = k.shape[2]
    _require(hkv >= 1 and hq % hkv == 0,
             f"{what}: Hq {hq} not a multiple of Hkv {hkv}")
    _require(d % 8 == 0 and d <= 128,
             f"{what}: head_dim {d} must be a multiple of 8, at most 128")
    _require(b >= 1 and s >= 1, f"{what}: empty batch or sequence")
    vec = 16 // q.element_size()
    for t, nm in ((q, "q"), (k, "k"), (v, "v")) + tuple(
            (t, f"operand {i}") for i, t in enumerate(more)):
        _require(t.device == q.device and t.dtype == q.dtype,
                 f"{what}: {nm} must be {q.dtype} on {q.device}, got "
                 f"{t.dtype} on {t.device}")
        # A size-1 dim's stride is never multiplied by a nonzero index.
        _require(t.stride(-1) == 1 and all(
            st % vec == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1])
            if n > 1),
                 f"{what}: {nm} needs a unit last stride and 16-byte "
                 f"aligned rows, got strides {t.stride()}")
        _require(t.data_ptr() % 16 == 0,
                 f"{what}: {nm} must start 16-byte aligned")
    return b, s, hq, hkv, d


def _row_stats(what: str, t: torch.Tensor, b: int, hq: int, s: int,
               device: torch.device) -> None:
    _require(t.device == device and t.dtype == torch.float32
             and t.is_contiguous() and t.shape == (b, hq, s),
             f"{what}: lse and D must be contiguous float32 [{b}, {hq}, "
             f"{s}] on {device}")


def _strides(*ts: torch.Tensor):
    return [st for t in ts for st in t.stride()[:3]]


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on the current stream, the design
    :func:`flash_variant` names for (dtype, D): (out [B, S, Hq, D] in q's
    dtype, lse [B, Hq, S] f32)."""
    b, s, hq, hkv, d = _check_flash("flash_fwd", q, k, v)
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    rc = _entry("flash_fwd", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, hq, hkv, d, *_strides(q, k, v), d ** -0.5,
        FLASH_VARIANTS[flash_variant(q.dtype, d)].code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(rc, "flash_fwd")
    return out, lse


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dout: torch.Tensor, lse: torch.Tensor, dvec: torch.Tensor
                 ) -> torch.Tensor:
    """Launch ``csrc/flash_bwd_dq.cu`` on the current stream, the design
    :func:`flash_variant` names for (dtype, D): dq [B, S, Hq, D] in q's
    dtype."""
    b, s, hq, hkv, d = _check_flash("flash_bwd_dq", q, k, v, dout)
    _require(dout.shape == q.shape, "flash_bwd_dq: dout must match q")
    for t in (lse, dvec):
        _row_stats("flash_bwd_dq", t, b, hq, s, q.device)
    dq = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    rc = _entry("flash_bwd_dq", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), b, s, hq, hkv, d,
        *_strides(q, k, v, dout), d ** -0.5,
        FLASH_VARIANTS[flash_variant(q.dtype, d)].code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(rc, "flash_bwd_dq")
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, lse: torch.Tensor, dvec: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_bwd_dkv.cu`` on the current stream, the design
    :func:`flash_variant` names for (dtype, D): (dk, dv), each
    [B, S, Hkv, D] in k's dtype, summed over each KV head's group."""
    b, s, hq, hkv, d = _check_flash("flash_bwd_dkv", q, k, v, dout)
    _require(dout.shape == q.shape, "flash_bwd_dkv: dout must match q")
    for t in (lse, dvec):
        _row_stats("flash_bwd_dkv", t, b, hq, s, q.device)
    dk = torch.empty((b, s, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    rc = _entry("flash_bwd_dkv", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, s, hq, hkv, d, *_strides(q, k, v, dout), d ** -0.5,
        FLASH_VARIANTS[flash_variant(q.dtype, d)].code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check(rc, "flash_bwd_dkv")
    return dk, dv


# Arrival counters of decode_gemm's K split, one int32 per output tile of
# a launch, a buffer per device, zeroed once when it is made: the last
# block of a tile sets its counter back to 0, as the span walk's do. Calls
# that share them must not run at once: one stream at a time.
_gemm_counters: Dict[torch.device, torch.Tensor] = {}


def decode_gemm(x: torch.Tensor, ws: Sequence[torch.Tensor],
                ys: Sequence[torch.Tensor]) -> None:
    """Launch ``csrc/decode_gemm.cu`` once on the current stream for up to
    :data:`MAX_GEMM_PROBLEMS` products of one input: ys[p] [M, N_p] =
    x [M, K] @ ws[p] [K, N_p] with f32 sums, for M >= 1 (past
    :data:`GEMM_WGMMA_ROWS` bf16 runs the wgmma kernel) and the dtypes of
    :data:`GEMM_SUFFIXES` (every y of one dtype). A block takes
    :func:`gemm_tile` columns and K is split into :func:`gemm_splits`
    ranges, both chosen by the group's widths and K alone, so each output
    row's bits do not depend on M."""
    if not x.is_cuda:
        raise ValueError(f"decode_gemm: the CUDA kernel takes CUDA tensors, "
                         f"got x on {x.device}")
    ws, ys = list(ws), list(ys)
    _require(1 <= len(ws) <= MAX_GEMM_PROBLEMS and len(ys) == len(ws),
             f"decode_gemm: 1-{MAX_GEMM_PROBLEMS} weights and as many "
             f"outputs a launch, got {len(ws)} and {len(ys)}")
    suffix = GEMM_SUFFIXES.get((x.dtype, ys[0].dtype))
    _require(suffix is not None and x.dim() == 2,
             f"decode_gemm: x [M, K] bfloat16 with bfloat16 or float32 y, or "
             f"all float32; got x {x.dtype} {tuple(x.shape)} and y "
             f"{ys[0].dtype}")
    m, k = x.shape
    _require(m >= 1, "decode_gemm: x must hold a row")
    _require(k % 8 == 0, f"decode_gemm: K {k} must be a multiple of 8 (rows "
             f"are copied in 16-byte pieces)")
    _require(x.is_contiguous() and x.data_ptr() % 16 == 0,
             "decode_gemm: x must be contiguous and start 16-byte aligned")
    for w, y in zip(ws, ys):
        _require(w.dtype == x.dtype and y.dtype == ys[0].dtype
                 and w.device == x.device and y.device == x.device,
                 f"decode_gemm: every w {x.dtype} and every y {ys[0].dtype} "
                 f"on {x.device}, got {w.dtype} and {y.dtype}")
        _require(w.dim() == 2 and w.shape[0] == k
                 and y.shape == (m, w.shape[1]),
                 f"decode_gemm: w [{k}, N] and y [{m}, N] for x "
                 f"{tuple(x.shape)}, got {tuple(w.shape)} and "
                 f"{tuple(y.shape)}")
        _require(w.is_contiguous() and y.is_contiguous(),
                 "decode_gemm: x, w and y must be contiguous")
        _require(w.shape[1] % 8 == 0,
                 f"decode_gemm: N {w.shape[1]} must be a multiple of 8")
        _require(w.data_ptr() % 16 == 0,
                 "decode_gemm: w must start 16-byte aligned")
    ns = [w.shape[1] for w in ws]
    tile_n, splits, workspace, counters = _gemm_split(x.device, ns, m, k,
                                                      torch.float32)
    pad = MAX_GEMM_PROBLEMS - len(ws)
    rc = getattr(library("decode_gemm"), f"tk8s_decode_gemm_{suffix}")(
        x.data_ptr(), *[w.data_ptr() for w in ws], *[None] * pad,
        *[y.data_ptr() for y in ys], *[None] * pad, *ns, *[0] * pad,
        len(ws), m, k, tile_n, splits,
        _ptr(workspace), _ptr(counters),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "decode_gemm")


def _gemm_split(device: torch.device, ns: Sequence[int], m: int, k: int,
                partial: torch.dtype):
    """(tile width, S, workspace, counters) of one decode_gemm
    launch of widths ``ns`` and M rows: :func:`gemm_tile` and
    :func:`gemm_splits` of the shape, and for S > 1 a fresh workspace
    tensor of ``partial`` words and the device's arrival counters, one a
    (column tile, row tile) pair; the caller holds both until the launch
    is enqueued, as :func:`_span_buffers`'s."""
    tile_n, splits = gemm_tile(sum(ns)), gemm_splits(sum(ns), k)
    if splits == 1:
        return tile_n, splits, None, None
    tiles = sum(-(-n // tile_n) for n in ns) * -(-m // MAX_GEMM_ROWS)
    workspace = torch.empty(tiles * splits * min(m, MAX_GEMM_ROWS) * tile_n,
                            dtype=partial, device=device)
    buf = _gemm_counters.get(device)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
        _gemm_counters[device] = buf
    return tile_n, splits, workspace, buf


def decode_gemm_w8a8(xq: torch.Tensor, x_scale: torch.Tensor,
                     ws: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                     ys: Sequence[torch.Tensor]) -> None:
    """Launch the W8A8 entry of ``csrc/decode_gemm.cu`` once on the current
    stream for up to :data:`MAX_GEMM_PROBLEMS` products of one quantized
    input: ys[p] [M, N_p] = (xq [M, K] ws[p]^T * x_scale[m]) * scales[p][n],
    ws[p] [N_p, K] int8 (summed in int32, merged in int32) or
    float8_e4m3fn (f32), for M >= 1 (the kernel :func:`gemm_wgmma`
    names) and bf16 or f32 y. Tile and K split as :func:`decode_gemm`'s,
    by the shape."""
    if not xq.is_cuda:
        raise ValueError(f"decode_gemm_w8a8: the CUDA kernel takes CUDA "
                         f"tensors, got xq on {xq.device}")
    ws, scales, ys = list(ws), list(scales), list(ys)
    _require(1 <= len(ws) <= MAX_GEMM_PROBLEMS
             and len(ys) == len(scales) == len(ws),
             f"decode_gemm_w8a8: 1-{MAX_GEMM_PROBLEMS} weights and as many "
             f"scales and outputs a launch, got {len(ws)}, {len(scales)} "
             f"and {len(ys)}")
    suffix = W8A8_SUFFIXES.get((xq.dtype, ys[0].dtype))
    _require(suffix is not None and xq.dim() == 2,
             f"decode_gemm_w8a8: xq [M, K] int8 or float8_e4m3fn with "
             f"bfloat16 or float32 y; got xq {xq.dtype} "
             f"{tuple(xq.shape)} and y {ys[0].dtype}")
    m, k = xq.shape
    _require(m >= 1, "decode_gemm_w8a8: xq must hold a row")
    _require(k % 16 == 0, f"decode_gemm_w8a8: K {k} must be a multiple of "
             f"16 (rows are copied in 16-byte pieces)")
    _require(x_scale.dtype == torch.float32 and x_scale.shape == (m,)
             and x_scale.is_contiguous() and x_scale.device == xq.device,
             f"decode_gemm_w8a8: x_scale [{m}] float32 on {xq.device}")
    _require(xq.is_contiguous() and xq.data_ptr() % 16 == 0,
             "decode_gemm_w8a8: xq must be contiguous and start 16-byte "
             "aligned")
    for w, sc, y in zip(ws, scales, ys):
        _require(w.dtype == xq.dtype and y.dtype == ys[0].dtype
                 and sc.dtype == torch.float32
                 and all(t.device == xq.device for t in (w, sc, y)),
                 f"decode_gemm_w8a8: every w {xq.dtype}, scale float32 and "
                 f"y {ys[0].dtype} on {xq.device}, got {w.dtype}, "
                 f"{sc.dtype} and {y.dtype}")
        _require(w.dim() == 2 and w.shape[1] == k
                 and sc.shape == w.shape[:1] and y.shape == (m, w.shape[0]),
                 f"decode_gemm_w8a8: w [N, {k}], scale [N] and y [{m}, N] "
                 f"for xq {tuple(xq.shape)}, got {tuple(w.shape)}, "
                 f"{tuple(sc.shape)} and {tuple(y.shape)}")
        _require(all(t.is_contiguous() for t in (w, sc, y)),
                 "decode_gemm_w8a8: w, scale and y must be contiguous")
        _require(w.shape[0] % 8 == 0,
                 f"decode_gemm_w8a8: N {w.shape[0]} must be a multiple of 8")
        _require(w.data_ptr() % 16 == 0,
                 "decode_gemm_w8a8: w must start 16-byte aligned")
    ns = [w.shape[0] for w in ws]
    partial = torch.int32 if xq.dtype == torch.int8 else torch.float32
    tile_n, splits, workspace, counters = _gemm_split(xq.device, ns, m, k,
                                                      partial)
    pad = MAX_GEMM_PROBLEMS - len(ws)
    rc = getattr(library("decode_gemm"), f"tk8s_decode_gemm_{suffix}")(
        xq.data_ptr(), x_scale.data_ptr(), *[w.data_ptr() for w in ws],
        *[None] * pad, *[sc.data_ptr() for sc in scales], *[None] * pad,
        *[y.data_ptr() for y in ys], *[None] * pad, *ns, *[0] * pad,
        len(ws), m, k, tile_n, splits,
        _ptr(workspace), _ptr(counters),
        torch.cuda.current_stream(xq.device).cuda_stream)
    _check(rc, "decode_gemm_w8a8")


def gemm_probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               f16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """decode_gemm's bit probe: D = C + A B over K k steps by one
    warpgroup, once as a chain of mma.sync steps (the M <= 64 kernels')
    and once as a chain of wgmma steps (the M > 64 kernel's), from the
    same swizzled shared tiles. a [64, K] bf16 (K = 16 steps), int8 or
    float8_e4m3fn (K = 32 steps), 1-8 steps; b bf16 [K, 64] (the weight
    layout), 8-bit [64, K]; c [64, 64] f32 (int32 for int8). ``f16``
    (float8_e4m3fn only): the wgmma chain on the operands converted to
    f16, two k16 steps for each k32 step, as the fp8 kernel runs it.
    Returns (D by mma.sync, D by wgmma)."""
    kind = GEMM_PROBE_KINDS.get(a.dtype)
    if f16:
        _require(a.dtype == torch.float8_e4m3fn,
                 "gemm_probe: f16 converts float8_e4m3fn operands")
        kind = "e4m3_f16"
    step = 16 if a.dtype == torch.bfloat16 else 32
    acc = torch.int32 if a.dtype == torch.int8 else torch.float32
    _require(kind is not None and a.is_cuda and a.dim() == 2
             and a.shape[0] == 64 and a.shape[1] % step == 0
             and 1 <= a.shape[1] // step <= 8,
             f"gemm_probe: a [64, {step} steps] (1-8 steps) bf16, int8 or "
             f"float8_e4m3fn on the card, got {a.dtype} {tuple(a.shape)}")
    want_b = ((a.shape[1], 64) if a.dtype == torch.bfloat16
              else (64, a.shape[1]))
    _require(b.dtype == a.dtype and tuple(b.shape) == want_b
             and c.dtype == acc and tuple(c.shape) == (64, 64)
             and all(t.device == a.device and t.is_contiguous()
                     for t in (a, b, c)),
             f"gemm_probe: b {want_b} {a.dtype} and c [64, 64] {acc}")
    d_mma, d_wg = torch.empty_like(c), torch.empty_like(c)
    rc = getattr(library("decode_gemm"), f"tk8s_gemm_probe_{kind}")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), d_mma.data_ptr(),
        d_wg.data_ptr(), a.shape[1] // step,
        torch.cuda.current_stream(a.device).cuda_stream)
    _check(rc, "gemm_probe")
    return d_mma, d_wg


def _check_rows(what: str, names: str, *rows: torch.Tensor) -> Tuple[int,
                                                                   int]:
    """Device, dtype, shape, contiguity and alignment checks of kernel
    A's [M, K] inputs ``rows`` (one dtype, bf16 or f32, one shape, K a
    multiple of 8, 16-byte aligned); returns (M, K)."""
    x = rows[0]
    if not x.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"{names.split(',')[0]} on {x.device}")
    _require(x.dtype in _SUFFIX and x.dim() == 2
             and all(t.dtype == x.dtype and t.device == x.device
                     and t.shape == x.shape for t in rows),
             f"{what}: {names} [M, K] of one dtype (bfloat16 or float32) "
             f"on {x.device}, got {[(t.dtype, tuple(t.shape)) for t in rows]}")
    _require(all(t.is_contiguous() for t in rows),
             f"{what}: {names} must be contiguous")
    m, k = x.shape
    _require(m >= 1 and k >= 1, f"{what}: {names} {tuple(x.shape)} is empty")
    _require(k % 8 == 0, f"{what}: K {k} must be a multiple of 8")
    _require(all(t.data_ptr() % 16 == 0 for t in rows),
             f"{what}: {names} must start 16-byte aligned")
    return m, k


def _quant_out(what: str, m: int, k: int, dtype: torch.dtype,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A's outputs, fresh: xq [M, K] of ``dtype`` (int8 or
    float8_e4m3fn) and x_scale [M] f32."""
    _require(dtype in _PAGE_SUFFIX, f"{what}: quantizes to int8 or "
                                    f"float8_e4m3fn, not {dtype}")
    return (torch.empty((m, k), dtype=dtype, device=device),
            torch.empty(m, dtype=torch.float32, device=device))


def quantize_rows(x: torch.Tensor, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/quantize_rows.cu`` once on the current stream: x
    [M, K], M >= 1, K a multiple of 8, bf16 or f32 -> (xq [M, K] int8 or
    float8_e4m3fn, x_scale [M] f32), each row quantized against max(amax /
    qmax, 1e-8)."""
    m, k = _check_rows("quantize_rows", "x", x)
    xq, x_scale = _quant_out("quantize_rows", m, k, dtype, x.device)
    rc = getattr(library("quantize_rows"),
                 f"tk8s_quantize_rows_{_SUFFIX[x.dtype]}_"
                 f"{_PAGE_SUFFIX[dtype]}")(
        x.data_ptr(), xq.data_ptr(), x_scale.data_ptr(), m, k,
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "quantize_rows")
    return xq, x_scale


def swiglu_quant(gate: torch.Tensor, up: torch.Tensor, dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/quantize_rows.cu``'s fused SwiGLU entry once on the
    current stream: gate and up [M, F] (bf16 or f32, F a multiple of 8) ->
    (xq [M, F] int8 or float8_e4m3fn, x_scale [M] f32) of ``silu(gate)``
    rounded to the input dtype, times up, rounded again, quantized per
    row."""
    m, f = _check_rows("swiglu_quant", "gate, up", gate, up)
    xq, x_scale = _quant_out("swiglu_quant", m, f, dtype, gate.device)
    rc = getattr(library("quantize_rows"),
                 f"tk8s_swiglu_quant_{_SUFFIX[gate.dtype]}_"
                 f"{_PAGE_SUFFIX[dtype]}")(
        gate.data_ptr(), up.data_ptr(), xq.data_ptr(), x_scale.data_ptr(),
        m, f, torch.cuda.current_stream(gate.device).cuda_stream)
    _check(rc, "swiglu_quant")
    return xq, x_scale


def silu_probe(x: torch.Tensor) -> torch.Tensor:
    """The SiLU of the fused SwiGLU entry on each element of x (bf16 on
    the card, contiguous): bf16(silu(float(x))), to hold against torch's
    ``silu(x.float()).to(bfloat16)`` bit for bit."""
    _require(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous()
             and x.numel() >= 1,
             f"silu_probe: a contiguous bfloat16 CUDA tensor, got "
             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    y = torch.empty_like(x)
    rc = library("quantize_rows").tk8s_silu_probe_bf16(
        x.data_ptr(), y.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "silu_probe")
    return y


def _check_norm(what: str, scale: torch.Tensor,
                *rows: torch.Tensor) -> Tuple[int, int]:
    """Device, dtype, shape, contiguity and alignment checks of the norm
    kernel's operands: every [M, D] row operand of ``rows`` (x first) and
    scale [D] of one dtype on one device; returns (M, D)."""
    x = rows[0]
    if not x.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, "
                         f"got x on {x.device}")
    names = "x, delta and scale" if len(rows) > 1 else "x and scale"
    for t in (scale, *rows[1:]):
        _require(x.dtype in _SUFFIX and t.dtype == x.dtype
                 and t.device == x.device,
                 f"{what}: {names} must share a dtype (bfloat16 or "
                 f"float32) on {x.device}, got {x.dtype} and {t.dtype} on "
                 f"{t.device}")
    _require(x.dim() == 2 and all(t.shape == x.shape for t in rows)
             and scale.shape == x.shape[1:],
             f"{what}: {'x and delta' if len(rows) > 1 else 'x'} [M, D] "
             f"and scale [D], got {[tuple(t.shape) for t in rows]} and "
             f"{tuple(scale.shape)}")
    _require(all(t.is_contiguous() for t in (scale, *rows)),
             f"{what}: {names} must be contiguous")
    m, d = x.shape
    _require(m >= 1, f"{what}: x must hold a row")
    _require(d % 8 == 0, f"{what}: D {d} must be a multiple of 8")
    _require(all(t.data_ptr() % 16 == 0 for t in (scale, *rows)),
             f"{what}: {names} must start 16-byte aligned")
    return m, d


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """Launch ``csrc/rms_norm.cu`` on the current stream: x [M, D], M >= 1
    (bf16 or f32, scale [D] of the same dtype) -> [M, D], each row's sum
    taken in one fixed order whatever M is."""
    m, d = _check_norm("rms_norm", scale, x)
    y = torch.empty_like(x)
    rc = _entry("rms_norm", x.dtype)(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), m, d, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "rms_norm")
    return y


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/rms_norm.cu``'s fused entry once on the current
    stream: x and delta [M, D], M >= 1 (bf16 or f32, scale [D] of the same
    dtype) -> (h, y), h = x + delta rounded as torch rounds it and y the
    :func:`rms_norm` of h, both fresh [M, D] tensors (x is not written)."""
    m, d = _check_norm("add_rms_norm", scale, x, delta)
    h, y = torch.empty_like(x), torch.empty_like(x)
    rc = getattr(library("rms_norm"),
                 f"tk8s_add_rms_norm_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), delta.data_ptr(), scale.data_ptr(), h.data_ptr(),
        y.data_ptr(), m, d, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "add_rms_norm")
    return h, y


def add_rms_norm_quant(x: torch.Tensor, delta: Optional[torch.Tensor],
                       scale: torch.Tensor, eps: float, dtype: torch.dtype
                       ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                  torch.Tensor]:
    """Launch ``csrc/rms_norm.cu``'s quantizing entry once on the current
    stream: (h, xq, x_scale), h = x + delta as :func:`add_rms_norm` forms
    it (None where ``delta`` is None: the delta-null norm of x) and the
    norm's output, never written, quantized per row to ``dtype`` (int8 or
    float8_e4m3fn): xq [M, D] and x_scale [M] f32, bitwise
    :func:`quantize_rows` of the y :func:`add_rms_norm` (or
    :func:`rms_norm`) writes."""
    what = "add_rms_norm_quant" if delta is not None else "rms_norm_quant"
    m, d = _check_norm(what, scale, *((x,) if delta is None else (x, delta)))
    xq, x_scale = _quant_out(what, m, d, dtype, x.device)
    h = None if delta is None else torch.empty_like(x)
    rc = getattr(library("rms_norm"),
                 f"tk8s_add_rms_norm_quant_{_SUFFIX[x.dtype]}_"
                 f"{_PAGE_SUFFIX[dtype]}")(
        x.data_ptr(), None if delta is None else delta.data_ptr(),
        scale.data_ptr(), None if h is None else h.data_ptr(),
        xq.data_ptr(), x_scale.data_ptr(), m, d, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, what)
    return h, xq, x_scale
