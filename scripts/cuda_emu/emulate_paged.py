"""Build the paged decode, verify and prefill kernels for the CPU and
check them.

The CUDA sources of ``triton_kubernetes_tpu_torch/csrc`` cannot be run
without a card. This script rewrites ``paged_decode.cu``,
``paged_verify.cu``, ``paged_prefill.cu`` and ``paged_common.cuh`` to
build with g++ against ``emu.h`` (a thread-level emulation of shared
memory, barriers, warp shuffles, ldmatrix, mma.sync and cp.async), loads
the libraries with ctypes, and drives their C entries with the arguments
the wrappers of ``ops/_kernels.py`` pass, on CPU tensors. It checks, for
the tensor-core designs (bf16 queries on bf16, int8 and fp8 pages, D
128/bs 16 and D 64/bs 32):

* decode and verify within one bf16 ulp (1e-2 + 2^-7 |plain|) of the span
  plain version of ``ops/paged_attention.py``, at lengths around the
  span edges;
* every verify row bitwise the decode kernel at its length;
* a second call gives the same bits, and the arrival counters are all 0
  after every call;
* prefill within one bf16 ulp of its plain version on windows that start
  and end inside a 64-key stage and on its edge, with a ragged last row
  tile, and its rows bitwise the same whatever window they came in (rows
  64-127 of a 128-token window at offset 0 against a 64-token window at
  offset 64, and the same positions 26 tokens apart in two windows).

Run from the repository root (about three minutes on 8 cores):

    python3 scripts/cuda_emu/emulate_paged.py [--build DIR] [--quick]

A rehearsal, not a measurement: the emulated mma.sync rounds its sums
unlike the card's tensor cores, and nothing here is timed.

:func:`build` takes any kernel of ``_kernels.KERNELS`` whose source needs
only what ``emu.h`` emulates: ``tests/test_torch_decode_gemm.py`` builds
``decode_gemm.cu`` with it and drives the GEMM's C entries on the CPU,
``tests/test_torch_norms.py`` ``rms_norm.cu`` and the norm's (its
quantizing entries held to the emulated ``quantize_rows.cu``),
``tests/test_torch_quantize_rows.py`` and
``tests/test_torch_swiglu_quant.py`` ``quantize_rows.cu`` (the standalone
quantizer, the fused SwiGLU and the SiLU probe). Every ``.cuh`` of
``csrc/`` is rewritten beside the sources.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from triton_kubernetes_tpu_torch.ops import _kernels as K  # noqa: E402
from triton_kubernetes_tpu_torch.ops import paged_attention as pa  # noqa: E402
from triton_kubernetes_tpu_torch.ops import quantization as qz  # noqa: E402

EMU_H = Path(__file__).resolve().parent / "emu.h"
KERNELS = ("paged_decode", "paged_verify", "paged_prefill")
# Device helpers emu.h replaces: their asm bodies are renamed out of the
# way, and calls resolve to emu.h's versions.
HELPERS = ("cp_async16", "cp_async_wait_all", "cp_async16_zfill",
           "ldmatrix_x4", "ldmatrix_x4_trans", "mma16816", "mma16832",
           "wg_desc", "mbar_init", "mbar_arrive", "mbar_arrive_copied",
           "mbar_wait", "bar_sync")


def for_host(src: str) -> str:
    """One CUDA source rewritten for g++ with emu.h included first."""
    for h in ("cuda_bf16.h", "cuda_fp16.h", "cuda_fp8.h", "cuda_runtime.h"):
        src = src.replace(f"#include <{h}>", "")
    for name in HELPERS:
        src = re.sub(rf"\b(void|uint64_t) {name}\(", rf"\1 {name}_device(",
                     src)
    src = src.replace("uint32_t smem_u32(", "uint32_t smem_u32_device(")
    # The wgmma helpers a macro stamps out for each width: emu.h has them.
    src = re.sub(r"^TK8S_GM_MMAS\(.*?\)\n", "", src, flags=re.M | re.S)
    src = re.sub(r"asm volatile\(.*?\);", ";", src, flags=re.S)
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = tls_smem;")
    # kernel<<<grid, threads, smem, stream>>>(args); -> emu_launch(...)
    return re.sub(
        r"([A-Za-z_]\w*(?:<[^;{}]*?>)?)<<<(.*?),(.*?),(.*?),(.*?)>>>"
        r"\((.*?)\);",
        lambda m: (f"emu_launch(dim3({m.group(2)}), {m.group(3)}, "
                   f"(int)({m.group(4)}), [&]() {{ {m.group(1)}"
                   f"({m.group(6)}); }});"), src, flags=re.S)


def build(out: Path, names=KERNELS) -> dict:
    """g++ builds of the named emulated kernels, all at once; {name:
    CDLL}."""
    csrc = K.CSRC
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (out / header.name).write_text(for_host(header.read_text()))
    procs = {}
    for name in names:
        (out / f"{name}.cpp").write_text(
            for_host((csrc / f"{name}.cu").read_text()))
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
             "-shared", "-fPIC", f"-DTK8S_PAGED_SPAN={K.PAGED_SPAN_KEYS}",
             "-include", str(EMU_H), "-I", str(out), "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cpp")])
    if any(p.wait() for p in procs.values()):
        raise SystemExit("emulation build failed")
    libs = {}
    for name in names:
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        K.bind(lib, name)
        libs[name] = lib
    return libs


class Emulated:
    """The C entries of the emulated kernels, called as the wrappers of
    ``ops/_kernels.py`` call the real ones."""

    def __init__(self, libs):
        self.libs = libs
        self.counters = torch.zeros(4096, dtype=torch.int32)

    def prefill(self, q, kp, vp, table, offset, ks, vs, variant=None):
        """The prefill C entry's rc and output ([1, C, Hq, D]); ``variant``
        defaults to the one the wrapper passes."""
        _, c, hq, d = q.shape
        _, hkv, bs, _ = kp.shape
        if variant is None:
            variant = K.PAGED_VARIANTS[K.paged_variant(q.dtype, kp.dtype,
                                                       bs, d)]
        out = torch.full_like(q, float("nan"))
        scales = (None, None) if ks is None else (ks.data_ptr(),
                                                  vs.data_ptr())
        rc = getattr(self.libs["paged_prefill"],
                     f"tk8s_paged_prefill_{suffix_of(q, kp)}")(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *scales,
            table.data_ptr(), out.data_ptr(), c, hkv, hq // hkv, d, bs,
            table.shape[0], offset, d ** -0.5, variant, None)
        return rc, out

    def __call__(self, name, q, kp, vp, tables, lens, ks, vs):
        b, s, hq, d = q.shape
        _, hkv, bs, _ = kp.shape
        tw = tables.shape[1]
        rows = s * (hq // hkv)
        variant = K.paged_variant(q.dtype, kp.dtype, bs, d)
        spans = max(1, -(-tw * bs // K.PAGED_SPAN_KEYS))
        ws = torch.full((b * hkv * spans * rows * (d + 2),), float("nan"))
        out = torch.full_like(q, float("nan"))
        suffix = suffix_of(q, kp)
        scales = (None, None) if ks is None else (ks.data_ptr(),
                                                  vs.data_ptr())
        args = [q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *scales,
                tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                ws.data_ptr(), self.counters.data_ptr(), b]
        if name == "paged_verify":
            args.append(s)
        args += [hkv, hq // hkv, d, bs, tw, d ** -0.5,
                 K.PAGED_VARIANTS[variant], None]
        rc = getattr(self.libs[name], f"tk8s_{name}_{suffix}")(*args)
        if rc != 0:
            raise AssertionError(f"{name}: the C entry refused ({rc})")
        if self.counters.any():
            raise AssertionError(f"{name}: arrival counters left non-zero")
        return out


def suffix_of(q, kp):
    """The C entry's dtype suffix for these queries and pages."""
    suffix = K._SUFFIX[q.dtype]
    if kp.dtype != q.dtype:
        suffix += "_" + K._PAGE_SUFFIX[kp.dtype]
    return suffix


def pages_of(kind, exact):
    """(k, v, k_scale, v_scale) of two exact f32 pools as pages of
    ``kind``: bf16, or the anchored int8/fp8 quantization."""
    if kind == "bf16":
        return (*(e.to(torch.bfloat16) for e in exact), None, None)
    (kp, ks), (vp, vs) = (qz.quantize_kv_pages(e, qz.KV_QUANT_DTYPES[kind])
                          for e in exact)
    return kp, vp, ks, vs


def case(kind, d, bs, hq, hkv, lengths, s, tw, seed):
    """bf16 queries over pages of ``kind`` holding each sequence's
    ``length + s - 1`` tokens (the trash page poisoned)."""
    gen = torch.Generator().manual_seed(seed)
    b = len(lengths)
    exact = [torch.randn((1 + b * tw, hkv, bs, d), generator=gen)
             for _ in range(2)]
    for e in exact:
        e[pa.TRASH_PAGE] = 1e4
    kp, vp, ks, vs = pages_of(kind, exact)
    tables = (torch.randperm(b * tw, generator=gen).reshape(b, tw) + 1
              ).to(torch.int32)
    for i, n in enumerate(lengths):
        tables[i, pa.blocks_for(n + s - 1, bs):] = pa.TRASH_PAGE
    lens = torch.tensor(lengths, dtype=torch.int32)
    q = torch.randn((b, s, hq, d), generator=gen).to(torch.bfloat16)
    return q, kp, vp, ks, vs, tables, lens


def prefill_case(kind, d, bs, hq, hkv, tw, seed):
    """A table of ``tw`` pages of ``kind`` (the trash page poisoned) and
    the generator for its windows' queries."""
    gen = torch.Generator().manual_seed(seed)
    exact = [torch.randn((1 + tw, hkv, bs, d), generator=gen)
             for _ in range(2)]
    for e in exact:
        e[pa.TRASH_PAGE] = 1e4
    table = (torch.randperm(tw, generator=gen) + 1).to(torch.int32)
    return gen, table, pages_of(kind, exact)


def check_prefill(emu, kind, d, bs, hq, hkv):
    """The tensor-core prefill against its plain version, and its rows
    against the same rows of another window, bit for bit."""
    ok = True
    tw = 320 // bs
    gen, table, (kp, vp, ks, vs) = prefill_case(kind, d, bs, hq, hkv, tw,
                                                d + bs)
    assert K.paged_variant(torch.bfloat16, kp.dtype, bs, d) == "tensor_core"
    # (C, offset): a window inside one stage, one across a stage edge from
    # inside it, one from an edge to inside, one edge to edge.
    for c, offset in ((20, 3), (40, 100), (24, 64), (64, 192)):
        q = torch.randn((1, c, hq, d), generator=gen).to(torch.bfloat16)
        rc, got = emu.prefill(q, kp, vp, table, offset, ks, vs)
        if rc != 0:
            print(f"  prefill C {c} @ {offset}: the C entry refused ({rc})")
            return False
        ok &= close(f"prefill C {c} @ {offset} ({c * hq // hkv} rows a "
                    f"head) vs the plain version", got,
                    pa.paged_prefill_attention(q, kp, vp, table, offset, ks,
                                               vs, impl="dense"))
    # The same positions through two windows: rows a multiple of 64
    # apart, then 26 tokens apart (at group 4, 104 rows: another warp,
    # and row g + 8 against g).
    q = torch.randn((1, 128, hq, d), generator=gen).to(torch.bfloat16)
    for (c, offset), (c2, offset2) in (((128, 0), (64, 64)),
                                       ((48, 16), (22, 42))):
        _, whole = emu.prefill(q[:, :c].contiguous(), kp, vp, table, offset,
                               ks, vs)
        _, part = emu.prefill(q[:, c - c2:c].contiguous(), kp, vp, table,
                              offset2, ks, vs)
        same = torch.equal(whole[:, c - c2:], part)
        print(f"  prefill positions {offset2}-{offset + c - 1}: window C {c} "
              f"@ {offset} == window C {c2} @ {offset2} bitwise: {same}",
              flush=True)
        ok &= same
    return ok


def close(what, got, want):
    err = (got.float() - want.float()).abs()
    bound = 1e-2 + 2 ** -7 * want.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and not bool(
        (err > bound).any())
    print(f"  {what}: max abs err {float(err.max()):.3g} "
          f"{'ok' if ok else 'OUTSIDE 1e-2 + 2^-7 |plain|'}", flush=True)
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--build", type=Path, default=None,
                        help="directory for the g++ builds (default: a "
                             "temporary one)")
    parser.add_argument("--quick", action="store_true",
                        help="bf16 pages at D 128, bs 16 only")
    args = parser.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        emu = Emulated(build(args.build or Path(tmp)))
        span = K.PAGED_SPAN_KEYS
        # (pages, D, bs, Hq, Hkv): group 4, and group 8 at D 64 / bs 32.
        configs = [("bf16", 128, 16, 8, 2), ("int8", 128, 16, 8, 2),
                   ("fp8", 128, 16, 8, 2), ("bf16", 64, 32, 8, 1),
                   ("int8", 64, 32, 16, 2), ("fp8", 64, 32, 16, 2)]
        ok = True
        for kind, d, bs, hq, hkv in configs[:1] if args.quick else configs:
            t0 = time.time()
            tw = 3 * span // bs
            print(f"{kind} pages, D {d}, bs {bs}, Hq {hq}, Hkv {hkv}",
                  flush=True)
            lengths = [0, 1, span - 1, span, span + 1, 2 * span - 1,
                       2 * span + 1, 3 * span]
            q, kp, vp, ks, vs, tables, lens = case(kind, d, bs, hq, hkv,
                                                   lengths, 1, tw, 0)
            got = emu("paged_decode", q, kp, vp, tables, lens, ks, vs)
            ok &= close("decode vs the span plain version", got,
                        pa._decode_plain(q, kp, vp, tables, lens, ks, vs,
                                         span))
            ok &= not bool(got[0].float().any())
            ok &= torch.equal(got, emu("paged_decode", q, kp, vp, tables,
                                       lens, ks, vs))
            for s in (4, 8) if 8 * hq // hkv <= K.MAX_VERIFY_ROWS else (4,):
                lengths = [0, 1, span - 3, span - 2, span - 1, span,
                           2 * span - 3, 3 * span - s + 1]
                q, kp, vp, ks, vs, tables, lens = case(
                    kind, d, bs, hq, hkv, lengths, s, tw, s)
                got = emu("paged_verify", q, kp, vp, tables, lens, ks, vs)
                ok &= close(f"verify S {s} vs the span plain version", got,
                            pa._verify_plain(q, kp, vp, tables, lens, ks,
                                             vs, span))
                for j in range(s):
                    row = emu("paged_decode", q[:, j:j + 1].contiguous(),
                              kp, vp, tables, lens + j, ks, vs)
                    if not torch.equal(got[:, j:j + 1], row):
                        print(f"  verify S {s}: row {j} differs from decode "
                              f"at lengths + {j}", flush=True)
                        ok = False
            ok &= check_prefill(emu, kind, d, bs, hq, hkv)
            print(f"  ({time.time() - t0:.1f} s)", flush=True)
    print("emulated tensor-core designs: all checks passed" if ok
          else "emulated tensor-core designs: FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
