"""The row-invariant ops of the port's decode and verify steps, on the CPU.

``paged_decode_step`` and ``paged_verify_step`` take their norms and
weight products through ``ops.norms.rms_norm_rows`` and
``ops.decode_gemm.decode_gemm_group`` (wq/wk/wv in one call, w3/w1 in
another), whose CUDA kernels give a row the same bits whatever the row
count (tests/test_torch_cuda.py checks them on the card,
tests/test_torch_decode_gemm.py the GEMM's source in an emulation). On CPU
tensors both run their plain versions, which must be exactly the ops the
model runs everywhere else, and agree with the JAX package's on the same
seeded numpy inputs. The GEMM's K split, a function of the shape alone,
and the flash dQ kernel's design table are pinned here too.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_paged_cache as jinit_cache
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.models import llama as jllama
from triton_kubernetes_tpu.models import paged as jpaged
from triton_kubernetes_tpu.ops import norms as jnorms
from triton_kubernetes_tpu_torch.models import (
    from_numpy_params,
    get_config,
    init_params,
    paged,
)
from triton_kubernetes_tpu_torch.models import llama
from triton_kubernetes_tpu_torch.ops import _kernels, decode_gemm, norms

# (spec, x shape, w shape) of every product the decode and verify steps
# run, at llama-test widths (D 64, 4 heads of 16, 2 KV heads, F 128).
SPECS = [
    ("bsd,dhk->bshk", (3, 4, 64), (64, 4, 16)),   # wq
    ("bsd,dhk->bshk", (3, 4, 64), (64, 2, 16)),   # wk, wv
    ("bshk,hkd->bsd", (3, 4, 4, 16), (4, 16, 64)),  # wo
    ("bsd,df->bsf", (3, 4, 64), (64, 128)),       # w1, w3
    ("bsf,fd->bsd", (3, 4, 128), (128, 64)),      # w2
]
DTYPES = ["float32", "bfloat16"]  # config names; getattr(torch, name)
# (spec, x shape, weight shapes) of the grouped products: wq/wk/wv and
# w3/w1 at llama-test widths.
GROUPS = [
    ("bsd,dhk->bshk", (3, 4, 64), [(64, 4, 16), (64, 2, 16), (64, 2, 16)]),
    ("bsd,df->bsf", (3, 4, 64), [(64, 128), (64, 128)]),
]
# The decode GEMM's tile width and K split at Llama-3-8B's groups, (group,
# N summed over the group, K, tile, S): wq+wk+wv, wo, w3+w1, w2, the lm
# head.
SPLITS_8B = [("wq+wk+wv", 6144, 4096, 64, 1), ("wo", 4096, 4096, 64, 2),
             ("w3+w1", 28672, 4096, 128, 1), ("w2", 4096, 14336, 64, 2),
             ("lm head", 128256, 4096, 128, 1)]


def _pair(seed, xs, ws):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(xs).astype(np.float32),
            (0.1 * rng.standard_normal(ws)).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec,xs,ws", SPECS)
def test_row_product_plain_is_weight_einsum(spec, xs, ws, dtype):
    """On CPU tensors the row-invariant product is bitwise the einsum the
    model runs off the decode path."""
    cfg = get_config("llama-test", dtype=dtype)
    xn, wn = _pair(len(spec), xs, ws)
    dt = getattr(torch, dtype)
    x, w = torch.from_numpy(xn).to(dt), torch.from_numpy(wn).to(dt)
    got = llama.weight_einsum(spec, x, w, cfg, row_invariant=True)
    want = llama.weight_einsum(spec, x, w, cfg)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("spec,xs,ws", SPECS)
def test_row_product_matches_jax_weight_einsum(spec, xs, ws):
    """Against the reference's ``weight_einsum`` on the same f32 inputs:
    f32 sums of the same products, so within f32 rounding."""
    xn, wn = _pair(len(spec) + 1, xs, ws)
    got = llama.weight_einsum(spec, torch.from_numpy(xn),
                              torch.from_numpy(wn), get_config("llama-test"),
                              row_invariant=True)
    want = jllama.weight_einsum(spec, jnp.asarray(xn), jnp.asarray(wn),
                                jget_config("llama-test"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_gemm_plain_f32_out_is_unembed(dtype):
    """The f32-out product is bitwise the lm head of ``unembed`` (which now
    takes it when row_invariant), and within f32 rounding of the
    reference's unembed on the same weights."""
    cfg = get_config("llama-test", dtype=dtype)
    model = init_params(cfg, seed=3, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 4, cfg.embed_dim)).astype(np.float32)).to(getattr(torch, dtype))
    want = llama.unembed(x, model)
    got = llama.unembed(x, model, row_invariant=True)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    h = llama.final_norm_hidden(x, model).reshape(12, -1)
    direct = decode_gemm.decode_gemm(h, llama.head_weights(model),
                                     torch.float32)
    assert torch.equal(direct, want.reshape(12, -1))
    if dtype == "float32":
        jcfg = jget_config("llama-test")
        params = {"final_norm": jnp.asarray(model.final_norm.numpy()),
                  "lm_head": jnp.asarray(model.lm_head.numpy())}
        ref = jllama.unembed(jnp.asarray(x.numpy()), params, jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_rows_plain_is_rms_norm(dtype):
    jdt = getattr(jnp, dtype)
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(3 * rng.standard_normal((3, 4, 64)).astype(
        np.float32)).to(dtype)
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(64).astype(
        np.float32)).to(dtype)
    got = norms.rms_norm_rows(x, scale, 1e-5)
    assert torch.equal(got, norms.rms_norm(x, scale, 1e-5))
    ref = jnorms.rms_norm(jnp.asarray(x.float().numpy()).astype(jdt),
                          jnp.asarray(scale.float().numpy()).astype(jdt),
                          1e-5)
    # bf16: one output ulp (f32 sum order); f32: f32 rounding.
    tol = (dict(rtol=2 ** -7, atol=1e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref).astype(np.float32), **tol)


def test_row_product_refuses_other_contractions():
    x, w = torch.zeros(2, 3, 8), torch.zeros(8, 5)
    with pytest.raises(ValueError, match="trailing-by-leading"):
        llama._row_products("bsd,fd->bsf", x, [w.T.contiguous()])


def _group(seed, xs, wss):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(xs).astype(np.float32),
            [(0.1 * rng.standard_normal(ws)).astype(np.float32)
             for ws in wss])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec,xs,wss", GROUPS)
def test_grouped_products_plain_are_weight_einsums(spec, xs, wss, dtype):
    """On CPU tensors the grouped row-invariant products are bitwise the
    separate einsums the model runs off the decode path, in order."""
    cfg = get_config("llama-test", dtype=dtype)
    xn, wns = _group(len(wss), xs, wss)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(xn).to(dt)
    ws = [torch.from_numpy(wn).to(dt) for wn in wns]
    got = llama.weight_einsums(spec, x, ws, cfg, row_invariant=True)
    assert len(got) == len(ws)
    for y, w in zip(got, ws):
        want = llama.weight_einsum(spec, x, w, cfg)
        assert y.dtype == want.dtype and torch.equal(y, want)
    flat = x.reshape(12, -1)
    for y, p in zip(decode_gemm.decode_gemm_group(
            flat, [w.reshape(flat.shape[1], -1) for w in ws]),
            decode_gemm.decode_gemm_group_plain(
                flat, [w.reshape(flat.shape[1], -1) for w in ws], dt)):
        assert torch.equal(y, p)


@pytest.mark.parametrize("spec,xs,wss", GROUPS)
def test_grouped_products_match_jax_weight_einsum(spec, xs, wss):
    """Each grouped product against the reference's ``weight_einsum`` of
    its weight on the same f32 inputs: within f32 rounding."""
    xn, wns = _group(len(wss) + 1, xs, wss)
    got = llama.weight_einsums(spec, torch.from_numpy(xn),
                               [torch.from_numpy(wn) for wn in wns],
                               get_config("llama-test"), row_invariant=True)
    for y, wn in zip(got, wns):
        want = jllama.weight_einsum(spec, jnp.asarray(xn), jnp.asarray(wn),
                                    jget_config("llama-test"))
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("group,n_total,k,tile,want", SPLITS_8B)
def test_gemm_splits_of_the_8b_groups(group, n_total, k, tile, want):
    """The tile width and K split at each Llama-3-8B group: 128-column
    tiles for the wide groups; the fewest ranges that give
    GEMM_BLOCKS_WANTED blocks, each range at least 8 k tiles; none where
    the tiles alone give them."""
    assert _kernels.gemm_tile(n_total) == tile, group
    s = _kernels.gemm_splits(n_total, k)
    assert s == want, group
    tiles, k_tiles = n_total // tile, k // 64
    assert k_tiles // s >= _kernels.GEMM_MIN_RANGE_TILES
    assert tiles * s >= _kernels.GEMM_BLOCKS_WANTED
    assert s == 1 or tiles * (s - 1) < _kernels.GEMM_BLOCKS_WANTED


def test_gemm_splits_depend_on_the_shape_alone():
    """The split takes the group's summed width and K, nothing else (no
    row count: a row's sum is its ranges' partials in range order, so a
    split that moved with M would break verify rows = decode rows), and
    is 1 at every llama-test group (K 64 or 128 holds too few k tiles);
    the tile width takes the summed width alone."""
    assert list(inspect.signature(_kernels.gemm_splits).parameters) == [
        "n_total", "k"]
    assert list(inspect.signature(_kernels.gemm_tile).parameters) == [
        "n_total"]
    cfg = get_config("llama-test")
    d, f = cfg.embed_dim, cfg.mlp_dim
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    for n_total, k in ((qkv, d), (d, cfg.num_heads * cfg.head_dim),
                       (2 * f, d), (d, f), (cfg.vocab_size, d)):
        assert _kernels.gemm_splits(n_total, k) == 1
    for n_total in (8, 64, 1000, 6144, 10 ** 6):
        for k in (8, 512, 4096, 14336, 10 ** 5):
            s = _kernels.gemm_splits(n_total, k)
            assert _kernels.gemm_tile(n_total) in (64, 128)
            assert 1 <= s <= _kernels.GEMM_MAX_SPLITS
            assert s == 1 or -(-k // 64) // s >= \
                _kernels.GEMM_MIN_RANGE_TILES


class _ResidualAdds(TorchFunctionMode):
    """Counts the adds whose result is a [..., D] tensor of the activation
    dtype -- a residual add -- made while it is active, except inside the
    fused add + norm (``inside``)."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.d, self.dtype, self.count, self.inside = d, dtype, 0, False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (not self.inside and func in _ADDS
                and isinstance(out, torch.Tensor) and out.dim() >= 2
                and out.shape[-1] == self.d and out.dtype == self.dtype):
            self.count += 1
        return out


_ADDS = (torch.add, torch.Tensor.add, torch.Tensor.add_,
         torch.Tensor.__add__, torch.Tensor.__radd__, torch.Tensor.__iadd__)


def test_decode_and_verify_steps_take_the_row_invariant_ops(monkeypatch):
    """Every norm and weight product of both steps goes through the
    row-invariant ops: one norm of the embeddings and 2 L fused residual
    adds + norms a step (each layer boundary, the last one's norm the
    final norm), with no residual add and no norm of ``models/llama.py``
    beside them, and 4 L + 1 product calls (wq/wk/wv, wo, w3/w1, w2 a
    layer, and the lm head), seven weights a layer. A prefill window makes
    the same norm calls and the same product calls but the head's (its one
    row is a plain product), so that its pages do not depend on the
    window's width; the one-shot prefill makes none of them (plain norms,
    adds and einsums)."""
    cfg = get_config("llama-test", dtype="bfloat16")
    model = init_params(cfg, seed=0, device="cpu")
    layers = cfg.num_layers
    calls = {}
    adds = _ResidualAdds(cfg.embed_dim, cfg.activation_dtype)
    real = {"norm": paged.rms_norm_rows, "fused": paged.add_rms_norm_rows,
            "llama_norm": llama._norm, "gemm": llama.decode_gemm_group}

    def counted(key):
        def call(*a, **k):
            calls[key] += 1
            if key == "gemm":
                calls["weights"] += len(a[1])
            adds.inside = key == "fused"
            try:
                return real[key](*a, **k)
            finally:
                adds.inside = False
        return call

    monkeypatch.setattr(paged, "rms_norm_rows", counted("norm"))
    monkeypatch.setattr(paged, "add_rms_norm_rows", counted("fused"))
    monkeypatch.setattr(llama, "_norm", counted("llama_norm"))
    monkeypatch.setattr(llama, "decode_gemm_group", counted("gemm"))

    def run(step, *args):
        calls.update(dict.fromkeys(("norm", "fused", "llama_norm", "gemm",
                                    "weights"), 0))
        adds.count = 0
        with adds:
            step(model, *args)
        return dict(calls, adds=adds.count)

    cache = paged.init_paged_cache(cfg, 9, 4, device="cpu")
    tables = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    assert run(paged.paged_prefill, torch.zeros((1, 8), dtype=torch.int32),
               5, cfg, cache, tables[1, :2]) == {
        "norm": 0, "fused": 0, "llama_norm": 2 * layers + 1, "gemm": 0,
        "weights": 0, "adds": 2 * layers}
    fused = {"norm": 1, "fused": 2 * layers, "llama_norm": 0, "adds": 0}
    assert run(paged.paged_prefill_chunk,
               torch.zeros((1, 8), dtype=torch.int32), 0, 5, cfg, cache,
               tables[0]) == dict(fused, gemm=4 * layers,
                                  weights=7 * layers)
    want = dict(fused, gemm=4 * layers + 1, weights=7 * layers + 1)
    assert run(paged.paged_decode_step,
               torch.tensor([1, 2], dtype=torch.int32), cfg, cache, tables,
               lens) == want
    assert run(paged.paged_verify_step,
               torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32), cfg,
               cache, tables, lens) == want


def _unfused_layers(model, x, config, positions, attend):
    """``paged._serve_layers`` composed as the steps ran before the fused
    add + norm: ``llama._qkv``, ``project_out`` and ``_mlp`` a layer (each
    norming its input), then the final norm."""
    cos, sin = model.rotary()
    for i, layer in enumerate(model.layers):
        q, k, v = llama._qkv(x, layer, config, cos, sin, positions, True)
        x = llama.project_out(x, attend(i, q, k, v), layer, config, True)
        x = x + llama._mlp(x, layer, config, True)[0]
    return llama.final_norm_hidden(x, model, True)


def _serve_sequence(model, cfg, jax_side=None):
    """Two prefill windows (C 8, the second right-padded) of a 13-token
    prompt, a decode step of it beside an inactive slot, then a verify
    step of 3 tokens: the logits of each step and the pool after, from the
    port -- and, with ``jax_side`` = (jcfg, jparams), the JAX package's on
    the same tokens, tables and lengths."""
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, 13)
    table = np.array([[5, 2, 9, 11], [0, 0, 0, 0]], np.int32)
    if jax_side is None:
        cache = paged.init_paged_cache(cfg, 16, 4, device="cpu")
    else:
        jcfg, jparams = jax_side
        cache = jinit_cache(jcfg, 16, 4)
    out = []
    for off in (0, 8):
        clen = min(8, 13 - off)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :clen] = prompt[off:off + clen]
        if jax_side is None:
            out.append(paged.paged_prefill_chunk(
                model, torch.from_numpy(toks), off, clen, cfg, cache,
                torch.from_numpy(table[0])))
        else:
            logits, cache = jpaged.paged_prefill_chunk(
                jparams, jnp.asarray(toks), jnp.int32(off),
                jnp.int32(clen), jcfg, cache, jnp.asarray(table[0]))
            out.append(logits)
    token = np.array([int(np.argmax(np.asarray(out[-1], np.float32))), 0],
                     np.int32)
    lens = np.array([13, 0], np.int32)
    drafts = np.array([[token[0], 3, 9], [0, 0, 0]], np.int32)
    if jax_side is None:
        out.append(paged.paged_decode_step(
            model, torch.from_numpy(token), cfg, cache,
            torch.from_numpy(table), torch.from_numpy(lens)))
        out.append(paged.paged_verify_step(
            model, torch.from_numpy(drafts), cfg, cache,
            torch.from_numpy(table), torch.from_numpy(lens + [1, 0]))[0])
        return out, (cache.k, cache.v)
    logits, cache = jpaged.paged_decode_step(
        jparams, jnp.asarray(token), jcfg, cache, jnp.asarray(table),
        jnp.asarray(lens))
    out.append(logits)
    logits, cache, _ = jpaged.paged_verify_step(
        jparams, jnp.asarray(drafts), jcfg, cache, jnp.asarray(table),
        jnp.asarray(lens + [1, 0]))
    out.append(logits)
    return out, (cache.k, cache.v)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_steps_are_the_unfused_composition(monkeypatch, dtype):
    """On CPU tensors the prefill-window, decode and verify steps, which
    fuse each layer boundary's add and norm, give bitwise the logits and
    pool of the same steps composed unfused (torch add, then the norm)."""
    cfg = get_config("llama-test", dtype=dtype)
    model = init_params(cfg, seed=4, device="cpu")
    fused, fused_pool = _serve_sequence(model, cfg)
    monkeypatch.setattr(paged, "_serve_layers", _unfused_layers)
    plain, plain_pool = _serve_sequence(model, cfg)
    for got, want in zip(fused + list(fused_pool), plain + list(plain_pool)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_fused_steps_match_jax():
    """The same prefill windows, decode step and verify step against the
    JAX package's at ``llama-test`` (f32, its weights carried over):
    within the tolerance of the other step tests (rtol/atol 1e-4: sums in
    another order through two layers and the lm head)."""
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("llama-test")
    model = from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    got, got_pool = _serve_sequence(model, cfg)
    want, want_pool = _serve_sequence(None, cfg, (jcfg, jparams))
    tol = dict(rtol=1e-4, atol=1e-4)
    for g, w in zip(got[:3], want[:3]):  # windows and decode, live rows
        np.testing.assert_allclose(g.reshape(-1, cfg.vocab_size)[0].numpy(),
                                   np.asarray(w).reshape(
                                       -1, cfg.vocab_size)[0], **tol)
    np.testing.assert_allclose(got[3][0].numpy(), np.asarray(want[3])[0],
                               **tol)
    pages = [5, 2, 9, 11]
    for g, w in zip(got_pool, want_pool):
        np.testing.assert_allclose(g[:, pages].numpy(),
                                   np.asarray(w)[:, pages], **tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_verify_rows_equal_decode_rows(dtype):
    """Each verify logits row (b, j) is bitwise the decode logits at
    length lengths[b] + j, and the two pools end bitwise equal (the check
    chip_smoke.py makes at the serve configuration on the card)."""
    cfg = get_config("llama-test", dtype=dtype)
    model = init_params(cfg, seed=2, device="cpu")
    bs, per, b, s = 4, 6, 3, 3
    cache = paged.init_paged_cache(cfg, 1 + b * per, bs, device="cpu")
    tables = torch.arange(1, 1 + b * per, dtype=torch.int32).reshape(b, per)
    rng = np.random.default_rng(6)
    lengths = [5, 9, 14]
    for i, n in enumerate(lengths):
        width = -(-n // bs) * bs
        toks = rng.integers(0, cfg.vocab_size, width).tolist()
        paged.paged_prefill(model, torch.tensor([toks], dtype=torch.int32),
                            n, cfg, cache, tables[i, :width // bs])
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                           ).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    vcache = paged.PagedKVCache(cache.k.clone(), cache.v.clone())
    verify, _ = paged.paged_verify_step(model, tok, cfg, vcache, tables,
                                        lens)
    for j in range(s):
        row = paged.paged_decode_step(model, tok[:, j].contiguous(), cfg,
                                      cache, tables, lens + j)
        assert torch.equal(verify[:, j], row), j
    assert torch.equal(vcache.k, cache.k) and torch.equal(vcache.v, cache.v)


def test_flash_variant_sends_dq_to_the_tensor_cores():
    """dQ takes its design from the same table as the forward and dK/dV:
    bf16 at D 64 and 128 on the tensor cores, the rest on the CUDA cores;
    the wrapper passes the table's code, and the C source instantiates the
    tensor-core kernel for exactly those widths."""
    for d in (64, 128):
        assert _kernels.flash_variant(torch.bfloat16, d) == "tensor_core"
    for dtype, d in ((torch.bfloat16, 96), (torch.float32, 128),
                     (torch.float32, 64)):
        assert _kernels.flash_variant(dtype, d) == "cuda_core"
    assert "FLASH_VARIANTS[flash_variant(q.dtype, d)].code" in \
        inspect.getsource(_kernels.flash_bwd_dq)
    sig = _kernels._SIGNATURES["flash_bwd_dq"]
    assert sig[-2:] == (_kernels._I, _kernels._P)  # variant, stream
    text = (_kernels.CSRC / "flash_bwd_dq.cu").read_text()
    for _, d in _kernels.FLASH_TENSOR_CORE:
        assert f"launch_tc<{d}>" in text
    assert "flash_bwd_dq_tc_kernel" in text


def test_row_kernels_are_built_and_bound():
    """Both row-invariant kernels are in the build list with C entries for
    bf16 and f32 (the GEMM's suffix names its operands' dtype, then its
    output's: bf16 operands with bf16 or f32 out, and f32 operands)."""
    entries = {"rms_norm": ("bf16", "f32"),
               "decode_gemm": ("bf16_bf16", "bf16_f32", "f32_f32")}
    assert tuple(_kernels.GEMM_SUFFIXES.values()) == entries["decode_gemm"]
    for name, suffixes in entries.items():
        assert name in _kernels.KERNELS
        assert tuple(_kernels._entry_suffixes(name)) == suffixes
        text = (_kernels.CSRC / f"{name}.cu").read_text()
        for suffix in suffixes:
            assert f"tk8s_{name}_{suffix}(" in text
    assert "mma.sync.aligned.m16n8k16" in (
        _kernels.CSRC / "decode_gemm.cu").read_text()


def test_row_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.decode_gemm(torch.zeros(2, 8, dtype=torch.bfloat16),
                             [torch.zeros(8, 8, dtype=torch.bfloat16)],
                             [torch.empty(2, 8, dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.rms_norm(torch.zeros(2, 8), torch.zeros(8), 1e-5)
