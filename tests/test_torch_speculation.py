"""Port parity for speculative decoding: the self-drafter, the verify step,
the rewind and the engine with ``spec_k > 0``.

* ``serve/speculation.py`` is pure Python: over a seeded sweep of
  histories its drafts and acceptance counts equal the JAX package's.
* ``paged_verify_step`` against the JAX package at ``llama-test`` weights
  (f32): logits at 1e-4; pages at 1e-4, or on quantized pools within one
  quantum with scales within 1e-6 relative (as in test_torch_quantization).
  On quantized pools an f32 rounding difference can move one page element
  by a quantum, which moves the logits of the rows reading it by ~2e-4:
  the JAX package's own dense and Pallas paths differ by 1.9e-4 on this
  int8 case, so quantized logits are held to 1e-3.
* ``paged_rewind`` is data movement: given identical pools and undo it
  gives the JAX package's pool exactly, outside the trash page.
* The port's own rewind pin: after a junk draft is rejected, every
  rejected slot (and restored scale) is byte-equal to the pre-verify pool.
  The kept slot holds token 0's K/V from the [B*S]-row projection, which
  may round differently from decode's [B]-row one; it is held to the
  decode step's write within 1e-6.
* The engine: spec ON == OFF greedy (speculation firing and accepting),
  seeded sampling, eos truncation, chunked prefill with the prefix cache,
  and int8/fp8 pools; spec_k = 0 is the plain engine.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_paged_cache as jinit_cache
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.models import paged as jpaged
from triton_kubernetes_tpu.serve import draft_ngram as jdraft
from triton_kubernetes_tpu.serve import longest_agreeing_prefix as jlap
from triton_kubernetes_tpu_torch.models import (
    PagedKVCache,
    VerifyUndo,
    from_numpy_params,
    get_config,
    init_paged_cache,
    paged_decode_step,
    paged_prefill,
    paged_rewind,
    paged_verify_step,
)
from triton_kubernetes_tpu_torch.ops import paged_attention as tpa
from triton_kubernetes_tpu_torch.serve import (
    ManualClock,
    Request,
    ServeEngine,
    draft_ngram,
    longest_agreeing_prefix,
)
from triton_kubernetes_tpu_torch.utils import metrics

TOL = dict(rtol=1e-4, atol=1e-4)
BS, NUM_BLOCKS, T = 4, 24, 6
# A prompt whose greedy continuation enters the llama-test model's cycle
# within a few tokens (tests/test_speculation.py), so drafts get accepted.
CYCLING_PROMPT = [169, 201, 77, 56, 201, 85]


@pytest.fixture(autouse=True)
def fresh_registry():
    metrics.configure()
    yield
    metrics.configure()


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("llama-test")
    model = from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return jcfg, jparams, cfg, model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return tpa.byte_view(x).view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# ------------------------------------------------------------------ drafter
def test_drafter_and_acceptance_match_jax_over_a_seeded_sweep():
    rng = random.Random(7)
    for _ in range(400):
        vocab = rng.randint(2, 24)
        hist = [rng.randrange(vocab) for _ in range(rng.randint(0, 60))]
        k = rng.randint(0, 6)
        kw = dict(max_ngram=rng.randint(1, 4), min_ngram=1,
                  max_scan=rng.choice([8, 32, 2048]))
        assert draft_ngram(hist, k, **kw) == jdraft(hist, k, **kw)
        assert draft_ngram(hist, k) == jdraft(hist, k)
        d = draft_ngram(hist, k)
        sampled = [t if rng.random() < 0.7 else vocab for t in d] + [1]
        assert longest_agreeing_prefix(d, sampled) == jlap(d, sampled)


# ---------------------------------------------------------- verify + rewind
def _prefilled(models, kind, prompt=(5, 7, 9, 11, 2)):
    """One prefilled sequence in both packages' pools (pages 1..T), its
    table, length and greedy first token."""
    jcfg, jparams, cfg, model = models
    jcache = jinit_cache(jcfg, NUM_BLOCKS, BS, kv_dtype=kind)
    tcache = init_paged_cache(cfg, NUM_BLOCKS, BS, kv_dtype=kind,
                              device="cpu")
    n = len(prompt)
    used = tpa.blocks_for(n, BS)
    table = np.array(list(range(1, 1 + used)) + [0] * (T - used), np.int32)
    toks = np.zeros((1, T * BS), np.int32)
    toks[0, :n] = prompt
    jl = jpaged.paged_prefill(jparams, jnp.asarray(toks), jnp.int32(n), jcfg,
                              jcache, jnp.asarray(table))
    jcache = jl[1]
    tl = paged_prefill(model, torch.from_numpy(toks), n, cfg, tcache,
                       torch.from_numpy(table))
    if tcache.quantized:
        tl = tl[0]
    bt = np.arange(1, 1 + T, dtype=np.int32)[None]
    return jcache, tcache, bt, n, int(torch.argmax(tl))


def _pools_close(jcache, tcache, pages):
    for name in ("k", "v"):
        got = _np(getattr(tcache, name)[:, pages])
        want = _np(getattr(jcache, name))[:, pages]
        if not tcache.quantized:
            np.testing.assert_allclose(got, want, **TOL)
            continue
        np.testing.assert_allclose(
            getattr(tcache, name + "_scale")[:, pages].numpy(),
            np.asarray(getattr(jcache, name + "_scale"))[:, pages], rtol=1e-6)
        step = (1.0 if tcache.k.dtype == torch.int8
                else np.maximum(np.abs(want) / 8, 2.0 ** -9))
        assert (np.abs(got - want) <= step).all()


@pytest.mark.parametrize("kind", ["auto", "int8", "fp8"])
def test_paged_verify_step_matches_jax(models, kind):
    jcfg, jparams, cfg, model = models
    jcache, tcache, bt, n, tok0 = _prefilled(models, kind)
    # Two sequences: the prefilled one with a 3-token draft, and an
    # inactive slot on the all-trash table.
    tables = np.concatenate([bt, np.zeros_like(bt)])
    lens = np.array([n, 0], np.int32)
    toks = np.array([[tok0, 3, 9, 4], [0, 0, 0, 0]], np.int32)
    jl, jcache, _ = jpaged.paged_verify_step(
        jparams, jnp.asarray(toks), jcfg, jcache, jnp.asarray(tables),
        jnp.asarray(lens))
    tl, undo = paged_verify_step(model, torch.from_numpy(toks), cfg, tcache,
                                 torch.from_numpy(tables),
                                 torch.from_numpy(lens))
    assert tl.shape == (2, 4, cfg.vocab_size)
    assert undo.k.shape == (cfg.num_layers, 2, 4, cfg.num_kv_heads,
                            cfg.head_dim)
    tol = TOL if kind == "auto" else dict(rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], **tol)
    _pools_close(jcache, tcache, list(range(1, 1 + T)))


@pytest.mark.parametrize("kind", ["auto", "int8"])
def test_paged_rewind_matches_jax_exactly(models, kind):
    """Identical random pools and undo through both rewinds: pages and
    scales equal outside the trash page. keep covers all-kept, all-
    rejected, a partial keep whose rejected run crosses into slot 0 of a
    page (its scale restored), and an inactive row."""
    jcfg, _, cfg, _ = models
    rng = np.random.default_rng(3)
    layers, hkv, dh, s = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 4
    shape = (layers, NUM_BLOCKS, hkv, BS, dh)
    tables = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [0, 0, 0]], np.int32)
    lens = np.array([2, 5, 1, 0], np.int32)
    keep = np.array([4, 1, 2, 4], np.int32)
    if kind == "int8":
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        saved = [rng.integers(-127, 128, (layers, 4, s, hkv, dh)).astype(
            np.int8) for _ in range(2)]
        scales = [rng.random(shape[:3]).astype(np.float32) for _ in range(2)]
        saved_s = [rng.random((layers, 4, s, hkv)).astype(np.float32)
                   for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2)]
        saved = [rng.standard_normal((layers, 4, s, hkv, dh)).astype(
            np.float32) for _ in range(2)]
        scales = saved_s = [None, None]
    t = [None if a is None else torch.from_numpy(a.copy())
         for a in pools + scales + saved + saved_s]
    tcache = PagedKVCache(*t[:4])
    paged_rewind(tcache, VerifyUndo(*t[4:]), torch.from_numpy(tables),
                 torch.from_numpy(lens), torch.from_numpy(keep))
    j = [None if a is None else jnp.asarray(a)
         for a in pools + scales + saved + saved_s]
    jcache = jpaged.PagedKVCache(*j[:4])
    jcache = jpaged.paged_rewind(jcache, jpaged.VerifyUndo(*j[4:]),
                                 jnp.asarray(tables), jnp.asarray(lens),
                                 jnp.asarray(keep))
    for name in ("k", "v", "k_scale", "v_scale"):
        got = getattr(tcache, name)
        if got is None:
            continue
        np.testing.assert_array_equal(got.numpy()[:, 1:],
                                      np.asarray(getattr(jcache, name))[:, 1:])
    assert not np.array_equal(tcache.k.numpy(), pools[0]), "nothing rewound"


@pytest.mark.parametrize("kind", ["auto", "int8", "fp8"])
def test_rewind_restores_rejected_slots_bytewise(models, kind):
    """The poisoned-page pin, on the port alone: verify a junk draft,
    reject everything but input 0 (keep = 1), rewind. Every rejected slot,
    and every restored scale, is byte-equal to the pre-verify pool (the
    trash page aside: the rewind steers kept lanes' writes there); the
    kept slot is within 1e-6 of what the decode step writes there. It is
    token 0's K/V from the [B*S]-row projection, not decode's [B]-row one:
    on torch's CPU build the f32 pool's kept slot differs from decode's by
    ~6e-8 (the fault that keeps the JAX package's own bytewise pin red),
    while the int8 and fp8 pools round both to the same bytes here."""
    _, _, cfg, model = models
    _, tcache, bt, n, tok0 = _prefilled(models, kind)
    before = [_bytes(t).copy() for t in (tcache.k, tcache.v)]
    before_s = ([] if not tcache.quantized else
                [t.clone() for t in (tcache.k_scale, tcache.v_scale)])
    lens = torch.tensor([n], dtype=torch.int32)
    ref = PagedKVCache(*[None if t is None else t.clone()
                         for t in (tcache.k, tcache.v, tcache.k_scale,
                                   tcache.v_scale)])
    paged_decode_step(model, torch.tensor([tok0], dtype=torch.int32), cfg,
                      ref, torch.from_numpy(bt), lens)
    _, undo = paged_verify_step(
        model, torch.tensor([[tok0, 3, 3, 3]], dtype=torch.int32), cfg,
        tcache, torch.from_numpy(bt), lens)
    assert not np.array_equal(_bytes(tcache.k), before[0]), "vacuous"
    paged_rewind(tcache, undo, torch.from_numpy(bt), lens,
                 torch.tensor([1], dtype=torch.int32))
    page, slot = n // BS + 1, n % BS  # input 0's slot (pages start at 1)
    for t, b, r in zip((tcache.k, tcache.v), before, (ref.k, ref.v)):
        got = _bytes(t)
        mask = np.ones(got.shape[:4], bool)
        mask[:, page, :, slot] = False
        mask[:, tpa.TRASH_PAGE] = False
        assert np.array_equal(got[mask], b[mask]), "a rejected slot kept"
        np.testing.assert_allclose(_np(t[:, page, :, slot]),
                                   _np(r[:, page, :, slot]), rtol=1e-6,
                                   atol=1e-6)
    if tcache.quantized:
        # The junk run wrote slot 0 of the next page (a new anchor); the
        # rewind put its scale back. Input 0 (slot 1) moved no scale.
        for t, b in zip((tcache.k_scale, tcache.v_scale), before_s):
            assert torch.equal(t[:, 1:], b[:, 1:])


# ------------------------------------------------------------------- engine
def _solo(models, prompt, n, **over):
    _, _, cfg, model = models
    req = {k: over.pop(k) for k in ("temperature", "top_k", "top_p", "seed",
                                     "eos_id") if k in over}
    kw = dict(block_size=4, num_blocks=40, max_batch=4, max_model_len=64,
              clock=ManualClock(tick=0.001), device="cpu")
    kw.update(over)
    eng = ServeEngine(model, cfg, **kw)
    eng.submit(Request("solo", list(prompt), n, **req))
    done = eng.run_until_idle()
    assert len(done) == 1 and eng.allocator.in_use == 0
    return done[0]


def test_engine_spec_matches_plain_greedy(models):
    base = _solo(models, CYCLING_PROMPT, 12).tokens
    metrics.configure()
    got = _solo(models, CYCLING_PROMPT, 12, spec_k=3)
    assert got.tokens == base
    proposed = metrics.counter(
        "tk8s_serve_spec_proposed_tokens_total").value()
    accepted = metrics.counter(
        "tk8s_serve_spec_accepted_tokens_total").value()
    assert proposed >= accepted > 0, "speculation never accepted"
    assert 1.0 <= metrics.gauge("tk8s_serve_spec_tokens_per_step").value() \
        <= 4.0


def test_engine_spec_matches_plain_seeded_and_eos(models):
    req = dict(temperature=0.8, top_k=8, top_p=0.9, seed=13)
    want = _solo(models, [4, 5, 4, 5, 4, 5], 8, **req).tokens
    assert _solo(models, [4, 5, 4, 5, 4, 5], 8, spec_k=3, **req).tokens \
        == want
    base = _solo(models, CYCLING_PROMPT, 12).tokens
    eos = base[len(base) // 2]
    done = _solo(models, CYCLING_PROMPT, 12, spec_k=3, eos_id=eos)
    assert done.tokens == base[:base.index(eos) + 1]
    assert done.finish_reason == "eos"


def test_engine_spec_zero_is_the_plain_engine(models):
    eng = _solo(models, [5, 7, 9], 6, spec_k=0)
    assert eng.tokens == _solo(models, [5, 7, 9], 6).tokens
    assert metrics.counter(
        "tk8s_serve_spec_proposed_tokens_total").value() == 0
    _, _, cfg, model = models
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(model, cfg, device="cpu", spec_k=-1)


def test_engine_spec_composes_with_chunked_prefill_and_prefix(models):
    _, _, cfg, model = models
    shared = [9, 4, 2, 7, 9, 4, 2, 7]
    reqs = [(f"r{i}", shared + [i + 1, i + 2], 8) for i in range(3)]
    outs, stats = {}, {}
    for spec_k in (0, 2):
        metrics.configure()
        eng = ServeEngine(model, cfg, block_size=4, num_blocks=40,
                          max_batch=4, max_model_len=64, prefill_chunk=8,
                          prefix_cache=True, spec_k=spec_k, device="cpu",
                          clock=ManualClock(tick=0.001))
        eng.submit(Request(*reqs[0]))
        done = list(eng.run_until_idle())
        for r in reqs[1:]:
            eng.submit(Request(*r))
        done.extend(eng.run_until_idle())
        outs[spec_k] = {d.request_id: d.tokens for d in done}
        assert metrics.counter(
            "tk8s_serve_prefix_hit_tokens_total").value() > 0
        stats[spec_k] = eng.stats()
        eng.release_prefix_cache()
        assert eng.allocator.in_use == 0
    assert outs[2] == outs[0]
    assert stats[2]["verify_steps"] > 0 and stats[0]["verify_steps"] == 0


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_engine_spec_on_quantized_pools(models, kind):
    """Spec ON == OFF on int8 and fp8 pools, drafts accepted (so rewinds
    of anchored scales and accepted writes both happened)."""
    accepted = 0
    for p, n in (([5, 7, 5, 7, 5, 7, 5, 7], 12), ([3, 1, 4, 1, 5, 9], 16)):
        want = _solo(models, p, n, kv_dtype=kind).tokens
        metrics.configure()
        assert _solo(models, p, n, kv_dtype=kind, spec_k=3).tokens == want
        accepted += metrics.counter(
            "tk8s_serve_spec_accepted_tokens_total").value()
    assert accepted > 0, "speculation never accepted"
