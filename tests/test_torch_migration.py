"""Port parity for KV-session migration (``serve/migration.py`` and the
engine's handoff, export, import, resume and release).

* The wire format: the port's ``pack_session`` gives byte-identical blobs to
  the JAX package's on the same arrays (f32, bf16, int8 with f32 scales,
  fp8), each package's ``unpack_session`` reads the other's blobs, and
  every bit flip and every truncation of a small payload is refused.
* Across engines, at ``llama-test`` on the CPU: a JAX engine's handoff
  imported into the port's engine, and the port's export imported into the
  JAX engine, each continue to the JAX engine's unmigrated greedy tokens
  (kv auto/bf16/int8/fp8 x spec_k 0/2). The two models' logits agree to f32
  rounding, so only a near-tie could flip an argmax; these prompts have
  none.
* The port's engine alone: the engine tests of ``tests/test_migration.py``
  (handoff parity, pool bytes landed, drain mid-stream, resume after a torn
  ship, prefix pages by reference, a torn import that leaves the pool
  ``torch.equal`` to before), each against the port's own unmigrated run.
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.serve import ManualClock as JClock
from triton_kubernetes_tpu.serve import Request as JRequest
from triton_kubernetes_tpu.serve import ServeEngine as JServeEngine
from triton_kubernetes_tpu.serve import migration as jmig
from triton_kubernetes_tpu.utils import metrics as jmetrics
from triton_kubernetes_tpu_torch.models import from_numpy_params, get_config
from triton_kubernetes_tpu_torch.serve import (
    ManualClock,
    MigrationError,
    Request,
    ServeEngine,
    TornPayloadError,
    corrupt,
    pack_session,
    unpack_session,
)
from triton_kubernetes_tpu_torch.serve import migration as tmig
from triton_kubernetes_tpu_torch.utils import metrics

KW = dict(block_size=4, num_blocks=40, max_batch=4, max_model_len=64)
KV_KINDS = ("auto", "bf16", "int8", "fp8")


@pytest.fixture(autouse=True)
def fresh_registries():
    metrics.configure()
    jmetrics.configure()
    yield
    metrics.configure()
    jmetrics.configure()


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("llama-test")
    model = from_numpy_params(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return (jparams, jcfg), (model, cfg)


def port_engine(models, **over):
    _, (model, cfg) = models
    return ServeEngine(model, cfg, device="cpu",
                       clock=ManualClock(tick=0.001), **dict(KW, **over))


def jax_engine(models, **over):
    (jparams, jcfg), _ = models
    return JServeEngine(jparams, jcfg, clock=JClock(tick=0.001),
                        **dict(KW, **over))


def solo_tokens(engine, request):
    engine.submit(request)
    (done,) = engine.run_until_idle()
    engine.release_prefix_cache()
    assert engine.allocator.in_use == 0
    return done.tokens


# ------------------------------------------------------------ wire format
def _session_arrays(kind, rng):
    """One session's components as numpy (the reference's input) and as
    torch tensors (the port's), the same bytes."""
    shape = (2, 3, 2, 4, 8)  # [L, pages, Hkv, bs, D]
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "f32":
        return {"k": x, "v": -x}, {"k": torch.from_numpy(x),
                                   "v": torch.from_numpy(-x)}
    if kind == "bf16":
        k, v = x.astype(ml_dtypes.bfloat16), (2 * x).astype(ml_dtypes.bfloat16)
        as_t = (lambda a: torch.from_numpy(a.view(np.int16).copy())
                .view(torch.bfloat16))
        return {"k": k, "v": v}, {"k": as_t(k), "v": as_t(v)}
    if kind == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        s = rng.random(shape[:3]).astype(np.float32)
        ref = {"k": q, "v": q[::-1].copy(), "k_scale": s, "v_scale": s * 2}
        return ref, {n: torch.from_numpy(a.copy()) for n, a in ref.items()}
    assert kind == "fp8"
    q = x.astype(ml_dtypes.float8_e4m3fn)
    s = rng.random(shape[:3]).astype(np.float32)
    ref = {"k": q, "v": (x / 2).astype(ml_dtypes.float8_e4m3fn),
           "k_scale": s, "v_scale": s + 1}
    as_t = (lambda a: torch.from_numpy(a.view(np.uint8).copy())
            .view(torch.float8_e4m3fn))
    return ref, {"k": as_t(ref["k"]), "v": as_t(ref["v"]),
                 "k_scale": torch.from_numpy(s),
                 "v_scale": torch.from_numpy(s + 1)}


PACK_KW = dict(model="llama-test", kv_dtype="int8", block_size=4,
               request={"request_id": "r", "tokens": [1, 2, 3],
                        "max_new_tokens": 4, "temperature": 0.0,
                        "top_k": 0, "top_p": 1.0, "eos_id": None,
                        "seed": 7, "trace_id": None},
               generated=[9, 8], prefilled=3, target=3, preemptions=1)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "fp8"])
def test_pack_is_byte_identical_and_cross_readable(kind):
    ref_arrays, arrays = _session_arrays(kind, np.random.default_rng(3))
    want = jmig.pack_session(arrays=ref_arrays, **PACK_KW)
    assert pack_session(arrays=arrays, **PACK_KW) == want
    # Raw bytes with their dtype names pack the same.
    raw = {n: (a.tobytes(), a.dtype.name, a.shape)
           for n, a in ref_arrays.items()}
    assert pack_session(arrays=raw, **PACK_KW) == want
    # Each package reads the other's blob.
    sp = unpack_session(want)
    assert sp.header == jmig.unpack_session(want).header
    assert sp.nbytes == len(want) and sp.pages == 3
    for name, a in ref_arrays.items():
        got = sp.arrays[name]
        assert got.dtype == arrays[name].dtype
        assert tuple(got.shape) == a.shape
        assert torch.equal(got.view(torch.uint8), arrays[name].view(
            torch.uint8))
    back = jmig.unpack_session(pack_session(arrays=arrays, **PACK_KW))
    for name, a in ref_arrays.items():
        assert back.arrays[name].dtype == a.dtype
        assert back.arrays[name].tobytes() == a.tobytes()


def test_unpacked_arrays_are_views_over_the_blob():
    _, arrays = _session_arrays("bf16", np.random.default_rng(0))
    blob = pack_session(arrays=arrays, **PACK_KW)
    sp = unpack_session(blob)
    base = np.frombuffer(blob, np.uint8).ctypes.data
    for t in sp.arrays.values():
        assert base <= t.data_ptr() < base + len(blob)


def test_every_bit_flip_and_truncation_is_refused():
    arrays = {"k": torch.arange(24, dtype=torch.float32).reshape(1, 2, 12),
              "v": torch.zeros(1, 2, 3, dtype=torch.float32)}
    blob = pack_session(arrays=arrays, **PACK_KW)
    assert len(blob) < 1024
    for off in range(len(blob)):
        for bit in range(8):
            bad = bytearray(blob)
            bad[off] ^= 1 << bit
            with pytest.raises(TornPayloadError):
                unpack_session(bytes(bad))
        with pytest.raises(TornPayloadError):
            unpack_session(blob[:off])
    assert unpack_session(blob).pages == 2


@pytest.mark.parametrize("mode,offset", [("truncate", 0), ("truncate", 57),
                                         ("bitflip", 3), ("bitflip", 10 ** 6),
                                         ("bitflip", -5)])
def test_corrupt_matches_reference(mode, offset):
    blob = pack_session(arrays={"k": torch.ones(1, 2, 4)}, **PACK_KW)
    assert corrupt(blob, mode=mode, offset=offset) == jmig.corrupt(
        blob, mode=mode, offset=offset)
    with pytest.raises(ValueError, match="unknown corruption mode"):
        corrupt(blob, mode="shred", offset=1)


def test_check_compatible_and_malformed_headers_match_reference():
    blob = pack_session(arrays={"k": torch.ones(1, 2, 4),
                                "v": torch.ones(1, 2, 4)}, **PACK_KW)
    ok = dict(model="llama-test", kv_dtype="int8", block_size=4,
              expect_arrays=("k", "v"))
    tmig.check_compatible(unpack_session(blob), **ok)
    for bad in (dict(ok, model="other"), dict(ok, kv_dtype="bf16"),
                dict(ok, block_size=8), dict(ok, expect_arrays=("k",))):
        with pytest.raises(MigrationError) as mine:
            tmig.check_compatible(unpack_session(blob), **bad)
        with pytest.raises(jmig.MigrationError) as theirs:
            jmig.check_compatible(jmig.unpack_session(blob), **bad)
        assert str(mine.value).replace("--", "—") == str(theirs.value)

    def reframe(header_bytes, payload=b""):
        body = (tmig.MAGIC + len(header_bytes).to_bytes(4, "big")
                + header_bytes + payload)
        import hashlib
        return body + hashlib.sha256(body).digest()

    header = json.loads(blob[12:12 + int.from_bytes(blob[8:12], "big")])
    cases = [b"{not json", json.dumps({"version": 1}).encode(),
             json.dumps(dict(header, version=2)).encode(),
             json.dumps(header).encode()]  # arrays overrun: no payload
    for hdr in cases:
        with pytest.raises(MigrationError):
            unpack_session(reframe(hdr))
        with pytest.raises(jmig.MigrationError):
            jmig.unpack_session(reframe(hdr))
    bad_magic = b"NOTMAGIC" + blob[8:-32]
    import hashlib
    bad_magic += hashlib.sha256(bad_magic).digest()
    with pytest.raises(MigrationError, match="bad magic"):
        unpack_session(bad_magic)


# ------------------------------------------------------- across engines
HANDOFF_PROMPTS = [[5, 7, 9, 11, 2, 4, 6], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5],
                   [5, 7, 5, 7, 5, 7, 9, 2, 5, 7]]

_JAX_ENGINES = {}


def _jax_engine_for(models, kv, spec_k):
    key = (kv, spec_k)
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = jax_engine(models, kv_dtype=kv, spec_k=spec_k)
    return _JAX_ENGINES[key]


@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("kv", KV_KINDS)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_engine_handoff_continues_the_stream(models, kv, spec_k,
                                                   direction):
    jeng = _jax_engine_for(models, kv, spec_k)
    teng = port_engine(models, kv_dtype=kv, spec_k=spec_k)
    for i, prompt in enumerate(HANDOFF_PROMPTS):
        want = solo_tokens(jeng, JRequest(f"w{i}", list(prompt), 8))
        rid = f"h{i}"
        if direction == "jax_to_port":
            src, dst, req = jeng, teng, JRequest
        else:
            src, dst, req = teng, jeng, Request
        src.submit(req(rid, list(prompt), 8, handoff=True))
        (first,) = src.run_until_idle()
        assert first.finish_reason == "handoff" and first.tokens == want[:1]
        blob = src.export_session(rid)
        new_rid = dst.import_session(blob, request_id=f"m{i}")
        assert src.release_session(rid) is None
        (done,) = dst.run_until_idle()
        assert done.request_id == new_rid
        assert done.tokens == want, (kv, spec_k, direction, i)
        assert src.allocator.in_use == 0 and dst.allocator.in_use == 0


# ------------------------------------------------------ the port alone
def _migrate(src, dst, rid, reason="handoff"):
    blob = src.export_session(rid, reason=reason)
    new_rid = dst.import_session(blob, request_id=f"mig-{rid}",
                                 reason=reason)
    src.release_session(rid)
    return new_rid, blob


def test_handoff_migration_is_bitwise_identical(models):
    solo = port_engine(models)
    src, dst = port_engine(models), port_engine(models)
    for i, plen in enumerate((4, 5, 7, 8, 11)):
        prompt = [(3 * j + i) % 29 for j in range(plen)]
        sampled = dict(temperature=0.8, top_p=0.9, seed=40 + i)
        want = solo_tokens(solo, Request("s", prompt, 6, **sampled))
        rid = f"r{i}"
        src.submit(Request(rid, prompt, 6, handoff=True, **sampled))
        first = src.run_until_idle()
        assert [d.request_id for d in first] == [rid]
        assert first[0].finish_reason == "handoff"
        assert first[0].tokens == want[:1]
        new_rid, blob = _migrate(src, dst, rid)
        done = dst.run_until_idle()
        assert [d.request_id for d in done] == [new_rid]
        assert done[0].tokens == want
        assert done[0].finish_reason in ("length", "eos")
        assert len(blob) > 0
    assert src.allocator.in_use == 0
    dst.release_prefix_cache()
    assert dst.allocator.in_use == 0
    fams = metrics.get_registry().render_openmetrics()
    assert 'tk8s_serve_migrations_total{direction="out"' in fams
    assert 'tk8s_serve_migration_bytes_total{direction="in"' in fams


@pytest.mark.parametrize("kv", KV_KINDS)
def test_imported_pool_bytes_equal_the_shipped_unit(models, kv):
    src, dst = port_engine(models, kv_dtype=kv), port_engine(models,
                                                             kv_dtype=kv)
    src.submit(Request("r", [5, 7, 9, 11, 2, 13, 4], 4, seed=3,
                       handoff=True))
    src.run_until_idle()
    blob = src.export_session("r")
    a = unpack_session(blob)
    rid2 = dst.import_session(blob, request_id="mig-r")
    seq = next(s for s in dst.waiting if s.request.request_id == rid2)
    pool = dst._components()
    assert sorted(pool) == sorted(a.arrays)
    for name, full in pool.items():
        landed = full.view(torch.uint8) if full.element_size() == 1 \
            else full
        landed = landed[:, torch.tensor(seq.pages)]
        shipped = a.arrays[name]
        assert torch.equal(landed.view(torch.uint8).reshape(-1),
                           shipped.contiguous().view(torch.uint8).reshape(-1))
    done = dst.run_until_idle()
    assert [d.request_id for d in done] == [rid2]
    src.release_session("r")
    assert src.allocator.in_use == 0 and dst.allocator.in_use == 0


def test_torn_import_leaves_destination_untouched(models):
    src, dst = port_engine(models), port_engine(models)
    dst.submit(Request("other", [1, 2, 3, 4, 5], 3))
    dst.step()
    src.submit(Request("r", [5, 7, 9, 11], 6, seed=1, handoff=True))
    src.run_until_idle()
    blob = src.export_session("r")
    before = dst.allocator.in_use
    pool = {n: t.clone() for n, t in dst._components().items()}
    for mode, off in (("truncate", len(blob) // 3),
                      ("bitflip", 10), ("bitflip", len(blob) // 2),
                      ("bitflip", len(blob) - 1)):
        with pytest.raises(TornPayloadError):
            dst.import_session(corrupt(blob, mode=mode, offset=off))
        assert dst.allocator.in_use == before
        assert all(torch.equal(t, pool[n])
                   for n, t in dst._components().items())
        assert "r" in src.parked  # the source still owns the session
    rid2 = dst.import_session(blob, request_id="mig-r")
    src.release_session("r")
    dst.run_until_idle()
    assert rid2 == "mig-r"
    fams = metrics.get_registry().render_openmetrics()
    assert 'tk8s_serve_migrations_total{direction="in"' in fams
    assert 'status="torn"' in fams


def test_import_refuses_a_foreign_pool(models):
    src = port_engine(models, kv_dtype="int8")
    src.submit(Request("r", [5, 7, 9, 11], 3, handoff=True))
    src.run_until_idle()
    blob = src.export_session("r")
    for dst in (port_engine(models), port_engine(models, kv_dtype="fp8")):
        with pytest.raises(MigrationError, match="pool dtype"):
            dst.import_session(blob)
        assert dst.allocator.in_use == 0
    with pytest.raises(MigrationError, match="no parked session"):
        src.release_session("nope")
    with pytest.raises(MigrationError, match="no exportable session"):
        src.export_session("nope")


def test_prefix_cached_pages_transfer_by_refcount(models):
    over = dict(prefill_chunk=8, prefix_cache=True)
    prefix = [2, 4, 6, 8, 1, 3, 5, 7]
    want = solo_tokens(port_engine(models, **over),
                       Request("s", list(prefix), 4, seed=5))
    src, dst = port_engine(models, **over), port_engine(models, **over)
    dst.submit(Request("warm", list(prefix), 2, seed=5))
    dst.run_until_idle()
    in_use = dst.allocator.in_use
    pool = {n: t.clone() for n, t in dst._components().items()}
    src.submit(Request("r", list(prefix), 4, seed=5, handoff=True))
    src.run_until_idle()
    _migrate(src, dst, "r")
    # Both prompt pages were already indexed: no fresh page, no write.
    assert dst.allocator.in_use == in_use
    assert all(torch.equal(t, pool[n])
               for n, t in dst._components().items())
    done = dst.run_until_idle()
    assert done[0].tokens == want
    dst.release_prefix_cache()
    assert dst.allocator.in_use == 0


def test_drain_migrates_live_decode_mid_stream(models):
    want = solo_tokens(port_engine(models),
                       Request("s", [5, 7, 9, 11, 2], 8, seed=2))
    src, dst = port_engine(models), port_engine(models)
    src.submit(Request("r", [5, 7, 9, 11, 2], 8, seed=2))
    for _ in range(4):  # prefill + a few decode steps
        src.step()
    assert src.exportable_sessions() == ["r"]
    assert src.stats()["sessions"] == ["r"]
    blob = src.export_session("r", reason="drain")
    assert src.stats()["parked"] == ["r"]
    rid2 = dst.import_session(blob, request_id="mig-r", reason="drain")
    done_src = src.release_session("r")
    assert done_src is not None
    assert done_src.finish_reason == "migrated"
    done = dst.run_until_idle()
    assert [d.request_id for d in done] == [rid2]
    assert done[0].tokens == want
    assert src.allocator.in_use == 0


def test_resume_after_failed_ship_finishes_locally(models):
    want = solo_tokens(port_engine(models),
                       Request("s", [5, 7, 9, 11, 2], 6, seed=8))
    src = port_engine(models)
    src.submit(Request("r", [5, 7, 9, 11, 2], 6, seed=8, handoff=True))
    first = src.run_until_idle()
    assert first[0].finish_reason == "handoff"
    blob = src.export_session("r")  # the ship that "fails"
    with pytest.raises(TornPayloadError):
        port_engine(models).import_session(
            corrupt(blob, mode="bitflip", offset=len(blob) // 2))
    src.resume_session("r")
    done = src.run_until_idle()
    assert [d.request_id for d in done] == ["r"]
    assert done[0].tokens == want
    assert src.allocator.in_use == 0
