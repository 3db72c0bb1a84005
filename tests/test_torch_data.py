"""The port's data pipelines, device prefetch, loop hooks and MFU
projections against the JAX package's, on the CPU.

Bit for bit (``np.array_equal``, no tolerance): ``epoch_order``;
``write_packed`` + ``PackedDataset.batches`` (shuffled and not);
``ShardedTokenPipeline`` on the Python path and, where ``g++`` builds
``native/data_pipeline.cpp``, on the native path (a build of its own,
named through ``TK8S_NATIVE_LIB``, which both packages honour), two
epochs of batches and their epoch tags. ``run_pipelined``'s window splits
under ``force_sync`` and ``should_stop`` equal the reference's (the
steps at each sync, the losses, the interrupt flag). The ``train/mfu.py``
projections equal the reference's to 1e-12 relative.

Mirrored from ``tests/test_step_pipeline.py`` and
``tests/test_native_data.py``: ``DevicePrefetch``'s wait accounting on a
fake clock and on threads, producer errors chained to their cause,
staging onto a device (the CPU here; pinned copies run on the card), the
loop's bitwise equality with per-step syncs, short epochs, the
``on_sync``/list contract, and the prefetch gauge.
"""

import importlib
import os
import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.topology.slices import SliceSpec
from triton_kubernetes_tpu.train import data as jdata
from triton_kubernetes_tpu.train.pipeline import run_pipelined as jrun
from triton_kubernetes_tpu_torch.models import get_config
from triton_kubernetes_tpu_torch.train import (
    DevicePrefetch,
    PrefetchProducerError,
    init_state,
    make_optimizer,
    make_train_step,
    run_pipelined,
)
from triton_kubernetes_tpu_torch.train import data as tdata
from triton_kubernetes_tpu_torch.utils import metrics as metrics_mod

# ``train.mfu`` is also the name of a function the packages export, so
# the modules are fetched by their full names.
jmfu = importlib.import_module("triton_kubernetes_tpu.train.mfu")
tmfu = importlib.import_module("triton_kubernetes_tpu_torch.train.mfu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def fresh_registry():
    old = metrics_mod.get_registry()
    reg = metrics_mod.configure()
    yield reg
    metrics_mod.configure(old)


def _host_batches(n, batch=4, seq=32, vocab=256):
    gen = tdata.synthetic_batches(vocab, batch, seq)
    return [next(gen) for _ in range(n)]


# ------------------------------------------------------ the data, bitwise

@pytest.mark.parametrize("n,seed,epoch", [(1, 0, 0), (2, 5, 1), (100, 42, 0),
                                          (100, 42, 1), (257, 0, 7),
                                          (64, 2 ** 63 + 5, 3)])
def test_epoch_order_is_the_references(n, seed, epoch):
    got = tdata.epoch_order(n, seed, epoch)
    assert np.array_equal(got, jdata.epoch_order(n, seed, epoch))
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("dtype,shuffle", [("int32", True),
                                           ("uint16", False)])
def test_packed_dataset_batches_are_the_references(tmp_path, dtype,
                                                   shuffle):
    toks = np.random.default_rng(3).integers(0, 60000, size=1001)
    ours, theirs = str(tmp_path / "p.bin"), str(tmp_path / "r.bin")
    tdata.write_packed(ours, toks, dtype)
    jdata.write_packed(theirs, toks, dtype)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    a = tdata.PackedDataset(ours, seq_len=15, dtype=dtype)
    b = jdata.PackedDataset(theirs, seq_len=15, dtype=dtype)
    assert len(a) == len(b)
    ga, gb = a.batches(4, seed=9, shuffle=shuffle), b.batches(
        4, seed=9, shuffle=shuffle)
    for _ in range(2 * len(a) // 4 + 3):  # across an epoch boundary
        x, y = next(ga)["tokens"], next(gb)["tokens"]
        assert x.dtype == np.int32 and np.array_equal(x, y)
    with pytest.raises(ValueError, match="tokens < window"):
        tdata.PackedDataset(ours, seq_len=5000, dtype=dtype)


@pytest.fixture()
def shards(tmp_path):
    rng = np.random.default_rng(7)
    for i in range(3):
        toks = rng.integers(0, 1000, size=137 + 64 * i, dtype=np.int32)
        toks.tofile(tmp_path / f"shard-{i}.bin")
    (tmp_path / "notes.txt").write_text("not a shard")
    return str(tmp_path)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """A build of native/data_pipeline.cpp of this module's own."""
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: the native pipeline cannot be built")
    out = tmp_path_factory.mktemp("native") / "libtkdata.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared",
                    "-pthread", "-o", str(out),
                    os.path.join(REPO, "native", "data_pipeline.cpp")],
                   check=True, capture_output=True, timeout=120)
    return str(out)


def _pipelines_agree(a, b, steps):
    for step in range(steps):
        (x, ex), (y, ey) = a.next(), b.next()
        assert np.array_equal(x, y), f"step {step}"
        assert ex == ey, f"step {step}: epoch {ex} != {ey}"


def test_python_pipeline_is_the_references(shards):
    kw = dict(batch_size=4, seq_len=31, seed=123, native=False)
    with tdata.ShardedTokenPipeline(shards, **kw) as ours, \
            jdata.ShardedTokenPipeline(shards, **kw) as theirs:
        assert not ours.native and len(ours) == len(theirs)
        _pipelines_agree(ours, theirs, 2 * len(ours) // 4 + 2)
    it = tdata.ShardedTokenPipeline(shards, batch_size=2, seq_len=15,
                                    native=False).batches()
    assert next(it)["tokens"].shape == (2, 16)


def test_native_pipeline_is_the_references_and_the_python_path(
        shards, native_lib, monkeypatch):
    monkeypatch.setenv("TK8S_NATIVE_LIB", native_lib)
    kw = dict(batch_size=4, seq_len=31, seed=123)
    with tdata.ShardedTokenPipeline(shards, native=True, **kw) as nat, \
            jdata.ShardedTokenPipeline(shards, native=True, **kw) as ref, \
            tdata.ShardedTokenPipeline(shards, native=False, **kw) as py:
        assert nat.native and ref.native and not py.native
        assert len(nat) == len(ref) == len(py)
        steps = 2 * len(py) // 4 + 2
        for step in range(steps):
            (a, ea), (b, eb), (c, ec) = nat.next(), ref.next(), py.next()
            assert np.array_equal(a, b) and np.array_equal(a, c), step
            assert ea == eb == ec
    with pytest.raises(ValueError, match="no sequences"):
        tdata.ShardedTokenPipeline(str(os.path.dirname(native_lib)),
                                   batch_size=2, seq_len=7, native=True)


def test_pipeline_rejects_empty_dir_and_missing_library(tmp_path,
                                                        monkeypatch):
    with pytest.raises(ValueError, match="no sequences"):
        tdata.ShardedTokenPipeline(str(tmp_path), batch_size=2, seq_len=7,
                                   native=False)
    monkeypatch.setenv("TK8S_NATIVE_LIB", str(tmp_path / "absent.so"))
    monkeypatch.setattr(tdata, "__file__", str(tmp_path / "x" / "y.py"))
    with pytest.raises(RuntimeError, match="not built"):
        tdata.ShardedTokenPipeline(str(tmp_path), batch_size=2, seq_len=7,
                                   native=True)


# --------------------------------------------------------- DevicePrefetch

def test_prefetch_fake_clock_wait_accounting():
    clock = {"t": 0.0}

    def source():
        for b in _host_batches(5):
            clock["t"] += 0.5
            yield b

    pf = DevicePrefetch(source(), buffer_size=2, threaded=False,
                        clock=lambda: clock["t"])
    first = next(pf)
    assert tuple(first["tokens"].shape) == (4, 33)
    assert pf.wait_seconds == pytest.approx(0.5)
    rest = list(pf)
    assert len(rest) == 4
    assert pf.wait_seconds == pytest.approx(0.5)
    assert pf.batches_out == 5 and pf.last_wait == pytest.approx(0.5)
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetch_threaded_overlap_wait_near_zero():
    batches = _host_batches(4)
    pf = DevicePrefetch(iter(batches), buffer_size=4)
    deadline = time.time() + 30.0
    while pf._queue.qsize() < 4:
        if time.time() > deadline:
            pytest.fail("prefetch producer starved for 30s")
        time.sleep(0.005)
    out = list(pf)
    assert len(out) == 4
    assert pf.wait_seconds < 2.0


def test_prefetch_threaded_slow_producer_wait_is_visible():
    def slow_source():
        for b in _host_batches(3):
            time.sleep(0.15)
            yield b

    pf = DevicePrefetch(slow_source(), buffer_size=2)
    t0 = time.perf_counter()
    out = list(pf)
    assert len(out) == 3
    assert time.perf_counter() - t0 >= 0.3
    assert pf.wait_seconds >= 0.1


def test_prefetch_stages_tensors_on_the_device_in_order():
    host = _host_batches(3)
    pf = DevicePrefetch(iter(host), device="cpu")
    got = list(pf)
    assert all(isinstance(b["tokens"], torch.Tensor)
               and b["tokens"].device.type == "cpu" for b in got)
    assert all(np.array_equal(b["tokens"].numpy(), h["tokens"])
               for b, h in zip(got, host))
    placed = []
    pf = DevicePrefetch(iter(host), place=lambda b: placed.append(b) or b,
                        threaded=False)
    assert len(list(pf)) == 3 and len(placed) == 3
    with pytest.raises(ValueError, match="not both"):
        DevicePrefetch(iter(host), device="cpu", place=lambda b: b)


def test_prefetch_propagates_producer_errors():
    def bad_source():
        yield _host_batches(1)[0]
        raise RuntimeError("disk ate the shard")

    pf = DevicePrefetch(bad_source(), buffer_size=2)
    next(pf)
    with pytest.raises(RuntimeError, match="disk ate the shard"):
        while True:
            next(pf)


@pytest.mark.parametrize("threaded", [True, False])
def test_prefetch_producer_error_chains_real_cause(threaded):
    boom = ValueError("shard 7 has 3 trailing bytes")

    def bad_source():
        for b in _host_batches(3):
            yield b
        raise boom

    pf = DevicePrefetch(bad_source(), buffer_size=2, threaded=threaded)
    got = [next(pf) for _ in range(3)]
    assert len(got) == 3
    with pytest.raises(PrefetchProducerError,
                       match="3 trailing bytes") as excinfo:
        next(pf)
    assert excinfo.value.__cause__ is boom
    frames = []
    tb = boom.__traceback__
    while tb is not None:
        frames.append(tb.tb_frame.f_code.co_name)
        tb = tb.tb_next
    assert "bad_source" in frames


def test_prefetch_rejects_bad_buffer_size():
    with pytest.raises(ValueError, match="buffer_size"):
        DevicePrefetch(iter([]), buffer_size=0)


def test_prefetch_close_unblocks_a_full_producer():
    pf = DevicePrefetch(iter(_host_batches(8)), buffer_size=1)
    next(pf)
    pf.close()
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


# ----------------------------------------------------------- run_pipelined

def _tiny_setup():
    cfg = get_config("llama-test")
    opt = make_optimizer(learning_rate=1e-2, warmup_steps=2, decay_steps=100)
    return cfg, opt, make_train_step(cfg, opt)


def test_pipelined_loop_bitwise_identical_to_sync(fresh_registry):
    cfg, opt, step = _tiny_setup()
    batches = _host_batches(7, batch=2, seq=16, vocab=cfg.vocab_size)
    state = init_state(cfg, opt, device="cpu")
    sync_losses = []
    for b in batches:
        state, metrics = step(state, b)
        sync_losses.append(float(metrics["loss"]))
    state2 = init_state(cfg, opt, device="cpu")
    state2, report = run_pipelined(
        step, state2, batches, sync_every=3, max_steps=len(batches),
        tokens_per_step=2 * 16, config_name="llama-test")
    assert report.steps == 7 and report.sync_points == 3
    assert report.losses == sync_losses
    assert state2.step == state.step
    assert metrics_mod.counter("tk8s_train_host_syncs_total").value(
        config="llama-test") == 3
    assert metrics_mod.histogram(
        "tk8s_train_step_duration_seconds").count(config="llama-test") == 7
    assert metrics_mod.counter("tk8s_train_tokens_total").value(
        config="llama-test") == 7 * 2 * 16


def test_pipelined_loop_short_epoch_and_empty(fresh_registry):
    cfg, opt, step = _tiny_setup()
    state = init_state(cfg, opt, device="cpu")
    batches = iter(_host_batches(5, batch=2, seq=16, vocab=cfg.vocab_size))
    state, report = run_pipelined(step, state, batches, sync_every=4,
                                  max_steps=100)
    assert report.steps == 5 and len(report.losses) == 5
    assert report.sync_points == 2
    assert np.isfinite(report.last_metrics["loss"])
    state, report = run_pipelined(step, state, iter([]), sync_every=4)
    assert report.steps == 0 and report.losses == []


def test_pipelined_loop_with_device_prefetch_end_to_end(fresh_registry):
    cfg, opt, step = _tiny_setup()
    pf = DevicePrefetch(iter(_host_batches(6, batch=2, seq=16,
                                           vocab=cfg.vocab_size)),
                        device="cpu")
    state = init_state(cfg, opt, device="cpu")
    state, report = run_pipelined(step, state, pf, sync_every=3,
                                  tokens_per_step=2 * 16,
                                  config_name="llama-test")
    assert report.steps == 6
    assert all(np.isfinite(l) for l in report.losses)
    assert report.prefetch_wait_seconds == pytest.approx(pf.wait_seconds)
    gauge = metrics_mod.gauge("tk8s_train_prefetch_wait_seconds")
    assert gauge.value() == pytest.approx(pf.wait_seconds)


def _toy_step(state, batch):
    s = state + 1
    return s, {"loss": np.asarray(1.0 / s + float(batch), np.float32)}


@pytest.mark.parametrize("kw", [
    dict(sync_every=2, max_steps=5),
    dict(sync_every=4, max_steps=10, force=5),
    dict(sync_every=3, max_steps=10, force=2, stop_after=4),
    dict(sync_every=4, max_steps=9, stop_after=1),
    dict(sync_every=1, max_steps=3, stop_after=0),
])
def test_window_splits_are_the_references(kw, fresh_registry):
    def run(fn):
        seen, flag = [], {"stop": kw.get("stop_after") == 0}

        def on_sync(n, st, losses, dt):
            seen.append((n, [float(x) for x in losses]))
            if "stop_after" in kw and n >= kw["stop_after"]:
                flag["stop"] = True
        force = kw.get("force")
        state, rep = fn(
            _toy_step, 0, [np.float32(0.5), np.float32(0.25)],
            sync_every=kw["sync_every"], max_steps=kw["max_steps"],
            on_sync=on_sync,
            force_sync=(lambda n: n % force == 0) if force else None,
            should_stop=(lambda: flag["stop"]) if "stop_after" in kw
            else None)
        return (int(state), rep.steps, rep.sync_points, rep.interrupted,
                [float(x) for x in rep.losses], seen)

    assert run(run_pipelined) == run(jrun)


def test_step_floor_paces_dispatch():
    t0 = time.perf_counter()
    _, rep = run_pipelined(_toy_step, 0, [np.float32(0)], sync_every=2,
                           max_steps=4, step_floor_seconds=0.05)
    assert rep.steps == 4 and time.perf_counter() - t0 >= 0.15
    clock = {"t": 0.0}

    def tick():
        clock["t"] += 1.0
        return clock["t"]
    _, rep = run_pipelined(_toy_step, 0, [np.float32(0)], sync_every=2,
                           max_steps=2, clock=tick)
    assert rep.wall_seconds == pytest.approx(clock["t"] - 1.0)


# ------------------------------------------------------------ mfu projections

def test_mfu_projections_are_the_references():
    rel = dict(rtol=1e-12, atol=0)
    spec = SliceSpec.from_accelerator("v5p-64")
    for proxy, target, ps, ts in [("llama3-bench", "llama3-8b", 1024, 4096),
                                  ("llama-test", "llama3-8b", 128, 2048),
                                  ("llama3-8b", "llama3-70b", 2048, 8192)]:
        p, t = get_config(proxy), get_config(target)
        jp, jt = jget_config(proxy), jget_config(target)
        for seq, c, jc in ((ps, p, jp), (ts, t, jt)):
            np.testing.assert_allclose(
                tmfu.attention_flops_fraction(c, seq),
                jmfu.attention_flops_fraction(jc, seq), **rel)
            np.testing.assert_allclose(
                tmfu.mfu_on_slice(12345.6, c, seq, spec),
                jmfu.mfu_on_slice(12345.6, jc, seq, spec), **rel)
            np.testing.assert_allclose(
                tmfu.tokens_per_sec_for_mfu(0.4, c, seq, 989.0),
                jmfu.tokens_per_sec_for_mfu(0.4, jc, seq, 989.0), **rel)
        for measured, eff in ((0.3, 0.7), (0.9, 0.5), (0.05, 1.0)):
            np.testing.assert_allclose(
                tmfu.project_mfu(measured, p, ps, t, ts, eff),
                jmfu.project_mfu(measured, jp, ps, jt, ts, eff), **rel)
