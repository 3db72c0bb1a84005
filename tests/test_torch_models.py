"""Port parity for the model layer: ``llama-test`` weights from the JAX
``init_params(PRNGKey(0))`` carried over by ``from_numpy_params``, then the
paged prefill/decode functions of both packages on the same tokens, tables
and pools. f32 on the CPU, rtol/atol 1e-4 (summation order differs through
two layers and the lm head). Pages written must agree to the same
tolerance; pages nobody wrote stay bitwise equal (both zero)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_paged_cache as jinit_cache
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu.models import paged as jpaged
from triton_kubernetes_tpu_torch.models import (
    from_numpy_params,
    get_config,
    init_paged_cache,
    init_params,
    paged_decode_step,
    paged_prefill,
    paged_prefill_chunk,
)

TOL = dict(rtol=1e-4, atol=1e-4)
BS, NUM_BLOCKS = 4, 24


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("llama-test")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = get_config("llama-test")
    return jcfg, jparams, cfg, from_numpy_params(tree, cfg, device="cpu")


def _pools_close(jcache, tcache, pages):
    for j, t in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
        np.testing.assert_allclose(t[:, pages].numpy(),
                                   np.asarray(j)[:, pages], **TOL)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


@pytest.mark.parametrize("jax_impl", [None, "pallas-interpret"])
def test_paged_prefill_chunk_matches_jax(models, jax_impl):
    """Two windows of one 13-token prompt (C = 8, the second right-padded):
    the logits at each window's last real row and the written pages."""
    jcfg, jparams, cfg, model = models
    prompt = _prompt(13)
    table = np.array([5, 2, 9, 11], np.int32)
    jcache = jinit_cache(jcfg, NUM_BLOCKS, BS)
    tcache = init_paged_cache(cfg, NUM_BLOCKS, BS, device="cpu")
    for off in (0, 8):
        clen = min(8, 13 - off)
        toks = np.zeros((1, 8), np.int32)
        toks[0, :clen] = prompt[off:off + clen]
        jl, jcache = jpaged.paged_prefill_chunk(
            jparams, jnp.asarray(toks), jnp.int32(off), jnp.int32(clen),
            jcfg, jcache, jnp.asarray(table), attention_impl=jax_impl)
        tl = paged_prefill_chunk(model, torch.from_numpy(toks), off, clen,
                                 cfg, tcache, torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _pools_close(jcache, tcache, table)
    untouched = np.setdiff1d(np.arange(NUM_BLOCKS), table)
    assert not tcache.k[:, untouched].any()


def test_paged_prefill_matches_jax(models):
    jcfg, jparams, cfg, model = models
    prompt = _prompt(10, seed=1)
    toks = np.zeros((1, 12), np.int32)
    toks[0, :10] = prompt
    table = np.array([3, 7, 1], np.int32)
    jcache = jinit_cache(jcfg, NUM_BLOCKS, BS)
    tcache = init_paged_cache(cfg, NUM_BLOCKS, BS, device="cpu")
    jl, jcache = jpaged.paged_prefill(jparams, jnp.asarray(toks),
                                      jnp.int32(10), jcfg, jcache,
                                      jnp.asarray(table))
    tl = paged_prefill(model, torch.from_numpy(toks), 10, cfg, tcache,
                       torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _pools_close(jcache, tcache, table)


@pytest.mark.parametrize("jax_impl", [None, "pallas-interpret"])
def test_paged_decode_step_matches_jax(models, jax_impl):
    """A ragged decode batch over prefilled pages: two live sequences at
    lengths 10 and 5, one empty slot on the all-trash table. Logits of
    the live rows and the pages after two steps agree."""
    jcfg, jparams, cfg, model = models
    jcache = jinit_cache(jcfg, NUM_BLOCKS, BS)
    tcache = init_paged_cache(cfg, NUM_BLOCKS, BS, device="cpu")
    tables = np.array([[3, 7, 1, 0], [4, 8, 0, 0], [0, 0, 0, 0]], np.int32)
    for row, n in ((0, 10), (1, 5)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = _prompt(n, seed=2 + row)
        tab = tables[row]
        _, jcache = jpaged.paged_prefill(jparams, jnp.asarray(toks),
                                         jnp.int32(n), jcfg, jcache,
                                         jnp.asarray(tab))
        paged_prefill(model, torch.from_numpy(toks), n, cfg, tcache,
                      torch.from_numpy(tab))
    lengths = np.array([10, 5, 0], np.int32)
    token = np.array([17, 42, 0], np.int32)
    for _ in range(2):
        jl, jcache = jpaged.paged_decode_step(
            jparams, jnp.asarray(token), jcfg, jcache, jnp.asarray(tables),
            jnp.asarray(lengths), attention_impl=jax_impl)
        tl = paged_decode_step(model, torch.from_numpy(token), cfg, tcache,
                               torch.from_numpy(tables),
                               torch.from_numpy(lengths))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   **TOL)
        token = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        token[2] = 0
        lengths = lengths + np.array([1, 1, 0], np.int32)
    _pools_close(jcache, tcache, [3, 7, 1, 4, 8])


def test_init_params_layout_and_count():
    cfg = get_config("llama-test")
    model = init_params(cfg, seed=3, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.num_params()
    assert model.layers[0].wq.shape == (64, 4, 16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    again = init_params(cfg, seed=3, device="cpu")
    assert torch.equal(model.lm_head, again.lm_head)
    bf = init_params(get_config("llama-test", dtype="bfloat16"), seed=3,
                     device="cpu")
    assert bf.embed.dtype == torch.bfloat16  # stored in the activation dtype


def test_entry_points_raise_without_cuda():
    """The entry points default to the card and raise where there is none
    (decided here, at run time, not at collection)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA error cannot arise")
    cfg = get_config("llama-test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_paged_cache(cfg, 8, 4)
    from triton_kubernetes_tpu_torch.serve import ServeEngine
    model = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, cfg)


def test_later_slices_raise_not_implemented():
    """Nothing of these slices raises any more: expert parallelism needs
    a world of processes (one drives one device, so ``--expert 4`` on one
    is a config error, exit 2; tests/test_torch_elastic.py trains it in a
    world of four), and MoE models, quantized pools and W8A8 weights
    build."""
    from triton_kubernetes_tpu_torch.train.__main__ import main as train
    assert train(["--model", "mixtral-test", "--expert", "4", "--device",
                  "cpu"]) == 2
    moe = init_params(get_config("mixtral-test"), device="cpu")
    assert moe.layers[0].moe_w1.shape == (4, 64, 128)
    from triton_kubernetes_tpu_torch.serve import ServeEngine
    cfg = get_config("llama-test")
    model = init_params(cfg, device="cpu")
    engine = ServeEngine(model, cfg, device="cpu", weight_dtype="int8",
                         matmul_dtype="int8")
    assert engine.config.weight_quant == engine.config.matmul_dtype == "int8"
    assert init_paged_cache(cfg, 8, 4, kv_dtype="int8",
                            device="cpu").quantized


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module, and chip_smoke.py, import without loading
    jax, ml_dtypes or any module of the JAX package -- the training
    package (its checkpoints, resilient loop and data pipelines among
    it), the flash-attention op, the weight and KV quantizers, the
    decode GEMM's wrappers, generation, the decode weight policy, the
    self-drafter, the migration wire format, the trace module, the two
    tools, and the distributed layer (mesh, sharding, collectives,
    multihost, the per-host rank launcher, ring and blockwise attention,
    the sharded step), the
    chaos harness (corpus, generator, shrinker, runner, workload arms, its
    command line) and the GPU provisioning twins (the topology renderers
    and their command line, the node pool and JobSet modules, the workflow
    configs) and the reconcile operator (its state document, backends,
    executor, pool repair and command line) named first."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import triton_kubernetes_tpu_torch.train\n"
        "import triton_kubernetes_tpu_torch.train.__main__\n"
        "import triton_kubernetes_tpu_torch.train.checkpoint\n"
        "import triton_kubernetes_tpu_torch.train.resilience\n"
        "import triton_kubernetes_tpu_torch.train.data\n"
        "import triton_kubernetes_tpu_torch.utils.logging\n"
        "import triton_kubernetes_tpu_torch.ops.flash_attention\n"
        "import triton_kubernetes_tpu_torch.ops.fused_ce\n"
        "import triton_kubernetes_tpu_torch.ops.quantization\n"
        "import triton_kubernetes_tpu_torch.ops.decode_gemm\n"
        "import triton_kubernetes_tpu_torch.models.generate\n"
        "import triton_kubernetes_tpu_torch.train.precision\n"
        "import triton_kubernetes_tpu_torch.serve.speculation\n"
        "import triton_kubernetes_tpu_torch.serve.migration\n"
        "import triton_kubernetes_tpu_torch.utils.trace\n"
        "import triton_kubernetes_tpu_torch.tools.trace\n"
        "import triton_kubernetes_tpu_torch.tools.goodput\n"
        "import triton_kubernetes_tpu_torch.parallel\n"
        "import triton_kubernetes_tpu_torch.parallel.mesh\n"
        "import triton_kubernetes_tpu_torch.parallel.sharding\n"
        "import triton_kubernetes_tpu_torch.parallel.collectives\n"
        "import triton_kubernetes_tpu_torch.parallel.multihost\n"
        "import triton_kubernetes_tpu_torch.parallel.host_launch\n"
        "import triton_kubernetes_tpu_torch.ops.ring_attention\n"
        "import triton_kubernetes_tpu_torch.ops.blockwise_attention\n"
        "import triton_kubernetes_tpu_torch.parallel.placement\n"
        "import triton_kubernetes_tpu_torch.chaos\n"
        "import triton_kubernetes_tpu_torch.chaos.corpus\n"
        "import triton_kubernetes_tpu_torch.chaos.generator\n"
        "import triton_kubernetes_tpu_torch.chaos.shrink\n"
        "import triton_kubernetes_tpu_torch.chaos.runner\n"
        "import triton_kubernetes_tpu_torch.chaos.workload\n"
        "import triton_kubernetes_tpu_torch.tools.chaos\n"
        "import triton_kubernetes_tpu_torch.topology\n"
        "import triton_kubernetes_tpu_torch.topology.gpus\n"
        "import triton_kubernetes_tpu_torch.topology.labels\n"
        "import triton_kubernetes_tpu_torch.topology.daemonsets\n"
        "import triton_kubernetes_tpu_torch.topology.jobset\n"
        "import triton_kubernetes_tpu_torch.topology.serving\n"
        "import triton_kubernetes_tpu_torch.topology.__main__\n"
        "import triton_kubernetes_tpu_torch.modules.gcp_gpu\n"
        "import triton_kubernetes_tpu_torch.workflows.providers.gcp_gpu\n"
        "import triton_kubernetes_tpu_torch.state\n"
        "import triton_kubernetes_tpu_torch.backends\n"
        "import triton_kubernetes_tpu_torch.executor\n"
        "import triton_kubernetes_tpu_torch.workflows.repair\n"
        "import triton_kubernetes_tpu_torch.operator\n"
        "import triton_kubernetes_tpu_torch.tools.operate\n"
        "import triton_kubernetes_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'"
        " or k.startswith('jax.') or k == 'ml_dtypes'"
        " or k.startswith('ml_dtypes.') or k == 'triton_kubernetes_tpu'"
        " or k.startswith('triton_kubernetes_tpu.'))\n"
        "print(len([k for k in sys.modules"
        " if k.startswith('triton_kubernetes_tpu_torch')]), bad)\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 25
