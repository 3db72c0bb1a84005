"""Fault F2 on the CPU: a prefill window's full pages do not depend on the
window's width.

The reference pins that full pages written by 8-token windows are bitwise
the pages written by 16-token ones, "page contents are a function of the
tokens alone" (``tests/test_paged_attention.py``,
``test_paged_prefill_chunk_window_invariance``): a page filled by one
writer is then valid for a reader whose windows are cut otherwise. The
port's windows take their weight products through the row-invariant
``ops.decode_gemm`` (the kernel on the card, where a library GEMM's rows
change with the row count), so the pin holds there; here it is held on the
CPU at the reference test's setup: ``llama-test`` f32 from the reference's
initial tree, its 32-token prompt, block size 4, a 16-page table -- and the
same under W8A8 int8 (exact integer products) and on an int8 pool.
"""

import jax
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import init_params as jinit_params
from triton_kubernetes_tpu_torch.models import (
    from_numpy_params,
    get_config,
    init_paged_cache,
    paged_prefill_chunk,
    quantize_weights,
)
from triton_kubernetes_tpu_torch.ops import decode_gemm as dg

BS, T = 4, 16


@pytest.fixture(scope="module")
def model():
    jparams = jinit_params(jget_config("llama-test"), jax.random.PRNGKey(0))
    return from_numpy_params(jax.tree.map(np.asarray, jparams),
                             get_config("llama-test"), device="cpu")


def _chunked(model, cfg, prompt, chunk, kv_dtype="auto"):
    """The prompt written by absolute ``chunk``-token windows into a fresh
    pool through a table of pages 1..T (the reference test's helper)."""
    cache = init_paged_cache(cfg, 40, BS, kv_dtype=kv_dtype, device="cpu")
    table = torch.arange(1, T + 1, dtype=torch.int32)
    with torch.inference_mode():
        for off in range(0, len(prompt), chunk):
            clen = min(chunk, len(prompt) - off)
            toks = prompt[off:off + clen] + [0] * (chunk - clen)
            paged_prefill_chunk(model, torch.tensor([toks], dtype=torch.int32),
                                off, clen, cfg, cache, table)
    return cache


@pytest.mark.parametrize("weights,kv_dtype", [
    (None, "auto"), ("int8", "auto"), (None, "int8")],
    ids=["f32", "w8a8-int8", "int8-pool"])
def test_full_pages_do_not_depend_on_the_window(model, weights, kv_dtype):
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(1, model.config.vocab_size, 32)]
    cfg = model.config
    if weights:
        model = quantize_weights(model, weights)
        cfg = get_config("llama-test", weight_quant=weights,
                         matmul_dtype=weights)
    dg.reset_launch_counts()
    c8 = _chunked(model, cfg, prompt, 8, kv_dtype)
    c16 = _chunked(model, cfg, prompt, 16, kv_dtype)
    assert dg.decode_gemm_group.launches == 0  # the plain version here
    full = len(prompt) // BS
    for a, b in ((c8.k, c16.k), (c8.v, c16.v), (c8.k_scale, c16.k_scale),
                 (c8.v_scale, c16.v_scale)):
        if a is None:
            continue
        for page in range(1, full + 1):
            assert torch.equal(a[:, page], b[:, page]), page
