"""The port's ring and blockwise attention against the JAX package's, on
the CPU.

Blockwise: forward and q/k/v gradients against
``triton_kubernetes_tpu.ops.blockwise_attention`` with GQA and a sequence
that pads to the block, with and without the positions operand. Ring: a
gloo world of 2 and of 4 CPU processes (this file run as a script) each
hold one sequence shard; output and dq/dk/dv of every shard against the
reference's ``make_ring_attention`` on a seq mesh of the same size over the
conftest's virtual devices, with and without the positions operand (the
form the pipeline nests), and the one-block ring (n = 1) against the
dense einsum. Seeded numpy inputs in f32; tolerance 1e-5 relative plus
1e-6 absolute (summation order only).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_distributed import spawn_world  # noqa: E402
from triton_kubernetes_tpu_torch.ops.blockwise_attention import \
    blockwise_attention  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
B, S, HQ, HKV, D = 2, 32, 4, 2, 16


def _inputs(s=S, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, s, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, s, HKV, D)).astype(np.float32)
    do = rng.standard_normal((B, s, HQ, D)).astype(np.float32)
    return q, k, v, do


def _torch_grads(fn, q, k, v, do):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.tensor(do))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _jax_grads(fn, q, k, v, do):
    """(out, dq, dk, dv) of ``fn`` under one ``jax.jit`` (a shard_map's
    vjp compiles once instead of dispatching eagerly)."""
    import jax

    def both(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(do)

    return [np.asarray(x) for x in jax.jit(both)(q, k, v, do)]


# ---------------------------------------------------------------- blockwise

@pytest.mark.parametrize("s,block_k,with_pos", [
    (32, 8, False), (40, 16, False), (40, 16, True), (24, 1024, False)])
def test_blockwise_matches_reference(s, block_k, with_pos):
    import jax.numpy as jnp

    from triton_kubernetes_tpu.ops.blockwise_attention import \
        blockwise_attention as jblockwise

    q, k, v, do = _inputs(s)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s))
    got = _torch_grads(lambda q, k, v: blockwise_attention(
        q, k, v, torch.tensor(pos) if with_pos else None, block_k),
        q, k, v, do)
    want = _jax_grads(lambda q, k, v: jblockwise(
        q, k, v, jnp.asarray(pos) if with_pos else None, block_k),
        q, k, v, do)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_blockwise_equals_dense_and_saves_no_logits():
    """Blockwise is the dense einsum's math; its backward recomputes from
    (q, k, v, out, lse), so autograd holds nothing of S x S."""
    from triton_kubernetes_tpu_torch.ops.attention import causal_attention

    q, k, v, do = _inputs(40)
    got = _torch_grads(lambda q, k, v: blockwise_attention(q, k, v,
                                                           block_k=16),
                       q, k, v, do)
    want = _torch_grads(lambda q, k, v: causal_attention(q, k, v),
                        q, k, v, do)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = blockwise_attention(*ts, block_k=16)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (B, 40, HQ, D), (B, 40, HKV, D), (B, 40, HKV, D), (B, 40, HQ, D),
        (B, HKV, HQ // HKV, 40)]


# --------------------------------------------------------------------- ring

def worker(world: int, rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from triton_kubernetes_tpu_torch.ops.ring_attention import \
        make_ring_attention
    from triton_kubernetes_tpu_torch.parallel import MeshConfig, create_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    mesh = create_mesh(MeshConfig(fsdp=1, seq=world), device_type="cpu")
    ring = make_ring_attention(mesh)
    sl = S // world
    part = slice(rank * sl, (rank + 1) * sl)
    q, k, v, do = (x[:, part] for x in _inputs())
    pos = torch.arange(S).expand(B, S)[:, part]
    out = {}
    for tag, p in (("nopos", None), ("pos", pos)):
        got = _torch_grads(lambda q, k, v: ring(q, k, v, p), q, k, v, do)
        for name, a in zip(("out", "dq", "dk", "dv"), got):
            out[f"{tag}/{name}"] = a
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"seq{n}")
def ring_world(request, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp(f"ring{request.param}"))
    spawn_world(os.path.abspath(__file__), request.param, out_dir)
    return request.param, [dict(np.load(os.path.join(out_dir,
                                                     f"rank{r}.npz")))
                           for r in range(request.param)]


@pytest.mark.parametrize("tag", ["nopos", "pos"])
def test_ring_matches_make_ring_attention(ring_world, tag):
    """Each shard's output and dq/dk/dv against the reference's ring on
    a seq mesh of the same size (its positions operand for "pos")."""
    import jax
    import jax.numpy as jnp

    from triton_kubernetes_tpu.ops.ring_attention import \
        make_ring_attention as jmake_ring
    from triton_kubernetes_tpu.parallel import MeshConfig, create_mesh

    n, outs = ring_world
    mesh = create_mesh(MeshConfig(fsdp=1, seq=n), devices=jax.devices()[:n])
    ring = jmake_ring(mesh, batch_axes=(), head_axis=None)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = _jax_grads(
        lambda q, k, v: ring(q, k, v, pos if tag == "pos" else None),
        *_inputs())
    sl = S // n
    for rank, out in enumerate(outs):
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(
                out[f"{tag}/{name}"], w[:, rank * sl:(rank + 1) * sl],
                err_msg=f"rank {rank} {name}", **TOL)
            # The positions operand changes no bit: it carries what the
            # rank index would compute.
            np.testing.assert_array_equal(out[f"pos/{name}"],
                                          out[f"nopos/{name}"])


def test_ring_of_one_block_is_dense_attention():
    """n = 1 (``--ring-attention`` on an unsplit sequence): one block,
    the dense einsum's math, on a mesh with no process group."""
    from triton_kubernetes_tpu_torch.ops.attention import causal_attention
    from triton_kubernetes_tpu_torch.ops.ring_attention import \
        make_ring_attention
    from triton_kubernetes_tpu_torch.parallel import MeshConfig, create_mesh

    ring = make_ring_attention(create_mesh(MeshConfig(fsdp=1), world=1,
                                           device_type="cpu"))
    q, k, v, do = _inputs()
    got = _torch_grads(lambda q, k, v: ring(q, k, v), q, k, v, do)
    want = _torch_grads(causal_attention, q, k, v, do)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(*map(int, sys.argv[2:5]), sys.argv[5])
