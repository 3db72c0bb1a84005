"""The port's sharded training against the JAX package's, on the CPU.

The port side runs in gloo worlds of 2 and 4 CPU processes (this file run
as a script: ``python tests/test_torch_distributed.py worker ...``), one
world per fixture with every case of that world in it; the JAX side runs
``make_train_step`` on the conftest's virtual devices, on a mesh of the
same shape over ``devices[:n]``. Both start from the same weights (the JAX
init, as numpy) and take the same global batches, ``llama-test`` in f32;
each rank trains its own blocks on its own rows.

Where a wrong result is most likely, and the test that names it:

1. gradients of replicated leaves (norms over ``tensor``, every leaf over
   ``seq`` and ``data``; fsdp-split leaves reduce-scattered):
   ``test_sharded_steps_match_make_train_step`` holds every updated leaf
   of every rank's block to JAX's, not only the loss;
2. the clip's global norm (replicated leaves counted once): the same
   test's ``grad_norm``;
3. the loss under seq and tensor sharding (the global batch's mean): the
   same test at ``seq`` 2 and ``tensor`` 2 and 4; the fused step's mean of
   per-shard means in ``test_fused_step_matches_the_sharded_step``;
4. GQA under tensor parallelism: ``tensor`` 4 with llama-test's 2 kv heads
   (hkv < tensor) in ``test_sharded_steps_match_make_train_step``; a
   tensor axis that divides neither head count (3 and 1 heads at
   ``tensor`` 2) in ``test_whole_heads_when_tensor_divides_no_head_count``;
5. no fallback: ``test_distributed_on_needs_a_world_size_and_nccl``.

Tolerances (f32; only summation orders differ, and the port's flash
attention stands where JAX computes the dense einsum): losses and grad
norms 1e-5 relative; the first step's gradients, every rank's block of
every leaf, 1e-5 relative plus 1e-7 absolute (the check that sees a
gradient summed over the wrong axes: Adam's update does not, since it
divides a leaf's scale out); parameters after two AdamW steps 1e-5
relative plus 1e-5 absolute, a thousandth of one step's largest update
(``lr``) -- near a zero gradient Adam divides by ``sqrt(nu) + eps``, which
turns the gradient's summation-order error into a large relative error of
the update (seen: 1.3e-6 on one embedding element of a token that occurs
once, at fsdp 2 x tensor 2).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from triton_kubernetes_tpu_torch.models import get_config, llama  # noqa: E402
from triton_kubernetes_tpu_torch.parallel.mesh import Mesh, MeshConfig  # noqa: E402
from triton_kubernetes_tpu_torch.parallel.sharding import local_slices  # noqa: E402

MODEL = "llama-test"
B, S = 8, 32
STEPS = 2
OPT = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=100)
REL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
PARAMS_TOL = dict(rtol=1e-5, atol=1e-5)

# (data, stage, fsdp, seq, tensor) of every sharded-step case, by world.
MESHES = {
    2: [(2, 1, 1, 1, 1), (1, 1, 2, 1, 1), (1, 1, 1, 1, 2),
        (1, 2, 1, 1, 1), (1, 1, 1, 2, 1)],
    4: [(2, 1, 2, 1, 1), (1, 1, 2, 1, 2), (1, 1, 1, 1, 4),
        (1, 2, 2, 1, 1)],
}
MICROBATCHES = 4  # for the stage cases
# Head counts the tensor axis of the misfit case divides neither of.
MISFIT = dict(num_heads=3, num_kv_heads=1)
MISFIT_MESH = (1, 1, 1, 1, 2)


def _key(mesh):
    return "mesh" + "_".join(map(str, mesh))


def _sizes(mesh):
    d, st, f, sq, t = mesh
    return dict(data=d, stage=st, fsdp=f, seq=sq, tensor=t)


def _tokens(seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(B, S + 1)).astype(np.int32)


# ---------------------------------------------------------------- workers

def _worker_train(mesh_t, params, world, rank, out, overrides=None,
                  key=None):
    from triton_kubernetes_tpu_torch.parallel import create_mesh
    from triton_kubernetes_tpu_torch.parallel.multihost import \
        make_batch_placer
    from triton_kubernetes_tpu_torch.train import (make_optimizer,
                                                   make_train_step,
                                                   state_for)

    cfg = get_config(MODEL, attention="flash", **(overrides or {}))
    mesh = create_mesh(MeshConfig(**_sizes(mesh_t)), device_type="cpu")
    model = llama.from_numpy_params(params, cfg, device="cpu",
                                    trainable=True, mesh=mesh)
    opt = make_optimizer(**OPT)
    state = state_for(model, opt)
    step = make_train_step(cfg, opt, mesh=mesh, microbatches=MICROBATCHES)
    place = make_batch_placer(mesh, microbatches=MICROBATCHES)
    key = key or _key(mesh_t)
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, place({"tokens": _tokens(10 + i)}))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:  # the synced gradient the first update used
            for name, p in state.model.named_parameters():
                out[f"{key}/grad/{model.layout[name][0]}"] = \
                    p.grad.numpy().copy()
    out[f"{key}/losses"] = np.array(losses)
    out[f"{key}/grad_norms"] = np.array(norms)
    for name, p in state.model.named_parameters():
        out[f"{key}/{model.layout[name][0]}"] = p.detach().numpy().copy()
    return step


def _worker_misfit(params, world, rank, out):
    """The sharded step at tensor 2 on a model of 3 query heads and 1 kv
    head: the flash attention (its plain version here) must run on whole
    heads, loudly, and never the dense einsum."""
    import warnings

    seen = []
    flash = llama._flash

    def counted(q, k, v, positions):
        seen.append((q.shape[2], k.shape[2]))
        return flash(q, k, v, positions)

    def dense(*args):
        raise AssertionError("the dense einsum ran")

    llama._flash, dense_before = counted, llama.causal_attention
    llama.causal_attention = dense
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step = _worker_train(MISFIT_MESH, params, world, rank, out,
                                 MISFIT, "misfit")
    finally:
        llama._flash, llama.causal_attention = flash, dense_before
    out["misfit/heads_seen"] = np.array(sorted(set(seen)))
    out["misfit/forfeits"] = np.array(len(step.attention_fn.forfeits))
    out["misfit/warned"] = np.array(
        sum("whole heads" in str(w.message) for w in caught))


def _worker_fused(params, world, rank, out):
    """The fused step and the sharded step at data 2, same start."""
    from triton_kubernetes_tpu_torch.parallel import create_mesh
    from triton_kubernetes_tpu_torch.parallel.multihost import (
        make_batch_placer, make_fused_dcn_step)
    from triton_kubernetes_tpu_torch.train import (make_optimizer,
                                                   make_train_step,
                                                   state_for)

    cfg = get_config(MODEL, attention="flash")
    mesh = create_mesh(MeshConfig(data=2, fsdp=1), device_type="cpu")
    place = make_batch_placer(mesh)
    opt = make_optimizer(**OPT)
    fused = state_for(llama.from_numpy_params(params, cfg, device="cpu",
                                              trainable=True), opt)
    opt2 = make_optimizer(**OPT)
    xla = state_for(llama.from_numpy_params(params, cfg, device="cpu",
                                            trainable=True, mesh=mesh), opt2)
    fstep = make_fused_dcn_step(cfg, mesh, opt)
    xstep = make_train_step(cfg, opt2, mesh=mesh)
    for i in range(STEPS):
        batch = place({"tokens": _tokens(10 + i)})
        fused, fm = fstep(fused, batch)
        xla, xm = xstep(xla, batch)
        for k in ("loss", "grad_norm"):
            out[f"fused/{k}{i}"] = np.array([float(fm[k]), float(xm[k])])
    for (name, a), b in zip(fused.model.named_parameters(),
                            xla.model.parameters()):
        out[f"fused/{name}"] = a.detach().numpy().copy()
        out[f"xla/{name}"] = b.detach().numpy().copy()


def _worker_checkpoint(params, world, rank, out, ckpt_dir, sizes, tag):
    """Train two steps on the mesh of ``sizes``, save through
    CoordinatedCheckpoint, restore into a fresh state at world 2; count
    the blocks this rank sent to rank 0."""
    import torch.distributed as dist

    from triton_kubernetes_tpu_torch.parallel import create_mesh
    from triton_kubernetes_tpu_torch.parallel.multihost import (
        CoordinatedCheckpoint, make_batch_placer)
    from triton_kubernetes_tpu_torch.train import (CheckpointManager,
                                                   init_state,
                                                   make_optimizer,
                                                   make_train_step,
                                                   mesh_spec_of, state_for)

    cfg = get_config(MODEL, attention="flash")
    mesh = create_mesh(MeshConfig(**sizes), device_type="cpu")
    opt = make_optimizer(**OPT)
    state = state_for(llama.from_numpy_params(params, cfg, device="cpu",
                                              trainable=True, mesh=mesh), opt)
    step = make_train_step(cfg, opt, mesh=mesh)
    place = make_batch_placer(mesh)
    for i in range(STEPS):
        state, _ = step(state, place({"tokens": _tokens(10 + i)}))
    mgr = CoordinatedCheckpoint(CheckpointManager(
        ckpt_dir,
        mesh_spec=mesh_spec_of(mesh, n_processes=world, global_batch=B)))
    sends, send = [], dist.send

    def counted_send(tensor, *args, **kwargs):
        sends.append(tensor.numel())
        return send(tensor, *args, **kwargs)

    dist.send = counted_send
    try:
        mgr.save(STEPS, state, kind="final")
    finally:
        dist.send = send
    out[f"{tag}/sends"] = np.array([len(sends), sum(sends)])
    fresh = init_state(cfg, make_optimizer(**OPT), seed=7, device="cpu",
                       mesh=mesh)
    fresh = mgr.restore(fresh)
    mgr.close()
    same = [torch.equal(a, b) for a, b in zip(
        list(state.model.parameters()) + state.opt_state.mu
        + state.opt_state.nu,
        list(fresh.model.parameters()) + fresh.opt_state.mu
        + fresh.opt_state.nu)]
    out[f"{tag}/bitwise"] = np.array(
        [all(same), fresh.step == state.step,
         fresh.opt_state.count == state.opt_state.count])
    for name, p in state.model.named_parameters():
        out[f"{tag}/{state.model.layout[name][0]}"] = \
            p.detach().numpy().copy()


def worker(world: int, rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    tree = _read_params(os.path.join(out_dir, "params.npz"))
    out = {}
    for mesh_t in MESHES[world]:
        _worker_train(mesh_t, tree, world, rank, out)
    if world == 2:
        _worker_misfit(_read_params(os.path.join(out_dir, "misfit.npz")),
                       world, rank, out)
        _worker_fused(tree, world, rank, out)
        _worker_checkpoint(tree, world, rank, out,
                           os.path.join(out_dir, "ckpt"), {"fsdp": 2},
                           "ckpt")
        _worker_checkpoint(tree, world, rank, out,
                           os.path.join(out_dir, "ckpt_data"), {"data": 2},
                           "ckpt_data")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------ harness

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(script: str, world: int, out_dir: str, timeout: float = 240
                ) -> None:
    """Run ``script worker`` as ``world`` gloo ranks and wait for all."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, script, "worker", str(world), str(r), str(port),
         out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in
           enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, bad


def _jax_params(overrides=None):
    import jax

    from triton_kubernetes_tpu.models import get_config as jget_config
    from triton_kubernetes_tpu.models import llama as jllama

    tree = jllama.init_params(jget_config(MODEL, **(overrides or {})),
                              jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def params():
    return _jax_params()


@pytest.fixture(scope="module")
def misfit_params():
    return _jax_params(MISFIT)


def _write_params(tree, path):
    flat = {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "lm_head": tree["lm_head"]}
    flat.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    np.savez(path, **flat)


def _read_params(path):
    params = dict(np.load(path))
    return {"embed": params.pop("embed"),
            "final_norm": params.pop("final_norm"),
            "lm_head": params.pop("lm_head"),
            "layers": {k.split("/")[1]: v for k, v in params.items()}}


_WORLDS = {}


@pytest.fixture(scope="module")
def worlds(params, misfit_params, tmp_path_factory):
    """``worlds(n)``: one gloo world of ``n`` ranks that ran every case of
    its size (spawned at the first request): (out_dir, each rank's
    outputs)."""

    def get(n):
        if n not in _WORLDS:
            out_dir = str(tmp_path_factory.mktemp(f"world{n}"))
            _write_params(params, os.path.join(out_dir, "params.npz"))
            _write_params(misfit_params, os.path.join(out_dir, "misfit.npz"))
            spawn_world(os.path.abspath(__file__), n, out_dir)
            _WORLDS[n] = out_dir, [
                dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                for r in range(n)]
        return _WORLDS[n]

    return get


def _jax_steps(params, mesh_t, overrides=None):
    """JAX's make_train_step on the same mesh shape: (losses, grad
    norms, final params)."""
    import jax
    import jax.numpy as jnp

    from triton_kubernetes_tpu.models import get_config as jget_config
    from triton_kubernetes_tpu.parallel import MeshConfig as JMeshConfig
    from triton_kubernetes_tpu.parallel import create_mesh as jcreate_mesh
    from triton_kubernetes_tpu.train import trainer as jtrainer

    n = int(np.prod(mesh_t))
    jcfg = jget_config(MODEL, **(overrides or {}))
    mesh = jcreate_mesh(JMeshConfig(**_sizes(mesh_t)),
                        devices=jax.devices()[:n])
    opt = jtrainer.make_optimizer(**OPT)

    def init(p):
        p = jtrainer._constrain_params(p, mesh, jcfg)
        o = jtrainer._constrain_opt_state(opt.init(p), opt, mesh, jcfg)
        return jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                                   opt_state=o)

    state = jax.jit(init)(params)
    step = jtrainer.make_train_step(jcfg, mesh, opt,
                                    microbatches=MICROBATCHES)
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(_tokens(10 + i))})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree.map(
        lambda a: np.asarray(a, np.float32), state.params)


def _jax_grads(params, overrides=None):
    """JAX's gradient of the first batch's loss at the start weights: the
    global loss, so one device's answer is every mesh's."""
    import jax
    import jax.numpy as jnp

    from triton_kubernetes_tpu.models import get_config as jget_config
    from triton_kubernetes_tpu.train import trainer as jtrainer

    jcfg = jget_config(MODEL, **(overrides or {}))
    g = jax.jit(jax.grad(lambda p, tok: jtrainer.loss_fn(p, tok, jcfg)[0]))(
        params, jnp.asarray(_tokens(10)))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), g)


@pytest.fixture(scope="module")
def grads(params):
    return _jax_grads(params)


def _full(tree, glob):
    parts = glob.split(".")
    if parts[0] == "layers":
        return tree["layers"][parts[2]][int(parts[1])]
    return tree[glob]


def _check_blocks(tree, outs, prefix, mesh_t, tol, overrides=None):
    """Every rank's block of every leaf against the same slice of the
    full JAX leaf."""
    cfg = get_config(MODEL, **(overrides or {}))
    checked = set()
    for rank, out in enumerate(outs):
        layout = llama.shard_layout(cfg, Mesh(_sizes(mesh_t), rank, "cpu"))
        for name, (glob, shape, spec) in layout.items():
            want = _full(tree, glob)[local_slices(
                shape, spec, Mesh(_sizes(mesh_t), rank, "cpu"))]
            np.testing.assert_allclose(out[f"{prefix}/{glob}"], want,
                                       err_msg=f"rank {rank} {glob}", **tol)
            checked.add(glob)
    return checked == {n for n, _ in llama._global_shapes(cfg)}


@pytest.mark.parametrize("n,mesh_t", [(n, m) for n in (2, 4)
                                      for m in MESHES[n]],
                         ids=[_key(m) for n in (2, 4) for m in MESHES[n]])
def test_sharded_steps_match_make_train_step(worlds, params, grads, n,
                                             mesh_t):
    """Two sharded steps: loss, grad norm and every rank's block of every
    updated leaf against JAX's step on a mesh of the same shape
    (data, stage, fsdp, seq, tensor). Covers (data, fsdp, tensor) in
    (2,1,1), (1,2,1), (1,1,2), (2,2,1), (1,2,2); tensor 4 (hkv 2 <
    tensor: the GQA repeat); stage 2 across 2 ranks (GPipe, 4
    microbatches), and stage 2 x fsdp 2 across 4 (the first stage gathers
    the embedding over fsdp before its first shift: fault F12, a hang in
    ``new_group`` until every rank made the mesh's groups in one order);
    seq 2 with the ring in the step."""
    _, outs = worlds(n)
    losses, norms, final = _jax_steps(params, mesh_t)
    key = _key(mesh_t)
    for out in outs:
        np.testing.assert_allclose(out[f"{key}/losses"], losses,
                                   err_msg=key, **REL)
        np.testing.assert_allclose(out[f"{key}/grad_norms"], norms,
                                   err_msg=key, **REL)
    assert _check_blocks(grads, outs, f"{key}/grad", mesh_t, GRAD_TOL)
    assert _check_blocks(final, outs, key, mesh_t, PARAMS_TOL)


def test_whole_heads_when_tensor_divides_no_head_count(worlds,
                                                      misfit_params):
    """Tensor 2 on a model of 3 query heads and 1 kv head: neither count
    divides, and one kv head cannot be repeated to cover q heads that are
    not split. The step runs the flash attention on whole heads on both
    ranks (never the dense einsum; loud, with ``forfeits``), ``wo``'s
    block takes each rank's heads, and two steps match JAX's on the same
    mesh: loss, grad norm, every rank's block of the first gradient and of
    every updated leaf."""
    _, outs = worlds(2)
    losses, norms, final = _jax_steps(misfit_params, MISFIT_MESH, MISFIT)
    for out in outs:
        assert out["misfit/heads_seen"].tolist() == [[3, 1]]
        assert int(out["misfit/forfeits"]) > 0
        assert int(out["misfit/warned"]) == 1
        np.testing.assert_allclose(out["misfit/losses"], losses, **REL)
        np.testing.assert_allclose(out["misfit/grad_norms"], norms, **REL)
    assert _check_blocks(_jax_grads(misfit_params, MISFIT), outs,
                         "misfit/grad", MISFIT_MESH, GRAD_TOL, MISFIT)
    assert _check_blocks(final, outs, "misfit", MISFIT_MESH, PARAMS_TOL,
                         MISFIT)


def test_fused_step_matches_the_sharded_step(worlds, params):
    """``make_fused_dcn_step`` at data 2 (one all-reduce of gradients and
    metrics) against the sharded step at data 2 -- loss, grad norm, every
    leaf of the replica -- and both against JAX's step."""
    _, outs = worlds(2)
    losses, norms, final = _jax_steps(params, (2, 1, 1, 1, 1))
    for out in outs:
        for i in range(STEPS):
            f, x = out[f"fused/loss{i}"]
            np.testing.assert_allclose(f, x, rtol=1e-6)
            np.testing.assert_allclose(f, losses[i], **REL)
            f, x = out[f"fused/grad_norm{i}"]
            np.testing.assert_allclose(f, x, rtol=1e-6)
            np.testing.assert_allclose(f, norms[i], **REL)
        for name, _ in llama.init_params(get_config(MODEL), device="cpu",
                                         trainable=True).named_parameters():
            np.testing.assert_allclose(out[f"fused/{name}"],
                                       out[f"xla/{name}"], rtol=1e-6,
                                       atol=1e-7, err_msg=name)
            np.testing.assert_allclose(out[f"fused/{name}"],
                                       _full(final, name), err_msg=name,
                                       **PARAMS_TOL)
    # The replicas stay bitwise equal across ranks.
    for k in outs[0]:
        if k.startswith("fused/"):
            np.testing.assert_array_equal(outs[0][k], outs[1][k])


@pytest.mark.parametrize("tag,mesh_t", [("ckpt", (1, 1, 2, 1, 1)),
                                        ("ckpt_data", (2, 1, 1, 1, 1))])
def test_coordinated_checkpoint_restores_at_world_1_and_2(worlds, tag,
                                                         mesh_t):
    """A ``CoordinatedCheckpoint`` written at world 2 -- fsdp 2 (every
    matrix split across the two ranks) and data 2 (two replicas) --
    restores bitwise into a fresh state at world 2 (each rank re-slices)
    and at world 1 (a plain manager into the one-device state: the
    manifest's paths and shapes are the one-device state's). Rank 0
    receives each distinct block once: at fsdp 2 rank 1 sends its half of
    every leaf that splits, at data 2 nothing."""
    from triton_kubernetes_tpu_torch.train import (CheckpointManager,
                                                   init_state,
                                                   make_optimizer)

    out_dir, outs = worlds(2)
    for out in outs:
        assert out[f"{tag}/bitwise"].all()
    cfg = get_config(MODEL, attention="flash")
    state = init_state(cfg, make_optimizer(**OPT), seed=5, device="cpu")
    mgr = CheckpointManager(os.path.join(out_dir, tag))
    manifest = mgr.manifest(STEPS)
    assert {k: v for k, v in manifest["mesh"]["axes"].items() if v > 1} \
        == {k: v for k, v in _sizes(mesh_t).items() if v > 1}
    assert manifest["mesh"]["n_processes"] == 2
    state = mgr.restore(state)
    mgr.close()
    assert state.step == STEPS and state.opt_state.count == STEPS
    n_split = numel_split = 0
    for name, p in state.model.named_parameters():
        for rank, out in enumerate(outs):
            layout = llama.shard_layout(cfg, Mesh(_sizes(mesh_t), rank))
            glob, shape, spec = layout[name]
            got = p.detach().numpy()[local_slices(
                shape, spec, Mesh(_sizes(mesh_t), rank))]
            np.testing.assert_array_equal(got, out[f"{tag}/{glob}"])
        if outs[1][f"{tag}/{glob}"].shape != tuple(p.shape):
            n_split += 1
            numel_split += outs[1][f"{tag}/{glob}"].size
    # Rank 1 sends its block of each leaf that splits, of the model, mu
    # and nu; rank 0 sends nothing.
    assert outs[0][f"{tag}/sends"].tolist() == [0, 0]
    assert outs[1][f"{tag}/sends"].tolist() == [3 * n_split,
                                                 3 * numel_split]
    assert (n_split > 0) == (tag == "ckpt")


def test_launch_trainers_runs_two_processes_and_fails_fast(tmp_path):
    """``launch_trainers``: a 2-process CLI run on the CPU takes the
    fused gradient exchange on a data-2 mesh, writes rank 0's report and
    rank-tagged logs; a fused exchange that cannot run, and a batch that
    does not divide, exit 2; a rank that dies at startup
    gets its peer reaped at once, not at the timeout."""
    from triton_kubernetes_tpu_torch.parallel.multihost import \
        launch_trainers

    args = ["--model", MODEL, "--device", "cpu", "--steps", "3",
            "--batch-size", "4", "--seq-len", "16", "--log-every", "1",
            "--json-logs", "--warmup-steps", "1", "--prefetch", "0"]
    rep = launch_trainers(args, n_processes=2, run_dir=str(tmp_path / "ok"),
                          timeout=240, pin_cores=False)
    assert rep.ok, [w.tail for w in rep.workers]
    assert rep.report["dcn_sync"] == "fused"
    assert rep.report["mesh"].startswith("mesh(data=2")
    assert rep.report["n_processes"] == 2
    assert len(rep.report["losses"]) == 3
    assert np.all(np.isfinite(rep.report["losses"]))
    for w in rep.workers:
        lines = [json.loads(x) for x in open(w.log_path)
                 if x.startswith("{")]
        tagged = [x for x in lines if x.get("process") == w.process_id]
        assert tagged and len(tagged) >= len(lines) - 2, lines[:3]
    # A fused exchange asked for on a tensor-split mesh is a config error
    # (rc 2), as is a batch the data axis does not divide: the first rank
    # out exits 2 and the launcher reaps the other from the exit barrier.
    for extra, msg in ((["--tensor", "2", "--dcn-sync", "fused"],
                        "fused DCN sync unavailable"),
                       (["--batch-size", "3"], "must divide")):
        rep = launch_trainers(args + extra, n_processes=2,
                              run_dir=str(tmp_path / extra[0][2:]),
                              timeout=240, pin_cores=False)
        assert 2 in rep.returncodes and 0 not in rep.returncodes
        assert all(rc in (2, -9) for rc in rep.returncodes)
        assert any(msg in w.tail for w in rep.workers)
    t0 = time.perf_counter()
    rep = launch_trainers(args, n_processes=2, run_dir=str(tmp_path / "die"),
                          timeout=240, pin_cores=False,
                          env_extra={"TK8S_TEST_CRASH_RANK": "1"})
    assert not rep.ok
    assert rep.returncodes[1] == 3
    assert time.perf_counter() - t0 < 60
    assert "TK8S_TEST_CRASH_RANK" in rep.workers[1].tail


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(*map(int, sys.argv[2:5]), sys.argv[5])
