"""The port's MoE training on a mesh against the JAX package's, on the CPU.

The port side runs in gloo worlds of 2 and 4 CPU processes (this file run
as a script: ``python tests/test_torch_expert_parallel.py worker ...``,
spawned by ``test_torch_distributed.spawn_world``), one world per fixture
with every case of that world in it; the JAX side runs
``make_train_step`` on the conftest's virtual devices, on a mesh of the
same shape over ``devices[:n]``. Both start from the same weights (the
JAX init of ``mixtral-test``, as numpy, f32) and take the same global
batches, at a capacity factor of 1.0, where tokens are dropped (the test
asserts that they are).

What each mesh pins:

1. ``data`` 2, ``fsdp`` 2 and ``seq`` 2 (the ring in the step): the
   routing of the global batch -- capacity, seats and drops over every
   token, and the aux loss's two means over every token -- although each
   rank holds half of the tokens (F6);
2. ``expert`` 2 and 4: each rank runs its own experts on the slots they
   kept, the combine summed over the expert ranks, the router's and the
   layer input's gradients summed there once and the aux loss's counted
   once, expert leaves never summed over ``expert``;
3. ``expert`` 2 x ``tensor`` 2 and ``expert`` 2 x ``fsdp`` 2: the
   reference's ``tests/test_parallel.py:91-107`` shapes cut to four ranks
   (experts split over ``expert``, their ``mlp`` and ``embed`` dims over
   ``tensor`` and ``fsdp``);
4. ``stage`` 2 x ``data`` 2 and ``stage`` 2 x ``fsdp`` 2 at 4
   microbatches: GPipe with the rows split. The reference's microbatch m
   is rows [m B/M, (m+1) B/M) of the global batch, its stage buffer
   sharded ``P(stage, (data, fsdp), seq)``; the batch placer gives rank r
   of the R row shards rows [m B/M + r B/(M R), m B/M + (r+1) B/(M R)) of
   every microbatch m, in m order, so each tick's routing seats one global
   microbatch (JAX's side: ``make_train_step(..., microbatches=4)``, its
   gradient the pipelined loss's). The placer's rows are held to the
   ``NamedSharding`` of that buffer, and the trainer's four-process world
   at ``--stage 2 --data 2`` -- through an elastic restart onto two
   processes (``data`` 1) and back -- to the one-process GPipe run.

Every mesh runs both dispatches ("dense" and "sort"). The bounds are
``test_torch_distributed.py``'s: losses and grad norms 1e-5 relative, the
first step's gradient (every rank's block of every leaf) 1e-5 relative
plus 1e-7 absolute, parameters after two steps 1e-5 relative plus 1e-5
absolute.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if path not in sys.path:
        sys.path.insert(0, path)

from test_torch_distributed import (GRAD_TOL, OPT, PARAMS_TOL,  # noqa: E402
                                    REL, STEPS, _full, _read_params,
                                    _tokens, _write_params, spawn_world)
from triton_kubernetes_tpu_torch.models import get_config, llama  # noqa: E402
from triton_kubernetes_tpu_torch.parallel.mesh import Mesh, MeshConfig  # noqa: E402
from triton_kubernetes_tpu_torch.parallel.sharding import local_slices  # noqa: E402

MODEL = "mixtral-test"
CF = 1.0
DISPATCHES = ("dense", "sort")
AXES = ("data", "stage", "fsdp", "seq", "expert", "tensor")
# (data, stage, fsdp, seq, expert, tensor) of every case, by world.
MESHES = {
    2: [(2, 1, 1, 1, 1, 1), (1, 1, 2, 1, 1, 1), (1, 1, 1, 2, 1, 1),
        (1, 1, 1, 1, 2, 1)],
    4: [(1, 1, 1, 1, 4, 1), (1, 1, 1, 1, 2, 2), (1, 1, 2, 1, 2, 1),
        (2, 2, 1, 1, 1, 1), (1, 2, 2, 1, 1, 1)],
}
# GPipe's microbatches for the stage cases (the stage count elsewhere).
MICROBATCHES = 4
CASES = [(n, m, d) for n in (2, 4) for m in MESHES[n] for d in DISPATCHES]


def _overrides(dispatch):
    return dict(capacity_factor=CF, moe_dispatch=dispatch)


def _sizes(mesh_t):
    return dict(zip(AXES, mesh_t))


def _key(mesh_t, dispatch):
    return "mesh" + "_".join(map(str, mesh_t)) + "_" + dispatch


def _stages(mesh_t):
    """(stages, microbatches) of a case: GPipe's, or (1, 1)."""
    stages = _sizes(mesh_t)["stage"]
    return (stages, MICROBATCHES) if stages > 1 else (1, 1)


# ---------------------------------------------------------------- workers

def _worker_train(mesh_t, dispatch, params, out):
    from triton_kubernetes_tpu_torch.parallel import create_mesh
    from triton_kubernetes_tpu_torch.parallel.multihost import \
        make_batch_placer
    from triton_kubernetes_tpu_torch.train import (make_eval_step,
                                                   make_optimizer,
                                                   make_train_step,
                                                   state_for)

    cfg = get_config(MODEL, attention="flash", **_overrides(dispatch))
    mesh = create_mesh(MeshConfig(**_sizes(mesh_t)), device_type="cpu")
    model = llama.from_numpy_params(params, cfg, device="cpu",
                                    trainable=True, mesh=mesh)
    opt = make_optimizer(**OPT)
    state = state_for(model, opt)
    _, micro = _stages(mesh_t)
    step = make_train_step(cfg, opt, mesh=mesh, microbatches=micro)
    place = make_batch_placer(mesh, microbatches=micro)
    key = _key(mesh_t, dispatch)
    losses, norms, auxs = [], [], []
    for i in range(STEPS):
        state, m = step(state, place({"tokens": _tokens(10 + i)}))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        auxs.append(float(m["aux_loss"]))
        if i == 0:
            for name, p in state.model.named_parameters():
                out[f"{key}/grad/{model.layout[name][0]}"] = \
                    p.grad.numpy().copy()
    out[f"{key}/losses"] = np.array(losses)
    out[f"{key}/grad_norms"] = np.array(norms)
    out[f"{key}/aux"] = np.array(auxs)
    if micro > 1:  # GPipe's eval step on the updated blocks
        m = make_eval_step(cfg, mesh=mesh, microbatches=micro)(
            state.model, place({"tokens": _tokens(10 + STEPS)}))
        out[f"{key}/eval"] = np.array([float(m["loss"]),
                                       float(m["aux_loss"])])
    for name, p in state.model.named_parameters():
        out[f"{key}/{model.layout[name][0]}"] = p.detach().numpy().copy()
        out[f"{key}/shape/{model.layout[name][0]}"] = np.array(p.shape)


def worker(world: int, rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    tree = _read_params(os.path.join(out_dir, "params.npz"))
    out = {}
    for mesh_t in MESHES[world]:
        for dispatch in DISPATCHES:
            _worker_train(mesh_t, dispatch, tree, out)
    if world == 2:
        import test_torch_distributed

        # Its checkpoint case, on this file's model.
        test_torch_distributed.MODEL = MODEL
        test_torch_distributed._worker_checkpoint(
            tree, world, rank, out, os.path.join(out_dir, "ckpt"),
            {"expert": 2}, "ckpt")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------ harness

def _jax_params():
    import jax

    from triton_kubernetes_tpu.models import get_config as jget_config
    from triton_kubernetes_tpu.models import llama as jllama

    tree = jllama.init_params(jget_config(MODEL), jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def params():
    return _jax_params()


_WORLDS = {}


@pytest.fixture(scope="module")
def worlds(params, tmp_path_factory):
    """``worlds(n)``: one gloo world of ``n`` ranks that ran every case of
    its size (spawned at the first request): (out_dir, each rank's
    outputs)."""

    def get(n):
        if n not in _WORLDS:
            out_dir = str(tmp_path_factory.mktemp(f"moe_world{n}"))
            _write_params(params, os.path.join(out_dir, "params.npz"))
            spawn_world(os.path.abspath(__file__), n, out_dir, timeout=300)
            _WORLDS[n] = out_dir, [
                dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                for r in range(n)]
        return _WORLDS[n]

    return get


def _jax_steps(params, mesh_t, dispatch):
    """JAX's make_train_step on the same mesh shape: (losses, grad norms,
    aux losses, final params, and under GPipe its make_eval_step's loss
    and aux loss on the next batch at the final params, else None)."""
    import jax
    import jax.numpy as jnp

    from triton_kubernetes_tpu.models import get_config as jget_config
    from triton_kubernetes_tpu.parallel import MeshConfig as JMeshConfig
    from triton_kubernetes_tpu.parallel import create_mesh as jcreate_mesh
    from triton_kubernetes_tpu.train import trainer as jtrainer

    n = int(np.prod(mesh_t))
    jcfg = jget_config(MODEL, **_overrides(dispatch))
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
                                    microbatches=_stages(mesh_t)[1])
    losses, norms, auxs = [], [], []
    for i in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(_tokens(10 + i))})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        auxs.append(float(m["aux_loss"]))
    evals = None
    if _stages(mesh_t)[0] > 1:
        m = jtrainer.make_eval_step(jcfg, mesh, microbatches=MICROBATCHES)(
            state.params, {"tokens": jnp.asarray(_tokens(10 + STEPS))})
        evals = [float(m["loss"]), float(m["aux_loss"])]
    return losses, norms, auxs, jax.tree.map(
        lambda a: np.asarray(a, np.float32), state.params), evals


_GRADS = {}


def _jax_grads(params, dispatch, stages=1, microbatches=1):
    """JAX's gradient of the first batch's loss at the start weights (the
    global loss: one device's answer is every mesh's; under GPipe the
    pipelined loss, whose routing runs per microbatch)."""
    key = (dispatch, stages, microbatches)
    if key not in _GRADS:
        import jax
        import jax.numpy as jnp

        from triton_kubernetes_tpu.models import get_config as jget_config
        from triton_kubernetes_tpu.train import trainer as jtrainer

        jcfg = jget_config(MODEL, **_overrides(dispatch))
        g = jax.jit(jax.grad(
            lambda p, tok: jtrainer.loss_fn(p, tok, jcfg, None, stages,
                                            microbatches)[0]))(
            params, jnp.asarray(_tokens(10)))
        _GRADS[key] = jax.tree.map(lambda a: np.asarray(a, np.float32), g)
    return _GRADS[key]


def _check_blocks(tree, outs, prefix, mesh_t, tol):
    """Every rank's block of every leaf against the same slice of the
    full JAX leaf; returns the leaves whose blocks are split."""
    cfg = get_config(MODEL)
    checked, split = set(), set()
    for rank, out in enumerate(outs):
        mesh = Mesh(_sizes(mesh_t), rank, "cpu")
        for name, (glob, shape, spec) in llama.shard_layout(
                cfg, mesh).items():
            want = _full(tree, glob)[local_slices(shape, spec, mesh)]
            np.testing.assert_allclose(out[f"{prefix}/{glob}"], want,
                                       err_msg=f"rank {rank} {glob}", **tol)
            checked.add(glob)
            if want.shape != tuple(shape):
                split.add(glob)
    assert checked == {n for n, _ in llama._global_shapes(cfg)}
    return split


def _drops(params, dispatch, stages=1, microbatches=1):
    """Assignments the one-device port model drops over the first batch
    (every layer, and under GPipe every microbatch), counted where its
    seating runs (``moe._positions``: a position at or past the capacity
    is a drop)."""
    from triton_kubernetes_tpu_torch.ops import moe
    from triton_kubernetes_tpu_torch.train.pipeline import pipeline_forward

    cfg = get_config(MODEL, **_overrides(dispatch))
    model = llama.from_numpy_params(params, cfg, device="cpu")
    dropped = []
    positions = moe._positions

    def counted_positions(top_i):
        pos = positions(top_i)
        cap = moe._capacity(cfg.capacity_factor, cfg.num_selected,
                            top_i.shape[0], cfg.num_experts)
        dropped.append(int((pos >= cap).sum()))
        return pos

    moe._positions = counted_positions
    inputs = torch.as_tensor(_tokens(10))[:, :-1]
    try:
        with torch.no_grad():
            if stages > 1:
                pipeline_forward(model, inputs, cfg, stages, microbatches)
            else:
                llama.forward(model, inputs, cfg)
    finally:
        moe._positions = positions
    assert len(dropped) == cfg.num_layers * microbatches
    return sum(dropped)


@pytest.mark.parametrize("n,mesh_t,dispatch", CASES,
                         ids=[_key(m, d) for _, m, d in CASES])
def test_moe_steps_match_make_train_step(worlds, params, n, mesh_t,
                                         dispatch):
    """Two sharded steps of ``mixtral-test`` at a capacity factor that
    drops tokens: loss, aux loss, grad norm, every rank's block of the
    first gradient and of every updated leaf against JAX's step on a mesh
    of the same shape (data, stage, fsdp, seq, expert, tensor); under
    GPipe also the eval step's loss and aux loss on the next batch. On an
    expert axis the expert leaves are split (``E / expert`` experts a
    rank) and the router is not."""
    _, outs = worlds(n)
    stages, micro = _stages(mesh_t)
    assert _drops(params, dispatch, stages, micro) > 0
    losses, norms, auxs, final, evals = _jax_steps(params, mesh_t, dispatch)
    key = _key(mesh_t, dispatch)
    for out in outs:
        np.testing.assert_allclose(out[f"{key}/losses"], losses,
                                   err_msg=key, **REL)
        np.testing.assert_allclose(out[f"{key}/aux"], auxs, err_msg=key,
                                   **REL)
        np.testing.assert_allclose(out[f"{key}/grad_norms"], norms,
                                   err_msg=key, **REL)
        if evals is not None:
            np.testing.assert_allclose(out[f"{key}/eval"], evals,
                                       err_msg=key, **REL)
    _check_blocks(_jax_grads(params, dispatch, stages, micro), outs,
                  f"{key}/grad", mesh_t, GRAD_TOL)
    split = _check_blocks(final, outs, key, mesh_t, PARAMS_TOL)
    sizes = _sizes(mesh_t)
    e = get_config(MODEL).num_experts
    for glob in (f"layers.{i}.{leaf}" for i in range(2)
                 for leaf in ("moe_w1", "moe_w3", "moe_w2")):
        # A layer's leaves live on its stage's ranks only.
        shape = next(out[f"{key}/shape/{glob}"] for out in outs
                     if f"{key}/shape/{glob}" in out)
        assert shape[0] == e // sizes["expert"]
        assert (glob in split) == (
            sizes["expert"] * sizes["fsdp"] * sizes["tensor"] > 1)
    assert "layers.0.router" in split if sizes["fsdp"] > 1 else \
        "layers.0.router" not in split


def test_expert_split_checkpoint_restores_at_world_1_and_2(worlds):
    """A ``CoordinatedCheckpoint`` written at ``expert`` 2 (every expert
    leaf split across the two ranks) restores bitwise into a fresh state
    at world 2 (each rank re-slices) and at world 1 (a plain manager into
    the one-device state, whose paths and shapes the manifest records).
    Rank 1 sends its block of each expert leaf, of the model and both
    moments, and nothing else."""
    from triton_kubernetes_tpu_torch.train import (CheckpointManager,
                                                   init_state,
                                                   make_optimizer)

    out_dir, outs = worlds(2)
    for out in outs:
        assert out["ckpt/bitwise"].all()
    cfg = get_config(MODEL, attention="flash")
    state = init_state(cfg, make_optimizer(**OPT), seed=5, device="cpu")
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
    manifest = mgr.manifest(STEPS)
    assert {k: v for k, v in manifest["mesh"]["axes"].items() if v > 1} \
        == {"expert": 2}
    state = mgr.restore(state)
    mgr.close()
    assert state.step == STEPS and state.opt_state.count == STEPS
    sizes = {"expert": 2}
    n_split = numel_split = 0
    for name, p in state.model.named_parameters():
        for rank, out in enumerate(outs):
            mesh = Mesh(sizes, rank)
            glob, shape, spec = llama.shard_layout(cfg, mesh)[name]
            np.testing.assert_array_equal(
                p.detach().numpy()[local_slices(shape, spec, mesh)],
                out[f"ckpt/{glob}"], err_msg=glob)
        if outs[1][f"ckpt/{glob}"].shape != tuple(p.shape):
            assert name.rsplit(".", 1)[-1] in ("moe_w1", "moe_w3", "moe_w2")
            n_split += 1
            numel_split += outs[1][f"ckpt/{glob}"].size
    assert n_split == 3 * cfg.num_layers
    assert outs[0]["ckpt/sends"].tolist() == [0, 0]
    assert outs[1]["ckpt/sends"].tolist() == [3 * n_split, 3 * numel_split]



@pytest.mark.parametrize("sizes", [
    dict(stage=2, data=2), dict(stage=2, fsdp=2),
    dict(stage=2, data=2, fsdp=2)], ids=lambda d: "_".join(
        f"{k}{v}" for k, v in d.items()))
def test_placer_rows_are_the_stage_buffers_shards(sizes):
    """Under ``stage`` > 1 each rank's rows are, microbatch by
    microbatch, the rows its device holds of the reference's stage buffer
    ``[M, mb, S]`` under ``NamedSharding(mesh, P(stage, (data, fsdp),
    seq))``: the buffer's row dim split over the row shards, the same for
    every microbatch (the stage dim names which stage's slot a device
    holds; every rank takes all M microbatches' rows)."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from triton_kubernetes_tpu.parallel import MeshConfig as JMeshConfig
    from triton_kubernetes_tpu.parallel import create_mesh as jcreate_mesh
    from triton_kubernetes_tpu_torch.parallel.multihost import (
        local_batch_rows, make_batch_placer)
    from triton_kubernetes_tpu_torch.train.trainer import batch_spec

    b, seq, micro = 16, 4, MICROBATCHES
    n = int(np.prod(list(sizes.values())))
    jmesh = jcreate_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])
    assert tuple(jmesh.axis_names) == AXES
    shape = (micro, b // micro, seq)
    buf = np.broadcast_to(np.arange(b).reshape(micro, -1, 1), shape)
    index = NamedSharding(jmesh, P("stage", ("data", "fsdp"), "seq")
                          ).devices_indices_map(shape)
    batch = {"tokens": np.arange(b)[:, None] * np.ones((1, seq + 1), int)}
    for rank in range(n):
        mesh = Mesh(sizes, rank)
        coord = mesh.coordinate()
        dev = jmesh.devices[tuple(coord[a] for a in AXES)]
        sl_m, sl_rows, _ = index[dev]
        got = make_batch_placer(mesh, microbatches=micro)(batch)["tokens"]
        assert (got == got[:, :1]).all()
        rows = got[:, 0].reshape(micro, -1)
        np.testing.assert_array_equal(rows, buf[:, sl_rows, 0])
        np.testing.assert_array_equal(rows[sl_m], buf[sl_m, sl_rows, 0])
        assert local_batch_rows(mesh, batch_spec(), b, micro) == rows.size
    # At stage 1 the placement is the plain row blocks, whatever M.
    mesh = Mesh(dict(data=2, fsdp=2), 1)
    assert make_batch_placer(mesh, microbatches=micro)(batch)["tokens"][
        :, 0].tolist() == [4, 5, 6, 7]


GPIPE_MICRO = 4
GPIPE_ARGS = ["--device", "cpu", "--model", MODEL, "--stage", "2", "--data",
              "2", "--microbatches", str(GPIPE_MICRO), "--batch-size", "8",
              "--seq-len", "16", "--log-every", "1", "--json-logs",
              "--model-opt", f"capacity_factor={CF}"]


def _one_process_gpipe(steps):
    """The trainer's run on one process with every stage here: its
    config, weights (seed 0), optimizer and synthetic batches, each step
    GPipe's ``loss_fn`` over the whole batch at the same microbatches.
    Losses and aux losses a step, and the assignments dropped at the
    first step."""
    from triton_kubernetes_tpu_torch.ops import moe
    from triton_kubernetes_tpu_torch.train import init_state, make_optimizer
    from triton_kubernetes_tpu_torch.train.__main__ import _build_parser
    from triton_kubernetes_tpu_torch.train.data import synthetic_batches
    from triton_kubernetes_tpu_torch.train.precision import apply_policy
    from triton_kubernetes_tpu_torch.train.trainer import loss_fn

    args = _build_parser().parse_args(GPIPE_ARGS + ["--steps", str(steps)])
    cfg = apply_policy(get_config(MODEL, capacity_factor=CF),
                       args.precision)
    opt = make_optimizer(learning_rate=args.learning_rate,
                         warmup_steps=args.warmup_steps,
                         decay_steps=max(args.steps, args.warmup_steps + 1))
    state = init_state(cfg, opt, seed=0, device="cpu")
    model, params = state.model, list(state.model.parameters())
    batches = synthetic_batches(cfg.vocab_size, args.batch_size,
                                args.seq_len)
    attn = llama.resolve_attention(cfg, model.device)
    dropped, positions = [], moe._positions

    def counted_positions(top_i):
        pos = positions(top_i)
        cap = moe._capacity(cfg.capacity_factor, cfg.num_selected,
                            top_i.shape[0], cfg.num_experts)
        dropped.append(int((pos >= cap).sum()))
        return pos

    losses, auxs = [], []
    for i in range(steps):
        for p in params:
            p.grad = None
        moe._positions = counted_positions if i == 0 else positions
        try:
            total, m = loss_fn(model, torch.as_tensor(next(batches)["tokens"]),
                               cfg, attn, 2, GPIPE_MICRO)
        finally:
            moe._positions = positions
        total.backward()
        grads = [p.grad for p in params]
        opt.update(params, grads, state.opt_state,
                   norm=model.placement.global_norm(params, grads))
        losses.append(float(m["loss"]))
        auxs.append(float(m["aux_loss"]))
    return losses, auxs, sum(dropped)


def test_trainer_trains_moe_under_stages_with_split_rows(tmp_path):
    """The trainer's four-process world at ``--stage 2 --data 2`` (an MoE
    model, capacity 1.0: tokens drop) exits 0, and its losses and aux
    losses equal the one-process GPipe run's at the same microbatches.
    Through ``elastic_restart`` it then resumes on two processes (``data``
    1: the recorded model axes kept, ``data`` absorbing the fleet) and on
    four again, each restore a reshard at the saved global step and each
    phase's batches placed by the new mesh: the losses at every step are
    still the one-process run's."""
    from triton_kubernetes_tpu_torch.parallel.multihost import (
        ElasticPhase, elastic_restart)

    ckpt = str(tmp_path / "ckpt")
    phases = [ElasticPhase(4, extra_args=("--steps", "2")),
              ElasticPhase(2, extra_args=("--steps", "3")),
              ElasticPhase(4, extra_args=("--steps", "4"))]
    reports = elastic_restart(GPIPE_ARGS + ["--checkpoint-dir", ckpt],
                              phases=phases, run_dir=str(tmp_path / "run"),
                              tag="t-moe-gpipe", timeout=240,
                              pin_cores=False)
    assert len(reports) == 3
    for rep in reports:
        assert rep.ok, [(w.returncode, w.tail) for w in rep.workers]
    losses, auxs, dropped = _one_process_gpipe(4)
    assert dropped > 0
    meshes = ["mesh(data=2, stage=2)", "mesh(stage=2)",
              "mesh(data=2, stage=2)"]
    starts = [0, 2, 3]
    for i, (rep, mesh) in enumerate(zip(reports, meshes)):
        r = rep.report
        assert r["mesh"] == mesh and r["microbatches"] == GPIPE_MICRO
        lo = starts[i]
        assert r["start_step"] == lo
        hi = lo + r["steps"]
        np.testing.assert_allclose(r["losses"], losses[lo:hi],
                                   err_msg=mesh, **REL)
        np.testing.assert_allclose(r["aux_losses"], auxs[lo:hi],
                                   err_msg=mesh, **REL)
        if i:
            assert r["reshard"]["step"] == lo
            assert r["reshard"]["from_processes"] == (4, 2)[i - 1]
        else:
            assert r["reshard"] is None


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(*map(int, sys.argv[2:5]), sys.argv[5])
