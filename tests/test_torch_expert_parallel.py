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
   ``tensor`` and ``fsdp``).

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
    4: [(1, 1, 1, 1, 4, 1), (1, 1, 1, 1, 2, 2), (1, 1, 2, 1, 2, 1)],
}
CASES = [(n, m, d) for n in (2, 4) for m in MESHES[n] for d in DISPATCHES]


def _overrides(dispatch):
    return dict(capacity_factor=CF, moe_dispatch=dispatch)


def _sizes(mesh_t):
    return dict(zip(AXES, mesh_t))


def _key(mesh_t, dispatch):
    return "mesh" + "_".join(map(str, mesh_t)) + "_" + dispatch


# ---------------------------------------------------------------- workers

def _worker_train(mesh_t, dispatch, params, out):
    from triton_kubernetes_tpu_torch.parallel import create_mesh
    from triton_kubernetes_tpu_torch.parallel.multihost import \
        make_batch_placer
    from triton_kubernetes_tpu_torch.train import (make_optimizer,
                                                   make_train_step,
                                                   state_for)

    cfg = get_config(MODEL, attention="flash", **_overrides(dispatch))
    mesh = create_mesh(MeshConfig(**_sizes(mesh_t)), device_type="cpu")
    model = llama.from_numpy_params(params, cfg, device="cpu",
                                    trainable=True, mesh=mesh)
    opt = make_optimizer(**OPT)
    state = state_for(model, opt)
    step = make_train_step(cfg, opt, mesh=mesh)
    place = make_batch_placer(mesh)
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
    aux losses, final params)."""
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
    step = jtrainer.make_train_step(jcfg, mesh, opt)
    losses, norms, auxs = [], [], []
    for i in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(_tokens(10 + i))})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        auxs.append(float(m["aux_loss"]))
    return losses, norms, auxs, jax.tree.map(
        lambda a: np.asarray(a, np.float32), state.params)


_GRADS = {}


def _jax_grads(params, dispatch):
    """JAX's gradient of the first batch's loss at the start weights (the
    global loss: one device's answer is every mesh's)."""
    if dispatch not in _GRADS:
        import jax
        import jax.numpy as jnp

        from triton_kubernetes_tpu.models import get_config as jget_config
        from triton_kubernetes_tpu.train import trainer as jtrainer

        jcfg = jget_config(MODEL, **_overrides(dispatch))
        g = jax.jit(jax.grad(
            lambda p, tok: jtrainer.loss_fn(p, tok, jcfg)[0]))(
            params, jnp.asarray(_tokens(10)))
        _GRADS[dispatch] = jax.tree.map(
            lambda a: np.asarray(a, np.float32), g)
    return _GRADS[dispatch]


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


def _drops(params, dispatch):
    """Assignments the one-device port model drops over the first batch
    (every layer), counted where its seating runs (``moe._positions``: a
    position at or past the capacity is a drop)."""
    from triton_kubernetes_tpu_torch.ops import moe

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
    try:
        with torch.no_grad():
            llama.forward(model, torch.as_tensor(_tokens(10))[:, :-1], cfg)
    finally:
        moe._positions = positions
    assert len(dropped) == cfg.num_layers
    return sum(dropped)


@pytest.mark.parametrize("n,mesh_t,dispatch", CASES,
                         ids=[_key(m, d) for _, m, d in CASES])
def test_moe_steps_match_make_train_step(worlds, params, n, mesh_t,
                                         dispatch):
    """Two sharded steps of ``mixtral-test`` at a capacity factor that
    drops tokens: loss, aux loss, grad norm, every rank's block of the
    first gradient and of every updated leaf against JAX's step on a mesh
    of the same shape (data, stage, fsdp, seq, expert, tensor). On an
    expert axis the expert leaves are split (``E / expert`` experts a
    rank) and the router is not."""
    _, outs = worlds(n)
    assert _drops(params, dispatch) > 0
    losses, norms, auxs, final = _jax_steps(params, mesh_t, dispatch)
    key = _key(mesh_t, dispatch)
    for out in outs:
        np.testing.assert_allclose(out[f"{key}/losses"], losses,
                                   err_msg=key, **REL)
        np.testing.assert_allclose(out[f"{key}/aux"], auxs, err_msg=key,
                                   **REL)
        np.testing.assert_allclose(out[f"{key}/grad_norms"], norms,
                                   err_msg=key, **REL)
    _check_blocks(_jax_grads(params, dispatch), outs, f"{key}/grad", mesh_t,
                  GRAD_TOL)
    split = _check_blocks(final, outs, key, mesh_t, PARAMS_TOL)
    sizes = _sizes(mesh_t)
    e = get_config(MODEL).num_experts
    for glob in (f"layers.{i}.{leaf}" for i in range(2)
                 for leaf in ("moe_w1", "moe_w3", "moe_w2")):
        assert outs[0][f"{key}/shape/{glob}"][0] == e // sizes["expert"]
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



def test_moe_under_stages_with_split_rows_is_refused(tmp_path):
    """An MoE model at ``stage`` 2 with its rows split (``data`` 2) is a
    config error: each rank's microbatches would hold other rows than the
    reference's, so the routing would differ. The trainer's world exits
    2 before its first step, and the library's GPipe raises the same
    typed error; a dense model there, and an MoE model whose rows stay on
    one rank (``seq`` 2, or ``stage`` 2 alone), pass the check."""
    from triton_kubernetes_tpu_torch.constants import EXIT_CONFIG
    from triton_kubernetes_tpu_torch.parallel.multihost import (
        MeshPlacementError, launch_trainers)
    from triton_kubernetes_tpu_torch.train.pipeline import (
        pipeline_forward, require_global_microbatches)

    moe_cfg, dense_cfg = get_config(MODEL), get_config("llama-test")
    for sizes in (dict(stage=2, data=2), dict(stage=2, fsdp=2)):
        with pytest.raises(MeshPlacementError, match="rows split"):
            require_global_microbatches(moe_cfg, Mesh(sizes, 0))
        require_global_microbatches(dense_cfg, Mesh(sizes, 0))
    for sizes in (dict(stage=2, seq=2), dict(stage=2),
                  dict(data=2, expert=2)):
        require_global_microbatches(moe_cfg, Mesh(sizes, 0))
    with pytest.raises(MeshPlacementError, match="rows split"):
        pipeline_forward(None, torch.zeros((4, 8), dtype=torch.long),
                         moe_cfg, 2, 2, mesh=Mesh(dict(stage=2, data=2), 0))
    rep = launch_trainers(
        ["--device", "cpu", "--model", MODEL, "--stage", "2", "--data", "2",
         "--seq-len", "16", "--steps", "1", "--json-logs"],
        n_processes=4, run_dir=str(tmp_path), tag="t-moe-gpipe",
        timeout=120, pin_cores=False)
    # Every rank refuses on its own; the launcher kills the peers of the
    # first to exit (SIGKILL, -9) if they are still running.
    done = [w for w in rep.workers if w.returncode != -9]
    assert done and all(w.returncode == EXIT_CONFIG for w in done), [
        (w.returncode, w.tail) for w in rep.workers]
    assert all("mesh placement rejected" in w.tail for w in done)

if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(*map(int, sys.argv[2:5]), sys.argv[5])
