"""The port's mesh and sharding layer against the JAX package's, on the CPU.

``MeshConfig.resolve``, ``ParallelismPlan.validate``, ``describe_mesh``,
``logical_axes`` and ``logical_to_spec`` against the reference for every
leaf of ``llama-test`` and ``mixtral-test``, on the meshes (data, fsdp,
tensor) in {(2,1,1), (1,2,1), (1,1,2), (2,2,1), (1,2,2)}; each rank's
``shard_pytree`` block against the block JAX's
``NamedSharding(...).devices_indices_map`` gives the device at that rank's
mesh position; ``parse_distributed_env`` on the reference's cases
(``tests/test_multihost.py``), and the trainer's typed exits. Exact
comparisons throughout (layouts and integers; the blocks are slices of the
same arrays).
"""

import jax
import numpy as np
import pytest

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import llama as jllama
from triton_kubernetes_tpu.parallel import mesh as jmesh
from triton_kubernetes_tpu.parallel import sharding as jsharding
from triton_kubernetes_tpu.train.__main__ import \
    parse_distributed_env as jparse_env
from triton_kubernetes_tpu_torch.constants import (COORDINATOR_PORT,
                                                   EXIT_CONFIG,
                                                   EXIT_UNSUPPORTED)
from triton_kubernetes_tpu_torch.models import get_config, llama
from triton_kubernetes_tpu_torch.ops import moe
from triton_kubernetes_tpu_torch.parallel import mesh as pmesh
from triton_kubernetes_tpu_torch.parallel import sharding as psharding
from triton_kubernetes_tpu_torch.parallel.mesh import Mesh
from triton_kubernetes_tpu_torch.parallel.multihost import (
    MeshPlacementError, default_mesh_config, make_batch_placer,
    process_batch_bounds, support_report)
from triton_kubernetes_tpu_torch.train.__main__ import (
    DistributedEnvError, parse_distributed_env)

MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1), (1, 2, 2)]
MODELS = ["llama-test", "mixtral-test"]


def _meshes(d, f, t):
    n = d * f * t
    jm = jmesh.create_mesh(jmesh.MeshConfig(data=d, fsdp=f, tensor=t),
                           devices=jax.devices()[:n])
    return jm, Mesh(dict(data=d, fsdp=f, tensor=t), 0, "cpu")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("model", MODELS)
def test_logical_axes_are_the_references(model):
    assert llama.logical_axes(get_config(model)) == \
        jllama.logical_axes(jget_config(model))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_logical_to_spec_matches_for_every_leaf(model, shape):
    jm, pm = _meshes(*shape)
    assert pmesh.MESH_AXES == jmesh.MESH_AXES
    assert psharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    assert pm.shape == dict(jm.shape)
    assert pmesh.describe_mesh(pm) == jmesh.describe_mesh(jm)
    tree = llama.logical_axes(get_config(model))
    for path, axes in _leaves(tree):
        want = tuple(jsharding.logical_to_spec(axes, mesh=jm))
        assert psharding.logical_to_spec(axes, mesh=pm) == want, path
        assert psharding.logical_to_spec(axes) == tuple(
            jsharding.logical_to_spec(axes)), path
    specs = psharding.spec_tree_from_logical(tree, mesh=pm)
    jspecs = jsharding.spec_tree_from_logical(tree, mesh=jm)
    for (path, spec), (_, jspec) in zip(_leaves(specs), _leaves(
            jax.tree.map(tuple, jspecs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)))):
        assert spec == jspec, path


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_shard_pytree_blocks_are_jax_device_blocks(shape):
    """Every rank's block of every leaf of the JAX parameter tree is the
    slice ``devices_indices_map`` gives the device at that rank's mesh
    position."""
    from jax.sharding import NamedSharding

    cfg = jget_config("llama-test")
    params = jax.tree.map(np.asarray, jllama.init_params(
        cfg, jax.random.PRNGKey(0)))
    jm, _ = _meshes(*shape)
    tree = llama.logical_axes(get_config("llama-test"))
    for rank, device in enumerate(jm.devices.flat):
        pm = Mesh(dict(zip(jm.axis_names, jm.devices.shape)), rank, "cpu")
        blocks = psharding.shard_pytree(params, tree, pm)
        for (path, arr), (_, axes), (_, block) in zip(
                _leaves(params), _leaves(tree), _leaves(blocks)):
            sharding = NamedSharding(jm, jsharding.logical_to_spec(
                axes, mesh=jm))
            want = arr[sharding.devices_indices_map(arr.shape)[device]]
            np.testing.assert_array_equal(block, want, err_msg=str(path))


EXPERT_MESHES = [dict(expert=2), dict(expert=4), dict(expert=2, tensor=2),
                 dict(fsdp=2, expert=2), dict(data=2, expert=2, tensor=2)]


@pytest.mark.parametrize("sizes", EXPERT_MESHES, ids=str)
def test_expert_leaves_split_as_jax_places_them(sizes):
    """On a mesh with an ``expert`` axis every ``mixtral-test`` leaf's spec
    is JAX's, and every rank's block is the slice JAX's
    ``devices_indices_map`` gives the device at its mesh position: the
    expert leaves hold ``E / expert`` experts (their ``embed`` and ``mlp``
    dims split over ``fsdp`` and ``tensor`` as before), the router none
    of the expert axis."""
    from jax.sharding import NamedSharding

    n = int(np.prod(list(sizes.values())))
    jm = jmesh.create_mesh(jmesh.MeshConfig(**dict(dict(fsdp=1), **sizes)),
                           devices=jax.devices()[:n])
    cfg = jget_config("mixtral-test")
    params = jax.tree.map(np.asarray, jllama.init_params(
        cfg, jax.random.PRNGKey(0)))
    tree = llama.logical_axes(get_config("mixtral-test"))
    for rank, device in enumerate(jm.devices.flat):
        pm = Mesh(dict(zip(jm.axis_names, jm.devices.shape)), rank, "cpu")
        blocks = psharding.shard_pytree(params, tree, pm)
        for (path, arr), (_, axes), (_, block) in zip(
                _leaves(params), _leaves(tree), _leaves(blocks)):
            spec = jsharding.logical_to_spec(axes, mesh=jm)
            assert psharding.logical_to_spec(axes, mesh=pm) == tuple(spec)
            want = arr[NamedSharding(jm, spec).devices_indices_map(
                arr.shape)[device]]
            np.testing.assert_array_equal(block, want, err_msg=str(path))
            if path[-1].startswith("moe_w"):
                assert block.shape[1] == cfg.num_experts // sizes["expert"]


def test_expert_axis_that_divides_no_expert_count_keeps_them_whole():
    """``expert`` 3 over 4 experts: the spec is JAX's (the rules do not
    look at sizes), and the port keeps the expert dim whole on every rank,
    as it keeps any dim its axes do not divide (``sharding.py``): each
    rank then runs every expert, and the MoE layer's placement sums
    nothing over ``expert``."""
    jm = jmesh.create_mesh(jmesh.MeshConfig(fsdp=1, expert=3),
                           devices=jax.devices()[:3])
    cfg = get_config("mixtral-test")
    tree = llama.logical_axes(cfg)
    for r in range(3):
        pm = Mesh(dict(expert=3), r, "cpu")
        for leaf in ("moe_w1", "moe_w3", "moe_w2"):
            axes = tree["layers"][leaf]
            spec = psharding.logical_to_spec(axes, mesh=pm)
            assert spec == tuple(jsharding.logical_to_spec(axes, mesh=jm))
            assert spec[1] == "expert"
            shape = (2, cfg.num_experts, 64, 128)
            assert psharding.local_shape(shape, spec, pm) == shape
        layout = llama.shard_layout(cfg, pm)
        assert all(shape == layout[name][1] for name, (_, shape, _) in
                   layout.items())
        model = llama.init_params(cfg, device="cpu", trainable=True,
                                  mesh=pm)
        assert model.placement.routing(model.layers[0].moe_w1) is moe.LOCAL


@pytest.mark.parametrize("cfg", [
    dict(), dict(fsdp=2, data=-1), dict(data=2, fsdp=-1, tensor=2),
    dict(fsdp=3), dict(data=-1, fsdp=-1), dict(stage=2, fsdp=1),
    dict(data=0, fsdp=4),
], ids=str)
@pytest.mark.parametrize("n", [1, 4, 8])
def test_resolve_and_validate_match(cfg, n):
    def outcome(mod):
        try:
            return mod.MeshConfig(**cfg).resolve(n)
        except ValueError as e:
            return ("error", str(e))

    assert outcome(pmesh) == outcome(jmesh)
    for ring in (False, True):
        for mb in (1, 2, 3, 4):
            def plan(mod):
                try:
                    return mod.ParallelismPlan(
                        mod.MeshConfig(**dict(cfg, seq=2) if ring
                                       else cfg),
                        ring_attention=ring, microbatches=mb).validate(n)
                except ValueError as e:
                    return ("error", str(e))

            assert plan(pmesh) == plan(jmesh), (ring, mb)


def test_mesh_coordinates_are_c_order_and_groups_follow():
    m = Mesh(dict(data=2, stage=1, fsdp=2, seq=1, expert=1, tensor=2), 5)
    assert m.coordinate() == dict(data=1, stage=0, fsdp=0, seq=0, expert=0,
                                  tensor=1)
    assert [m.rank_of(m.coordinate(r)) for r in range(8)] == list(range(8))
    assert m.group_ranks(["fsdp"]) == [5, 7]
    assert m.group_ranks(["data", "fsdp"]) == [1, 3, 5, 7]
    assert m.axes_index(["data", "fsdp"]) == 2
    assert m.live_axes(["seq", "tensor", "data"]) == ("data", "tensor")
    # A layout-only mesh has no collectives, and over size-1 axes needs
    # none.
    assert m.group(["seq", "expert"]) is None
    with pytest.raises(RuntimeError, match="layout only"):
        m.group(["tensor"])


def test_uneven_dims_stay_whole_and_batch_rows_split_data_major():
    """kv_heads 2 over tensor 4 (JAX refuses to place it) is kept whole on
    every rank; the batch splits over (data, fsdp) data-major."""
    m = Mesh(dict(tensor=4), 3)
    spec = psharding.logical_to_spec(("embed", "kv_heads", "head_dim"),
                                     mesh=m)
    assert spec == ("fsdp", "tensor")
    assert psharding.local_slices((64, 2, 16), spec, m) == (
        slice(0, 64), slice(0, 2), slice(0, 16))
    assert psharding.local_slices((64, 4, 16), spec, m)[1] == slice(3, 4)
    rows = np.arange(8)[:, None]
    for rank, want in enumerate([[0, 1], [2, 3], [4, 5], [6, 7]]):
        mesh = Mesh(dict(data=2, fsdp=2), rank)
        got = make_batch_placer(mesh)({"tokens": rows})["tokens"][:, 0]
        assert got.tolist() == want
    assert process_batch_bounds(8, 1, 4) == (2, 4)
    with pytest.raises(MeshPlacementError):
        process_batch_bounds(6, 0, 4)
    assert default_mesh_config(pmesh.MeshConfig(data=0, fsdp=2), 4).data \
        == 2
    assert default_mesh_config(pmesh.MeshConfig(data=0), 4).data == 4


# --------------------------------------------- distributed-env parsing

ENV_CASES = [
    {},
    {"JAX_COORDINATOR_ADDRESS": "  "},
    {"JAX_COORDINATOR_ADDRESS": f"run-0.run.ns.svc:{COORDINATOR_PORT}",
     "TPU_WORKER_ID": "3", "NUM_TPU_WORKERS": "4"},
    {"JAX_COORDINATOR_ADDRESS": "h:1234", "JOB_COMPLETION_INDEX": "1",
     "NUM_TPU_WORKERS": "2"},
    {"JAX_COORDINATOR_ADDRESS": "h:1234", "JOB_COMPLETION_INDEX": "1",
     "NUM_TPU_WORKERS": "2", "TPU_WORKER_ID": "0"},
    {"JAX_COORDINATOR_ADDRESS": "h:1234"},
    {"JAX_COORDINATOR_ADDRESS": "h:1234", "NUM_TPU_WORKERS": "0"},
]
MALFORMED = [
    {"JAX_COORDINATOR_ADDRESS": "no-port"},
    {"JAX_COORDINATOR_ADDRESS": "h:port"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "TPU_WORKER_ID": "x"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "TPU_WORKER_ID": "-1"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "NUM_TPU_WORKERS": "nope"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "NUM_TPU_WORKERS": "-2"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "TPU_WORKER_ID": "2",
     "NUM_TPU_WORKERS": "2"},
]


@pytest.mark.parametrize("env", ENV_CASES, ids=str)
def test_parse_distributed_env_matches(env):
    got, want = parse_distributed_env(env), jparse_env(env)
    if want is None:
        assert got is None
    else:
        assert (got.coordinator, got.process_id, got.num_processes) == (
            want.coordinator, want.process_id, want.num_processes)


@pytest.mark.parametrize("env", MALFORMED, ids=str)
def test_parse_distributed_env_malformed_raises_clean(env):
    from triton_kubernetes_tpu.train.__main__ import \
        DistributedEnvError as JDistributedEnvError

    with pytest.raises(JDistributedEnvError):
        jparse_env(env)
    with pytest.raises(DistributedEnvError) as e:
        parse_distributed_env(env)
    with pytest.raises(JDistributedEnvError) as je:
        jparse_env(env)
    assert str(e.value) == str(je.value)


def test_distributed_on_needs_a_world_size_and_nccl(monkeypatch):
    """No fallback: ``--distributed on`` without a world size exits
    EXIT_UNSUPPORTED with a typed reason (torch cannot discover one), so
    does a CUDA run where there is no NCCL (this machine has no card:
    it does not fall back to gloo or the CPU); a malformed variable exits
    EXIT_CONFIG. None of these joins a world."""
    import torch.distributed as dist

    from triton_kubernetes_tpu_torch.train.__main__ import main

    for var in ("JAX_COORDINATOR_ADDRESS", "TPU_WORKER_ID",
                "NUM_TPU_WORKERS", "JOB_COMPLETION_INDEX"):
        monkeypatch.delenv(var, raising=False)
    args = ["--model", "llama-test", "--steps", "1", "--seq-len", "16"]
    assert main(args + ["--device", "cpu", "--distributed", "on"]) == \
        EXIT_UNSUPPORTED
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    assert main(args + ["--device", "cpu", "--distributed", "on"]) == \
        EXIT_UNSUPPORTED
    monkeypatch.setenv("NUM_TPU_WORKERS", "1")
    assert support_report("cuda")["reason"] == "no-nccl"
    assert main(args + ["--distributed", "on"]) == EXIT_UNSUPPORTED
    monkeypatch.setenv("TPU_WORKER_ID", "x")
    assert main(args + ["--device", "cpu"]) == EXIT_CONFIG
    assert main(args + ["--device", "cpu", "--distributed", "off",
                        "--tensor", "2"]) == EXIT_CONFIG
    assert not dist.is_initialized()
