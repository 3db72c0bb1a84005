"""The port's GPipe schedule against the JAX package's, on the CPU.

``pipeline_forward`` with every stage in this process (the reference's
``vmap`` branch) at (stages, microbatches) in {(2, 2), (2, 4), (4, 4)}:
logits, aux and the gradient of the mean CE with respect to every leaf
against the reference's ``pipeline_forward`` (``tests/test_pipeline.py``)
on the same numpy weights and tokens, ``llama-test`` at 4 layers, f32;
and the port's own sequential forward. MoE aux over bubbles
(``mixtral-test``, 4 layers, 2 stages, 4 microbatches: the port skips the
bubbles the reference masks), and the validation errors. Tolerances: 1e-5
relative plus 1e-6 absolute (logits, aux) and 1e-5 relative plus 1e-7
absolute (gradients): summation order only. Stage 2 across two processes
is in ``test_torch_distributed.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.models import get_config as jget_config
from triton_kubernetes_tpu.models import llama as jllama
from triton_kubernetes_tpu.train.pipeline import \
    pipeline_forward as jpipeline_forward
from triton_kubernetes_tpu_torch.models import get_config, llama
from triton_kubernetes_tpu_torch.ops.fused_ce import \
    cross_entropy_with_integer_labels
from triton_kubernetes_tpu_torch.parallel.mesh import Mesh
from triton_kubernetes_tpu_torch.train.pipeline import (pipeline_degree,
                                                        pipeline_forward)

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _setup(model, seed, batch, seq, **over):
    jcfg = jget_config(model, num_layers=4, **over)
    params = jax.tree.map(np.asarray, jllama.init_params(
        jcfg, jax.random.PRNGKey(seed)))
    tokens = np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, size=(batch, seq + 1)).astype(np.int32)
    cfg = get_config(model, num_layers=4, **over)
    return jcfg, cfg, params, tokens


def _jax_loss_and_grads(params, tokens, jcfg, stages, mb):
    def loss(p):
        logits, aux = jpipeline_forward(p, jnp.asarray(tokens[:, :-1]), jcfg,
                                        num_stages=stages, microbatches=mb)
        lse = jax.nn.logsumexp(logits, axis=-1)
        tgt = jnp.take_along_axis(logits, jnp.asarray(tokens[:, 1:])[..., None],
                                  axis=-1)[..., 0]
        return (lse - tgt).mean(), (logits, aux)

    (_, (logits, aux)), g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return (np.asarray(logits), float(aux),
            jax.tree.map(np.asarray, g))


def _port_loss_and_grads(params, tokens, cfg, stages, mb):
    model = llama.from_numpy_params(params, cfg, device="cpu",
                                    trainable=True)
    logits, aux = pipeline_forward(model, torch.from_numpy(tokens[:, :-1]),
                                   cfg, stages, mb)
    cross_entropy_with_integer_labels(
        logits, torch.from_numpy(tokens[:, 1:])).mean().backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return model, logits.detach().numpy(), float(aux.detach()), grads


def _jax_leaf(tree, name):
    parts = name.split(".")
    if parts[0] == "layers":
        return tree["layers"][parts[2]][int(parts[1])]
    return tree[name]


@pytest.mark.parametrize("stages,microbatches", [(2, 2), (2, 4), (4, 4)])
def test_pipeline_matches_reference(stages, microbatches):
    jcfg, cfg, params, tokens = _setup("llama-test", 1, 4, 32)
    want_logits, want_aux, want_grads = _jax_loss_and_grads(
        params, tokens, jcfg, stages, microbatches)
    model, logits, aux, grads = _port_loss_and_grads(
        params, tokens, cfg, stages, microbatches)
    np.testing.assert_allclose(logits, want_logits, **TOL)
    assert aux == want_aux == 0.0
    for name, g in grads.items():
        np.testing.assert_allclose(g, _jax_leaf(want_grads, name),
                                   err_msg=name, **GRAD_TOL)
    # The schedule reorders when layers run, never what they compute.
    seq, _ = llama.forward(model, torch.from_numpy(tokens[:, :-1]), cfg)
    np.testing.assert_allclose(logits, seq.detach().numpy(), **TOL)


def test_pipeline_moe_aux_skips_bubbles():
    """The MoE aux counts each real microbatch once: the port skips the
    bubble ticks the reference computes on zeros and masks out; routing
    and capacity run per microbatch on both sides."""
    jcfg, cfg, params, tokens = _setup("mixtral-test", 2, 4, 16)
    want_logits, want_aux, want_grads = _jax_loss_and_grads(
        params, tokens, jcfg, 2, 4)
    _, logits, aux, grads = _port_loss_and_grads(params, tokens, cfg, 2, 4)
    assert want_aux > 0
    np.testing.assert_allclose(aux, want_aux, **TOL)
    np.testing.assert_allclose(logits, want_logits, **TOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g, _jax_leaf(want_grads, name),
                                   err_msg=name, **GRAD_TOL)


def test_pipeline_shape_validation():
    cfg = get_config("llama-test", num_layers=4)
    model = llama.init_params(cfg, device="cpu")
    t6 = torch.zeros((6, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="divide evenly"):
        pipeline_forward(model, t6, cfg, num_stages=3, microbatches=3)
    t4 = torch.zeros((4, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward(model, t4, cfg, num_stages=2, microbatches=3)
    with pytest.raises(ValueError, match="batch"):
        pipeline_forward(model, t4, cfg, num_stages=2, microbatches=8)
    mesh = Mesh(dict(stage=2), 0, "cpu")
    with pytest.raises(ValueError, match="mesh stage axis"):
        pipeline_forward(model, t4, cfg, num_stages=4, microbatches=4,
                         mesh=mesh)
    with pytest.raises(ValueError, match="build the model over"):
        pipeline_forward(model, t4, cfg, num_stages=2, microbatches=2,
                         mesh=mesh)
    assert pipeline_degree(mesh) == 2
