"""The port's MoE layer (``ops/moe.py``) against the JAX package's, on the
CPU.

The same seeded numpy inputs go through both: ``moe_layer`` in both
dispatches with and without drops (outputs within 1e-5, aux within 1e-6
relative, both f32), its gradients for every leaf and for x at cf 1.0
(within 1e-4, against ``jax.grad``), ``sort_router`` field by field,
``_auto_dispatch_mode`` at the reference test's thresholds and the
capacity over a sweep of token counts. Then the port's own rules: ties in
the router go to the lower expert, and the serving layer
``moe_layer_rows`` (the row-invariant path; plain products on the CPU)
gives ``moe_layer``'s outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_kubernetes_tpu.ops import moe as jmoe
from triton_kubernetes_tpu_torch.ops import moe

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
D, F, E, K = 16, 32, 4, 2


def _params(seed=6, d=D, f=F, e=E):
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((d, e)) * 0.5).astype(np.float32),
            "w1": (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
            "w3": (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((e, f, d)) * 0.1).astype(np.float32)}


def _x(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _torch(params, requires_grad=False):
    return {k: torch.tensor(v, requires_grad=requires_grad)
            for k, v in params.items()}


def _jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("mode", ["dense", "sort", "auto"])
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_moe_layer_matches_jax(mode, cf):
    """No drops (cf 4.0, twice the dropless E / K) and heavy drops (cf
    0.5)."""
    params = _params()
    x = _x((2, 16, D))
    yj, auxj = jmoe.moe_layer(jnp.asarray(x), _jax(params), K, cf,
                              dispatch_mode=mode)
    yt, auxt = moe.moe_layer(torch.from_numpy(x), _torch(params), K, cf,
                             dispatch_mode=mode)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-6)
    assert float(auxt) >= 0.99


def test_sort_dispatch_matches_dense_exactly():
    """The reference's own pin, on the port: the two dispatches seat and
    drop the same assignments."""
    params = _torch(_params())
    x = torch.from_numpy(_x((2, 16, D)))
    for cf in (4.0, 0.5):
        yd, auxd = moe.moe_layer(x, params, K, cf, dispatch_mode="dense")
        ys, auxs = moe.moe_layer(x, params, K, cf, dispatch_mode="sort")
        np.testing.assert_allclose(ys.numpy(), yd.numpy(), **TOL)
        np.testing.assert_allclose(float(auxs), float(auxd), rtol=1e-6)


@pytest.mark.parametrize("mode", ["dense", "sort"])
def test_moe_layer_gradients_match_jax(mode):
    """Every leaf's gradient and x's at cf 1.0 (some drops), through the
    gates and the aux loss, against jax.grad."""
    params = _params()
    x = _x((2, 8, D))

    def jloss(p, xx):
        y, aux = jmoe.moe_layer(xx, p, K, 1.0, dispatch_mode=mode)
        return (y ** 2).sum() + aux

    gp, gx = jax.grad(jloss, argnums=(0, 1))(_jax(params), jnp.asarray(x))
    tp = _torch(params, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_layer(tx, tp, K, 1.0, dispatch_mode=mode)
    ((y ** 2).sum() + aux).backward()
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]),
                                   err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GRAD_TOL)


@pytest.mark.parametrize("cap", [2, 4, 16])
def test_sort_router_matches_jax(cap):
    x = _x((32, D), seed=0)
    w = _x((D, E), seed=1)
    want = jmoe.sort_router(jnp.asarray(x), jnp.asarray(w), K, cap)
    got = moe.sort_router(torch.from_numpy(x), torch.from_numpy(w), K, cap)
    names = ("token_idx", "slot", "gate", "keep", "aux")
    for name, g, j in zip(names, got, want):
        if name in ("gate", "aux"):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(j),
                                          err_msg=name)


def test_top_k_router_matches_jax():
    x = _x((24, D), seed=2)
    w = _x((D, E), seed=3)
    for cap in (3, 12):
        want = jmoe.top_k_router(jnp.asarray(x), jnp.asarray(w), K, cap)
        got = moe.top_k_router(torch.from_numpy(x), torch.from_numpy(w), K,
                               cap)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


@pytest.mark.parametrize("t,e,c", [
    (1024, 8, 320), (8192, 8, 2560), (4096, 8, None), (4096, 8, "over")])
def test_auto_dispatch_mode_matches_jax(t, e, c):
    """The reference test's thresholds: 20 MB dense, 1.3 GB sort, and the
    capacity just under and just over 64 MiB."""
    under = (64 * 2 ** 20) // (2 * 4 * 4096 * 8)
    c = under if c is None else under + 1 if c == "over" else c
    assert moe._auto_dispatch_mode(t, e, c) == jmoe._auto_dispatch_mode(
        t, e, c)


def test_capacity_matches_jax_over_a_sweep_of_t():
    """Capacity in Python floats, as the reference: the same slot count at
    every token count and capacity factor (read back from the dense
    dispatch's width)."""
    x = _x((97, D), seed=4)
    w = _x((D, E), seed=5)
    for t in (1, 2, 3, 7, 8, 31, 64, 97):
        for cf in (0.5, 1.0, 1.25, 2.0, 4.0):
            cap = moe._capacity(cf, K, t, E)
            assert cap == max(1, int(cf * K * t / E))
            dj, _, _ = jmoe.top_k_router(jnp.asarray(x[:t]), jnp.asarray(w),
                                         K, cap)
            dt, _, _ = moe.top_k_router(torch.from_numpy(x[:t]),
                                        torch.from_numpy(w), K, cap)
            np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_tied_router_probabilities_route_to_the_lower_expert():
    """Rows whose router logits tie go to the lower expert ids, as
    lax.top_k does, in both the port's and the reference's routing."""
    x = np.ones((4, D), np.float32)
    w = np.zeros((D, E), np.float32)
    w[:, 2] = 0.5  # expert 2 wins, experts 0, 1 and 3 tie for second
    top_p, top_i, _ = moe._route(torch.from_numpy(x), torch.from_numpy(w), K)
    assert top_i.tolist() == [[2, 0]] * 4
    jp, ji, _ = jmoe._route(jnp.asarray(x), jnp.asarray(w), K)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jp), rtol=1e-6)
    all_tied = moe._route(torch.from_numpy(x), torch.zeros(D, E), K)[1]
    assert all_tied.tolist() == [[0, 1]] * 4


@pytest.mark.parametrize("cf", [4.0, 1.0])
@pytest.mark.parametrize("e", [4, 8])
def test_moe_layer_rows_matches_moe_layer(cf, e):
    """The serving layer on the CPU (plain products in the decode GEMM's
    place, the router padded to 8 columns where E is 4) against the plain
    layer, with and without drops."""
    params = _torch(_params(seed=11, e=e))
    x = torch.from_numpy(_x((3, 5, D), seed=12))
    want, aux_want = moe.moe_layer(x, params, K, cf, dispatch_mode="sort")
    got, aux = moe.moe_layer_rows(x, params, K, cf)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-6)


def test_moe_layer_rows_rows_do_not_depend_on_the_row_count():
    """Dropless: each token's output from a step of its rows alone equals
    its row in the full step (to 1e-5 here, where the products are plain
    ``torch.mm``; the card's check, with the decode GEMM, is bitwise)."""
    params = _torch(_params(seed=13))
    x = torch.from_numpy(_x((1, 12, D), seed=14))
    full, _ = moe.moe_layer_rows(x, params, K, E / K)
    for m in (1, 5, 12):
        part, _ = moe.moe_layer_rows(x[:, :m].contiguous(), params, K, E / K)
        np.testing.assert_allclose(part.numpy(), full[:, :m].numpy(),
                                   **TOL)


def test_bad_dispatch_mode_raises():
    with pytest.raises(ValueError, match="dispatch_mode"):
        moe.moe_layer(torch.zeros(1, 2, D), _torch(_params()), K, 1.0,
                      dispatch_mode="ragged")
