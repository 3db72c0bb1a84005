"""Llama-3-family decoder as a PyTorch ``nn.Module`` -- the port of
``triton_kubernetes_tpu/models/llama.py`` for the serving and training
paths.

Weights keep the JAX package's layouts (``wq [D, H, Dh]``, ``wo [H, Dh,
D]``, ``w1 [D, F]``, ...), so a JAX parameter tree maps onto the module one
to one (:func:`from_numpy_params`, :func:`to_numpy_params`). A model is
built in one of two forms:

* serving (the default): weights stored in the activation dtype, without
  gradients. The JAX package keeps f32 master weights and casts them at
  every use, which gives the same matmul operand at twice the memory;
* trainable (``trainable=True``): ``config.weight_dtype`` master weights
  as ``nn.Parameter`` s with gradients, cast to the activation dtype at
  every use (the reference's ``resolve_weight``), so the gradient of each
  master is the reference's cotangent cast back to f32.

The block math is split as in the reference -- :func:`_qkv`, attention (the
caller's), :func:`project_out`, :func:`_mlp`, and :func:`unembed` -- and
each of those norming ones is built on a helper that takes the norm's
output (:func:`_qkv_normed`, :func:`out_projection`, :func:`_mlp_normed`,
:func:`unembed_normed`), so the paged serving steps (``models/paged.py``)
can run their own norms: they fuse each layer boundary's residual add and
norm into one ``ops.norms.add_rms_norm_rows``. :func:`forward` and
:func:`forward_hidden` run the whole stack for training with the plain
``rms_norm``. Each takes ``row_invariant``: the paged decode and verify
steps set it, so their weight products go through ``ops.decode_gemm`` (one
launch for wq/wk/wv and one for w3/w1, which share an input) -- and the
norms of these functions through ``ops.norms.rms_norm_rows`` -- whose rows
do not depend on the row count (a verify row is then bitwise the decode
row, as the reference pins); everything else keeps the plain ``rms_norm``
and ``torch.einsum``.

An MoE config (``num_experts > 0``, the Mixtral family) swaps the dense
SwiGLU for the expert layer of ``ops/moe.py``: ``router [D, E]``,
``moe_w1``/``moe_w3 [E, D, F]`` and ``moe_w2 [E, F, D]``, the reference's
layouts. :func:`_mlp` returns the layer's aux loss beside its delta, and
:func:`forward` sums it over the layers. The row-invariant steps run
``ops.moe.moe_layer_rows`` (the router and every expert's products on
``decode_gemm``), everything else ``ops.moe.moe_layer``. The router's
product is f32 in the reference (``x.float() @ router.float()``), so the
router is kept in f32 in the serving form too.

With ``config.weight_quant`` "int8"/"fp8" the matmul weights are
:class:`QuantizedWeight` s, one scale per output channel (and per expert
for the expert weights; the router stays full precision), contracted W8A8
where ``config.matmul_dtype`` says so (:func:`w8a8_dtype`; never the
expert products, which dequantize at use as the reference's
``resolve_weight`` does) and dequantized otherwise.
"""

from __future__ import annotations

import functools
from dataclasses import replace
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.attention import causal_attention
from ..ops.decode_gemm import decode_gemm_group, decode_gemm_plain
from ..ops.flash_attention import flash_attention
from ..ops.moe import moe_layer, moe_layer_rows
from ..ops.norms import rms_norm, rms_norm_rows
from ..ops.quantization import (
    QuantizedRows,
    fp8_dtype,
    quantize_channelwise,
    resolve_matmul_dtype,
    swiglu_quantize_rows,
    w8a8_rows,
)
from ..ops.rotary import apply_rotary, rotary_tables
from ..parallel.placement import LOCAL, Placement
from .config import ModelConfig

# attention_fn(q, k, v, positions) -> out; positions is [B, S] int.
AttentionFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

# The JAX package's parameter tree: {"embed", "layers": {name: [L, ...]},
# "final_norm", "lm_head"} (numpy leaves where the port takes one).
Params = Dict[str, Any]

# A layer's weight leaves, in the JAX package's order: a dense layer's,
# and an MoE layer's.
LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w1", "w3",
                "w2")
MOE_LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                    "router", "moe_w1", "moe_w3", "moe_w2")
# Quantized weights of a dense layer -> how many of their leading dims (JAX
# layout, one layer) the matmul contracts: per-channel scales reduce
# exactly these (the reference's _QUANT_AXES_LAYERS). The lm head [D, V]
# contracts D.
QUANT_CONTRACT = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w1": 1, "w3": 1,
                  "w2": 1}
# The expert weights ([E, D, F], [E, F, D]): the expert dim leads, then one
# contracted dim, so a scale per (expert, output column).
MOE_QUANT_CONTRACT = {"moe_w1": 1, "moe_w3": 1, "moe_w2": 1}


# Each leaf's logical axes in the port's layout: the reference's
# ``logical_axes`` less the leading "layers" axis of a stacked leaf (a layer
# of the port is its own tensor; the layer index maps to the stage axis).
LEAF_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "embed"),
    "final_norm": ("norm",),
    "lm_head": ("embed", "vocab"),
    "attn_norm": ("norm",),
    "mlp_norm": ("norm",),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "w1": ("embed", "mlp"),
    "w3": ("embed", "mlp"),
    "w2": ("mlp", "embed"),
    "router": ("embed", None),
    "moe_w1": ("expert", "embed", "mlp"),
    "moe_w3": ("expert", "embed", "mlp"),
    "moe_w2": ("expert", "mlp", "embed"),
}


def logical_axes(config: ModelConfig) -> Params:
    """The reference's ``logical_axes``: the JAX parameter tree's
    structure (the layout :func:`from_numpy_params` and
    :func:`to_numpy_params` use), leaves logical-axis tuples; a stacked
    layer leaf leads with "layers", which the rules map to the stage
    axis."""
    return {
        "embed": LEAF_AXES["embed"],
        "layers": {n: ("layers",) + LEAF_AXES[n]
                   for n in layer_leaves(config)},
        "final_norm": LEAF_AXES["final_norm"],
        "lm_head": LEAF_AXES["lm_head"],
    }


def layer_leaves(config: ModelConfig) -> Tuple[str, ...]:
    """The weight leaves of one of ``config``'s layers."""
    return MOE_LAYER_LEAVES if config.is_moe else LAYER_LEAVES


def quantized_leaves(config: ModelConfig) -> Dict[str, Tuple[int, int]]:
    """The layer leaves :func:`quantize_weights` quantizes -> (leading
    batch dims, contracted dims after them)."""
    out = {n: (0, c) for n, c in QUANT_CONTRACT.items()
           if n in layer_leaves(config)}
    if config.is_moe:
        out.update({n: (1, c) for n, c in MOE_QUANT_CONTRACT.items()})
    return out


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere;
    asking for it on a machine without a card raises instead of quietly
    running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the port's plain versions on the CPU")
    return dev


def _weight(shape, dtype, device, trainable: bool) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=trainable)


def quant_dtype(weight_quant: str) -> torch.dtype:
    """The storage dtype of a ``weight_quant`` mode ("int8" or "fp8")."""
    if weight_quant == "int8":
        return torch.int8
    if weight_quant == "fp8":
        return fp8_dtype()
    raise ValueError(f"weight_quant must be 'int8' or 'fp8', got "
                     f"{weight_quant!r}")


class QuantizedWeight(nn.Module):
    """A weight quantized per output channel: buffers ``q`` [*B, N, K]
    (int8 or float8_e4m3fn, K-contiguous: the layout the W8A8 kernel
    reads, the transpose of the JAX layout's flattened [K, N]) and
    ``scale`` [*B, N] f32, for a weight of JAX-layout ``shape`` whose first
    ``batch`` dims index separate matrices (the experts of an MoE weight)
    and whose next ``contract`` dims are the contraction (K their product,
    N the rest's)."""

    def __init__(self, shape: Sequence[int], contract: int,
                 dtype: torch.dtype, device: torch.device, batch: int = 0):
        super().__init__()
        self.shape = tuple(shape)
        self.contract = contract
        self.batch = batch
        lead = self.shape[:batch]
        k = int(np.prod(self.shape[batch:batch + contract]))
        n = int(np.prod(self.shape[batch + contract:]))
        self.register_buffer("q", torch.empty(lead + (n, k), dtype=dtype,
                                              device=device))
        self.register_buffer("scale", torch.empty(lead + (n,),
                                                  dtype=torch.float32,
                                                  device=device))

    def jax_q(self) -> torch.Tensor:
        """``q`` in the JAX layout (a view)."""
        return self.q.transpose(-1, -2).reshape(self.shape)

    def jax_scale(self) -> torch.Tensor:
        """``scale`` in the JAX layout, the contraction dims size 1."""
        b = self.batch
        return self.scale.reshape(self.shape[:b] + (1,) * self.contract
                                  + self.shape[b + self.contract:])

    def set_jax(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Store a JAX-layout (q, scale) pair (q's bytes as they are)."""
        n, k = self.q.shape[-2:]
        lead = self.q.shape[:-2]
        self.q.view(torch.uint8).copy_(
            q.reshape(lead + (k, n)).view(torch.uint8).transpose(-1, -2))
        self.scale.copy_(scale.reshape(lead + (n,)))

    def quantize_from(self, w: torch.Tensor) -> None:
        """Quantize a JAX-layout weight into this leaf
        (``quantize_channelwise`` over the contraction dims)."""
        b = self.batch
        self.set_jax(*quantize_channelwise(
            w, tuple(range(b, b + self.contract)), self.q.dtype))

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        """``(q * scale)`` in f32, cast to ``dtype``, in the JAX layout."""
        return (self.q.float() * self.scale[..., None]).to(dtype).transpose(
            -1, -2).contiguous().reshape(self.shape)


def _leaf(shape, contract: int, dtype, device, trainable: bool,
          qdtype: Optional[torch.dtype], batch: int = 0):
    if qdtype is None:
        return _weight(shape, dtype, device, trainable)
    return QuantizedWeight(shape, contract, qdtype, device, batch)


class LlamaBlock(nn.Module):
    """One decoder layer's weights, in the JAX package's layouts: the
    dense SwiGLU's ``w1``/``w3``/``w2``, or for an MoE config the
    ``router`` (f32 in the serving form, whose product the reference
    computes in f32) and the experts' ``moe_w1``/``moe_w3``/``moe_w2``.
    With ``qdtype`` the matmul weights are :class:`QuantizedWeight` s (the
    router stays full precision)."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype,
                 device: torch.device, trainable: bool = False,
                 qdtype: Optional[torch.dtype] = None):
        super().__init__()
        d, dh, f = config.embed_dim, config.head_dim, config.mlp_dim
        h, hkv, e = config.num_heads, config.num_kv_heads, config.num_experts
        w = functools.partial(_weight, dtype=dtype, device=device,
                              trainable=trainable)
        shapes = {"wq": (d, h, dh), "wk": (d, hkv, dh), "wv": (d, hkv, dh),
                  "wo": (h, dh, d), "w1": (d, f), "w3": (d, f), "w2": (f, d),
                  "moe_w1": (e, d, f), "moe_w3": (e, d, f),
                  "moe_w2": (e, f, d)}
        self.attn_norm = w((d,))
        self.mlp_norm = w((d,))
        if config.is_moe:
            self.router = _weight((d, e), dtype if trainable
                                  else torch.float32, device, trainable)
        for name, (batch, contract) in quantized_leaves(config).items():
            setattr(self, name, _leaf(shapes[name], contract, dtype, device,
                                      trainable, qdtype, batch))


class Llama(nn.Module):
    """Embedding, ``num_layers`` :class:`LlamaBlock` s, final norm and lm
    head. Build one with :func:`init_params` or :func:`from_numpy_params`.
    ``trainable`` stores ``config.weight_dtype`` masters with gradients
    instead of activation-dtype weights without. A config with
    ``weight_quant`` "int8"/"fp8" makes the matmul weights and the lm head
    :class:`QuantizedWeight` s (serving only: ``trainable`` raises); fill
    them with :func:`quantize_weights` or :func:`from_numpy_params`.

    A model built over a mesh (``init_params``/``from_numpy_params`` with
    ``mesh=``) holds one rank's blocks: its stage's layers (numbered from
    0) and, of every leaf, the block :func:`..parallel.sharding.
    local_slices` gives the rank. ``mesh`` is then that mesh and ``layout``
    maps each parameter's name to ``(global name, full shape, spec)``;
    ``config`` stays the whole model's. ``placement`` says where the
    leaves live (``parallel/placement.py``): the forward and the train
    step read every leaf through it."""

    mesh = None
    layout: Optional[Dict[str, Tuple[str, Tuple[int, ...], Any]]] = None
    placement: Placement = LOCAL

    def __init__(self, config: ModelConfig, device: torch.device | str,
                 trainable: bool = False):
        super().__init__()
        qdtype = None
        if config.weight_quant != "none":
            if trainable:
                raise ValueError(
                    f"weight_quant {config.weight_quant!r}: quantized "
                    f"weights serve, they do not train (trainable=True)")
            qdtype = quant_dtype(config.weight_quant)
        dev = torch.device(device)
        dtype = config.weight_dtype if trainable else config.activation_dtype
        d, v = config.embed_dim, config.vocab_size
        self.config = config
        self.trainable = trainable
        self.embed = _weight((v, d), dtype, dev, trainable)
        self.layers = nn.ModuleList(
            LlamaBlock(config, dtype, dev, trainable, qdtype)
            for _ in range(config.num_layers))
        self.final_norm = _weight((d,), dtype, dev, trainable)
        self.lm_head = _leaf((d, v), 1, dtype, dev, trainable, qdtype)
        self._rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def rotary(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin) tables for every position, built once per model."""
        if self._rotary is None:
            c = self.config
            self._rotary = rotary_tables(c.head_dim, c.max_seq_len,
                                         c.rope_theta, device=self.device)
        return self._rotary


def _init_draws(config: ModelConfig):
    """(parameter name, std; None for a norm's ones) in the order the
    init rule draws them from the generator."""
    std = 0.02
    out_std = 0.02 / (2 * config.num_layers) ** 0.5
    # Residual-out projections (wo, w2 or moe_w2) at out_std.
    mlp, mlp_out = ((("router", "moe_w1", "moe_w3"), "moe_w2")
                    if config.is_moe else (("w1", "w3"), "w2"))
    yield "embed", std
    for i in range(config.num_layers):
        yield f"layers.{i}.attn_norm", None
        yield f"layers.{i}.mlp_norm", None
        for name in ("wq", "wk", "wv") + mlp:
            yield f"layers.{i}.{name}", std
        yield f"layers.{i}.wo", out_std
        yield f"layers.{i}.{mlp_out}", out_std
    yield "final_norm", None
    yield "lm_head", std


def init_params(config: ModelConfig, seed: int = 0,
                device: torch.device | str = "cuda",
                trainable: bool = False, mesh=None) -> Llama:
    """Normal(0.02) init, residual-out projections scaled by 1/sqrt(2L),
    norms at one -- the reference's init rule, drawn from a ``torch``
    generator on ``device`` (so the values differ from the JAX init). A
    config with ``weight_quant`` set draws the full-precision weights, then
    quantizes them (:func:`quantize_weights`).

    With ``mesh`` the model holds this rank's blocks only (see
    :class:`Llama`): every leaf is still drawn whole, in the same order
    from the same generator, and cut to the rank's block, so the values are
    those of the one-device model at any mesh shape, and the transient
    memory is one whole leaf."""
    dev = resolve_device(device)
    if config.weight_quant != "none":
        if mesh is not None:
            raise ValueError("a quantized model serves on one device")
        full = init_params(replace(config, weight_quant="none",
                                   matmul_dtype="auto"), seed, dev)
        model = quantize_weights(full, config.weight_quant)
        model.config = config
        return model
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, s: Optional[float]) -> torch.Tensor:
        if s is None:
            return torch.ones(shape, dtype=torch.float32, device=dev)
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * s

    if mesh is not None:
        shapes = dict(_global_shapes(config))
        return _sharded_model(config, mesh, dev, trainable, (
            (name, draw(shapes[name], s))
            for name, s in _init_draws(config)))
    model = Llama(config, dev, trainable)
    with torch.no_grad():
        for name, s in _init_draws(config):
            p = model.get_parameter(name)
            if s is None:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev,
                                    dtype=torch.float32) * s)
    return model


def _global_shapes(config: ModelConfig):
    """(name, shape) of every parameter of the whole model, in
    ``named_parameters`` order (a model on the meta device)."""
    for name, p in Llama(config, "meta", trainable=True).named_parameters():
        yield name, tuple(p.shape)


def shard_layout(config: ModelConfig, mesh, rules=None
                 ) -> Dict[str, Tuple[str, Tuple[int, ...], Any]]:
    """This rank's parameters under ``mesh``: local name -> (global name,
    full shape, spec). The stage axis takes contiguous groups of
    ``L / stage`` layers (the reference's ``_stage_params``)."""
    from ..parallel.sharding import logical_to_spec

    stages = mesh.shape["stage"]
    if config.num_layers % stages:
        raise ValueError(
            f"num_layers ({config.num_layers}) must divide evenly into "
            f"{stages} pipeline stages")
    per = config.num_layers // stages
    first = mesh.coordinate()["stage"] * per
    out = {}
    for name, shape in _global_shapes(replace(config, num_layers=per)):
        parts = name.split(".")
        glob = (f"layers.{first + int(parts[1])}.{parts[2]}"
                if parts[0] == "layers" else name)
        out[name] = (glob, shape,
                     logical_to_spec(LEAF_AXES[parts[-1]], rules, mesh))
    return out


def _sharded_model(config: ModelConfig, mesh, dev: torch.device,
                   trainable: bool, values) -> Llama:
    """A model of this rank's blocks from ``values``, (global name, whole
    leaf) pairs -- tensors or numpy arrays, taken one at a time; leaves
    of other stages are skipped."""
    from ..parallel.placement import MeshPlacement
    from ..parallel.sharding import local_slices

    layout = shard_layout(config, mesh)
    local = {glob: (name, shape, spec)
             for name, (glob, shape, spec) in layout.items()}
    per = config.num_layers // mesh.shape["stage"]
    model = Llama(replace(config, num_layers=per), "meta", trainable)
    model.config = config
    dtype = config.weight_dtype if trainable else config.activation_dtype
    with torch.no_grad():
        for glob, full in values:
            if glob not in local:
                continue
            name, shape, spec = local.pop(glob)
            if tuple(full.shape) != shape:
                raise ValueError(f"leaf {glob} shape {tuple(full.shape)} "
                                 f"!= expected {shape}")
            block = full[local_slices(shape, spec, mesh)]
            if not isinstance(block, torch.Tensor):
                block = torch.from_numpy(np.array(block, dtype=np.float32))
            block = block.to(device=dev, dtype=dtype).clone(
                memory_format=torch.contiguous_format)
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf,
                    nn.Parameter(block, requires_grad=trainable))
    if local:
        raise ValueError(f"no value for {sorted(local)[:4]}")
    model.mesh = mesh
    model.layout = layout
    model.placement = MeshPlacement(mesh, layout, model.named_parameters())
    return model


def from_numpy_params(params: Dict[str, Any], config: ModelConfig,
                      device: torch.device | str = "cuda",
                      trainable: bool = False, mesh=None) -> Llama:
    """The port's model from a JAX parameter tree given as numpy arrays
    (``{"embed", "layers": {name: [L, ...]}, "final_norm", "lm_head"}``,
    the stacked layout of the reference's ``init_params``). Leaves are cast
    to the activation dtype, or to ``config.weight_dtype`` masters with
    gradients when ``trainable``. A quantized tree (the reference's
    ``quantize_weights``: ``{"q", "scale"}`` leaves) needs
    ``config.weight_quant`` set to its dtype; its values are taken as their
    bytes, so fp8 may come as ``ml_dtypes.float8_e4m3fn`` or as uint8.

    With ``mesh`` the model holds this rank's blocks only (see
    :class:`Llama`; full-precision trees)."""
    dev = resolve_device(device)
    if mesh is not None:
        def leaf(name: str) -> np.ndarray:
            parts = name.split(".")
            if parts[0] == "layers":
                return np.asarray(params["layers"][parts[2]])[int(parts[1])]
            return np.asarray(params[name])

        return _sharded_model(config, mesh, dev, trainable, (
            (name, leaf(name)) for name, _ in _global_shapes(config)))
    model = Llama(config, dev, trainable)

    def put(p, arr: Any) -> None:
        if isinstance(p, QuantizedWeight):
            if not isinstance(arr, dict):
                raise ValueError(
                    f"weight_quant {config.weight_quant!r}: expected a "
                    f"{{'q', 'scale'}} leaf, got an array")
            q = np.ascontiguousarray(arr["q"])
            if q.dtype.itemsize != 1 or tuple(q.shape) != p.shape:
                raise ValueError(f"q leaf {q.dtype} {q.shape} != expected "
                                 f"one byte {p.shape}")
            scale = np.array(arr["scale"], dtype=np.float32)
            p.set_jax(torch.from_numpy(q.view(np.uint8).copy()).view(
                p.q.dtype), torch.from_numpy(scale))
            return
        if isinstance(arr, dict):
            raise ValueError(
                "a quantized {'q', 'scale'} leaf needs config.weight_quant "
                "set to its dtype")
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(
                f"leaf shape {a.shape} != expected {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))

    def layer_leaf(leaf: Any, i: int) -> Any:
        if isinstance(leaf, dict):
            return {k: np.asarray(v)[i] for k, v in leaf.items()}
        return np.asarray(leaf)[i]

    with torch.no_grad():
        put(model.embed, params["embed"])
        put(model.final_norm, params["final_norm"])
        put(model.lm_head, params["lm_head"])
        stacked = params["layers"]
        for i, layer in enumerate(model.layers):
            for name in layer_leaves(config):
                put(getattr(layer, name), layer_leaf(stacked[name], i))
    return model


def to_numpy_params(model: Llama) -> Dict[str, Any]:
    """The model's weights as a JAX-layout parameter tree, layers stacked on
    a leading ``L`` axis (the inverse of :func:`from_numpy_params`): f32
    numpy arrays, and for :class:`QuantizedWeight` s the reference's
    ``{"q", "scale"}`` leaves -- q int8, or fp8 as its uint8 bytes (numpy
    has no float8 of its own), scale f32 with the contraction dims size
    1."""

    def arr(p) -> Any:
        if isinstance(p, QuantizedWeight):
            q = p.jax_q().contiguous().cpu()
            return {"q": (q.numpy() if q.dtype == torch.int8
                          else q.view(torch.uint8).numpy()),
                    "scale": p.jax_scale().cpu().numpy()}
        return p.detach().float().cpu().numpy()

    def stack(leaves: List[Any]) -> Any:
        if isinstance(leaves[0], dict):
            return {k: np.stack([leaf[k] for leaf in leaves])
                    for k in leaves[0]}
        return np.stack(leaves)

    return {
        "embed": arr(model.embed),
        "layers": {n: stack([arr(getattr(layer, n))
                             for layer in model.layers])
                   for n in layer_leaves(model.config)},
        "final_norm": arr(model.final_norm),
        "lm_head": arr(model.lm_head),
    }


def quantize_weights(model: Llama, dtype: str = "int8") -> Llama:
    """Per-channel symmetric quantization of the big matmul weights: a NEW
    model whose matmul weights (:func:`quantized_leaves`: the dense MLP's
    or the experts', and the attention's) and lm head are
    :class:`QuantizedWeight` s of ``dtype`` ("int8" or "fp8"), each scale
    over its contraction dims (the reference's ``quantize_weights``), and
    whose config records ``weight_quant=dtype``; the embedding, the norms
    and the MoE router are copied as they are. The caller's model is
    untouched. Idempotent at the same dtype (the model itself comes back);
    a model already quantized to another dtype raises (rounding losses must
    not compound)."""
    if dtype not in ("int8", "fp8"):
        raise ValueError(
            f"quantize_weights dtype must be 'int8' or 'fp8', got {dtype!r}")
    config = model.config
    if config.weight_quant == dtype:
        return model
    if config.weight_quant != "none":
        raise ValueError(
            f"the model is already weight_quant={config.weight_quant!r}; "
            f"re-quantizing to {dtype!r} would compound rounding losses -- "
            f"quantize from the full-precision model instead")
    new = Llama(replace(config, weight_quant=dtype), model.device)
    quantized = quantized_leaves(config)
    with torch.no_grad():
        new.embed.copy_(model.embed)
        new.final_norm.copy_(model.final_norm)
        new.lm_head.quantize_from(model.lm_head)
        for old, layer in zip(model.layers, new.layers):
            for name in layer_leaves(config):
                if name in quantized:
                    getattr(layer, name).quantize_from(getattr(old, name))
                else:  # the norms and the router
                    getattr(layer, name).copy_(getattr(old, name))
    return new


def resolve_weight(w: Any, config: ModelConfig) -> torch.Tensor:
    """The matmul operand of a weight: the weight cast to the activation
    dtype (a no-op for the serving form, whose weights already are), or a
    :class:`QuantizedWeight` dequantized, ``(q * scale)`` in f32 cast to
    the activation dtype, in the JAX layout."""
    if isinstance(w, QuantizedWeight):
        return w.dequantize(config.activation_dtype)
    return w.to(config.activation_dtype)


def matmul_arithmetic(config: ModelConfig, x: torch.Tensor) -> str:
    """What a quantized weight's product runs on ``x``'s device:
    ``resolve_matmul_dtype`` of the config, with platform "gpu" for CUDA
    tensors and "cpu" otherwise ("f32": dequantize; "int8"/"fp8": W8A8)."""
    return resolve_matmul_dtype(config.matmul_dtype, config.weight_quant,
                                "gpu" if x.is_cuda else "cpu")


def w8a8_dtype(ws: Sequence[Any], config: ModelConfig,
               x: Union[torch.Tensor, QuantizedRows]
               ) -> Optional[torch.dtype]:
    """The 8-bit dtype in which the products of x with the weight group
    ``ws`` contract here -- every leaf a :class:`QuantizedWeight` and
    ``matmul_dtype`` resolving to "int8"/"fp8" on x's device (W8A8) -- or
    None: the f32 path. :func:`weight_einsums` routes by it, and the
    producers of a group's input ask it: a norm or the SwiGLU hands its
    consumers :class:`ops.quantization.QuantizedRows` only where it is not
    None."""
    device_of = x.xq if isinstance(x, QuantizedRows) else x
    if not (all(isinstance(w, QuantizedWeight) for w in ws)
            and matmul_arithmetic(config, device_of) != "f32"):
        return None
    return ws[0].q.dtype


def _norm(x: torch.Tensor, scale: torch.Tensor, config: ModelConfig,
          row_invariant: bool) -> torch.Tensor:
    norm = rms_norm_rows if row_invariant else rms_norm
    return norm(x, scale, config.norm_eps)


@functools.lru_cache(maxsize=None)
def _contracted_dims(spec: str) -> int:
    """How many of x's trailing dims an einsum spec contracts with w's
    leading ones, in order; raises for any other kind of spec."""
    ins, out = spec.split("->")
    xs, ws = ins.split(",")
    c = sum(ch not in out for ch in xs)
    if xs[len(xs) - c:] != ws[:c] or out != xs[:len(xs) - c] + ws[c:]:
        raise ValueError(f"{spec!r} is not a trailing-by-leading contraction")
    return c


def _row_products(spec: str, x: torch.Tensor,
                  ws: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``[einsum(spec, x, w) for w in ws]`` for a spec that contracts x's
    trailing dims with w's leading ones in order (``"bsd,dhk->bshk"``,
    ``"bshk,hkd->bsd"``), as one [M, K] @ [K, N_w] launch of
    :func:`decode_gemm_group` for all of ``ws``."""
    c = _contracted_dims(spec)
    lead = x.shape[:x.dim() - c]
    ys = decode_gemm_group(x.reshape(lead.numel(), -1).contiguous(),
                           [w.reshape(-1, w.shape[c:].numel()) for w in ws])
    return [y.reshape(*lead, *w.shape[c:]) for y, w in zip(ys, ws)]


def _quantized_products(spec: str, x: Union[torch.Tensor, QuantizedRows],
                        ws: Sequence[QuantizedWeight],
                        out_dtype: torch.dtype) -> List[torch.Tensor]:
    """W8A8 ``[einsum(spec, x, w) for w in ws]`` for a trailing-by-leading
    spec: x's rows quantized once (or already, :class:`QuantizedRows`),
    the products in one ``ops.quantization.w8a8_rows`` call."""
    c = _contracted_dims(spec)
    if isinstance(x, QuantizedRows):
        lead, rows = x.lead, x
    else:
        lead = tuple(x.shape[:x.dim() - c])
        rows = x.reshape(-1, x.shape[x.dim() - c:].numel()).contiguous()
    ys = w8a8_rows(rows, [w.q for w in ws], [w.scale for w in ws],
                   out_dtype)
    return [y.reshape(*lead, *w.shape[c:]) for y, w in zip(ys, ws)]


def weight_einsums(spec: str, x: Union[torch.Tensor, QuantizedRows],
                   ws: Sequence[Any], config: ModelConfig,
                   row_invariant: bool = False) -> List[torch.Tensor]:
    """The weight matmuls of one input with each of ``ws``, in the
    activation dtype. On the reference's f32 path (unquantized leaves, or
    quantized ones with ``matmul_dtype`` resolving to "f32") the products
    of the activation-dtype operands, quantized leaves dequantized first;
    ``row_invariant`` takes them all through one
    :func:`ops.decode_gemm.decode_gemm_group` call. Quantized leaves with
    ``matmul_dtype`` "int8"/"fp8" contract W8A8 (:func:`w8a8_dtype`),
    row-invariant on the card whatever ``row_invariant`` says; only they
    take x as :class:`QuantizedRows`."""
    if w8a8_dtype(ws, config, x) is not None:
        return _quantized_products(spec, x, ws, config.activation_dtype)
    if isinstance(x, QuantizedRows):
        raise TypeError("quantized rows feed W8A8 products only")
    ws = [resolve_weight(w, config) for w in ws]
    if row_invariant:
        return _row_products(spec, x, ws)
    return [torch.einsum(spec, x, w) for w in ws]


def weight_einsum(spec: str, x: torch.Tensor, w: Any,
                  config: ModelConfig,
                  row_invariant: bool = False) -> torch.Tensor:
    """:func:`weight_einsums` of one weight."""
    return weight_einsums(spec, x, [w], config, row_invariant)[0]


def _placed_products(spec: str, h: torch.Tensor, ws: Sequence[Any],
                     config: ModelConfig, row_invariant: bool,
                     place: Placement) -> List[torch.Tensor]:
    """:func:`weight_einsums` of ``h`` with each of ``ws`` as ``place``
    has them read: each leaf as :meth:`Placement.weight` gives it, each
    product fed what :meth:`Placement.feed` gives it (one call for the
    products that share an input)."""
    xs = place.feed(h, ws)
    ws = [place.weight(w) for w in ws]
    if all(x is xs[0] for x in xs):
        return weight_einsums(spec, xs[0], ws, config, row_invariant)
    return [weight_einsum(spec, x, w, config, row_invariant)
            for x, w in zip(xs, ws)]


def _qkv_normed(h: torch.Tensor, layer: LlamaBlock, config: ModelConfig,
                cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor,
                row_invariant: bool = False, place: Placement = LOCAL):
    """Projected + rotary-encoded q/k/v from the attention norm's output
    ([B, S, D])."""
    q, k, v = _placed_products("bsd,dhk->bshk", h,
                               [layer.wq, layer.wk, layer.wv], config,
                               row_invariant, place)
    q = apply_rotary(q, cos, sin, positions)
    k = apply_rotary(k, cos, sin, positions)
    return q, k, v


def _qkv(x: torch.Tensor, layer: LlamaBlock, config: ModelConfig,
         cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor,
         row_invariant: bool = False, place: Placement = LOCAL):
    """Projected + rotary-encoded q/k/v for a block input ([B, S, D])."""
    h = _norm(x, layer.attn_norm, config, row_invariant)
    return _qkv_normed(h, layer, config, cos, sin, positions, row_invariant,
                       place)


def mlp_readers(layer: LlamaBlock, config: ModelConfig) -> List[Any]:
    """The weights whose products read the MLP norm's output: w3 and w1,
    or for an MoE layer the router and the experts' w3 and w1 (never W8A8:
    the router stays full precision)."""
    if config.is_moe:
        return [layer.router, layer.moe_w3, layer.moe_w1]
    return [layer.w3, layer.w1]


def _moe_normed(h: torch.Tensor, layer: LlamaBlock, config: ModelConfig,
                row_invariant: bool, place: Placement = LOCAL
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer of the MLP norm's output: ``ops.moe.moe_layer_rows``
    where ``row_invariant``, else ``moe_layer``. Expert weights take part
    as :func:`resolve_weight` gives them (quantized ones dequantized: the
    expert products are never W8A8, as in the reference), with their
    ``embed`` and ``mlp`` dims whole and their expert dim as the rank
    holds it: on a mesh ``moe_layer`` takes the placement's routing
    (:meth:`Placement.routing`), which runs the rank's experts."""
    params = {"router": place.weight(layer.router),
              "w1": resolve_weight(place.weight(layer.moe_w1, whole=True),
                                   config),
              "w3": resolve_weight(place.weight(layer.moe_w3, whole=True),
                                   config),
              "w2": resolve_weight(place.weight(layer.moe_w2, whole=True),
                                   config)}
    if row_invariant:
        return moe_layer_rows(h, params, config.num_selected,
                              config.capacity_factor)
    return moe_layer(h, params, config.num_selected, config.capacity_factor,
                     dispatch_mode=config.moe_dispatch,
                     routing=place.routing(layer.moe_w1))


def _mlp_normed(h: torch.Tensor, layer: LlamaBlock, config: ModelConfig,
                row_invariant: bool = False, place: Placement = LOCAL
                ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """Dense SwiGLU or the expert layer of the MLP norm's output. Returns
    (residual delta, aux loss: the float 0.0 for a dense layer, which
    costs the serving steps no kernel launch)."""
    if config.is_moe:
        return _moe_normed(h, layer, config, row_invariant, place)
    gate, up = _placed_products("bsd,df->bsf", h, [layer.w3, layer.w1],
                                config, row_invariant, place)
    w2 = place.weight(layer.w2)
    qdtype = w8a8_dtype([w2], config, gate)
    if qdtype is not None:  # w2's input quantized in the same pass
        y = weight_einsum("bsf,fd->bsd",
                          swiglu_quantize_rows(gate, up, qdtype), w2,
                          config, row_invariant)
    else:
        gate = torch.nn.functional.silu(gate.float()).to(
            config.activation_dtype)
        y = weight_einsum("bsf,fd->bsd", gate * up, w2, config,
                          row_invariant)
    return place.reduce(y, layer.w2), 0.0


def _mlp(x: torch.Tensor, layer: LlamaBlock, config: ModelConfig,
         row_invariant: bool = False, place: Placement = LOCAL
         ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """Post-attention half of the block: norm + SwiGLU (dense or MoE).
    Returns (residual delta, aux loss)."""
    h = _norm(x, layer.mlp_norm, config, row_invariant)
    return _mlp_normed(h, layer, config, row_invariant, place)


def out_projection(attn: torch.Tensor, layer: LlamaBlock,
                   config: ModelConfig, row_invariant: bool = False,
                   place: Placement = LOCAL) -> torch.Tensor:
    """Attention output projection: the residual delta of the attention
    half."""
    y = weight_einsum("bshk,hkd->bsd", place.heads(attn, layer.wo),
                      place.weight(layer.wo), config, row_invariant)
    return place.reduce(y, layer.wo)


def project_out(x: torch.Tensor, attn: torch.Tensor, layer: LlamaBlock,
                config: ModelConfig, row_invariant: bool = False,
                place: Placement = LOCAL) -> torch.Tensor:
    """Attention output projection + residual add."""
    return x + out_projection(attn, layer, config, row_invariant, place)


def final_norm_hidden(x: torch.Tensor, model: Llama,
                      row_invariant: bool = False) -> torch.Tensor:
    """The hidden states the vocab head consumes (final rms_norm)."""
    return _norm(x, model.final_norm, model.config, row_invariant)


def head_weights(model: Llama,
                 config: Optional[ModelConfig] = None) -> torch.Tensor:
    """The lm head matrix in the activation dtype: the operand
    :func:`unembed` contracts with on the f32 path (and the fused-CE
    head's), a quantized head dequantized, the whole head of a model
    built over a mesh. ``config`` defaults to the model's."""
    return resolve_weight(model.placement.weight(model.lm_head, whole=True),
                          config or model.config)


def unembed(x: torch.Tensor, model: Llama, row_invariant: bool = False,
            config: Optional[ModelConfig] = None) -> torch.Tensor:
    """Final norm + lm head: [B, S, D] -> f32 logits [B, S, V], the
    product accumulated in f32 and kept in f32 (the reference's
    ``preferred_element_type``), never rounded to the activation dtype."""
    return unembed_normed(final_norm_hidden(x, model, row_invariant), model,
                          row_invariant, config)


def unembed_normed(h: Union[torch.Tensor, QuantizedRows], model: Llama,
                   row_invariant: bool = False,
                   config: Optional[ModelConfig] = None) -> torch.Tensor:
    """The lm head of the final norm's output: [B, S, D] -> f32 logits
    [B, S, V], as :func:`unembed`. A quantized head under W8A8 arithmetic
    (``config.matmul_dtype``; ``config`` defaults to the model's) contracts
    W8A8 with an f32 out, and takes the final norm's output as
    :class:`QuantizedRows` too."""
    config = config or model.config
    if w8a8_dtype([model.lm_head], config, h) is not None:
        return _quantized_products("bsd,dv->bsv", h, [model.lm_head],
                                   torch.float32)[0]
    b, s, d = h.shape
    h2 = h.reshape(b * s, d)
    w = head_weights(model, config)
    if row_invariant:
        out = decode_gemm_group(h2.contiguous(), [w], torch.float32)[0]
    else:
        out = decode_gemm_plain(h2, w, torch.float32)
    return out.reshape(b, s, -1)


# ---------------------------------------------------------------------
# The whole stack, for training (reference ``forward``/``forward_hidden``)
# ---------------------------------------------------------------------

def _dense_attention(q, k, v, positions):
    return causal_attention(q, k, v, positions, positions)


def _flash(q, k, v, positions):
    return flash_attention(q, k, v)


# The kernels it launches (those whose launches ``flash_attention``
# counts), which a step's compile builds ahead (``trainer.step_kernels``).
_flash.kernels = tuple(flash_attention.launches)


def resolve_attention(config: ModelConfig,
                      device: torch.device | str) -> Optional[AttentionFn]:
    """``config.attention`` -> attention fn, or None for the dense einsum.

    "flash" (and "flash-interpret") take :func:`ops.flash_attention`: the
    hand-written kernels on CUDA tensors, their plain versions on CPU
    tensors. "auto" takes flash on a CUDA device and the dense einsum on
    the CPU, as the reference's auto takes its kernel only on the
    accelerator. Flash assumes standard positions (0..S-1);
    :func:`forward_hidden` keeps the dense einsum when a caller passes
    explicit positions."""
    mode = config.attention
    if mode == "dense":
        return None
    if mode in ("flash", "flash-interpret"):
        return _flash
    return _flash if torch.device(device).type == "cuda" else None


# Matmul outputs the "dots" remat policy saves: the aten products the
# einsums and mms lower to. Everything else in a block is recomputed.
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(body: Callable, config: ModelConfig) -> Callable:
    """Apply the configured rematerialization policy to a block body.
    "none" (or remat=False) saves everything; "full" recomputes the whole
    block in backward (``torch.utils.checkpoint``, non-reentrant); "dots"
    saves the matmul outputs and recomputes the rest (selective
    checkpointing), as the reference's ``dots_with_no_batch_dims_saveable``
    keeps its MXU outputs."""
    if not config.remat or config.remat_policy == "none":
        return body
    if config.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
        return lambda *a: checkpoint(body, *a, use_reentrant=False,
                                     context_fn=context_fn)
    return lambda *a: checkpoint(body, *a, use_reentrant=False)


def _block(x: torch.Tensor, layer: LlamaBlock, config: ModelConfig,
           cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor,
           attention_fn: AttentionFn, place: Placement = LOCAL
           ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    q, k, v = _qkv(x, layer, config, cos, sin, positions, place=place)
    attn = attention_fn(q, k, v, positions)
    x = project_out(x, attn, layer, config, place=place)
    y, aux = _mlp(x, layer, config, place=place)
    return x + y, aux


def embed(model: Llama, tokens: torch.Tensor,
          config: ModelConfig) -> torch.Tensor:
    """The token embeddings [B, S, D]. Cast, then gather, as the
    reference does: the embedding's gradient is scattered in the
    activation dtype and cast back to the master's."""
    place = model.placement
    table = resolve_weight(place.weight(model.embed), config)
    return place.lookup(table, tokens, model.embed)


def forward(model: Llama, tokens: torch.Tensor, config: ModelConfig,
            attention_fn: Optional[AttentionFn] = None,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B, S, V] f32, MoE aux loss scalar: the layers'
    sum, 0 for a dense model)."""
    x, aux = forward_hidden(model, tokens, config, attention_fn, positions)
    return unembed(x, model, config=config), aux


def forward_hidden(model: Llama, tokens: torch.Tensor, config: ModelConfig,
                   attention_fn: Optional[AttentionFn] = None,
                   positions: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder stack without the vocab projection: (hidden states
    [B, S, D] before the final norm, MoE aux loss scalar). The fused-CE
    head (``ops/fused_ce.py``) consumes this, so [B, S, V] logits are never
    formed.

    The layers are a Python loop: the reference's ``scan_layers`` exists to
    keep XLA's compile time flat in depth, which eager PyTorch does not
    have, so the flag is not read here."""
    b, s = tokens.shape
    if attention_fn is None:
        if positions is None:
            attention_fn = resolve_attention(config, tokens.device)
        attention_fn = attention_fn or _dense_attention
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = model.rotary()
    x = embed(model, tokens, config)

    def body(x: torch.Tensor, layer: LlamaBlock):
        return _block(x, layer, config, cos, sin, positions, attention_fn,
                      model.placement)

    body = remat_block(body, config)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        x, aux = body(x, layer)
        aux_total = aux_total + aux
    return x, aux_total
