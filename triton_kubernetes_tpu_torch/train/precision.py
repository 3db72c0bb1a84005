"""Mixed-precision policies for the training step, and the decode-time
weight policy -- the port of ``triton_kubernetes_tpu/train/precision.py``.

bf16 compute over f32 master state: matmul operands and activations in
bfloat16, while master params, Adam moments, the attention softmax, the
RMS-norm reductions and the CE logsumexp stay float32. The ops already
keep the reductions in f32; a policy chooses the storage and matmul-operand
dtypes, i.e. exactly the ``param_dtype``/``dtype`` pair of
:class:`..models.config.ModelConfig`, and is applied by rewriting the
config (:func:`apply_policy`) before the step is built. Gradients of the
f32 masters are f32, so the optimizer runs in f32, and bf16's f32-sized
exponent range needs no loss scaling.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, Tuple, Union

import torch

from ..constants import WEIGHT_DTYPES
from ..models.config import ModelConfig
from ..models.llama import Llama, quantize_weights


@dataclass(frozen=True)
class PrecisionPolicy:
    """Storage/compute dtype pair for one training step: ``param_dtype``
    for the master params and optimizer moments, ``compute_dtype`` for
    weights at their point of use and for activations."""

    name: str
    param_dtype: str
    compute_dtype: str

    def describe(self) -> str:
        return (f"{self.name}: params/opt {self.param_dtype}, "
                f"compute/activations {self.compute_dtype}, "
                f"reductions float32")


POLICIES: Dict[str, PrecisionPolicy] = {
    "f32": PrecisionPolicy("f32", "float32", "float32"),
    "bf16": PrecisionPolicy("bf16", "float32", "bfloat16"),
}


def get_policy(policy: Union[str, PrecisionPolicy]) -> PrecisionPolicy:
    if isinstance(policy, PrecisionPolicy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise KeyError(
            f"unknown precision policy {policy!r}; know "
            f"{sorted(POLICIES)}") from None


def apply_policy(config: ModelConfig,
                 policy: Union[str, PrecisionPolicy, None]) -> ModelConfig:
    """Config with the policy's dtypes applied; None/"auto" is identity."""
    if policy is None or policy == "auto":
        return config
    p = get_policy(policy)
    if (config.dtype == p.compute_dtype
            and config.param_dtype == p.param_dtype):
        return config
    return replace(config, dtype=p.compute_dtype, param_dtype=p.param_dtype)


def policy_of(config: ModelConfig) -> str:
    """A config's dtype pair as a policy name ("custom" when none
    matches)."""
    for name, p in POLICIES.items():
        if (config.dtype == p.compute_dtype
                and config.param_dtype == p.param_dtype):
            return name
    return "custom"


def remat_policy_of(config: ModelConfig) -> str:
    """The effective rematerialization policy ("none" when remat is off
    either way), matching ``models.llama.remat_block``'s gating."""
    return "none" if not config.remat else config.remat_policy


def grads_all_finite(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """Device bool scalar: every gradient tensor is NaN/Inf-free (no host
    sync)."""
    ok = None
    for g in grads:
        leaf = torch.isfinite(g).all()
        ok = leaf if ok is None else ok & leaf
    return ok if ok is not None else torch.tensor(True)


def quantize_for_decode(model: Llama, config: ModelConfig,
                        weight_dtype: str) -> Tuple[Llama, ModelConfig]:
    """Apply a decode weight policy: returns ``(model, config)``. "auto" is
    the identity on both; "int8"/"fp8" rewrite both together -- a new model
    from ``models.llama.quantize_weights`` (the caller's is untouched) and
    the config with ``weight_quant`` set -- so a half-quantized state
    cannot exist. Raises ``KeyError`` for a dtype outside
    ``WEIGHT_DTYPES``."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise KeyError(
            f"unknown weight_dtype {weight_dtype!r}; know "
            f"{list(WEIGHT_DTYPES)}")
    if weight_dtype == "auto":
        return model, config
    return (quantize_weights(model, weight_dtype),
            replace(config, weight_quant=weight_dtype))
