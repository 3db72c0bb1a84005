"""Model-FLOPs-utilization accounting -- the port of
``triton_kubernetes_tpu/train/mfu.py`` (``flops_per_token``, ``mfu``,
``mfu_on_slice``, ``attention_flops_fraction``, ``project_mfu``,
``tokens_per_sec_for_mfu``: the same arithmetic, the same numbers).

The PaLM-appendix convention, as the reference defines it: a training step
costs ``6 * N_active`` FLOPs per token (forward + backward) plus
attention's ``12 * L * H * d_head * S`` per token, halved for causal
masking. ``N_active`` counts the embedding table, whose lookup does no
matmul, so at shallow depth the figure overstates the work (PERF.md).
"""

from __future__ import annotations

from typing import Any

from ..models.config import ModelConfig

# Dense bf16 peaks of the cards the port runs on (NVIDIA data sheets).
PEAK_BF16_TFLOPS = {"H100 SXM": 989.0, "H100 PCIe": 756.0, "H100 NVL": 835.0,
                    "H200": 989.0}


def flops_per_token(config: ModelConfig, seq_len: int,
                    causal: bool = True) -> float:
    """Training (fwd+bwd) FLOPs per token."""
    matmul = 6.0 * config.active_params()
    attn = (12.0 * config.num_layers * config.num_heads
            * config.head_dim * seq_len)
    if causal:
        attn *= 0.5
    return matmul + attn


def mfu(tokens_per_sec: float, config: ModelConfig, seq_len: int,
        peak_tflops_total: float) -> float:
    """Fraction of peak achieved."""
    achieved = tokens_per_sec * flops_per_token(config, seq_len)
    return achieved / (peak_tflops_total * 1e12)


def mfu_on_slice(tokens_per_sec: float, config: ModelConfig, seq_len: int,
                 spec: Any) -> float:
    """:func:`mfu` against ``spec.peak_bf16_tflops`` (the reference's
    ``SliceSpec``, or any object with that field)."""
    return mfu(tokens_per_sec, config, seq_len, spec.peak_bf16_tflops)


def attention_flops_fraction(config: ModelConfig, seq_len: int) -> float:
    """Share of training FLOPs in the attention score/value matmuls (the
    part that runs in the flash kernels)."""
    total = flops_per_token(config, seq_len)
    return (total - 6.0 * config.active_params()) / total


def project_mfu(measured_mfu: float, proxy: ModelConfig, proxy_seq: int,
                target: ModelConfig, target_seq: int,
                kernel_rel_efficiency: float = 0.7) -> float:
    """The reference's conservative transfer of a proxy-measured MFU to a
    target (model, seq): the matmul-only efficiency inferred from the
    proxy (clamped to 1) re-applied under the target's mix, where the
    attention share runs at ``kernel_rel_efficiency`` of the matmul rate.
    Every other factor that differs is taken as no credit."""
    debit = 1.0 - kernel_rel_efficiency
    proxy_mix = 1.0 - attention_flops_fraction(proxy, proxy_seq) * debit
    target_mix = 1.0 - attention_flops_fraction(target, target_seq) * debit
    matmul_mfu = min(1.0, measured_mfu / proxy_mix)
    return matmul_mfu * target_mix


def tokens_per_sec_for_mfu(target_mfu: float, config: ModelConfig,
                           seq_len: int, peak_tflops_total: float) -> float:
    """Inverse of :func:`mfu`: the throughput that reaches
    ``target_mfu``."""
    return (target_mfu * peak_tflops_total * 1e12
            / flops_per_token(config, seq_len))


def peak_bf16_tflops(device_name: str) -> float:
    """Dense bf16 peak of a card by its CUDA device name; 0 for a device
    outside the table (the CPU), where MFU is then not reported."""
    for key in ("H200", "H100 NVL", "H100 PCIe"):
        if all(part in device_name for part in key.split()):
            return PEAK_BF16_TFLOPS[key]
    return PEAK_BF16_TFLOPS["H100 SXM"] if "H100" in device_name else 0.0
