"""Model-FLOPs-utilization accounting -- the port of
``triton_kubernetes_tpu/train/mfu.py`` (``flops_per_token``, ``mfu``).

The PaLM-appendix convention, as the reference defines it: a training step
costs ``6 * N_active`` FLOPs per token (forward + backward) plus
attention's ``12 * L * H * d_head * S`` per token, halved for causal
masking. ``N_active`` counts the embedding table, whose lookup does no
matmul, so at shallow depth the figure overstates the work (PERF.md).
"""

from __future__ import annotations

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


def peak_bf16_tflops(device_name: str) -> float:
    """Dense bf16 peak of a card by its CUDA device name; 0 for a device
    outside the table (the CPU), where MFU is then not reported."""
    for key in ("H200", "H100 NVL", "H100 PCIe"):
        if all(part in device_name for part in key.split()):
            return PEAK_BF16_TFLOPS[key]
    return PEAK_BF16_TFLOPS["H100 SXM"] if "H100" in device_name else 0.0
