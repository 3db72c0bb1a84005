"""The GPU generation table and pool-shape arithmetic: the H100 twin of
the reference's ``topology/slices.py``.

Accelerator names follow the reference's ``<generation>-<count>``
convention, the count being the pool's GPUs: ``h100-8`` is one A3 host's
eight H100s, ``h100-16`` two such hosts. Where a TPU slice is a torus of
chips over ICI, a GPU pool is hosts of eight GPUs joined all to all by
NVLink, the hosts by the data-centre network: there are no torus
coordinates, so a pool is its generation and GPU count alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

# The H100 SXM's dense bf16 peak, the value of ``train/mfu.py``'s
# PEAK_BF16_TFLOPS["H100 SXM"] (pinned equal in tests/test_torch_topology.py):
# rendering never imports the training stack, as the reference's
# ``topology`` never imports its workload stack.
H100_SXM_PEAK_BF16_TFLOPS = 989.0


@dataclass(frozen=True)
class GpuGeneration:
    name: str
    gpus_per_host: int  # multi-host pools: GPUs per worker VM
    peak_bf16_tflops: float
    hbm_gb_per_gpu: float
    gke_accelerator: str  # GKE guest_accelerator type / node label value
    machine_type: str  # GKE machine type of a whole host
    max_gpus: int
    # Machine types by GPU count: A3 offers 1, 2, 4 and 8 H100s on one
    # host (a3-highgpu-1g ... -8g), so a pool of up to 8 is one host.
    single_host_types: Tuple[Tuple[int, str], ...] = ()


GPU_GENERATIONS: Dict[str, GpuGeneration] = {
    "h100": GpuGeneration(
        "h100", 8, H100_SXM_PEAK_BF16_TFLOPS, 80.0,
        "nvidia-h100-80gb", "a3-highgpu-8g", 4096,
        ((1, "a3-highgpu-1g"), (2, "a3-highgpu-2g"), (4, "a3-highgpu-4g"),
         (8, "a3-highgpu-8g"))),
}


def parse_accelerator(name: str) -> Tuple[GpuGeneration, int]:
    """``"h100-16"`` -> (the h100 generation, 16 GPUs). A count must fit
    one machine shape or be whole hosts, as the reference requires of a
    slice: otherwise node count, worker ids and per-host GPU limits would
    disagree with the machines."""
    gen_name, sep, count = name.partition("-")
    if gen_name not in GPU_GENERATIONS:
        raise ValueError(
            f"unknown GPU generation {gen_name!r}; know "
            f"{sorted(GPU_GENERATIONS)}")
    if not sep or not count.isdigit() or int(count) < 1:
        raise ValueError(f"accelerator must be <gen>-<gpus>, got {name!r}")
    gen = GPU_GENERATIONS[gen_name]
    gpus = int(count)
    if gpus > gen.max_gpus:
        raise ValueError(f"{gen_name} pools max out at {gen.max_gpus} GPUs")
    shapes = [c for c, _ in gen.single_host_types]
    if gpus not in shapes and gpus % gen.gpus_per_host != 0:
        raise ValueError(
            f"{name}: GPU count must be one of {shapes} (one host) or a "
            f"multiple of {gen.gpus_per_host} (GPUs/host on {gen_name})")
    return gen, gpus


@dataclass(frozen=True)
class GpuPoolSpec:
    """A resolved GPU pool: generation and GPU count."""

    generation: GpuGeneration
    gpus: int

    @staticmethod
    def from_accelerator(name: str) -> "GpuPoolSpec":
        gen, gpus = parse_accelerator(name)
        return GpuPoolSpec(gen, gpus)

    @property
    def accelerator(self) -> str:
        return f"{self.generation.name}-{self.gpus}"

    @property
    def _single_host_type(self) -> str | None:
        """Machine type when this GPU count is one host, else None: the
        one lookup host count and machine type both read."""
        for c, mt in self.generation.single_host_types:
            if c == self.gpus:
                return mt
        return None

    @property
    def num_hosts(self) -> int:
        if self._single_host_type is not None:
            return 1
        return self.gpus // self.generation.gpus_per_host

    @property
    def gpus_per_host(self) -> int:
        """GPUs each worker VM owns: the ``nvidia.com/gpu`` limit of a
        pod and the count the health probe asserts."""
        return self.gpus // self.num_hosts

    @property
    def machine_type(self) -> str:
        return self._single_host_type or self.generation.machine_type

    @property
    def is_multi_host(self) -> bool:
        return self.num_hosts > 1

    @property
    def peak_bf16_tflops(self) -> float:
        return self.gpus * self.generation.peak_bf16_tflops
