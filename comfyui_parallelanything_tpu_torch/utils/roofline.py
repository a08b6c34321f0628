"""Platform roofline specs and the nominal step time the heterogeneous-chain speed
blend reads (counterpart of ``platform_spec``/``nominal_step_time_s`` in
``comfyui_parallelanything_tpu/utils/roofline.py``, kept on the port's side).

A spec is matched by a substring of the device's kind (``torch.cuda.get_device_name``
for a GPU, ``""`` for the host); an unknown kind gets ``CPU_SPEC``, the JAX
package's deterministic pseudo-spec for the host, so a GPU + CPU chain's split
reflects that the CPU is roughly a hundred times slower.
"""

from __future__ import annotations

# Peak dense bf16 FLOP/s and HBM bytes/s per card (NVIDIA's H100 SXM data sheet).
PLATFORM_SPECS: tuple[tuple[str, dict], ...] = (
    ("h100", {"peak_flops": 989e12, "hbm_bw": 3.35e12}),
)

# The JAX package's pseudo-spec for the host (its CPU_SPEC's peak_flops and
# hbm_bw; the interconnect entries have no reader here).
CPU_SPEC = {"peak_flops": 2e12, "hbm_bw": 50e9, "generation": "cpu-pseudo"}

# The speed blend's reference workload, the JAX package's: roughly one SD1.5
# batch-16 1024² denoise step. The absolute numbers cancel in the share
# normalisation; the flops:bytes ratio decides which wall each platform's time
# sits against.
NOMINAL_STEP_FLOPS = 2e12
NOMINAL_STEP_BYTES = 4e10


def platform_spec(device_kind: str = "", platform: str = "cpu") -> dict:
    """The roofline spec of a device: the first ``PLATFORM_SPECS`` key that is a
    substring of ``device_kind`` (case-insensitive), else ``CPU_SPEC``."""
    kind = str(device_kind or "").lower()
    for key, spec in PLATFORM_SPECS:
        if kind and key in kind:
            return {**spec, "generation": key, "platform": platform}
    return {**CPU_SPEC, "platform": platform}


def nominal_step_time_s(device_kind: str = "", platform: str = "cpu",
                        flops: float = NOMINAL_STEP_FLOPS,
                        bytes_accessed: float = NOMINAL_STEP_BYTES) -> float:
    """The reference workload's time on a device from its spec alone: the larger of
    operations over peak FLOP/s and bytes over memory bandwidth."""
    spec = platform_spec(device_kind, platform)
    return max(flops / spec["peak_flops"], bytes_accessed / spec["hbm_bw"])
