"""Timestep-boundary expert switching: the Wan2.2 A14B two-expert denoiser
(counterpart of ``comfyui_parallelanything_tpu/models/experts.py``).

Wan2.2's 14B release splits denoising between two full DiT checkpoints: a
high-noise expert for the early steps and a low-noise expert for the rest,
switched at a fixed flow-time boundary. The samplers are host loops whose timestep
values are concrete at each call, so the switch is plain Python; each expert can be
``parallelize``d on its own chain.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# Official Wan2.2 A14B switch points (flow time in [0, 1]).
WAN22_T2V_BOUNDARY = 0.875
WAN22_I2V_BOUNDARY = 0.900


@dataclasses.dataclass
class TimestepExpertSwitch:
    """Callable denoiser that routes each step to one of two experts by the step's
    flow time: ``t >= boundary`` → ``high_noise``, else ``low_noise``.

    Timestep units follow the sampler driving it (flow samplers pass t ∈ [0, 1]).
    Both experts may be ``DiffusionModel``s or ``ParallelModel``s."""

    high_noise: Any
    low_noise: Any
    boundary: float = WAN22_T2V_BOUNDARY

    def expert_for(self, timesteps) -> Any:
        t = float(torch.as_tensor(timesteps).max())
        return self.high_noise if t >= self.boundary else self.low_noise

    def __call__(self, x, timesteps, context=None, **kwargs):
        return self.expert_for(timesteps)(x, timesteps, context, **kwargs)

    def traceable(self):
        """None: the expert is picked on the host from each step's timestep, which
        one captured loop cannot do, so ``compile_loop=True`` runs the eager loop."""
        return None

    @property
    def model_config(self):
        from ..parallel.orchestrator import model_config_of

        return model_config_of(self.high_noise)

    def cleanup(self) -> None:
        for expert in (self.high_noise, self.low_noise):
            fn = getattr(expert, "cleanup", None)
            if fn is not None:
                fn()
