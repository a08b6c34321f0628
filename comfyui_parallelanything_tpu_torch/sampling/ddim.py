"""DDIM sampler (eps- or v-prediction, deterministic η=0) with batched CFG
(counterpart of ``comfyui_parallelanything_tpu/sampling/ddim.py``).

A host-side step loop: each step drives the (possibly parallelized) model forward
once, cond ‖ uncond in one batch when CFG is on. The alpha-bar table and the
timesteps live on the CPU in f32, so reading them never waits for the device.
"""

from __future__ import annotations

import torch

from .cfg import apply_callback, double_kwargs, rescale_guidance
from .schedules import ddim_timesteps, scaled_linear_schedule


def ddim_sample(
    model,
    x_init: torch.Tensor,
    context: torch.Tensor | None = None,
    *,
    steps: int = 20,
    cfg_scale: float = 1.0,
    uncond_context: torch.Tensor | None = None,
    uncond_kwargs: dict | None = None,
    alphas_cumprod: torch.Tensor | None = None,
    callback=None,
    ts: torch.Tensor | None = None,
    prediction: str = "eps",
    cfg_rescale: float = 0.0,
    **model_kwargs,
) -> torch.Tensor:
    """Denoise ``x_init`` (noise at t=ts[0]) over the DDIM steps; returns x_0.
    ``ts`` overrides the timestep schedule (img2img passes a truncated one and
    noises ``x_init`` to ts[0] itself). ``prediction="v"`` reads the output as
    SD2.x v-parameterization (x0 = √ᾱ·x − √(1−ᾱ)·v)."""
    if prediction not in ("eps", "v"):
        raise ValueError(f"prediction must be 'eps' or 'v', got {prediction!r}")
    acp = torch.as_tensor(scaled_linear_schedule() if alphas_cumprod is None
                          else alphas_cumprod, dtype=torch.float32).cpu()
    ts = ddim_timesteps(steps, acp.shape[0]) if ts is None else torch.as_tensor(ts).cpu()
    ts = [int(t) for t in ts]
    batch = x_init.shape[0]
    dev = x_init.device
    use_cfg = cfg_scale != 1.0 and uncond_context is not None

    x = x_init
    for i, t in enumerate(ts):
        t_vec = torch.full((batch,), float(t), dtype=torch.float32, device=dev)
        if use_cfg:
            kw = double_kwargs(model_kwargs, uncond_kwargs, batch)
            out_both = model(torch.cat([x, x]), torch.cat([t_vec, t_vec]),
                             torch.cat([context, uncond_context]), **kw)
            out_c, out_u = out_both.chunk(2, dim=0)
            out = out_u + cfg_scale * (out_c - out_u)
            out = rescale_guidance(out, out_c, cfg_rescale)
        else:
            out = model(x, t_vec, context, **model_kwargs)

        a_t = acp[t]
        a_prev = acp[ts[i + 1]] if i + 1 < len(ts) else torch.tensor(1.0)
        if prediction == "v":
            x0 = torch.sqrt(a_t) * x - torch.sqrt(1.0 - a_t) * out
            eps = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
        else:
            eps = out
            x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        x = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        x = apply_callback(callback, i, x)
    return x
