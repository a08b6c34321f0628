"""Flow-matching Euler sampler for the FLUX / rectified-flow family (counterpart of
``comfyui_parallelanything_tpu/sampling/flow.py``).

The model predicts velocity v(x_t, t); integration runs t: 1 → 0 with
x_{t'} = x_t + (t' − t)·v. A host-side step loop: each step drives the (possibly
parallelized) model forward. The schedule lives on the host, so reading it never
waits for the device.
"""

from __future__ import annotations

import torch

from .cfg import apply_callback, double_kwargs, rescale_guidance


def apply_flow_shift(t: torch.Tensor, shift: float) -> torch.Tensor:
    """The rectified-flow resolution shift warp t ↦ s·t/(1+(s−1)·t)."""
    if shift == 1.0:
        return t
    return shift * t / (1.0 + (shift - 1.0) * t)


def flow_timesteps(steps: int, shift: float = 1.0) -> torch.Tensor:
    """(steps+1,) descending t in [1, 0] (f32, on the CPU), shift applied."""
    return apply_flow_shift(torch.linspace(1.0, 0.0, steps + 1, dtype=torch.float32), shift)


def flow_euler_sample(
    model,
    x_init: torch.Tensor,
    context: torch.Tensor | None = None,
    *,
    steps: int = 20,
    shift: float = 1.0,
    guidance: float | None = None,
    cfg_scale: float = 1.0,
    uncond_context: torch.Tensor | None = None,
    uncond_kwargs: dict | None = None,
    callback=None,
    ts: torch.Tensor | None = None,
    cfg_rescale: float = 0.0,
    **model_kwargs,
) -> torch.Tensor:
    """Euler-integrate the flow from noise (t=ts[0]) to sample (t=0).

    ``guidance`` feeds FLUX-dev's distilled guidance embedding; ``cfg_scale`` +
    ``uncond_context`` run true classifier-free guidance (batched). ``ts``
    overrides the schedule."""
    if ts is None:
        ts = flow_timesteps(steps, shift)
    ts = [float(t) for t in ts]
    steps = len(ts) - 1
    batch = x_init.shape[0]
    dev = x_init.device
    use_cfg = cfg_scale != 1.0 and uncond_context is not None

    kw = dict(model_kwargs)
    if guidance is not None:
        kw["guidance"] = torch.full((batch,), guidance, dtype=torch.float32, device=dev)

    x = x_init
    for i in range(steps):
        t_vec = torch.full((batch,), ts[i], dtype=torch.float32, device=dev)
        if use_cfg:
            x_in = torch.cat([x, x], dim=0)
            t_in = torch.cat([t_vec, t_vec], dim=0)
            c_in = torch.cat([context, uncond_context], dim=0)
            v_both = model(x_in, t_in, c_in, **double_kwargs(kw, uncond_kwargs, batch))
            v_c, v_u = v_both.chunk(2, dim=0)
            v = v_u + cfg_scale * (v_c - v_u)
            v = rescale_guidance(v, v_c, cfg_rescale)
        else:
            v = model(x, t_vec, context, **kw)
        x = x + (ts[i + 1] - ts[i]) * v
        x = apply_callback(callback, i, x)
    return x
