"""k-diffusion-family samplers, the KSampler scheduler menu and ``EpsDenoiser``
(counterpart of ``comfyui_parallelanything_tpu/sampling/k_samplers.py``).

Host-side step loops like ``flow.py``: each model call routes through the
(possibly parallelized) forward. Conventions (eps-prediction SD family,
k-diffusion/EDM parameterization): ``sigma_t = sqrt((1-ᾱ_t)/ᾱ_t)``; the model
input is ``x/sqrt(sigma²+1)`` at the table timestep interpolated in log-sigma;
the denoised prediction is ``x0 = x - sigma·eps``.

Every schedule is a 1-D float32 tensor on the CPU, computed in f32 as the JAX
package computes it, and the samplers read its entries as 0-d CPU tensors: the
``float(s_next) == 0.0`` tests of each step never wait for the device, and the
sigma arithmetic stays in f32.

Per-step noise comes from ``step_noise`` alone: its draw depends only on the
request generator's seed, the step and the part of the step, never on how many
draws came before (the JAX package's ``fold_in(rng, i)`` discipline). The
whole-loop compiled sampler draws every step's noise before the loop and hands the
samplers the table through ``noise_table``.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import numpy as np
import torch

from .cfg import apply_callback, double_kwargs, rescale_guidance
from .flow import apply_flow_shift
from .schedules import scaled_linear_schedule

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """SplitMix64's finaliser: a 64-bit integer → a well-spread 64-bit integer."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_noise(rng: torch.Generator, i: int, shape, like: torch.Tensor,
               part: int = 0) -> torch.Tensor:
    """The N(0, 1) draw of step ``i`` (``part`` 1 for ``dpmpp_sde``'s second draw),
    in ``like``'s dtype and on its device, from a generator seeded from
    ``(rng.initial_seed(), i, part)``."""
    seed = _mix64(rng.initial_seed() ^ _mix64(4 * i + part)) & ((1 << 63) - 1)
    gen = torch.Generator(device=like.device).manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, dtype=like.dtype, device=like.device)


def broadcast_cond_batch(arr, batch: int):
    """ComfyUI conditioning-batch semantics: one encoded prompt (or any divisor of
    the batch) tiles to the latent batch; a non-divisor batch is an error."""
    if arr is not None and arr.shape[0] != batch:
        if batch % arr.shape[0]:
            raise ValueError(
                f"conditioning batch {arr.shape[0]} does not divide latent batch {batch}")
        arr = torch.as_tensor(arr).repeat_interleave(batch // arr.shape[0], dim=0)
    return arr


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).cpu()


def interp(x, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp``: piecewise-linear ``fp(xp)`` at ``x``, clamped to ``fp[0]`` /
    ``fp[-1]`` outside ``[xp[0], xp[-1]]`` (``xp`` ascending), step for step."""
    x = _f32(x)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _with_zero(sig: torch.Tensor) -> torch.Tensor:
    return torch.cat([sig.float(), torch.zeros(1)])


def model_sigmas(alphas_cumprod: torch.Tensor) -> torch.Tensor:
    """Per-trained-timestep sigma table, ascending with t."""
    alphas_cumprod = _f32(alphas_cumprod)
    return torch.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)


def _sigma_table(alphas_cumprod, sigma_table=None) -> torch.Tensor:
    if sigma_table is not None:
        return _f32(sigma_table)
    if alphas_cumprod is None:
        alphas_cumprod = scaled_linear_schedule()
    return model_sigmas(alphas_cumprod)


def sampling_sigmas(n_steps: int, alphas_cumprod=None, sigma_table=None) -> torch.Tensor:
    """(n_steps+1,) descending sigmas over the model's range, ending at 0."""
    table = _sigma_table(alphas_cumprod, sigma_table)
    idx = torch.linspace(len(table) - 1, 0, n_steps, dtype=torch.float32)
    return _with_zero(interp(idx, torch.arange(len(table), dtype=torch.float32), table))


def karras_sigmas(n_steps: int, sigma_min: float = 0.0292, sigma_max: float = 14.6146,
                  rho: float = 7.0) -> torch.Tensor:
    """Karras et al. (2022) spacing, denser near sigma_min; (n_steps+1,), ends at 0."""
    ramp = torch.linspace(0.0, 1.0, n_steps, dtype=torch.float32)
    min_inv, max_inv = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return _with_zero((max_inv + ramp * (min_inv - max_inv)) ** rho)


def exponential_sigmas(n_steps: int, sigma_min: float = 0.0292,
                       sigma_max: float = 14.6146) -> torch.Tensor:
    """Log-uniform spacing (k-diffusion ``get_sigmas_exponential``); ends at 0."""
    lo, hi = (torch.log(torch.tensor(v, dtype=torch.float32)) for v in (sigma_min, sigma_max))
    return _with_zero(torch.exp(torch.linspace(float(hi), float(lo), n_steps,
                                               dtype=torch.float32)))


def flow_sigma_table(shift: float = 1.0, n: int = 1000) -> torch.Tensor:
    """The CONST (rectified-flow) model sigma table: sigma(t) = t with the resolution
    shift applied, ascending over n trained timesteps."""
    return apply_flow_shift(torch.linspace(1.0 / n, 1.0, n, dtype=torch.float32), shift)


def sgm_uniform_sigmas(n_steps: int, alphas_cumprod=None, sigma_table=None) -> torch.Tensor:
    """SGM "trailing" uniform-timestep spacing: n+1 uniform timesteps, last dropped."""
    table = _sigma_table(alphas_cumprod, sigma_table)
    idx = torch.linspace(len(table) - 1, 0, n_steps + 1, dtype=torch.float32)[:-1]
    return _with_zero(interp(idx, torch.arange(len(table), dtype=torch.float32), table))


def simple_sigmas(n_steps: int, alphas_cumprod=None, sigma_table=None) -> torch.Tensor:
    """ComfyUI ``simple``: raw table entries at equal index strides (no interp)."""
    table = _sigma_table(alphas_cumprod, sigma_table)
    stride = len(table) / n_steps
    idx = [len(table) - 1 - int(i * stride) for i in range(n_steps)]
    return _with_zero(table[torch.tensor(idx)])


def _betainc(a: float, b: float, x: np.ndarray) -> np.ndarray:
    """Regularised incomplete beta I_x(a, b) in f64, by the continued fraction
    (modified Lentz), with the symmetry I_x(a, b) = 1 − I_{1−x}(b, a) where the
    fraction converges slowly."""
    x = np.asarray(x, np.float64)
    out = np.zeros_like(x)
    out[x >= 1.0] = 1.0
    inner = (x > 0.0) & (x < 1.0)
    flip = inner & (x > (a + 1.0) / (a + b + 2.0))
    for sel, aa, bb, xx, flipped in ((inner & ~flip, a, b, x, False),
                                     (flip, b, a, 1.0 - x, True)):
        if not sel.any():
            continue
        xs = xx[sel]
        lbeta = math.lgamma(aa) + math.lgamma(bb) - math.lgamma(aa + bb)
        front = np.exp(aa * np.log(xs) + bb * np.log1p(-xs) - lbeta) / aa
        tiny = 1e-300
        c = np.ones_like(xs)
        d = 1.0 - (aa + bb) * xs / (aa + 1.0)
        d = 1.0 / np.where(np.abs(d) < tiny, tiny, d)
        f = d.copy()
        for m in range(1, 300):
            for num in (m * (bb - m) * xs / ((aa + 2 * m - 1) * (aa + 2 * m)),
                        -(aa + m) * (aa + bb + m) * xs / ((aa + 2 * m) * (aa + 2 * m + 1))):
                d = 1.0 + num * d
                d = 1.0 / np.where(np.abs(d) < tiny, tiny, d)
                c = 1.0 + num / c
                c = np.where(np.abs(c) < tiny, tiny, c)
                f = f * c * d
        val = front * f
        out[sel] = 1.0 - val if flipped else val
    return out


@functools.lru_cache(maxsize=8)
def _beta_cdf_grid(a: float, b: float, grid_points: int) -> tuple[np.ndarray, np.ndarray]:
    grid = np.linspace(0.0, 1.0, grid_points, dtype=np.float64)
    return grid, _betainc(a, b, grid)


def _beta_ppf(q: np.ndarray, a: float, b: float, grid_points: int = 65537) -> np.ndarray:
    """Beta quantile function by numeric CDF inversion on a uniform grid (f64)."""
    grid, cdf = _beta_cdf_grid(float(a), float(b), grid_points)
    return np.interp(q, cdf, grid)


def beta_sigmas(n_steps: int, alphas_cumprod=None, alpha: float = 0.6, beta: float = 0.6,
                sigma_table=None) -> torch.Tensor:
    """ComfyUI ``beta`` (arXiv:2407.12173): timesteps at Beta(0.6, 0.6) quantiles,
    denser at both schedule ends; duplicate timesteps are skipped, so the result
    may be shorter than ``n_steps + 1``."""
    table = _sigma_table(alphas_cumprod, sigma_table)
    ts = 1.0 - np.linspace(0.0, 1.0, n_steps, endpoint=False, dtype=np.float64)
    idx = np.rint(_beta_ppf(ts, alpha, beta) * (len(table) - 1)).astype(np.int64)
    keep = np.concatenate([[True], np.diff(idx) != 0])
    return _with_zero(table[torch.from_numpy(idx[keep])])


def ddim_uniform_sigmas(n_steps: int, alphas_cumprod=None, sigma_table=None) -> torch.Tensor:
    """ComfyUI ``ddim_uniform``: table entries at indices ``1, 1+T//n, … (< T)``,
    descending; a stride of 1 hands off to ``sgm_uniform``."""
    table = _sigma_table(alphas_cumprod, sigma_table)
    T = len(table)
    stride = T // n_steps
    if stride <= 1:
        return sgm_uniform_sigmas(n_steps, alphas_cumprod, sigma_table)
    idx = list(range(1, T, stride))
    return _with_zero(table[torch.tensor(list(reversed(idx)))])


def kl_optimal_sigmas(n_steps: int, alphas_cumprod=None, sigma_table=None) -> torch.Tensor:
    """"Align Your Steps" KL-optimal spacing (arXiv:2404.14507), inclusive of
    sigma_min."""
    table = _sigma_table(alphas_cumprod, sigma_table)
    sigma_min, sigma_max = table[0], table[-1]
    frac = torch.linspace(0.0, 1.0, n_steps, dtype=torch.float32)
    return _with_zero(torch.tan((1.0 - frac) * torch.arctan(sigma_max)
                                + frac * torch.arctan(sigma_min)))


SCHEDULER_NAMES = (
    "karras", "normal", "exponential", "sgm_uniform", "simple", "ddim_uniform",
    "beta", "kl_optimal",
)


def make_sigmas(scheduler: str, n_steps: int, alphas_cumprod=None,
                sigma_table=None) -> torch.Tensor:
    """The KSampler scheduler menu: named spacing → (n_steps+1,) descending sigmas
    ending at 0, ranged over the model's sigma table (``sigma_table`` overrides the
    alpha-bar derivation; flow models pass ``flow_sigma_table(shift)``)."""
    if scheduler in ("karras", "exponential"):
        fn = karras_sigmas if scheduler == "karras" else exponential_sigmas
        if alphas_cumprod is None and sigma_table is None:
            return fn(n_steps)
        table = _sigma_table(alphas_cumprod, sigma_table)
        return fn(n_steps, sigma_min=float(table[0]), sigma_max=float(table[-1]))
    if scheduler == "normal":
        return sampling_sigmas(n_steps, alphas_cumprod, sigma_table)
    if scheduler == "sgm_uniform":
        return sgm_uniform_sigmas(n_steps, alphas_cumprod, sigma_table)
    if scheduler == "simple":
        return simple_sigmas(n_steps, alphas_cumprod, sigma_table)
    if scheduler == "ddim_uniform":
        return ddim_uniform_sigmas(n_steps, alphas_cumprod, sigma_table)
    if scheduler == "beta":
        return beta_sigmas(n_steps, alphas_cumprod, sigma_table=sigma_table)
    if scheduler == "kl_optimal":
        return kl_optimal_sigmas(n_steps, alphas_cumprod, sigma_table)
    raise ValueError(f"unknown scheduler {scheduler!r} (have {', '.join(SCHEDULER_NAMES)})")


def area_weight(area, strength: float, shape, mask=None, mask_strength: float = 1.0,
                area_pct=None, device=None):
    """Per-pixel weight of one cond: ``strength`` everywhere (a 0-d CPU tensor), or
    strength inside the (h, w, y, x) latent-unit box (SetArea; ``area_pct`` gives it
    as fractions of the latent frame), times a pixel-space MASK resized to the
    latent grid (SetMask) and its ``mask_strength``. Maps are (1|B, H, W, 1) on
    ``device``. Non-2-D latents use the full frame."""
    weight = torch.tensor(float(strength), dtype=torch.float32)
    if area_pct is not None and area is None and len(shape) == 4:
        fh, fw, fy, fx = (float(v) for v in area_pct)
        area = (max(1, round(fh * shape[1])), max(1, round(fw * shape[2])),
                round(fy * shape[1]), round(fx * shape[2]))
    if area is not None and len(shape) == 4:
        h, w, y, x0 = (int(v) for v in area)
        box = torch.zeros((1, shape[1], shape[2], 1), dtype=torch.float32, device=device)
        box[:, y:y + h, x0:x0 + w, :] = 1.0
        weight = weight * box
    if mask is not None and len(shape) == 4:
        from ..models.vae import normalize_mask

        m = normalize_mask(mask, (shape[1], shape[2])).to(device)
        if m.shape[0] not in (1, shape[0]):
            m = m[:1]
        weight = weight * m * float(mask_strength)
    return weight


class EpsDenoiser:
    """Wraps a model forward into ``denoise(x, sigma) -> x0`` with batched CFG
    (cond ‖ uncond in one call).

    ``prediction``: ``"eps"`` (x0 = x − σ·eps, input scaled by 1/√(σ²+1), σ →
    timestep by log-sigma interpolation), ``"v"`` (x0 = x/(σ²+1) − v·σ/√(σ²+1)),
    ``"flow"`` (σ is the flow time: the model takes x unscaled and t = σ, and
    x0 = x − σ·v). ``extra_conds`` (each ``{"context", "pooled"?, "strength"?,
    "area"?, "area_pct"?, "mask"?, "mask_strength"?, "timestep_range"?}``) and the
    primary cond's area/mask/strength combine by per-pixel area-weight
    normalisation (one model call per extra cond)."""

    def __init__(self, model, context=None, *, cfg_scale: float = 1.0, uncond_context=None,
                 uncond_kwargs: dict | None = None, alphas_cumprod=None,
                 prediction: str = "eps", cfg_rescale: float = 0.0,
                 extra_conds: tuple | list | None = None, cond_area: tuple | None = None,
                 cond_area_pct: tuple | None = None, cond_mask=None,
                 cond_strength: float = 1.0, cond_mask_strength: float = 1.0,
                 **model_kwargs):
        if alphas_cumprod is None:
            alphas_cumprod = scaled_linear_schedule()
        if prediction not in ("eps", "v", "flow"):
            raise ValueError(f"prediction must be 'eps', 'v' or 'flow', got {prediction!r}")
        self.prediction = prediction
        self.model = model
        self.context = context
        self.cfg_scale = cfg_scale
        self.cfg_rescale = cfg_rescale
        self.uncond_context = uncond_context
        self.uncond_kwargs = uncond_kwargs
        self.extra_conds = tuple(extra_conds or ())
        self.cond_area = cond_area
        self.cond_area_pct = cond_area_pct
        self.cond_mask = cond_mask
        self.cond_strength = cond_strength
        self.cond_mask_strength = cond_mask_strength
        self.kwargs = model_kwargs
        self.sigma_table = model_sigmas(alphas_cumprod)
        self.log_sigmas = torch.log(self.sigma_table)

    @property
    def _multi_cond(self) -> bool:
        return bool(self.extra_conds or self.cond_area is not None
                    or self.cond_area_pct is not None or self.cond_mask is not None)

    def _combine_conds(self, eps_c, x_in, t_vec, batch):
        """Area-weight-normalised blend of the primary cond's prediction with every
        extra cond's; an extra with ``timestep_range`` (start, end) counts only
        while sampling progress is inside the window. Pixels no cond covers keep
        the primary prediction."""
        from ..ops.basic import progress_window_gate

        dev = eps_c.device
        m0 = area_weight(self.cond_area, self.cond_strength, x_in.shape,
                         mask=self.cond_mask, mask_strength=self.cond_mask_strength,
                         area_pct=self.cond_area_pct, device=dev)
        num = m0 * eps_c
        den = m0 * torch.ones_like(eps_c[..., :1])
        for e in self.extra_conds:
            ctx = broadcast_cond_batch(e["context"], batch)
            kw = dict(self.kwargs)
            pooled = e.get("pooled")
            if pooled is not None:
                kw["y"] = broadcast_cond_batch(pooled, batch)
            eps_e = self.model(x_in, t_vec, ctx, **kw)
            m = area_weight(e.get("area"), float(e.get("strength", 1.0)), x_in.shape,
                            mask=e.get("mask"), mask_strength=float(e.get("mask_strength", 1.0)),
                            area_pct=e.get("area_pct"), device=dev)
            window = e.get("timestep_range")
            if window is not None:
                m = m * progress_window_gate(t_vec, window[0], window[1], x_in.ndim,
                                             flow_time=self.prediction == "flow")
            num = num + m * eps_e
            den = den + m * torch.ones_like(eps_e[..., :1])
        return torch.where(den > 0, num / torch.clamp(den, min=1e-8), eps_c)

    def _timestep(self, sigma) -> torch.Tensor:
        """Continuous timestep whose table sigma matches (log-space interpolation)."""
        return interp(torch.log(_f32(sigma)), self.log_sigmas,
                      torch.arange(len(self.log_sigmas), dtype=torch.float32))

    def __call__(self, x: torch.Tensor, sigma) -> torch.Tensor:
        batch = x.shape[0]
        sigma = _f32(sigma)
        if self.prediction == "flow":
            scale = 1.0
            t_vec = torch.full((batch,), float(sigma), dtype=torch.float32, device=x.device)
            x_in = x
        else:
            scale = 1.0 / torch.sqrt(sigma**2 + 1.0)
            t_vec = torch.full((batch,), float(self._timestep(sigma)), dtype=torch.float32,
                               device=x.device)
            x_in = x * scale
        if self.cfg_scale != 1.0 and self.uncond_context is not None:
            kw = double_kwargs(self.kwargs, self.uncond_kwargs, batch)
            eps_both = self.model(torch.cat([x_in, x_in]), torch.cat([t_vec, t_vec]),
                                  torch.cat([self.context, self.uncond_context]), **kw)
            eps_c, eps_u = eps_both.chunk(2, dim=0)
            if self._multi_cond:
                eps_c = self._combine_conds(eps_c, x_in, t_vec, batch)
            eps = eps_u + self.cfg_scale * (eps_c - eps_u)
            eps = rescale_guidance(eps, eps_c, self.cfg_rescale)
        else:
            eps = self.model(x_in, t_vec, self.context, **self.kwargs)
            if self._multi_cond:
                eps = self._combine_conds(eps, x_in, t_vec, batch)
        if self.prediction == "v":
            return x / (sigma**2 + 1.0) - eps * sigma * scale
        # eps: x0 = x − σ·eps. flow: x0 = x − σ·v — the same expression.
        return x - sigma * eps


# The whole-loop compiled sampler's pre-drawn noise: (steps, parts, *latent) while
# a loop runs under ``noise_table`` (``sampling/compiled.py``), else None.
_NOISE_TABLE: contextvars.ContextVar = contextvars.ContextVar("noise_table", default=None)


@contextlib.contextmanager
def noise_table(table: torch.Tensor | None):
    """Inside the block the samplers' per-step draws read ``table[i, part]``, the
    ``step_noise`` draws made before the loop, instead of drawing: a captured CUDA
    graph cannot seed a generator per step, and its replays read the buffer the
    caller refills."""
    token = _NOISE_TABLE.set(table)
    try:
        yield
    finally:
        _NOISE_TABLE.reset(token)


def _noise(rng, i, x, part=0):
    table = _NOISE_TABLE.get()
    if table is not None:
        return table[i, part].to(x.dtype)
    return step_noise(rng, i, x.shape, x, part)


def sample_euler(denoise, x, sigmas, callback=None):
    """Deterministic Euler over the sigma schedule."""
    for i in range(len(sigmas) - 1):
        x0 = denoise(x, sigmas[i])
        d = (x - x0) / sigmas[i]
        x = x + d * (sigmas[i + 1] - sigmas[i])
        x = apply_callback(callback, i, x)
    return x


def ancestral_steps(s, s_next, eta: float = 1.0):
    """(sigma_down, sigma_up) for an ancestral step from ``s`` to ``s_next``
    (k-diffusion's get_ancestral_step)."""
    sigma_up = torch.minimum(
        s_next, eta * torch.sqrt(torch.clamp(s_next**2 * (s**2 - s_next**2) / s**2, min=0.0)))
    sigma_down = torch.sqrt(torch.clamp(s_next**2 - sigma_up**2, min=0.0))
    return sigma_down, sigma_up


def sample_euler_ancestral(denoise, x, sigmas, rng, eta: float = 1.0, callback=None):
    """Euler with ancestral noise injection (stochastic)."""
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        sigma_down, sigma_up = ancestral_steps(s, s_next, eta)
        d = (x - x0) / s
        x = x + d * (sigma_down - s)
        if float(s_next) > 0:
            x = x + sigma_up * _noise(rng, i, x)
        x = apply_callback(callback, i, x)
    return x


def _rf_renoise(s, s_next, eta):
    """The RF ancestral step's (sigma_down, alpha ratio, renoise std)."""
    sd = s_next * (1.0 + (s_next / s - 1.0) * eta)
    alpha_ip1, alpha_down = 1.0 - s_next, 1.0 - sd
    renoise = torch.sqrt(torch.clamp(s_next**2 - sd**2 * alpha_ip1**2 / alpha_down**2, min=0.0))
    return sd, alpha_ip1 / alpha_down, renoise


def sample_euler_ancestral_rf(denoise, x, sigmas, rng, eta: float = 1.0, callback=None):
    """Euler ancestral for rectified-flow schedules: the renoise rescales by the
    interpolant's alpha ratio and injects the variance that restores the t_next
    marginal."""
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        if float(s_next) == 0.0:
            x = x0
        else:
            sd, ratio_a, renoise = _rf_renoise(s, s_next, eta)
            ratio = sd / s
            x = ratio * x + (1.0 - ratio) * x0
            x = ratio_a * x + renoise * _noise(rng, i, x)
        x = apply_callback(callback, i, x)
    return x


def sample_dpmpp_2s_ancestral_rf(denoise, x, sigmas, rng, eta: float = 1.0, callback=None):
    """DPM-Solver++(2S) ancestral for rectified-flow schedules: λ = log((1−σ)/σ),
    the midpoint at λ + h/2 (pinned to σ = 0.9999 when σ = 1), RF renoise."""
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        sd, ratio_a, renoise = _rf_renoise(s, s_next, eta)
        if float(s_next) == 0.0:
            d = (x - x0) / s
            x = x + d * (sd - s)
        else:
            if float(s) >= 1.0:
                sigma_mid = torch.tensor(0.9999, dtype=torch.float32)
            else:
                t_i = torch.log((1.0 - s) / s)
                t_down = torch.log((1.0 - sd) / sd)
                sigma_mid = 1.0 / (torch.exp(t_i + 0.5 * (t_down - t_i)) + 1.0)
            u = (sigma_mid / s) * x + (1.0 - sigma_mid / s) * x0
            x0_2 = denoise(u, sigma_mid)
            x = (sd / s) * x + (1.0 - sd / s) * x0_2
        if float(s_next) > 0:
            x = ratio_a * x + renoise * _noise(rng, i, x)
        x = apply_callback(callback, i, x)
    return x


def sample_lcm_rf(denoise, x, sigmas, rng, callback=None):
    """LCM on rectified-flow schedules: re-noise with the flow interpolant
    ``x = t·n + (1−t)·x0``."""
    for i in range(len(sigmas) - 1):
        x0 = denoise(x, sigmas[i])
        x = x0
        if float(sigmas[i + 1]) > 0:
            t = sigmas[i + 1]
            x = t * _noise(rng, i, x) + (1.0 - t) * x0
        x = apply_callback(callback, i, x)
    return x


def sample_heun(denoise, x, sigmas, callback=None):
    """Heun's 2nd-order method (two model calls per step except the last)."""
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        d = (x - x0) / s
        x_pred = x + d * (s_next - s)
        if float(s_next) == 0.0:
            x = x_pred
        else:
            x0_2 = denoise(x_pred, s_next)
            d2 = (x_pred - x0_2) / s_next
            x = x + 0.5 * (d + d2) * (s_next - s)
        x = apply_callback(callback, i, x)
    return x


def sample_dpm_2(denoise, x, sigmas, callback=None):
    """DPM2: explicit midpoint, the second call at the geometric mean of the
    step's sigmas."""
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        d = (x - x0) / s
        if float(s_next) == 0.0:
            x = x + d * (s_next - s)
        else:
            sigma_mid = torch.exp(0.5 * (torch.log(s) + torch.log(s_next)))
            x_2 = x + d * (sigma_mid - s)
            x0_2 = denoise(x_2, sigma_mid)
            d_2 = (x_2 - x0_2) / sigma_mid
            x = x + d_2 * (s_next - s)
        x = apply_callback(callback, i, x)
    return x


def sample_dpm_2_ancestral(denoise, x, sigmas, rng, eta: float = 1.0, callback=None):
    """DPM2 ancestral: the midpoint step runs to sigma_down, then sigma_up of fresh
    noise."""
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        sigma_down, sigma_up = ancestral_steps(s, s_next, eta)
        d = (x - x0) / s
        if float(sigma_down) == 0.0:
            x = x + d * (sigma_down - s)
        else:
            sigma_mid = torch.exp(0.5 * (torch.log(s) + torch.log(sigma_down)))
            x_2 = x + d * (sigma_mid - s)
            x0_2 = denoise(x_2, sigma_mid)
            d_2 = (x_2 - x0_2) / sigma_mid
            x = x + d_2 * (sigma_down - s)
        if float(s_next) > 0:
            x = x + sigma_up * _noise(rng, i, x)
        x = apply_callback(callback, i, x)
    return x


def sample_dpmpp_2s_ancestral(denoise, x, sigmas, rng, eta: float = 1.0, callback=None):
    """DPM-Solver++ (2S) ancestral: single-step 2nd order, midpoint at r = 1/2 in
    log-sigma time, ancestral noise on every non-final step."""
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        sigma_down, sigma_up = ancestral_steps(s, s_next, eta)
        if float(sigma_down) == 0.0:
            d = (x - x0) / s
            x = x + d * (sigma_down - s)
        else:
            t, t_next = -torch.log(s), -torch.log(sigma_down)
            h = t_next - t
            sigma_mid = torch.exp(-(t + 0.5 * h))
            x_2 = (sigma_mid / s) * x - torch.expm1(-0.5 * h) * x0
            x0_2 = denoise(x_2, sigma_mid)
            x = (sigma_down / s) * x - torch.expm1(-h) * x0_2
        if float(s_next) > 0:
            x = x + sigma_up * _noise(rng, i, x)
        x = apply_callback(callback, i, x)
    return x


def sample_dpmpp_sde(denoise, x, sigmas, rng, eta: float = 1.0, callback=None):
    """DPM-Solver++ SDE (r = 1/2): two model calls and two noise draws per step
    (``step_noise`` parts 0 and 1)."""
    r = 0.5
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        if float(s_next) == 0.0:
            d = (x - x0) / s
            x = x + d * (s_next - s)
        else:
            t, t_next = -torch.log(s), -torch.log(s_next)
            h = t_next - t
            sigma_mid = torch.exp(-(t + r * h))
            fac = 1.0 / (2.0 * r)
            sd1, su1 = ancestral_steps(s, sigma_mid, eta)
            t_down1 = -torch.log(torch.clamp(sd1, min=1e-10))
            x_2 = (sd1 / s) * x - torch.expm1(t - t_down1) * x0
            x_2 = x_2 + su1 * _noise(rng, i, x, part=0)
            x0_2 = denoise(x_2, sigma_mid)
            sd2, su2 = ancestral_steps(s, s_next, eta)
            t_down2 = -torch.log(torch.clamp(sd2, min=1e-10))
            x0_blend = (1.0 - fac) * x0 + fac * x0_2
            x = (sd2 / s) * x - torch.expm1(t - t_down2) * x0_blend
            x = x + su2 * _noise(rng, i, x, part=1)
        x = apply_callback(callback, i, x)
    return x


def sample_dpmpp_2m(denoise, x, sigmas, callback=None):
    """DPM-Solver++ (2M): multistep 2nd order, one model call per step."""
    old_x0 = None
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        t, t_next = -torch.log(s), -torch.log(torch.clamp(s_next, min=1e-10))
        h = t_next - t
        if old_x0 is None or float(s_next) == 0.0:
            x = (s_next / s) * x - torch.expm1(-h) * x0
        else:
            h_last = t - (-torch.log(sigmas[i - 1]))
            r = h_last / h
            x0_prime = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * old_x0
            x = (s_next / s) * x - torch.expm1(-h) * x0_prime
        old_x0 = x0
        x = apply_callback(callback, i, x)
    return x


def sample_dpmpp_2m_sde(denoise, x, sigmas, rng, eta: float = 1.0, callback=None):
    """DPM-Solver++ (2M) SDE with the midpoint solver: one model call per step,
    per-step noise scaled by the SDE's decay."""
    old_x0 = None
    h_last = None
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        if float(s_next) == 0.0:
            x = x0
        else:
            t, t_next = -torch.log(s), -torch.log(s_next)
            h = t_next - t
            eta_h = eta * h
            x = (s_next / s) * torch.exp(-eta_h) * x + (-torch.expm1(-h - eta_h)) * x0
            if old_x0 is not None:
                r = h_last / h
                x = x + 0.5 * (-torch.expm1(-h - eta_h)) * (1 / r) * (x0 - old_x0)
            if eta > 0:
                x = x + s_next * torch.sqrt(
                    torch.clamp(-torch.expm1(-2 * eta_h), min=0.0)) * _noise(rng, i, x)
            h_last = h
        old_x0 = x0
        x = apply_callback(callback, i, x)
    return x


def sample_dpmpp_3m_sde(denoise, x, sigmas, rng, eta: float = 1.0, callback=None):
    """DPM-Solver++ (3M) SDE: third-order multistep in exponential-integrator form,
    the two previous x0 estimates building the corrections, per-step noise."""
    x0_1 = x0_2 = None
    h_1 = h_2 = None
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        if float(s_next) == 0.0:
            # No history update on a zero step.
            x = apply_callback(callback, i, x0)
            continue
        t, t_next = -torch.log(s), -torch.log(s_next)
        h = t_next - t
        h_eta = h * (eta + 1.0)
        x = torch.exp(-h_eta) * x + (-torch.expm1(-h_eta)) * x0
        if h_2 is not None:
            r0, r1 = h_1 / h, h_2 / h
            d1_0 = (x0 - x0_1) / r0
            d1_1 = (x0_1 - x0_2) / r1
            d1 = d1_0 + (d1_0 - d1_1) * r0 / (r0 + r1)
            d2 = (d1_0 - d1_1) / (r0 + r1)
            phi_2 = torch.expm1(-h_eta) / h_eta + 1.0
            phi_3 = phi_2 / h_eta - 0.5
            x = x + phi_2 * d1 - phi_3 * d2
        elif h_1 is not None:
            r = h_1 / h
            d = (x0 - x0_1) / r
            phi_2 = torch.expm1(-h_eta) / h_eta + 1.0
            x = x + phi_2 * d
        if eta > 0:
            x = x + s_next * torch.sqrt(
                torch.clamp(-torch.expm1(-2.0 * eta * h), min=0.0)) * _noise(rng, i, x)
        x0_1, x0_2 = x0, x0_1
        h_1, h_2 = h, h_1
        x = apply_callback(callback, i, x)
    return x


def lms_coefficient_matrix(sigmas, order: int = 4) -> np.ndarray:
    """Adams-Bashforth coefficients for LMS over a concrete sigma schedule:
    ``C[i, j]`` weights the j-steps-back derivative at step i (f64, zero past the
    running order ``min(i+1, order)``)."""
    from numpy.polynomial.legendre import leggauss

    sig = np.asarray(sigmas, np.float64)
    nodes, weights = leggauss(16)

    def lms_coeff(order_, i, j):
        # Integral over [sigma_i, sigma_i+1] of the Lagrange basis polynomial.
        def poly(tau):
            prod = 1.0
            for k in range(order_):
                if k == j:
                    continue
                prod *= (tau - sig[i - k]) / (sig[i - j] - sig[i - k])
            return prod

        a, b = sig[i], sig[i + 1]
        tau = 0.5 * (b - a) * nodes + 0.5 * (b + a)
        return float(0.5 * (b - a) * np.sum(weights * np.vectorize(poly)(tau)))

    n = len(sig) - 1
    C = np.zeros((n, order), np.float64)
    for i in range(n):
        cur = min(i + 1, order)
        for j in range(cur):
            C[i, j] = lms_coeff(cur, i, j)
    return C


def sample_lms(denoise, x, sigmas, order: int = 4, callback=None):
    """Linear multistep (Adams-Bashforth over the sigma schedule)."""
    C = lms_coefficient_matrix(sigmas, order)
    ds = []
    for i in range(len(sigmas) - 1):
        x0 = denoise(x, sigmas[i])
        ds.append((x - x0) / sigmas[i])
        if len(ds) > order:
            ds.pop(0)
        cur = min(i + 1, order)
        x = x + sum(float(C[i, j]) * d_ for j, d_ in zip(range(cur), reversed(ds)))
        x = apply_callback(callback, i, x)
    return x


def sample_lcm(denoise, x, sigmas, rng, callback=None):
    """Latent Consistency Model sampling: take the x0 prediction and re-noise it to
    the next sigma with fresh noise."""
    for i in range(len(sigmas) - 1):
        x0 = denoise(x, sigmas[i])
        x = x0
        if float(sigmas[i + 1]) > 0:
            x = x + sigmas[i + 1] * _noise(rng, i, x)
        x = apply_callback(callback, i, x)
    return x


def sample_ddpm(denoise, x, sigmas, rng, callback=None):
    """Ancestral DDPM in sigma space: the exact DDPM posterior mean in ᾱ-space with
    posterior-variance noise on every non-final step."""
    for i in range(len(sigmas) - 1):
        s, s_next = sigmas[i], sigmas[i + 1]
        x0 = denoise(x, s)
        eps = (x - x0) / s
        acp = 1.0 / (s**2 + 1.0)
        acp_prev = 1.0 / (s_next**2 + 1.0)
        alpha = acp / acp_prev
        x_a = x / torch.sqrt(1.0 + s**2)
        mu = torch.sqrt(1.0 / alpha) * (x_a - (1.0 - alpha) * eps / torch.sqrt(1.0 - acp))
        if float(s_next) > 0:
            var = (1.0 - alpha) * (1.0 - acp_prev) / (1.0 - acp)
            mu = mu + torch.sqrt(var) * _noise(rng, i, x)
            x = mu * torch.sqrt(1.0 + s_next**2)
        else:
            x = mu
        x = apply_callback(callback, i, x)
    return x


def unipc_coeff_table(sigmas, order: int = 3, variant: str = "bh1") -> np.ndarray:
    """Per-step UniPC quantities (f64), row i ``[h_phi_1, B_h, rp0, rp1, rc0, rc1,
    rc_t, rki0, rki1]`` for the step σ_i→σ_{i+1} at running order
    p = min(order, i+1, n-i); unused slots are zero."""
    sig = np.asarray(sigmas, np.float64)
    lam = -np.log(np.maximum(sig, 1e-10))
    n = len(sig) - 1
    table = np.zeros((n, 9))
    for i in range(n):
        p = max(1, min(order, i + 1, n - i))
        h = lam[i + 1] - lam[i]
        hh = -h
        h_phi_1 = np.expm1(hh)
        B_h = hh if variant == "bh1" else np.expm1(hh)
        rks, rkinv = [], []
        for j in range(1, p):
            rk = (lam[i - j] - lam[i]) / h
            rks.append(rk)
            rkinv.append(1.0 / rk)
        rks.append(1.0)
        R = np.array([[rk**k for rk in rks] for k in range(p)])
        b = np.zeros(p)
        fact = 1.0
        h_phi_k = h_phi_1 / hh - 1.0
        for k in range(1, p + 1):
            b[k - 1] = h_phi_k * fact / B_h
            fact *= k + 1
            h_phi_k = h_phi_k / hh - 1.0 / fact
        # The official UniPC hardcodes the order-2 predictor to 0.5.
        if p == 1:
            rhos_p = np.zeros(0)
        elif p == 2:
            rhos_p = np.array([0.5])
        else:
            rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
        rhos_c = np.linalg.solve(R, b) if p > 1 else np.array([0.5])
        row = table[i]
        row[0], row[1] = h_phi_1, B_h
        row[2 : 2 + len(rhos_p)] = rhos_p
        row[4 : 4 + len(rhos_c) - 1] = rhos_c[:-1]
        row[6] = rhos_c[-1]
        row[7 : 7 + len(rkinv)] = rkinv
    return table


def _sample_unipc(denoise, x, sigmas, callback=None, variant="bh1", order=3):
    """UniPC multistep predictor-corrector (data-prediction form), one model call
    per step; the final (σ→0) step returns m0."""
    C = unipc_coeff_table(sigmas, order, variant)
    n = len(sigmas) - 1
    hist = [denoise(x, sigmas[0])]
    for i in range(n):
        s, s_next = sigmas[i], sigmas[i + 1]
        m0 = hist[-1]
        if float(s_next) == 0.0:
            x = apply_callback(callback, i, m0)
            continue
        hphi1, Bh, rp0, rp1, rc0, rc1, rct, rki0, rki1 = (float(v) for v in C[i])
        D1_1 = (hist[-2] - m0) * rki0 if len(hist) >= 2 else 0.0
        D1_2 = (hist[-3] - m0) * rki1 if len(hist) >= 3 else 0.0
        base = (s_next / s) * x - hphi1 * m0
        x_pred = base - Bh * (rp0 * D1_1 + rp1 * D1_2)
        m_t = denoise(x_pred, s_next)
        x = base - Bh * (rc0 * D1_1 + rc1 * D1_2 + rct * (m_t - m0))
        hist.append(m_t)
        if len(hist) > order:
            hist.pop(0)
        x = apply_callback(callback, i, x)
    return x


def sample_uni_pc(denoise, x, sigmas, callback=None):
    """UniPC, bh1 variant."""
    return _sample_unipc(denoise, x, sigmas, callback, variant="bh1")


def sample_uni_pc_bh2(denoise, x, sigmas, callback=None):
    """UniPC, bh2 variant."""
    return _sample_unipc(denoise, x, sigmas, callback, variant="bh2")


SAMPLERS = {
    "euler": sample_euler,
    "euler_ancestral": sample_euler_ancestral,
    "heun": sample_heun,
    "dpm_2": sample_dpm_2,
    "dpm_2_ancestral": sample_dpm_2_ancestral,
    "lms": sample_lms,
    "dpmpp_2s_ancestral": sample_dpmpp_2s_ancestral,
    "dpmpp_sde": sample_dpmpp_sde,
    "dpmpp_2m": sample_dpmpp_2m,
    "dpmpp_2m_sde": sample_dpmpp_2m_sde,
    "dpmpp_3m_sde": sample_dpmpp_3m_sde,
    "lcm": sample_lcm,
    "ddpm": sample_ddpm,
    "uni_pc": sample_uni_pc,
    "uni_pc_bh2": sample_uni_pc_bh2,
}
# The stochastic samplers take a generator after the schedule.
RNG_SAMPLERS = frozenset(
    {"euler_ancestral", "dpm_2_ancestral", "dpmpp_2s_ancestral", "dpmpp_sde",
     "dpmpp_2m_sde", "dpmpp_3m_sde", "lcm", "ddpm"}
)
# prediction="flow": samplers with a rectified-flow form swap it in; ddpm's alpha-bar
# posterior has no flow meaning and is refused; the rest run their generic form.
FLOW_VARIANTS = {
    "euler_ancestral": sample_euler_ancestral_rf,
    "dpmpp_2s_ancestral": sample_dpmpp_2s_ancestral_rf,
    "lcm": sample_lcm_rf,
}
FLOW_REJECT = frozenset({"ddpm"})
