"""Per-lane step plans: every k-sampler as a stateful lane (counterpart of
``comfyui_parallelanything_tpu/sampling/lane_specs.py``; numpy only, its own copy).

The serving layer's dispatch unit is ONE batched model eval (the only thing that
costs FLOPs); everything a sampler does *around* that eval is elementwise latent
math with schedule-derived scalar weights. This module factors each k-sampler's
step into exactly that shape, so lanes running DIFFERENT samplers share one
batched step (``sampling/compiled.lane_step_program``):

- **Lane state** is the fixed tuple ``(x, xe, h1, h2)``: the current latent, the
  next model-eval input (mid-step for two-eval samplers, else ``x``), and two
  history slots (dpmpp_2m's ``old_x0`` and the like).
- **A StepPlan** is one model eval plus a linear update: evaluate the model at
  ``(xe, sigma_eval)`` for the denoised estimate ``x0``, then each state slot
  becomes a per-lane-scalar-weighted combination of the basis
  ``(x, xe, x0, h1, h2, noise)``. The weights depend only on the host-known
  schedule, step index and phase, so they are computed here in float64 and
  shipped as a ``[4, 6]`` matrix per lane per dispatch. Second-order samplers
  (heun, dpm_2, ...) emit TWO plans per σ-interval.
- **Stochastic samplers** name their draw: ``noise`` is ``"step"`` (the step's
  ``k_samplers.step_noise`` draw, part 0) or dpmpp_sde's ``"sde_mid"`` /
  ``"sde_end"`` (parts 0 and 1). A draw is a function of (request generator,
  step, part) only, the discipline of the eager loops and the captured loop, so a
  lane's output does not depend on what else shares its dispatch.

The plans equal the JAX package's exactly (``tests/test_torch_lane_specs.py``).
``LANE_SPECS`` is the registry ``serving.scheduler.BATCHABLE_SAMPLERS`` comes
from. Excluded by design: ``lms``/``uni_pc*`` (order-4 latent history and a
predictor-corrector eval at the next sigma: another dispatch shape), and ``ddpm``
on flow schedules (``k_samplers.FLOW_REJECT``). Each plan compiler transcribes its
eager twin in ``k_samplers.py`` op for op, the sigma-dependent scalars lifted to
the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

__all__ = [
    "LANE_SPECS",
    "LaneStepSpec",
    "StepPlan",
    "lane_eval_count",
    "plan_schedule",
]

# Basis indices for StepPlan.coef columns: current latent, eval input, fresh
# model estimate, history slots, per-step noise draw.
X, XE, E, H1, H2, N = range(6)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One model eval + linear state update for one lane.

    ``coef[j]`` weights the basis ``(x, xe, x0, h1, h2, noise)`` into the new
    ``(x, xe, h1, h2)[j]``. ``noise`` selects the basis noise draw: None (no
    draw consumed), ``"step"`` (``step_noise(rng, step)``), or
    ``"sde_mid"``/``"sde_end"`` (parts 0 and 1 of the step, the two draws
    dpmpp_sde consumes per interval). ``completes`` marks the eval that
    finishes the σ-interval (the lane's step index advances; progress fires)."""

    sigma_eval: float
    coef: np.ndarray  # [4, 6] float32
    completes: bool = True
    noise: str | None = None
    step: int = 0


def _vec(x=0.0, xe=0.0, e=0.0, h1=0.0, h2=0.0, n=0.0) -> np.ndarray:
    return np.array([x, xe, e, h1, h2, n], np.float64)


_KEEP_H1 = _vec(h1=1.0)
_KEEP_H2 = _vec(h2=1.0)


def _mk(sigma_eval, x_row, *, xe_row=None, h1_row=None, h2_row=None,
        completes=True, noise=None, step=0) -> StepPlan:
    """Assemble a plan; ``xe`` follows the new ``x`` unless overridden (a
    completed step's next eval input IS its output latent), history slots
    default to carry-through."""
    coef = np.stack([
        x_row,
        xe_row if xe_row is not None else x_row,
        h1_row if h1_row is not None else _KEEP_H1,
        h2_row if h2_row is not None else _KEEP_H2,
    ]).astype(np.float32)
    return StepPlan(float(sigma_eval), coef, completes, noise, step)


def _ancestral(s: float, s_next: float, eta: float = 1.0):
    """Float64 twin of k_samplers.ancestral_steps."""
    su = min(
        s_next,
        eta * math.sqrt(max(s_next**2 * (s**2 - s_next**2) / s**2, 0.0)),
    )
    sd = math.sqrt(max(s_next**2 - su**2, 0.0))
    return sd, su


# ---------------------------------------------------------------------------
# plan compilers — one per sampler; (sigmas float64, prediction) -> [StepPlan].
# Each transcribes its eager twin's branch structure; eta is the eager default
# (1.0) because run_sampler never overrides it.
# ---------------------------------------------------------------------------


def _plans_euler(sig, prediction):
    out = []
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        r = (sn - s) / s
        out.append(_mk(s, _vec(x=1.0 + r, e=-r), step=i))
    return out


def _plans_euler_ancestral(sig, prediction, eta=1.0):
    out = []
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        if prediction == "flow":
            # sample_euler_ancestral_rf: interpolant alpha-ratio renoise.
            if sn == 0.0:
                out.append(_mk(s, _vec(e=1.0), step=i))
                continue
            sd = sn * (1.0 + (sn / s - 1.0) * eta)
            a1, ad = 1.0 - sn, 1.0 - sd
            renoise = math.sqrt(max(sn**2 - sd**2 * a1**2 / ad**2, 0.0))
            g, ratio = a1 / ad, sd / s
            out.append(_mk(
                s, _vec(x=g * ratio, e=g * (1.0 - ratio), n=renoise),
                noise="step", step=i,
            ))
            continue
        sd, su = _ancestral(s, sn, eta)
        r = (sd - s) / s
        out.append(_mk(
            s, _vec(x=1.0 + r, e=-r, n=su if sn > 0 else 0.0),
            noise="step" if sn > 0 else None, step=i,
        ))
    return out


def _plans_heun(sig, prediction):
    out = []
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        if sn == 0.0:
            # Final step is plain Euler to σ=0, which collapses to x0.
            out.append(_mk(s, _vec(e=1.0), step=i))
            continue
        r = (sn - s) / s
        out.append(_mk(
            s, _vec(x=1.0),
            xe_row=_vec(x=1.0 + r, e=-r),          # x_pred
            h1_row=_vec(x=1.0 / s, e=-1.0 / s),    # stash d
            completes=False, step=i,
        ))
        half = 0.5 * (sn - s)
        out.append(_mk(
            sn, _vec(x=1.0, h1=half, xe=half / sn, e=-half / sn), step=i,
        ))
    return out


def _plans_dpm_2(sig, prediction):
    out = []
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        if sn == 0.0:
            out.append(_mk(s, _vec(e=1.0), step=i))
            continue
        smid = math.exp(0.5 * (math.log(s) + math.log(sn)))
        rm = (smid - s) / s
        out.append(_mk(s, _vec(x=1.0), xe_row=_vec(x=1.0 + rm, e=-rm),
                       completes=False, step=i))
        d = sn - s
        out.append(_mk(smid, _vec(x=1.0, xe=d / smid, e=-d / smid), step=i))
    return out


def _plans_dpm_2_ancestral(sig, prediction, eta=1.0):
    out = []
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        sd, su = _ancestral(s, sn, eta)
        nz = "step" if sn > 0 else None
        if sd == 0.0:
            r = (sd - s) / s
            out.append(_mk(s, _vec(x=1.0 + r, e=-r, n=su if sn > 0 else 0.0),
                           noise=nz, step=i))
            continue
        smid = math.exp(0.5 * (math.log(s) + math.log(sd)))
        rm = (smid - s) / s
        out.append(_mk(s, _vec(x=1.0), xe_row=_vec(x=1.0 + rm, e=-rm),
                       completes=False, step=i))
        d = sd - s
        out.append(_mk(smid,
                       _vec(x=1.0, xe=d / smid, e=-d / smid,
                            n=su if sn > 0 else 0.0),
                       noise=nz, step=i))
    return out


def _plans_dpmpp_2s_ancestral(sig, prediction, eta=1.0):
    out = []
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        if prediction == "flow":
            # sample_dpmpp_2s_ancestral_rf: flow log-SNR midpoint + RF renoise.
            sd = sn * (1.0 + (sn / s - 1.0) * eta)
            if sn == 0.0:
                r = (sd - s) / s
                out.append(_mk(s, _vec(x=1.0 + r, e=-r), step=i))
                continue
            a1, ad = 1.0 - sn, 1.0 - sd
            renoise = math.sqrt(max(sn**2 - sd**2 * a1**2 / ad**2, 0.0))
            if s >= 1.0:
                smid = 0.9999  # λ diverges at σ=1 (host pin)
            else:
                t_i = math.log((1.0 - s) / s)
                t_dn = math.log((1.0 - sd) / sd)
                smid = 1.0 / (math.exp(t_i + 0.5 * (t_dn - t_i)) + 1.0)
            g = a1 / ad
            out.append(_mk(s, _vec(x=1.0),
                           xe_row=_vec(x=smid / s, e=1.0 - smid / s),
                           completes=False, step=i))
            out.append(_mk(smid,
                           _vec(x=g * (sd / s), e=g * (1.0 - sd / s),
                                n=renoise),
                           noise="step", step=i))
            continue
        sd, su = _ancestral(s, sn, eta)
        nz = "step" if sn > 0 else None
        if sd == 0.0:
            r = (sd - s) / s
            out.append(_mk(s, _vec(x=1.0 + r, e=-r, n=su if sn > 0 else 0.0),
                           noise=nz, step=i))
            continue
        t, tn = -math.log(s), -math.log(sd)
        h = tn - t
        smid = math.exp(-(t + 0.5 * h))
        out.append(_mk(s, _vec(x=1.0),
                       xe_row=_vec(x=smid / s, e=-math.expm1(-0.5 * h)),
                       completes=False, step=i))
        out.append(_mk(smid,
                       _vec(x=sd / s, e=-math.expm1(-h),
                            n=su if sn > 0 else 0.0),
                       noise=nz, step=i))
    return out


def _plans_dpmpp_sde(sig, prediction, eta=1.0, r=0.5):
    out = []
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        if sn == 0.0:
            rr = (sn - s) / s
            out.append(_mk(s, _vec(x=1.0 + rr, e=-rr), step=i))
            continue
        t, tn = -math.log(s), -math.log(sn)
        h = tn - t
        smid = math.exp(-(t + r * h))
        fac = 1.0 / (2.0 * r)
        sd1, su1 = _ancestral(s, smid, eta)
        td1 = -math.log(max(sd1, 1e-10))
        out.append(_mk(
            s, _vec(x=1.0),
            xe_row=_vec(x=sd1 / s, e=-math.expm1(t - td1), n=su1),
            h1_row=_vec(e=1.0),  # stash x0 for the end-step blend
            completes=False, noise="sde_mid", step=i,
        ))
        sd2, su2 = _ancestral(s, sn, eta)
        td2 = -math.log(max(sd2, 1e-10))
        c = -math.expm1(t - td2)
        out.append(_mk(
            smid, _vec(x=sd2 / s, h1=c * (1.0 - fac), e=c * fac, n=su2),
            noise="sde_end", step=i,
        ))
    return out


def _plans_dpmpp_2m(sig, prediction):
    out = []
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        t, tn = -math.log(s), -math.log(max(sn, 1e-10))
        h = tn - t
        em = -math.expm1(-h)
        if i == 0 or sn == 0.0:
            out.append(_mk(s, _vec(x=sn / s, e=em), h1_row=_vec(e=1.0),
                           step=i))
            continue
        h_last = t - (-math.log(sig[i - 1]))
        rr = h_last / h
        out.append(_mk(
            s,
            _vec(x=sn / s, e=em * (1.0 + 1.0 / (2.0 * rr)),
                 h1=-em / (2.0 * rr)),
            h1_row=_vec(e=1.0), step=i,
        ))
    return out


def _plans_dpmpp_2m_sde(sig, prediction, eta=1.0):
    out = []
    h_last, have = 1.0, False
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        if sn == 0.0:
            # Eager final step: x = x0; old_x0 still updated, h_last untouched.
            out.append(_mk(s, _vec(e=1.0), h1_row=_vec(e=1.0), step=i))
            continue
        t, tn = -math.log(s), -math.log(sn)
        h = tn - t
        eta_h = eta * h
        ce = -math.expm1(-h - eta_h)
        row = _vec(x=(sn / s) * math.exp(-eta_h), e=ce)
        if have:
            corr = 0.5 * ce * (h / h_last)
            row = row + _vec(e=corr, h1=-corr)
        if eta > 0:
            row = row + _vec(
                n=sn * math.sqrt(max(-math.expm1(-2.0 * eta_h), 0.0))
            )
        out.append(_mk(s, row, h1_row=_vec(e=1.0),
                       noise="step" if eta > 0 else None, step=i))
        h_last, have = h, True
    return out


def _plans_dpmpp_3m_sde(sig, prediction, eta=1.0):
    out = []
    h_1 = h_2 = None
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        if sn == 0.0:
            # Eager: `x = x0; continue` — NO history update on a zero step.
            out.append(_mk(s, _vec(e=1.0), step=i))
            continue
        t, tn = -math.log(s), -math.log(sn)
        h = tn - t
        h_eta = h * (eta + 1.0)
        row = _vec(x=math.exp(-h_eta), e=-math.expm1(-h_eta))
        if h_2 is not None:
            r0, r1 = h_1 / h, h_2 / h
            phi_2 = math.expm1(-h_eta) / h_eta + 1.0
            phi_3 = phi_2 / h_eta - 0.5
            v10 = _vec(e=1.0 / r0, h1=-1.0 / r0)       # d1_0
            v11 = _vec(h1=1.0 / r1, h2=-1.0 / r1)      # d1_1
            d1 = v10 + (v10 - v11) * (r0 / (r0 + r1))
            d2 = (v10 - v11) / (r0 + r1)
            row = row + phi_2 * d1 - phi_3 * d2
        elif h_1 is not None:
            rr = h_1 / h
            phi_2 = math.expm1(-h_eta) / h_eta + 1.0
            row = row + phi_2 * _vec(e=1.0 / rr, h1=-1.0 / rr)
        if eta > 0:
            row = row + _vec(
                n=sn * math.sqrt(max(-math.expm1(-2.0 * eta * h), 0.0))
            )
        out.append(_mk(s, row, h1_row=_vec(e=1.0), h2_row=_vec(h1=1.0),
                       noise="step" if eta > 0 else None, step=i))
        h_1, h_2 = h, h_1
    return out


def _plans_lcm(sig, prediction):
    out = []
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        if sn <= 0.0:
            out.append(_mk(s, _vec(e=1.0), step=i))
        elif prediction == "flow":
            # sample_lcm_rf: flow-interpolant renoise t·n + (1−t)·x0.
            out.append(_mk(s, _vec(e=1.0 - sn, n=sn), noise="step", step=i))
        else:
            out.append(_mk(s, _vec(e=1.0, n=sn), noise="step", step=i))
    return out


def _plans_ddpm(sig, prediction):
    out = []
    for i in range(len(sig) - 1):
        s, sn = sig[i], sig[i + 1]
        acp = 1.0 / (s * s + 1.0)
        acp_prev = 1.0 / (sn * sn + 1.0)
        alpha = acp / acp_prev
        ia = math.sqrt(1.0 / alpha)
        k_eps = (1.0 - alpha) / (s * math.sqrt(1.0 - acp))
        cx = ia * (1.0 / math.sqrt(1.0 + s * s) - k_eps)
        ce = ia * k_eps
        if sn > 0:
            var = (1.0 - alpha) * (1.0 - acp_prev) / (1.0 - acp)
            sc = math.sqrt(1.0 + sn * sn)
            out.append(_mk(s, _vec(x=cx * sc, e=ce * sc,
                                   n=math.sqrt(max(var, 0.0)) * sc),
                           noise="step", step=i))
        else:
            out.append(_mk(s, _vec(x=cx, e=ce), step=i))
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LaneStepSpec:
    """One sampler's lane behavior: the plan compiler plus the routing facts
    the scheduler needs (does it consume rng? does dpmpp_sde's two-draw step
    need two parts a step? is there a rectified-flow form?)."""

    name: str
    compile_plans: Callable[[np.ndarray, str], list]
    needs_rng: bool = False
    split_keys: bool = False
    flow_ok: bool = True


LANE_SPECS: dict[str, LaneStepSpec] = {
    spec.name: spec
    for spec in (
        LaneStepSpec("euler", _plans_euler),
        LaneStepSpec("euler_ancestral", _plans_euler_ancestral,
                     needs_rng=True),
        LaneStepSpec("heun", _plans_heun),
        LaneStepSpec("dpm_2", _plans_dpm_2),
        LaneStepSpec("dpm_2_ancestral", _plans_dpm_2_ancestral,
                     needs_rng=True),
        LaneStepSpec("dpmpp_2s_ancestral", _plans_dpmpp_2s_ancestral,
                     needs_rng=True),
        LaneStepSpec("dpmpp_sde", _plans_dpmpp_sde, needs_rng=True,
                     split_keys=True),
        LaneStepSpec("dpmpp_2m", _plans_dpmpp_2m),
        LaneStepSpec("dpmpp_2m_sde", _plans_dpmpp_2m_sde, needs_rng=True),
        LaneStepSpec("dpmpp_3m_sde", _plans_dpmpp_3m_sde, needs_rng=True),
        LaneStepSpec("lcm", _plans_lcm, needs_rng=True),
        # ddpm's alpha-bar posterior has no flow form (k_samplers.FLOW_REJECT).
        LaneStepSpec("ddpm", _plans_ddpm, needs_rng=True, flow_ok=False),
    )
}


def plan_schedule(sampler: str, sigmas, prediction: str) -> list[StepPlan]:
    """The full eval-ordered plan list for one request's schedule."""
    sig = np.asarray(sigmas, np.float64)
    return LANE_SPECS[sampler].compile_plans(sig, prediction)


def lane_eval_count(sampler: str, sigmas, prediction: str = "eps") -> int:
    """Model evals this lane consumes for the schedule: a mixed batch completes
    in max(lane_eval_count) shared dispatches, not the sum."""
    return len(plan_schedule(sampler, sigmas, prediction))
