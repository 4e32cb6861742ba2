"""Samplers (counterpart of ``mode_diffusion_policy_tpu/models/edm/samplers.py``).

Every name of the JAX dispatch table, with the JAX package's design:

- The sigma schedule is static host numpy; every per-step scalar
  (sigma_hat, ancestral sigma_down/up, DPM++ log-ratios, LMS quadrature
  coefficients) is computed host-side in float64 numpy by the same helpers
  and cast to float32 where the JAX sampler casts it, so each update rounds
  as the JAX one does. The JAX ``lax.scan`` loops are Python loops here.
- The denoiser callback has the JAX signature ``denoiser(x, sigma_vec,
  step_idx)``: ``step_idx`` is the scheduled-step index (>= 0) on the
  schedule, so that an agent can use its per-sigma routing tables, and -1
  off it (midpoints, churned sigmas, the DPM-Solver fast/adaptive times),
  where the model routes inline. The step index decides the model's path,
  so every sampler passes exactly the JAX sampler's indices.
- The final steps with sigma_next == 0 are split out statically, as in JAX.
- Stochastic samplers draw every Gaussian through one noise function
  ``noise(x) -> tensor like x``: by default ``torch.randn`` from an explicit
  ``torch.Generator`` (seeded 0 when none is given, as JAX's default key is
  ``PRNGKey(0)``). A caller may pass its own, e.g. one that replays another
  framework's draws, so that two implementations see the same noise.
- The BrownianTree noise of ``dpmpp_sde`` is i.i.d. Gaussian increments, the
  JAX package's documented deviation.

``log_likelihood`` integrates the probability-flow ODE with a Hutchinson
divergence, as the JAX function does: the JVP through the denoiser is
exact forward mode (``torch.func.jvp``), and the integrator ``odeint`` is
the adaptive Dormand-Prince method of ``jax.experimental.ode.odeint``,
written out step for step. No CUDA kernel has a derivative, so it runs on
the plain path (the ``reference`` serving preset); a kernel wrapper reached
under the JVP raises (``ops/kernels/_common.no_autodiff``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

f32 = np.float32


# ---------------------------------------------------------------------------
# Host-side helpers (float64 numpy on static schedules), as in JAX
# ---------------------------------------------------------------------------

def _ancestral_steps(sigmas: np.ndarray, eta: float = 1.0):
    """sigma_down/sigma_up per step (gc_sampling.py:102-109)."""
    s_from = sigmas[:-1].astype(np.float64)
    s_to = sigmas[1:].astype(np.float64)
    if not eta:
        return s_to.astype(f32), np.zeros_like(s_to, dtype=f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        su = np.minimum(s_to, eta * np.sqrt(s_to ** 2 * (s_from ** 2 - s_to ** 2)
                                            / s_from ** 2))
    su = np.nan_to_num(su, nan=0.0)
    sd = np.sqrt(np.maximum(s_to ** 2 - su ** 2, 0.0))
    return sd.astype(f32), su.astype(f32)


def _churn_gammas(sigmas: np.ndarray, s_churn: float, s_tmin: float,
                  s_tmax: float):
    n = len(sigmas) - 1
    gammas = np.zeros(n, dtype=np.float64)
    for i in range(n):
        if s_tmin <= sigmas[i] <= s_tmax:
            gammas[i] = min(s_churn / n, 2 ** 0.5 - 1)
    sigma_hat = sigmas[:-1] * (gammas + 1)
    noise_scale = np.sqrt(np.maximum(sigma_hat ** 2 - sigmas[:-1] ** 2, 0.0))
    return sigma_hat.astype(f32), noise_scale.astype(f32)


def _lms_coeffs(sigmas: np.ndarray, order: int) -> np.ndarray:
    """Quadrature coefficients of the linear multistep method
    (gc_sampling.py:413-426), integrated host-side with scipy."""
    from scipy import integrate

    t = sigmas.astype(np.float64)
    n = len(sigmas) - 1
    coeffs = np.zeros((n, order), dtype=np.float64)

    def coeff(cur_order, i, j):
        def fn(tau):
            prod = 1.0
            for k in range(cur_order):
                if j == k:
                    continue
                prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
            return prod
        return integrate.quad(fn, t[i], t[i + 1], epsrel=1e-4)[0]

    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            coeffs[i, j] = coeff(cur_order, i, j)
    return coeffs.astype(f32)


def _s_in(x: torch.Tensor, sigma) -> torch.Tensor:
    return torch.full((x.shape[0],), float(f32(sigma)), dtype=torch.float32,
                      device=x.device)


def _generator_noise(generator: Optional[torch.Generator] = None,
                     device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The default noise function: standard normals like ``x`` from
    ``generator`` (a new one seeded 0 on ``device`` when None)."""
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)

    def noise(x):
        return torch.randn(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype)
    return noise


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def sample_euler(denoiser, x, sigmas, noise, *, s_churn=0.0, s_tmin=0.0,
                 s_tmax=float("inf"), s_noise=1.0, **_):
    """Karras Algorithm 2 Euler variant (gc_sampling.py:164-210)."""
    sigmas = np.asarray(sigmas)
    sigma_hat, noise_scale = _churn_gammas(sigmas, s_churn, s_tmin, s_tmax)
    on_schedule = s_churn == 0.0
    s_next = sigmas[1:].astype(f32)
    for i in range(len(sigmas) - 1):
        sh, ns = sigma_hat[i], noise_scale[i]
        if s_churn > 0:
            x = x + noise(x) * f32(s_noise) * ns
        den = denoiser(x, _s_in(x, sh), i if on_schedule else -1)
        d = (x - den) / sh
        x = x + d * (s_next[i] - sh)
    return x


def sample_euler_ancestral(denoiser, x, sigmas, noise, *, eta=1.0,
                           s_noise=1.0, **_):
    """gc_sampling.py:213-253."""
    sigmas = np.asarray(sigmas)
    sd, su = _ancestral_steps(sigmas, eta)
    gate = (sd > 0).astype(f32)   # the reference gates on sigma_down > 0
    s_i = sigmas[:-1].astype(f32)
    for i in range(len(sigmas) - 1):
        den = denoiser(x, _s_in(x, s_i[i]), i)
        d = (x - den) / s_i[i]
        x = x + d * (sd[i] - s_i[i])
        x = x + noise(x) * (su[i] * gate[i])
    return x


def sample_heun(denoiser, x, sigmas, noise, *, s_churn=0.0, s_tmin=0.0,
                s_tmax=float("inf"), s_noise=1.0, **_):
    """Karras Algorithm 2 with 2nd-order correction (gc_sampling.py:256-311).
    The final sigma->0 steps are Euler steps, split out statically."""
    sigmas = np.asarray(sigmas)
    sigma_hat, noise_scale = _churn_gammas(sigmas, s_churn, s_tmin, s_tmax)
    n = len(sigmas) - 1
    on_schedule = s_churn == 0.0
    nz = int(np.sum(sigmas[1:] > 0))
    s_next = sigmas[1:nz + 1].astype(f32)
    for i in range(nz):
        sh, ns = sigma_hat[i], noise_scale[i]
        if s_churn > 0:
            x = x + noise(x) * f32(s_noise) * ns
        den = denoiser(x, _s_in(x, sh), i if on_schedule else -1)
        d = (x - den) / sh
        dt = s_next[i] - sh
        x_2 = x + d * dt
        den_2 = denoiser(x_2, _s_in(x, s_next[i]),
                         i + 1 if on_schedule else -1)
        d_2 = (x_2 - den_2) / s_next[i]
        x = x + f32(0.5) * (d + d_2) * dt
    for i in range(nz, n):
        if s_churn > 0:
            x = x + noise(x) * f32(s_noise) * f32(noise_scale[i])
        den = denoiser(x, _s_in(x, sigma_hat[i]), i if on_schedule else -1)
        d = (x - den) / sigma_hat[i]
        x = x + d * f32(sigmas[i + 1] - sigma_hat[i])
    return x


def sample_dpm_2(denoiser, x, sigmas, noise, *, s_churn=0.0, s_tmin=0.0,
                 s_tmax=float("inf"), s_noise=1.0, **_):
    """DPM-Solver-2-style midpoint sampler (gc_sampling.py:314-372)."""
    sigmas = np.asarray(sigmas)
    sigma_hat, noise_scale = _churn_gammas(sigmas, s_churn, s_tmin, s_tmax)
    n = len(sigmas) - 1
    on_schedule = s_churn == 0.0
    nz = int(np.sum(sigmas[1:] > 0))
    # geometric midpoint in log space (gc_sampling.py:363)
    sigma_mid = np.exp(0.5 * (np.log(sigma_hat[:nz])
                              + np.log(sigmas[1:nz + 1]))).astype(f32)
    s_next = sigmas[1:nz + 1].astype(f32)
    for i in range(nz):
        sh, ns, s_mid = sigma_hat[i], noise_scale[i], sigma_mid[i]
        if s_churn > 0:
            x = x + noise(x) * f32(s_noise) * ns
        den = denoiser(x, _s_in(x, sh), i if on_schedule else -1)
        d = (x - den) / sh
        x_2 = x + d * (s_mid - sh)
        den_2 = denoiser(x_2, _s_in(x, s_mid), -1)
        d_2 = (x_2 - den_2) / s_mid
        x = x + d_2 * (s_next[i] - sh)
    for i in range(nz, n):
        den = denoiser(x, _s_in(x, sigma_hat[i]), i if on_schedule else -1)
        d = (x - den) / sigma_hat[i]
        x = x + d * f32(sigmas[i + 1] - sigma_hat[i])
    return x


def sample_dpm_2_ancestral(denoiser, x, sigmas, noise, *, eta=1.0, **_):
    """gc_sampling.py:375-410 (MoDE's 'ancestral' sampler)."""
    sigmas = np.asarray(sigmas)
    sd, su = _ancestral_steps(sigmas, eta)
    n = len(sigmas) - 1
    nz = int(np.sum(sd > 0))
    sigma_mid = np.exp(0.5 * (np.log(sigmas[:nz])
                              + np.log(sd[:nz]))).astype(f32)
    s_i = sigmas[:nz].astype(f32)
    for i in range(nz):
        den = denoiser(x, _s_in(x, s_i[i]), i)
        d = (x - den) / s_i[i]
        x_2 = x + d * (sigma_mid[i] - s_i[i])
        den_2 = denoiser(x_2, _s_in(x, sigma_mid[i]), -1)
        d_2 = (x_2 - den_2) / sigma_mid[i]
        x = x + d_2 * (sd[i] - s_i[i])
        x = x + noise(x) * su[i]
    for i in range(nz, n):
        den = denoiser(x, _s_in(x, sigmas[i]), i)
        d = (x - den) / f32(sigmas[i])
        x = x + d * f32(sd[i] - sigmas[i])
    return x


def sample_lms(denoiser, x, sigmas, noise=None, *, order=4, **_):
    """Linear multistep sampler (gc_sampling.py:429-465); quadrature
    coefficients precomputed host-side. The derivative buffer holds the
    ``order`` newest derivatives, zeros before the first steps."""
    sigmas = np.asarray(sigmas)
    coeffs = _lms_coeffs(sigmas, order)   # [n, order], zero-padded
    s_i = sigmas[:-1].astype(f32)
    ds = torch.zeros((order,) + tuple(x.shape), dtype=x.dtype,
                     device=x.device)
    for i in range(len(sigmas) - 1):
        den = denoiser(x, _s_in(x, s_i[i]), i)
        d = (x - den) / s_i[i]
        ds = torch.cat([d[None], ds[:-1]], dim=0)   # newest first
        c = torch.as_tensor(coeffs[i], device=x.device)
        x = x + torch.einsum("j,j...->...", c, ds)
    return x


def sample_ddim(denoiser, x, sigmas, noise=None, **_):
    """DDIM / DPM-Solver-1 (gc_sampling.py:922-951), the MoDE default, in
    ratio form: ``x <- (s_next/s) x + (1 - s_next/s) denoised``, finite at
    s_next = 0. (The JAX ``unroll`` option has no meaning for a Python
    loop and is accepted and ignored.)"""
    sigmas = np.asarray(sigmas)
    ratios = (sigmas[1:] / sigmas[:-1]).astype(f32)
    s_i = sigmas[:-1].astype(f32)
    for i in range(len(sigmas) - 1):
        den = denoiser(x, _s_in(x, s_i[i]), i)
        r = ratios[i]
        x = r * x + (f32(1.0) - r) * den
    return x


def sample_dpmpp_2m(denoiser, x, sigmas, noise=None, **_):
    """DPM-Solver++(2M) (gc_sampling.py:699-733)."""
    sigmas = np.asarray(sigmas).astype(np.float64)
    n = len(sigmas) - 1
    ratios = np.zeros(n)
    rs = np.zeros(n)
    simple = np.zeros(n, dtype=bool)
    for i in range(n):
        ratios[i] = sigmas[i + 1] / sigmas[i]
        if i == 0 or sigmas[i + 1] == 0:
            simple[i] = True
        else:
            h = math.log(sigmas[i]) - math.log(sigmas[i + 1])
            h_last = math.log(sigmas[i - 1]) - math.log(sigmas[i])
            rs[i] = h_last / h
    s_i, ratios, rs = (a.astype(f32) for a in (sigmas[:-1], ratios, rs))
    old_den = torch.zeros_like(x)
    for i in range(n):
        den = denoiser(x, _s_in(x, s_i[i]), i)
        if simple[i]:
            den_eff = den
        else:
            fac = f32(1.0) / (f32(2.0) * max(rs[i], f32(1e-30)))
            den_eff = (f32(1.0) + fac) * den - fac * old_den
        r = ratios[i]
        x = r * x + (f32(1.0) - r) * den_eff
        old_den = den
    return x


def sample_dpmpp_2s(denoiser, x, sigmas, noise=None, **_):
    """DPM-Solver++(2S) (gc_sampling.py:955-994)."""
    sigmas = np.asarray(sigmas).astype(np.float64)
    n = len(sigmas) - 1
    nz = int(np.sum(sigmas[1:] > 0))
    sigma_s = np.sqrt(sigmas[:nz] * sigmas[1:nz + 1])   # log-midpoint
    ratio_s = sigma_s / sigmas[:nz]
    ratio = sigmas[1:nz + 1] / sigmas[:nz]
    s_i, s_mid, r_s, r = (a.astype(f32) for a in (sigmas[:nz], sigma_s,
                                                  ratio_s, ratio))
    for i in range(nz):
        den = denoiser(x, _s_in(x, s_i[i]), i)
        x_2 = r_s[i] * x + (f32(1.0) - r_s[i]) * den
        den_2 = denoiser(x_2, _s_in(x, s_mid[i]), -1)
        x = r[i] * x + (f32(1.0) - r[i]) * den_2
    for i in range(nz, n):
        den = denoiser(x, _s_in(x, sigmas[i]), i)
        d = (x - den) / f32(sigmas[i])
        x = x + d * f32(sigmas[i + 1] - sigmas[i])
    return x


def sample_dpmpp_2s_ancestral(denoiser, x, sigmas, noise, *, eta=1.0,
                              s_noise=1.0, **_):
    """gc_sampling.py:873-919."""
    sigmas = np.asarray(sigmas).astype(np.float64)
    sd, su = _ancestral_steps(sigmas.astype(f32), eta)
    sd = sd.astype(np.float64)
    n = len(sigmas) - 1
    nz = int(np.sum(sd > 0))
    sigma_s = np.sqrt(sigmas[:nz] * sd[:nz])
    ratio_s = sigma_s / sigmas[:nz]
    ratio = sd[:nz] / sigmas[:nz]
    s_i, s_mid, r_s, r = (a.astype(f32) for a in (sigmas[:nz], sigma_s,
                                                  ratio_s, ratio))
    for i in range(nz):
        den = denoiser(x, _s_in(x, s_i[i]), i)
        x_2 = r_s[i] * x + (f32(1.0) - r_s[i]) * den
        den_2 = denoiser(x_2, _s_in(x, s_mid[i]), -1)
        x = r[i] * x + (f32(1.0) - r[i]) * den_2
        x = x + noise(x) * f32(s_noise) * su[i]
    for i in range(nz, n):
        den = denoiser(x, _s_in(x, sigmas[i]), i)
        d = (x - den) / f32(sigmas[i])
        x = x + d * f32(sd[i] - sigmas[i])
    return x


def sample_dpmpp_sde(denoiser, x, sigmas, noise, *, eta=1.0, s_noise=1.0,
                     r=0.5, **_):
    """DPM-Solver++ (stochastic) (gc_sampling.py:736-792), with i.i.d.
    Gaussian increments for the reference's BrownianTree noise (the JAX
    package's documented deviation): two draws per step, the midpoint's
    first."""
    sigmas64 = np.asarray(sigmas).astype(np.float64)
    n = len(sigmas64) - 1
    nz = int(np.sum(sigmas64[1:] > 0))
    t = -np.log(sigmas64[:nz])
    t_next = -np.log(sigmas64[1:nz + 1])
    h = t_next - t
    s = t + h * r
    fac = 1 / (2 * r)
    sigma_sf = np.exp(-s)
    sd_1, su_1, sd_2, su_2 = (np.zeros(nz) for _ in range(4))
    for i in range(nz):
        a, b = _ancestral_steps(np.array([sigmas64[i], sigma_sf[i]], f32), eta)
        sd_1[i], su_1[i] = a[0], b[0]
        a, b = _ancestral_steps(np.array([sigmas64[i], sigmas64[i + 1]], f32),
                                eta)
        sd_2[i], su_2[i] = a[0], b[0]
    ratio_1 = sd_1 / sigmas64[:nz]      # sigma(s_)/sigma(t)
    ratio_2 = sd_2 / sigmas64[:nz]      # sigma(t_next_)/sigma(t)
    s_i, s_mid, r1, r2, su1, su2 = (a.astype(f32) for a in (
        sigmas64[:nz], sigma_sf, ratio_1, ratio_2, su_1, su_2))
    for i in range(nz):
        den = denoiser(x, _s_in(x, s_i[i]), i)
        x_2 = r1[i] * x + (f32(1.0) - r1[i]) * den
        x_2 = x_2 + noise(x) * f32(s_noise) * su1[i]
        den_2 = denoiser(x_2, _s_in(x, s_mid[i]), -1)
        den_d = f32(1 - fac) * den + f32(fac) * den_2
        x = r2[i] * x + (f32(1.0) - r2[i]) * den_d
        x = x + noise(x) * f32(s_noise) * su2[i]
    for i in range(nz, n):
        den = denoiser(x, _s_in(x, sigmas64[i]), i)
        d = (x - den) / f32(sigmas64[i])
        x = x + d * f32(sigmas64[i + 1] - sigmas64[i])
    return x


# ---------------------------------------------------------------------------
# DPM-Solver fast / adaptive (gc_sampling.py:524-696, 833-870)
# ---------------------------------------------------------------------------

def _dpm_eps(denoiser, x, t, step_idx=-1):
    sigma = math.exp(-t)
    den = denoiser(x, _s_in(x, sigma), step_idx)
    return (x - den) / f32(sigma)


def _sig(t):
    return math.exp(-t)


def sample_dpm_fast(denoiser, x, sigmas, noise=None, *, sigma_min=None,
                    sigma_max=None, n=None, eta=0.0, s_noise=1.0, **_):
    """DPM-Solver-Fast with the reference's order schedule
    (gc_sampling.py:579-616); every evaluation is off the schedule."""
    sigmas = np.asarray(sigmas)
    if sigma_min is None:
        sigma_min = float(sigmas[sigmas > 0].min())
    if sigma_max is None:
        sigma_max = float(sigmas.max())
    if n is None:
        n = len(sigmas)
    t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
    m = n // 3 + 1
    ts = np.linspace(t_start, t_end, m + 1)
    if n % 3 == 0:
        orders = [3] * (m - 2) + [2, 1]
    else:
        orders = [3] * (m - 1) + [n % 3]
    sig = _sig
    for i, order in enumerate(orders):
        t, t_next = float(ts[i]), float(ts[i + 1])
        h = t_next - t
        eps = _dpm_eps(denoiser, x, t)
        if order == 1:
            x = x - f32(sig(t_next) * math.expm1(h)) * eps
        elif order == 2:
            r1 = 0.5
            s1 = t + r1 * h
            u1 = x - f32(sig(s1) * math.expm1(r1 * h)) * eps
            eps_r1 = _dpm_eps(denoiser, u1, s1)
            x = x - f32(sig(t_next) * math.expm1(h)) * eps \
                - f32(sig(t_next) / (2 * r1) * math.expm1(h)) * (eps_r1 - eps)
        else:
            r1, r2 = 1 / 3, 2 / 3
            s1, s2 = t + r1 * h, t + r2 * h
            u1 = x - f32(sig(s1) * math.expm1(r1 * h)) * eps
            eps_r1 = _dpm_eps(denoiser, u1, s1)
            u2 = x - f32(sig(s2) * math.expm1(r2 * h)) * eps \
                - f32(sig(s2) * (r2 / r1) * (math.expm1(r2 * h) / (r2 * h)
                                             - 1)) * (eps_r1 - eps)
            eps_r2 = _dpm_eps(denoiser, u2, s2)
            x = x - f32(sig(t_next) * math.expm1(h)) * eps \
                - f32(sig(t_next) / r2 * (math.expm1(h) / h - 1)) \
                * (eps_r2 - eps)
    return x


class _PIDController:
    """PID step-size controller (gc_sampling.py:495-521)."""

    def __init__(self, h, pcoeff, icoeff, dcoeff, order=1, accept_safety=0.81,
                 eps=1e-8):
        self.h = h
        self.b1 = (pcoeff + icoeff + dcoeff) / order
        self.b2 = -(pcoeff + 2 * dcoeff) / order
        self.b3 = dcoeff / order
        self.accept_safety = accept_safety
        self.eps = eps
        self.errs = []

    def propose_step(self, error):
        inv_error = 1 / (float(error) + self.eps)
        if not self.errs:
            self.errs = [inv_error, inv_error, inv_error]
        self.errs[0] = inv_error
        factor = (self.errs[0] ** self.b1 * self.errs[1] ** self.b2
                  * self.errs[2] ** self.b3)
        factor = 1 + math.atan(factor - 1)
        accept = factor >= self.accept_safety
        if accept:
            self.errs[2] = self.errs[1]
            self.errs[1] = self.errs[0]
        self.h *= factor
        return accept


def sample_dpm_adaptive(denoiser, x, sigmas, noise=None, *, sigma_min=None,
                        sigma_max=None, order=3, rtol=0.05, atol=0.0078,
                        h_init=0.05, pcoeff=0.0, icoeff=1.0, dcoeff=0.0,
                        accept_safety=0.81, **_):
    """DPM-Solver-12/23 adaptive (gc_sampling.py:618-669): a host-driven
    control loop; every evaluation is off the schedule."""
    sigmas = np.asarray(sigmas)
    if sigma_min is None:
        sigma_min = float(sigmas[sigmas > 0].min())
    if sigma_max is None:
        sigma_max = float(sigmas.max())
    t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
    if order not in (2, 3):
        raise ValueError("order should be 2 or 3")
    s = t_start
    x_prev = x
    pid = _PIDController(abs(h_init), pcoeff, icoeff, dcoeff, order,
                         accept_safety)
    sig = _sig

    def solver_1(x, t, t_next, eps):
        return x - f32(sig(t_next) * math.expm1(t_next - t)) * eps

    def solver_2(x, t, t_next, eps, r1=0.5):
        h = t_next - t
        s1 = t + r1 * h
        u1 = x - f32(sig(s1) * math.expm1(r1 * h)) * eps
        eps_r1 = _dpm_eps(denoiser, u1, s1)
        return x - f32(sig(t_next) * math.expm1(h)) * eps \
            - f32(sig(t_next) / (2 * r1) * math.expm1(h)) * (eps_r1 - eps), \
            eps_r1

    def solver_3(x, t, t_next, eps, eps_r1, r1=1 / 3, r2=2 / 3):
        h = t_next - t
        s2 = t + r2 * h
        u2 = x - f32(sig(s2) * math.expm1(r2 * h)) * eps \
            - f32(sig(s2) * (r2 / r1) * (math.expm1(r2 * h) / (r2 * h) - 1)) \
            * (eps_r1 - eps)
        eps_r2 = _dpm_eps(denoiser, u2, s2)
        return x - f32(sig(t_next) * math.expm1(h)) * eps \
            - f32(sig(t_next) / r2 * (math.expm1(h) / h - 1)) * (eps_r2 - eps)

    while s < t_end - 1e-5:
        t = min(t_end, s + pid.h)
        eps = _dpm_eps(denoiser, x, s)
        if order == 2:
            x_low = solver_1(x, s, t, eps)
            x_high, _ = solver_2(x, s, t, eps)
        else:
            x_low, eps_r1 = solver_2(x, s, t, eps, r1=1 / 3)
            x_high = solver_3(x, s, t, eps, eps_r1)
        delta = torch.clamp_min(
            f32(rtol) * torch.maximum(x_low.abs(), x_prev.abs()), f32(atol))
        error = float(torch.linalg.vector_norm((x_low - x_high) / delta)
                      / math.sqrt(x.numel()))
        if pid.propose_step(error):
            x_prev = x_low
            x = x_high
            s = t
    return x


# ---------------------------------------------------------------------------
# Log-likelihood: the probability-flow ODE through the adaptive Dormand-Prince
# integrator of jax.experimental.ode (gc_sampling.py:468-492)
# ---------------------------------------------------------------------------

# the Dopri5 tableau (jax/experimental/ode.py runge_kutta_step), and the
# midpoint weights of its dense output (interp_fit_dopri)
_DOPRI_ALPHA = [1 / 5, 3 / 10, 4 / 5, 8 / 9, 1., 1., 0]
_DOPRI_BETA = [
    [1 / 5, 0, 0, 0, 0, 0, 0], [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]]
_DOPRI_C_SOL = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]
_DOPRI_C_ERR = [35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085,
                125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
                11 / 84 - 649 / 6300, -1. / 60.]
_DOPRI_C_MID = [6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
                -2691868925 / 45128329728 / 2,
                187940372067 / 1594534317056 / 2,
                -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2]


def _norm(a):
    """jnp.linalg.norm of a vector: the root of its sum of squares."""
    return torch.sqrt((a * a).sum())


def _initial_step_size(fun, t0, y0, order, rtol, atol, f0):
    """Hairer, Norsett and Wanner's starting step (ode.py:78)."""
    scale = atol + y0.abs() * rtol
    d0 = _norm(y0 / scale)
    d1 = _norm(f0 / scale)
    small = bool((d0 < 1e-5) | (d1 < 1e-5))
    h0 = torch.full_like(d0, 1e-6) if small else 0.01 * d0 / d1
    y1 = y0 + h0 * f0
    f1 = fun(y1, t0 + h0)
    d2 = _norm((f1 - f0) / scale) / h0
    if bool((d1 <= 1e-15) & (d2 <= 1e-15)):
        h1 = torch.clamp_min(h0 * 1e-3, 1e-6)
    else:
        h1 = (0.01 / torch.maximum(d1, d2)) ** (1. / (order + 1.))
    return torch.minimum(100. * h0, h1)


def _runge_kutta_step(func, y0, f0, t0, dt, tab):
    """One Dopri5 step (ode.py:100): the solution, the last stage's slope,
    the error estimate and the seven stages."""
    alpha, beta, c_sol, c_err = tab
    k = torch.zeros((7, f0.shape[0]), dtype=f0.dtype, device=f0.device)
    k[0] = f0
    for i in range(1, 7):
        ti = t0 + dt * alpha[i - 1]
        yi = y0 + dt * (beta[i - 1] @ k)
        k[i] = func(yi, ti)
    y1 = dt * (c_sol @ k) + y0
    return y1, k[-1], dt * (c_err @ k), k


def _mean_error_ratio(error_estimate, rtol, atol, y0, y1):
    err_tol = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    return torch.sqrt(torch.mean((error_estimate / err_tol) ** 2))


def _optimal_step_size(last_step, mean_error_ratio, safety=0.9,
                       ifactor=10.0, dfactor=0.2, order=5.0):
    """ode.py:143, in the ratio's dtype as JAX computes it."""
    r = mean_error_ratio
    dfactor = torch.where(r < 1, torch.ones_like(r), torch.full_like(r,
                                                                     dfactor))
    factor = torch.clamp_max(torch.maximum(r ** (-1.0 / order) * safety,
                                           dfactor), ifactor)
    return torch.where(r == 0, last_step * ifactor, last_step * factor)


def _interp_fit_dopri(y0, y1, k, dt, c_mid):
    """The dense output's quartic over the step (ode.py:60,69): its
    coefficients [5, n], highest power first."""
    y_mid = y0 + dt * (c_mid @ k)
    dy0, dy1 = k[0], k[-1]
    a = -2. * dt * dy0 + 2. * dt * dy1 - 8. * y0 - 8. * y1 + 16. * y_mid
    b = 5. * dt * dy0 - 3. * dt * dy1 + 18. * y0 + 14. * y1 - 32. * y_mid
    c = -4. * dt * dy0 + dt * dy1 - 11. * y0 - 5. * y1 + 16. * y_mid
    return torch.stack([a, b, c, dt * dy0, y0])


def odeint(func: Callable, y0: torch.Tensor, ts, *, rtol: float = 1.4e-8,
           atol: float = 1.4e-8, mxstep: float = math.inf,
           hmax: float = math.inf, stats: Optional[dict] = None
           ) -> torch.Tensor:
    """``jax.experimental.ode.odeint``'s adaptive Dormand-Prince integrator,
    step for step: ``func(y, t)`` over a flat state ``y0`` [n] from
    ``ts[0]`` through each later time of ``ts`` (increasing). A step is
    accepted when its mean error ratio is at most 1, and the next step size
    follows from that ratio (safety 0.9, growth at most 10x, shrink at most
    5x); the value at each output time is the accepted step's dense-output
    quartic. The times are 0-d tensors in y0's dtype (f32 for an f32
    state, as JAX's f32 ``ts``). Returns [len(ts), n]. ``stats``, when given, is
    filled with the counts of ``func`` evaluations and of accepted and
    rejected steps. The loop runs on the host: each step reads its error
    ratio (one device sync per step)."""
    dt_ = y0.dtype
    dev = y0.device

    def tensor(v):
        return torch.as_tensor(v, dtype=dt_, device=dev)

    tab = tuple(tensor(v) for v in (_DOPRI_ALPHA, _DOPRI_BETA, _DOPRI_C_SOL,
                                    _DOPRI_C_ERR))
    c_mid = tensor(_DOPRI_C_MID)
    ts = [tensor(t) for t in (ts.tolist() if hasattr(ts, "tolist") else ts)]
    counts = {"evaluations": 0, "accepted": 0, "rejected": 0}

    def fun(y, t):
        counts["evaluations"] += 1
        return func(y, t)

    y = y0
    f = fun(y0, ts[0])
    dt = torch.clamp(_initial_step_size(fun, ts[0], y0, 4, rtol, atol, f),
                     min=0., max=hmax)
    t = last_t = ts[0]
    interp = torch.stack([y0] * 5)
    out = [y0]
    for target in ts[1:]:
        i = 0
        while bool(t < target) and i < mxstep and bool(dt > 0):
            next_y, next_f, next_err, k = _runge_kutta_step(fun, y, f, t, dt,
                                                            tab)
            ratio = _mean_error_ratio(next_err, rtol, atol, y, next_y)
            new_dt = torch.clamp(_optimal_step_size(dt, ratio), min=0.,
                                 max=hmax)
            if bool(ratio <= 1.):
                interp = _interp_fit_dopri(y, next_y, k, dt, c_mid)
                y, f, last_t, t = next_y, next_f, t, t + dt
                counts["accepted"] += 1
            else:
                counts["rejected"] += 1
            dt = new_dt
            i += 1
        rel = (target - last_t) / (t - last_t)
        val = torch.zeros_like(y)
        for coeff in interp:                   # jnp.polyval: Horner from 0
            val = val * rel + coeff
        out.append(val)
    if stats is not None:
        stats.update(counts)
    return torch.stack(out)


@torch.no_grad()
def log_likelihood(denoiser: Callable, x: torch.Tensor, sigma_min: float,
                   sigma_max: float,
                   generator: Optional[torch.Generator] = None, *,
                   v: Optional[torch.Tensor] = None, atol: float = 1e-4,
                   rtol: float = 1e-4, stats: Optional[dict] = None
                   ) -> torch.Tensor:
    """Log-likelihood [B] of the samples ``x`` [B, ...] under the
    probability-flow ODE ``dx/dsigma = (x - D(x, sigma)) / sigma``,
    integrated from ``sigma_min`` to ``sigma_max`` with the change of
    log-density given by Hutchinson's estimate of the divergence,
    ``sum(v * J v)`` per sample, for one Rademacher draw ``v`` (+-1 like
    x), plus the log-density of the end point under Normal(0,
    sigma_max) (gc_sampling.py:468-492). The denoiser is called with step
    index -1 (off the schedule); its JVP is exact forward mode
    (``torch.func.jvp``), so the denoiser must be differentiable: the
    ``reference`` preset's plain modules are, the CUDA kernels are not and
    raise. ``v`` is drawn from ``generator`` unless given (the JAX function
    draws it from its key; a test passes JAX's draw). ``stats``: see
    ``odeint``. Runs under ``torch.no_grad``: the forward-mode JVP needs no
    reverse graph, which would otherwise chain through every step."""
    B = x.shape[0]
    n = x.numel()
    if v is None:
        v = torch.randint(0, 2, x.shape, generator=generator,
                          device=x.device).to(x.dtype) * 2 - 1
    v = v.to(device=x.device, dtype=x.dtype)

    def ode_fn(state, sigma):
        xt = state[:n].reshape(x.shape)
        s_vec = sigma.to(x.dtype).reshape(1).expand(B)

        def f(xx):
            return (xx - denoiser(xx, s_vec, -1)) / sigma

        d, jvp_v = torch.func.jvp(f, (xt,), (v,))
        d_ll = (v * jvp_v).reshape(B, -1).sum(dim=1)
        return torch.cat([d.reshape(-1), d_ll.reshape(-1)])

    init = torch.cat([x.reshape(-1), torch.zeros(B, dtype=x.dtype,
                                                 device=x.device)])
    ts = np.asarray([sigma_min, sigma_max], np.float32)
    sol = odeint(ode_fn, init, ts, atol=atol, rtol=rtol, stats=stats)[-1]
    latent, delta_ll = sol[:n].reshape(x.shape), sol[n:]
    # jax.scipy.stats.norm.logpdf(latent, 0, sigma_max)
    scale = torch.as_tensor(float(f32(sigma_max)), dtype=x.dtype,
                            device=x.device)
    log_normalizer = torch.log(2 * math.pi * scale * scale)
    ll_prior = (log_normalizer + latent * latent / (scale * scale)) / -2
    return ll_prior.reshape(B, -1).sum(dim=1) + delta_ll


# ---------------------------------------------------------------------------
# Dispatch (reference mode_agent.py:771-840)
# ---------------------------------------------------------------------------

SAMPLERS: Dict[str, Callable] = {
    "lms": sample_lms,
    "heun": sample_heun,
    "euler": sample_euler,
    "ancestral": sample_dpm_2_ancestral,
    "euler_ancestral": sample_euler_ancestral,
    "dpm": sample_dpm_2,
    "dpm_adaptive": sample_dpm_adaptive,
    "dpm_fast": sample_dpm_fast,
    "dpmpp_2s_ancestral": sample_dpmpp_2s_ancestral,
    "dpmpp_2m": sample_dpmpp_2m,
    "dpmpp_2m_sde": sample_dpmpp_sde,
    "ddim": sample_ddim,
    "dpmpp_2s": sample_dpmpp_2s,
    "dpmpp_2_with_lms": sample_dpmpp_2m,  # the reference aliases 2M math
    "debugging": sample_dpmpp_2m,
}


def sample_loop(sampler_type: str, denoiser: Callable, x: torch.Tensor,
                sigmas: np.ndarray,
                generator: Optional[torch.Generator] = None,
                extra_args: Optional[dict] = None, *,
                noise_fn: Optional[Callable] = None) -> torch.Tensor:
    """Run the named sampler. ``denoiser(x, sigma_vec, step_idx) ->
    denoised``; ``extra_args`` are the sampler's options (``s_churn``,
    ``eta``, ``order``, ...; ``keep_last_actions`` is dropped, as in JAX).
    Stochastic samplers draw from ``noise_fn(x)`` when given, else from
    ``generator`` (a new one seeded 0 when None)."""
    if sampler_type not in SAMPLERS:
        raise ValueError(f"desired sampler type not found: {sampler_type}")
    extra = dict(extra_args or {})
    extra.pop("keep_last_actions", None)
    if noise_fn is None:
        noise_fn = _generator_noise(generator, x.device)
    return SAMPLERS[sampler_type](denoiser, x, sigmas, noise_fn, **extra)
