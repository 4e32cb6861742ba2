"""Noise schedules (sigma ladders) for sampling.

A copy of ``mode_diffusion_policy_tpu/models/edm/schedules.py`` (numpy
only): the 7 sigma ladders, computed host-side in float64 numpy and handed
to the samplers as small float32 arrays.
"""
from __future__ import annotations

import math
from typing import Dict, Callable

import numpy as np


def _append_zero(s: np.ndarray) -> np.ndarray:
    return np.concatenate([s, np.zeros((1,), dtype=s.dtype)])


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float, rho: float = 7.0) -> np.ndarray:
    ramp = np.linspace(0, 1, n)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return _append_zero(sigmas.astype(np.float32))


def get_sigmas_exponential(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    sigmas = np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min), n))
    return _append_zero(sigmas.astype(np.float32))


def get_sigmas_linear(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    sigmas = np.linspace(sigma_max, sigma_min, n)
    return _append_zero(sigmas.astype(np.float32))


def cosine_beta_schedule(n: int, s: float = 0.008) -> np.ndarray:
    steps = n + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    betas_clipped = np.clip(betas, 0, 0.999)
    return _append_zero(np.flip(betas_clipped).astype(np.float32))


def get_sigmas_ve(n: int, sigma_min: float = 0.02, sigma_max: float = 100.0) -> np.ndarray:
    steps = n + 1
    t = np.linspace(0, steps, n)
    t = (sigma_max ** 2) * ((sigma_min ** 2 / sigma_max ** 2) ** (t / (n - 1)))
    return _append_zero(np.sqrt(t).astype(np.float32))


def get_iddpm_sigmas(n: int, sigma_min: float = 0.02, sigma_max: float = 100.0,
                     M: int = 1000, j_0: int = 0, C_1: float = 0.001,
                     C_2: float = 0.008) -> np.ndarray:
    step_indices = np.arange(n, dtype=np.float64)
    u = np.zeros(M + 1, dtype=np.float64)
    alpha_bar = lambda j: np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2
    for j in range(M, j_0, -1):
        u[j - 1] = np.sqrt((u[j] ** 2 + 1) / max(alpha_bar(j - 1) / alpha_bar(j), C_1) - 1)
    u_filtered = u[np.logical_and(u >= sigma_min, u <= sigma_max)]
    sigmas = u_filtered[np.round((len(u_filtered) - 1) / (n - 1) * step_indices).astype(np.int64)]
    return _append_zero(sigmas.astype(np.float32))


def get_sigmas_vp(n: int, beta_d: float = 19.9, beta_min: float = 0.1,
                  eps_s: float = 1e-3) -> np.ndarray:
    t = np.linspace(1, eps_s, n)
    sigmas = np.sqrt(np.exp(beta_d * t ** 2 / 2 + beta_min * t) - 1)
    return _append_zero(sigmas.astype(np.float32))


NOISE_SCHEDULES: Dict[str, Callable] = {
    "karras": get_sigmas_karras,
    "exponential": get_sigmas_exponential,
    "linear": get_sigmas_linear,
    "cosine_beta": cosine_beta_schedule,
    "ve": get_sigmas_ve,
    "iddpm": get_iddpm_sigmas,
    "vp": get_sigmas_vp,
}


def get_noise_schedule(n_sampling_steps: int, noise_schedule_type: str,
                       sigma_min: float = 0.001, sigma_max: float = 80.0) -> np.ndarray:
    """Dispatch matching reference MoDEAgent.get_noise_schedule
    (mode_agent.py:842-860)."""
    if noise_schedule_type == "karras":
        return get_sigmas_karras(n_sampling_steps, sigma_min, sigma_max, 7.0)
    if noise_schedule_type == "exponential":
        return get_sigmas_exponential(n_sampling_steps, sigma_min, sigma_max)
    if noise_schedule_type == "vp":
        return get_sigmas_vp(n_sampling_steps)
    if noise_schedule_type == "linear":
        return get_sigmas_linear(n_sampling_steps, sigma_min, sigma_max)
    if noise_schedule_type == "cosine_beta":
        return cosine_beta_schedule(n_sampling_steps)
    if noise_schedule_type == "ve":
        return get_sigmas_ve(n_sampling_steps, sigma_min, sigma_max)
    if noise_schedule_type == "iddpm":
        return get_iddpm_sigmas(n_sampling_steps, sigma_min, sigma_max)
    raise ValueError(f"Unknown noise schedule type: {noise_schedule_type}")
