"""Samplers (counterpart of ``mode_diffusion_policy_tpu/models/edm/samplers.py``).

The denoiser callback has the JAX package's signature ``denoiser(x,
sigma_vec, step_idx)``, with ``step_idx`` the scheduled-step index so an
agent can pick its per-sigma precomputed routing. Only DDIM, the MoDE
default and the serving path's sampler, is ported; the other names of the
JAX dispatch table raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

UNPORTED_SAMPLERS = (
    "lms", "heun", "euler", "ancestral", "euler_ancestral", "dpm",
    "dpm_adaptive", "dpm_fast", "dpmpp_2s_ancestral", "dpmpp_2m",
    "dpmpp_2m_sde", "dpmpp_2s", "dpmpp_2_with_lms", "debugging")


def sample_ddim(denoiser: Callable, x: torch.Tensor, sigmas: np.ndarray,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DDIM / DPM-Solver-1 in ratio form:
    ``x <- (s_next/s) x + (1 - s_next/s) denoised``, finite at s_next = 0.
    The ratios are float32, as the JAX sampler scans over them."""
    sigmas = np.asarray(sigmas, np.float32)
    ratios = (sigmas[1:] / sigmas[:-1]).astype(np.float32)
    for i in range(len(sigmas) - 1):
        s_in = torch.full((x.shape[0],), float(sigmas[i]),
                          dtype=torch.float32, device=x.device)
        den = denoiser(x, s_in, i)
        r = float(ratios[i])
        x = r * x + float(np.float32(1.0) - ratios[i]) * den
    return x


SAMPLERS = {"ddim": sample_ddim}


def sample_loop(sampler_type: str, denoiser: Callable, x: torch.Tensor,
                sigmas: np.ndarray, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """Run the named sampler. ``denoiser(x, sigma_vec, step_idx) -> denoised``."""
    if sampler_type in UNPORTED_SAMPLERS:
        raise NotImplementedError(
            f"sampler {sampler_type!r} is not ported yet; only 'ddim' is "
            "(ROADMAP.md Queue 1, the other samplers)")
    if sampler_type not in SAMPLERS:
        raise ValueError(f"desired sampler type not found: {sampler_type}")
    return SAMPLERS[sampler_type](denoiser, x, sigmas, generator)
