"""Karras/EDM preconditioning and the EDM loss (counterpart of
``mode_diffusion_policy_tpu/models/edm/precond.py``): the scalings are free
functions applied around any ``inner_apply(states, scaled_actions, goal,
sigma) -> pred``."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ...ops.primitives import append_dims, at_least_f32


def edm_scalings(sigma: torch.Tensor, sigma_data: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """c_skip, c_out, c_in."""
    sd2 = sigma_data ** 2
    c_skip = sd2 / (sigma ** 2 + sd2)
    c_out = sigma * sigma_data / torch.sqrt(sigma ** 2 + sd2)
    c_in = 1.0 / torch.sqrt(sigma ** 2 + sd2)
    return c_skip, c_out, c_in


def denoiser_forward(inner_apply: Callable, states, action: torch.Tensor,
                     goal: torch.Tensor, sigma: torch.Tensor, *,
                     sigma_data: float = 0.5, **kwargs) -> torch.Tensor:
    """D(x, sigma) = inner(c_in * x, sigma) * c_out + x * c_skip; sigma [B]."""
    c_skip, c_out, c_in = [append_dims(c, action.ndim)
                           for c in edm_scalings(sigma, sigma_data)]
    model_out = inner_apply(states, action * c_in, goal, sigma, **kwargs)
    return model_out.float() * c_out + action * c_skip


def denoiser_loss(inner_apply: Callable, states, action: torch.Tensor,
                  goal: torch.Tensor, noise: torch.Tensor, sigma: torch.Tensor,
                  *, sigma_data: float = 0.5, **kwargs):
    """EDM score-matching loss: returns (scalar mse, model output). The
    model output and the target are cast to (at least) f32 before the
    difference, as in the JAX package."""
    c_skip, c_out, c_in = [append_dims(c, action.ndim)
                           for c in edm_scalings(sigma, sigma_data)]
    noised = action + noise * append_dims(sigma, action.ndim)
    model_out = inner_apply(states, noised * c_in, goal, sigma, **kwargs)
    target = (action - c_skip * noised) / c_out
    loss = ((at_least_f32(model_out) - at_least_f32(target)) ** 2).mean()
    return loss, model_out
