"""Training-time sigma sample densities (counterpart of
``mode_diffusion_policy_tpu/models/edm/densities.py``).

Each density is split in two: ``draw(generator, shape, device)`` takes the
uniform or normal draws from a ``torch.Generator``, and ``transform(draws)``
turns them into sigmas with the JAX package's arithmetic (float32, the
truncation bounds computed host-side in float64). A test can hand JAX's
own draws to ``transform``; ``density(generator, shape, device)`` does both.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch


def _uniform(generator, shape, device):
    return torch.rand(shape, generator=generator, device=device)


def _normal(generator, shape, device):
    return torch.randn(shape, generator=generator, device=device)


class SampleDensity:
    """``draw`` then ``transform``; calling it does both."""

    def __init__(self, draw: Callable, transform: Callable):
        self.draw = draw
        self.transform = transform

    def __call__(self, generator, shape, device=None) -> torch.Tensor:
        return self.transform(self.draw(generator, shape, device))


def log_normal(loc=0.0, scale=1.0) -> SampleDensity:
    return SampleDensity(lambda g, s, d: {"n": _normal(g, s, d)},
                         lambda r: torch.exp(r["n"] * scale + loc))


def log_logistic(loc=0.0, scale=1.0, min_value=0.0,
                 max_value=float("inf")) -> SampleDensity:
    """Truncated log-logistic (the MoDE default): u ~ U[0,1) mapped into
    [cdf(min), cdf(max)], then exp(logit(u) * scale + loc)."""
    def cdf(v):
        return 1.0 / (1.0 + math.exp(-(math.log(v) - loc) / scale))
    min_cdf = np.float32(cdf(min_value) if min_value > 0 else 0.0)
    max_cdf = np.float32(cdf(max_value) if math.isfinite(max_value) else 1.0)
    width = float(max_cdf - min_cdf)

    def transform(r):
        u = r["u"].float() * width + float(min_cdf)
        return torch.exp(torch.logit(u) * scale + loc)

    return SampleDensity(lambda g, s, d: {"u": _uniform(g, s, d)}, transform)


def log_uniform(min_value, max_value) -> SampleDensity:
    lo, hi = math.log(min_value), math.log(max_value)
    return SampleDensity(lambda g, s, d: {"u": _uniform(g, s, d)},
                         lambda r: torch.exp(r["u"] * (hi - lo) + lo))


def uniform(min_value, max_value) -> SampleDensity:
    return SampleDensity(
        lambda g, s, d: {"u": _uniform(g, s, d)},
        lambda r: r["u"] * (max_value - min_value) + min_value)


def v_diffusion(sigma_data=1.0, min_value=0.0,
                max_value=float("inf")) -> SampleDensity:
    min_cdf = math.atan(min_value / sigma_data) * 2 / math.pi
    max_cdf = (math.atan(max_value / sigma_data) * 2 / math.pi
               if math.isfinite(max_value) else 1.0)

    def transform(r):
        u = r["u"] * (max_cdf - min_cdf) + min_cdf
        return torch.tan(u * math.pi / 2) * sigma_data

    return SampleDensity(lambda g, s, d: {"u": _uniform(g, s, d)}, transform)


def split_log_normal(loc, scale_1, scale_2) -> SampleDensity:
    ratio = scale_1 / (scale_1 + scale_2)

    def transform(r):
        n = r["n"].abs()
        return torch.exp(torch.where(r["u"] < ratio, n * -scale_1 + loc,
                                     n * scale_2 + loc))

    return SampleDensity(
        lambda g, s, d: {"n": _normal(g, s, d), "u": _uniform(g, s, d)},
        transform)


def discrete(values: Sequence[float]) -> SampleDensity:
    table = torch.as_tensor(np.asarray(values, np.float32))
    n = len(values)
    return SampleDensity(
        lambda g, s, d: {"idx": torch.randint(0, n, tuple(s), generator=g,
                                              device=d)},
        lambda r: table.to(r["idx"].device)[r["idx"].long()])


SIGMA_DENSITIES = ("lognormal", "loglogistic", "loguniform", "uniform",
                   "v-diffusion", "discrete", "split-lognormal")


def make_sample_density(density_type: str, *, sigma_data: float = 0.5,
                        sigma_min: float = 0.001, sigma_max: float = 80.0,
                        num_sampling_steps: int = 10, **kw) -> SampleDensity:
    """The density of ``density_type`` with the JAX package's defaults
    (loglogistic: loc=log(sigma_data), scale=0.5, truncated to
    [sigma_min, sigma_max])."""
    if density_type == "lognormal":
        return log_normal(kw.get("loc", 0.0), kw.get("scale", 1.0))
    if density_type == "loglogistic":
        return log_logistic(kw.get("loc", math.log(sigma_data)),
                            kw.get("scale", 0.5),
                            kw.get("min_value", sigma_min),
                            kw.get("max_value", sigma_max))
    if density_type == "loguniform":
        return log_uniform(sigma_min, sigma_max)
    if density_type == "uniform":
        return uniform(sigma_min, sigma_max)
    if density_type == "v-diffusion":
        return v_diffusion(sigma_data, sigma_min, sigma_max)
    if density_type == "discrete":
        from .schedules import get_sigmas_exponential
        return discrete(get_sigmas_exponential(
            int(num_sampling_steps * 1e5), sigma_min, sigma_max))
    if density_type == "split-lognormal":
        return split_log_normal(kw["loc"], kw["scale_1"], kw["scale_2"])
    raise ValueError(f"Unknown sample density type: {density_type}")


__all__ = ["SampleDensity", "SIGMA_DENSITIES", "make_sample_density"]
