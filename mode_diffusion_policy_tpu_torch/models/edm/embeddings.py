"""Time/sigma embeddings (counterpart of
``mode_diffusion_policy_tpu/models/edm/embeddings.py``). MoDeDiT itself uses
the linear sigma path (``MoDeDiT.process_sigma_embeddings``); these are kept
for alternative noise conditioners. Parameter names follow the flax modules
(``W``, ``weight``, ``Dense_0``/``Dense_1``)."""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.primitives import DenseP


class GaussianFourierProjection(nn.Module):
    """Random-feature time encoding with fixed weights ``W`` [embed_dim/2]."""

    def __init__(self, embed_dim: int, scale: float = 30.0, device=None,
                 generator=None):
        super().__init__()
        W = torch.randn(embed_dim // 2, device=device, generator=generator)
        self.register_buffer("W", W * scale)

    def forward(self, x):
        proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class FourierFeatures(nn.Module):
    """``[cos(2 pi x W^T), sin(2 pi x W^T)]`` with ``weight`` [embed_dim/2, in]."""

    def __init__(self, embed_dim: int, in_features: int = 1, std: float = 1.0,
                 device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(embed_dim // 2, in_features, device=device,
                        generator=generator) * std)

    def forward(self, x):
        if x.ndim == 1:
            x = x[:, None]
        f = 2 * math.pi * x @ self.weight.T
        return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


def sinusoidal_pos_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    emb = torch.exp(torch.arange(half, device=x.device) * -emb)
    emb = x[:, None] * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def _mish(h):
    return h * torch.tanh(F.softplus(h))


class SinusoidalPosEmbedding(nn.Module):
    """Sinusoidal embedding + Dense(2d) -> Mish -> Dense(d)."""

    def __init__(self, embed_dim: int, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.Dense_0 = DenseP(embed_dim, 2 * embed_dim, device=device)
        self.Dense_1 = DenseP(2 * embed_dim, embed_dim, device=device)

    def forward(self, t):
        h = sinusoidal_pos_emb(t, self.embed_dim)
        return self.Dense_1(_mish(self.Dense_0(h)))


class GaussianFourierEmbedding(nn.Module):
    """GaussianFourierProjection + Dense(2d) -> Mish -> Dense(d)."""

    def __init__(self, embed_dim: int, device=None, generator=None):
        super().__init__()
        self.GaussianFourierProjection_0 = GaussianFourierProjection(
            embed_dim, device=device, generator=generator)
        self.Dense_0 = DenseP(embed_dim, 2 * embed_dim, device=device)
        self.Dense_1 = DenseP(2 * embed_dim, embed_dim, device=device)

    def forward(self, t):
        h = self.GaussianFourierProjection_0(t)
        return self.Dense_1(_mish(self.Dense_0(h)))
