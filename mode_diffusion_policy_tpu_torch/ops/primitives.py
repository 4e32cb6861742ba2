"""Core NN primitives (counterpart of ``mode_diffusion_policy_tpu/ops/primitives.py``).

Parameters keep the JAX package's names and layouts (a dense ``kernel`` is
[in, out]), so ``utils/weights.py`` maps a JAX parameter tree onto these
modules leaf by leaf.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import draw_rows


class RMSNorm(nn.Module):
    """``x / max(||x||_2 * d^-0.5, eps) * g``, computed in f32 and cast back
    to the input dtype. The eps clamps the scaled L2 norm itself; this is
    not ``x * rsqrt(mean(x^2) + eps)``."""

    def __init__(self, dim: int, eps: float = 1e-8, device=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                         device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = at_least_f32(x)
        norm = torch.linalg.vector_norm(x32, dim=-1, keepdim=True) \
            * (self.dim ** -0.5)
        return (x32 / norm.clamp_min(self.eps) * self.g).to(x.dtype)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in f64 when it is f64: the JAX package's f32 casts,
    which a float64 evaluation (the gradient check against f64) keeps in
    f64."""
    return x if x.dtype == torch.float64 else x.float()


def swish_glu(h: torch.Tensor) -> torch.Tensor:
    """SwishGLU on a pre-projected ``[..., 2*out]`` tensor: the first half is
    the value branch, the second half the gate."""
    value, gate = h.chunk(2, dim=-1)
    return value * F.silu(gate)


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Append trailing singleton dims until x has ``target_ndim`` dims."""
    n = target_ndim - x.ndim
    if n < 0:
        raise ValueError(
            f"input has {x.ndim} dims but target_ndim is {target_ndim}")
    return x[(...,) + (None,) * n]


class DenseP(nn.Module):
    """``flax.linen.Dense`` semantics: ``x.to(dtype) @ kernel.to(dtype) +
    bias.to(dtype)`` with ``kernel`` stored [in, out] in f32 (the serving
    precast may leave it in ``dtype`` already, making the cast a no-op)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class SwishGLUDense(nn.Module):
    """Dense ``project`` to ``2 * out_dim``, then ``swish_glu``. With the
    default f32 ``dtype`` this is the JAX module, whose dense promotes an
    f32 or bf16 input to its f32 parameters."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.project = DenseP(in_dim, 2 * out_dim, use_bias=use_bias,
                              dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swish_glu(self.project(x))


def gumbel_topk_sample(log_probs: torch.Tensor, k: int, *,
                       generator: Optional[torch.Generator] = None,
                       gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample k items without replacement from categorical(log_probs) by the
    Gumbel-top-k trick: the top k of ``log_probs + g``, g standard Gumbel
    noise of ``log_probs``'s shape, given as ``gumbel`` or drawn from
    ``generator`` as -log(-log(u)), u uniform in [tiny, 1)."""
    if gumbel is None:
        tiny = torch.finfo(log_probs.dtype).tiny
        u = draw_rows(torch.rand, log_probs.shape, generator=generator,
                      device=log_probs.device, dtype=log_probs.dtype)
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.topk(log_probs + gumbel.to(log_probs), k, dim=-1).indices


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep each element with
    probability 1 - rate (a uniform draw from ``generator`` below it) and
    scale the kept ones by 1 / (1 - rate), the scale in ``x``'s dtype.
    Rate 0 returns ``x``. In a data-parallel step the draw covers the
    global batch (``parallel.mesh.draw_rows``)."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = draw_rows(torch.rand, x.shape, generator=generator,
                     device=x.device) < keep_prob
    scale = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
