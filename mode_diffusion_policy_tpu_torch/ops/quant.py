"""Weight-only int8 quantization of the MoE expert FFNs.

Counterpart of ``mode_diffusion_policy_tpu/ops/quant.py``. Quantization is
symmetric per output channel, so the scale factors out of the product:
``x @ (q * s) == (x @ q) * s``. Unlike ``quant_math.quant_rows`` it DIVIDES
by the scale, exactly as the JAX function does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedExperts(NamedTuple):
    w1_q: torch.Tensor   # int8 [E, D, 2H]
    w1_s: torch.Tensor   # f32  [E, 2H]   per-output-channel scales
    b1: torch.Tensor     # [E, 2H]
    w2_q: torch.Tensor   # int8 [E, H, D]
    w2_s: torch.Tensor   # f32  [E, D]


def quantize_per_channel(w: torch.Tensor, axis: int = -1):
    """Symmetric int8 per-output-channel, keeping the leading expert axis:
    returns (q int8, scales f32 [w.shape[0], w.shape[axis]])."""
    ax = axis % w.ndim
    w32 = w.float()
    red = tuple(a for a in range(w.ndim) if a not in (0, ax))
    amax = w32.abs().amax(dim=red) if red else w32.abs()
    scales = (amax / 127.0).clamp_min(1e-12)
    shape = [1] * w.ndim
    shape[0] = w.shape[0]
    shape[ax] = w.shape[ax]
    q = torch.round(w32 / scales.reshape(shape)).clamp_(-127, 127)
    return q.to(torch.int8), scales


def quantize_experts(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor
                     ) -> QuantizedExperts:
    w1_q, w1_s = quantize_per_channel(w1, axis=-1)
    w2_q, w2_s = quantize_per_channel(w2, axis=-1)
    return QuantizedExperts(w1_q.contiguous(), w1_s.float().contiguous(),
                            b1.contiguous(), w2_q.contiguous(),
                            w2_s.float().contiguous())


def dequantize_experts(q: QuantizedExperts):
    """Reference dequantization (for tests)."""
    w1 = q.w1_q.float() * q.w1_s[:, None, :]
    w2 = q.w2_q.float() * q.w2_s[:, None, :]
    return w1, q.b1, w2
