"""Plain PyTorch versions of the shared int8 helpers.

Counterpart of ``mode_diffusion_policy_tpu/ops/pallas/quant_math.py``: per-row
symmetric int8 quantization by reciprocal multiply with round-half-to-even,
and the exact int8 x int8 -> int32 product. The CUDA kernel in
``csrc/fused_layer_q8c.cu`` repeats the same arithmetic (``rintf`` and an
IEEE reciprocal), so both round identically on identical inputs.
"""
from __future__ import annotations

import torch


def quant_rows(x: torch.Tensor):
    """[N, K] float -> (int8 [N, K], f32 [N, 1] per-row scale)."""
    x = x.float()
    s = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-6) / 127.0
    q = torch.round(x * (1.0 / s)).clamp_(-127, 127).to(torch.int8)
    return q, s


def dot_i8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [N, K] @ int8 [K, M] -> int32 [N, M], exact.

    Computed in float64, which holds every partial sum exactly while
    K * 127 * 127 < 2**53 (any K this model uses), on the CPU and on CUDA
    alike (CUDA has no general integer matmul)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"dot_i8 takes int8 operands, got {a.dtype}, {b.dtype}")
    return torch.matmul(a.double(), b.double()).to(torch.int32)
