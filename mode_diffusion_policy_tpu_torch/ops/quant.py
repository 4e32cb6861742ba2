"""Weight-only int8 quantization of the MoE expert FFNs and of the
attention projections.

Counterpart of ``mode_diffusion_policy_tpu/ops/quant.py``. Quantization is
symmetric per output channel, so the scale factors out of the product:
``x @ (q * s) == (x @ q) * s``. Unlike ``quant_math.quant_rows`` it DIVIDES
by the scale, exactly as the JAX functions do (and, like them, the two
functions clamp the scale at different points: see ``quantize_attn``).
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


def _own_f32(t: torch.Tensor) -> torch.Tensor:
    """An f32 copy that shares nothing with ``t``: a bias passed through
    must not follow later in-place changes of the parameter it came from
    (the serving precast recasts parameters in place)."""
    return t.detach().to(torch.float32, copy=True).contiguous()


def quantize_experts(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor
                     ) -> QuantizedExperts:
    w1_q, w1_s = quantize_per_channel(w1, axis=-1)
    w2_q, w2_s = quantize_per_channel(w2, axis=-1)
    return QuantizedExperts(w1_q.contiguous(), w1_s.float().contiguous(),
                            _own_f32(b1), w2_q.contiguous(),
                            w2_s.float().contiguous())


class ExpertsKMajor(NamedTuple):
    """The int8 experts with the contraction axis innermost, the layout in
    which the int8 layer kernel's wgmma products read them (s8 wgmma takes
    both operands K-major)."""

    w1_t: torch.Tensor   # int8 [E, 2H, D]: w1_q transposed per expert
    w2_t: torch.Tensor   # int8 [E, D, H]:  w2_q transposed per expert


def kmajor_experts(q: QuantizedExperts) -> ExpertsKMajor:
    """A K-major copy of ``q``'s int8 weights (``q`` itself stays as it is:
    the plain versions and the other kernels read the JAX layout). Made
    once per quantization, it costs the int8 expert bytes again."""
    return ExpertsKMajor(q.w1_q.transpose(1, 2).contiguous(),
                         q.w2_q.transpose(1, 2).contiguous())


def dequantize_experts(q: QuantizedExperts):
    """Reference dequantization (for tests)."""
    w1 = q.w1_q.float() * q.w1_s[:, None, :]
    w2 = q.w2_q.float() * q.w2_s[:, None, :]
    return w1, q.b1, w2


class QuantizedAttn(NamedTuple):
    """int8 attention projection weights (per-output-channel symmetric)."""

    wqkv_q: torch.Tensor   # int8 [D, 3D]
    wqkv_s: torch.Tensor   # f32  [3D]
    bqkv: torch.Tensor     # f32  [3D]
    wout_q: torch.Tensor   # int8 [D, D]
    wout_s: torch.Tensor   # f32  [D]


def quantize_attn(wqkv: torch.Tensor, bqkv: torch.Tensor, wout: torch.Tensor
                  ) -> QuantizedAttn:
    """``s = max(amax, 1e-12) / 127`` per output column, ``q = round(w / s)``
    (the expert quantizer clamps ``amax / 127`` instead)."""
    def q(w):
        w32 = w.float()
        s = w32.abs().amax(dim=0).clamp_min(1e-12) / 127.0
        return (torch.round(w32 / s).clamp_(-127, 127).to(torch.int8)
                .contiguous(), s.contiguous())

    wqkv_q, wqkv_s = q(wqkv)
    wout_q, wout_s = q(wout)
    return QuantizedAttn(wqkv_q, wqkv_s, _own_f32(bqkv), wout_q, wout_s)


class AttnKMajor(NamedTuple):
    """The int8 attention projections with the contraction axis innermost,
    the layout in which the int8 attention kernels' wgmma products read
    them (s8 wgmma takes both operands K-major). Kept apart from
    ``QuantizedAttn``, whose field order the layer stack relies on."""

    wqkv_t: torch.Tensor   # int8 [3D, D]: wqkv_q transposed
    wout_t: torch.Tensor   # int8 [D, D]:  wout_q transposed


def kmajor_attn(q: QuantizedAttn) -> AttnKMajor:
    """A K-major copy of ``q``'s int8 weights (``q`` itself stays as it is:
    the plain versions, the megakernel's layer stack and the JAX layout
    read it). Made once per quantization, it costs the int8 projection
    bytes again (4 D^2: 4.2 MB a layer at D = 1024)."""
    return AttnKMajor(q.wqkv_q.t().contiguous(), q.wout_q.t().contiguous())

