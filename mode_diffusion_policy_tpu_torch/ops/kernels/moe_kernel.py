"""The int8 x int8 top-2 SwishGLU MoE of NoiseBlockMoE: CUDA kernel, wrapper
and plain version.

Counterpart of ``mode_diffusion_policy_tpu/ops/pallas/moe_kernel.py::
fused_top2_mlp_q8c`` (the Pallas ``_kernel_q8c``). For the routing row
``step`` of the [S,2] tables (or single [2] rows) it computes

    out   = seed + sum_{e in top2} sum_k p_e * dot_i8(q(act_e,k), W2_e,k) * s
    act_e = value * silu(gate),  [value | gate] = dot_i8(q(xm), W1_e) * s + b1
    xm    = rmsnorm(x) * ln_g cast to x.dtype, or x itself without ln_g
    seed  = xm with ``residual``, else 0

with the JAX kernel's cast chain: the MoE input quantized once per row,
``act`` re-quantized per row within each ``block_hidden`` column block, the
(slot, block) contributions added to the f32 accumulator in the JAX order,
and the sum written in x.dtype.

``fused_top2_mlp_q8c`` launches ``csrc/fused_top2_mlp_q8c.cu`` for CUDA
tensors (and raises on what it cannot take) and runs the plain version,
``fused_top2_mlp_q8c_ref``, only for CPU tensors.
``fused_top2_mlp_q8c.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..quant import QuantizedExperts
from ._common import (_check, _check_moe_widths, _hidden_block,
                      _rmsnorm_rows, _routing_row, _tables)
from .quant_math import dot_i8, quant_rows


def fused_top2_mlp_q8c_ref(x, top2_idx, top2_probs, qexp: QuantizedExperts,
                           *, step=None, block_hidden: int = 1024,
                           residual: bool = False, ln_g=None,
                           ln_eps: float = 1e-6,
                           red_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Plain PyTorch version (any device, any float dtype). x [B,T,D];
    top2_idx/probs [S,2] tables with a ``step`` row selector, or single [2]
    rows; ``qexp`` the int8 experts. ``red_dtype`` is the accumulation type
    of the prenorm's sum of squares (float32 as in the kernel, or float64
    for a near-exact evaluation). Returns x.dtype [B,T,D]."""
    B, T, D = x.shape
    dt = x.dtype
    HH = qexp.w1_q.shape[-1] // 2
    TH = _hidden_block(HH, block_hidden)
    xm = x.reshape(B * T, D).float()
    if ln_g is not None:
        xm = _rmsnorm_rows(xm, ln_g, ln_eps, red_dtype).to(dt).float()
    acc = xm if residual else torch.zeros_like(xm)
    xq, sx = quant_rows(xm)
    idx, probs = _routing_row(top2_idx, top2_probs, step)
    for slot in range(2):
        e = idx[slot].to(qexp.w1_q.device)
        w1, s1 = qexp.w1_q[e], qexp.w1_s[e].float()
        b1 = qexp.b1[e].float()
        w2, s2 = qexp.w2_q[e], qexp.w2_s[e].float()
        p = probs[slot].to(x.device)
        for kb in range(HH // TH):
            vc = slice(kb * TH, (kb + 1) * TH)
            gc = slice(HH + kb * TH, HH + (kb + 1) * TH)
            value = dot_i8(xq, w1[:, vc]).float() * (sx * s1[vc][None]) + b1[vc]
            gate = dot_i8(xq, w1[:, gc]).float() * (sx * s1[gc][None]) + b1[gc]
            aq, sa = quant_rows(value * F.silu(gate))
            contrib = dot_i8(aq, w2[vc]).float() * (sa * s2[None])
            acc = acc + p * contrib
    return acc.to(dt).reshape(B, T, D)


_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int]
             + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    from ._build import load_library
    fn = load_library("fused_top2_mlp_q8c").fused_top2_mlp_q8c_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def fused_top2_mlp_q8c(x, top2_idx, top2_probs, qexp: QuantizedExperts, *,
                       step=None, block_hidden: int = 1024,
                       residual: bool = False, ln_g=None,
                       ln_eps: float = 1e-6) -> torch.Tensor:
    """The int8 top-2 MoE of x [B,T,D], optionally prenormed by ``ln_g``
    and seeded with its (prenormed) input (``residual``).

    CUDA tensors: one launch of the hand-written kernel (bf16 x, any token
    count, D and block_hidden multiples of 128). CPU tensors: the plain
    version ``fused_top2_mlp_q8c_ref``. Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_top2_mlp_q8c_ref(
            x, top2_idx, top2_probs, qexp, step=step,
            block_hidden=block_hidden, residual=residual, ln_g=ln_g,
            ln_eps=ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_top2_mlp_q8c runs on CUDA or CPU, not "
                         f"{x.device}")
    dev = x.device
    if x.ndim != 3:
        raise ValueError(f"x must be [B,T,D], got {tuple(x.shape)}")
    B, T, D = x.shape
    E, _, H2 = qexp.w1_q.shape
    HH = H2 // 2
    TH = _hidden_block(HH, block_hidden)
    _check_moe_widths(D, TH)
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    _check(x, "x", bf, (B, T, D), dev)
    if ln_g is not None:
        ln_g = ln_g.float().contiguous()
        _check(ln_g, "ln_g", f32, (D,), dev)
    b1 = qexp.b1.float().contiguous()
    for t, name, dtype, shape in (
            (qexp.w1_q, "w1_q", i8, (E, D, H2)),
            (qexp.w1_s, "w1_s", f32, (E, H2)), (b1, "b1", f32, (E, H2)),
            (qexp.w2_q, "w2_q", i8, (E, HH, D)),
            (qexp.w2_s, "w2_s", f32, (E, D))):
        _check(t, name, dtype, shape, dev)
    idx, probs, S, s = _tables(top2_idx, top2_probs, step)
    _check(idx, "top2_idx", torch.int32, (S, 2), dev)
    _check(probs, "top2_probs", f32, (S, 2), dev)

    M = B * T
    n_h = HH // TH

    def buf(*shape, dtype):
        return torch.empty(*shape, dtype=dtype, device=dev)

    xm = buf(M, D, dtype=bf) if ln_g is not None else None
    scratch = (xm, buf(M, D, dtype=i8), buf(M, dtype=f32),
               buf(2, M, HH, dtype=f32), buf(2, M, HH, dtype=i8),
               buf(2, M, n_h, dtype=f32), buf(2 * n_h, M, D, dtype=f32))
    out = buf(B, T, D, dtype=bf)
    ptrs = [None if t is None else t.data_ptr() for t in (
        x, ln_g, qexp.w1_q, qexp.w1_s, b1, qexp.w2_q, qexp.w2_s, idx, probs)]
    scr = [None if t is None else t.data_ptr() for t in (*scratch, out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(*ptrs, s, *scr, M, D, HH, TH, E, int(residual),
                          ln_eps, D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"fused_top2_mlp_q8c launch failed: CUDA error "
                           f"{err}")
    fused_top2_mlp_q8c.launches += 1
    return out


fused_top2_mlp_q8c.launches = 0
