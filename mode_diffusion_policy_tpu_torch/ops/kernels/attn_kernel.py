"""The attention sub-block of NoiseBlockMoE with int8 projections: CUDA
kernel, wrapper and plain version.

Counterpart of ``mode_diffusion_policy_tpu/ops/pallas/attn_kernel.py::
fused_attn_block_q8`` (the Pallas ``_kernel_q8``). It computes

    out = x + dot_i8(q(o), wout_q) * (os * sout)
    o   = attn(qk_norm(split(dot_i8(hq, wqkv_q) * (hs * sqkv) + bqkv)))
    hq, hs = q(rmsnorm(x) * g + c)

with the JAX kernel's cast chain: ``h`` stays f32 (no cast to the compute
dtype) and is quantized per row; q and k are head-RMS-normed and cast to
the compute dtype, v is cast, the causal softmax within each sample is cast
before the product with v; ``o`` stays f32 and is re-quantized per row;
``x + y`` is summed in f32 and written in x.dtype.

``fused_attn_block_q8`` launches ``csrc/fused_attn_block_q8.cu`` for CUDA
tensors (and raises on what it cannot take) and runs the plain version,
``fused_attn_block_q8_ref``, only for CPU tensors.
``fused_attn_block_q8.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..quant import QuantizedAttn
from ._common import (_attend, _check, _check_attn_widths, _cond_rows,
                      _rmsnorm_rows)
from .quant_math import dot_i8, quant_rows


def fused_attn_block_q8_ref(x, c, ln_g, qattn: QuantizedAttn, q_g, k_g, *,
                            ln_eps: float = 1e-6, qk_eps: float = 1e-6,
                            acc_dtype: torch.dtype = torch.float32,
                            red_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Plain PyTorch version (any device, any float dtype). x [B,T,D];
    c one shared [1,1,D] row or one per sample or token ([B,1,D],
    [B,T,D]); ``qattn`` the int8 projections; q_g/k_g [hd]. ``acc_dtype``
    is the accumulation type of the attention's compute-dtype products and
    ``red_dtype`` that of the norms' sums of squares and the softmax:
    float32 as in the kernel, or float64 for near-exact evaluations of the
    same cast chain. Returns x.dtype [B,T,D]."""
    B, T, D = x.shape
    x32 = x.reshape(B * T, D).float()
    h = _rmsnorm_rows(x32, ln_g, ln_eps, red_dtype) + _cond_rows(c, x)
    hq, hs = quant_rows(h)
    qkv = dot_i8(hq, qattn.wqkv_q).float() \
        * (hs * qattn.wqkv_s.float()[None]) + qattn.bqkv.float()
    o = _attend(qkv, q_g, k_g, B, T, x.dtype, qk_eps, acc_dtype, red_dtype)
    oq, os_ = quant_rows(o)
    y = dot_i8(oq, qattn.wout_q).float() * (os_ * qattn.wout_s.float()[None])
    return (x32 + y).to(x.dtype).reshape(B, T, D)


_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 5 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    from ._build import load_library
    fn = load_library("fused_attn_block_q8").fused_attn_block_q8_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def fused_attn_block_q8(x, c, ln_g, qattn: QuantizedAttn, q_g, k_g, *,
                        ln_eps: float = 1e-6,
                        qk_eps: float = 1e-6) -> torch.Tensor:
    """``x + attn(ln_1(x) + c)`` with int8 QKV and c_proj.

    CUDA tensors: one launch of the hand-written kernel (bf16 x, a shared
    [1,1,D] cond row, T <= 16 tokens per sample, head dim a multiple of 32);
    a per-sample or per-token cond raises. CPU tensors: the plain version
    ``fused_attn_block_q8_ref``. Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_attn_block_q8_ref(x, c, ln_g, qattn, q_g, k_g,
                                       ln_eps=ln_eps, qk_eps=qk_eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attn_block_q8 runs on CUDA or CPU, not "
                         f"{x.device}")
    dev = x.device
    if x.ndim != 3:
        raise ValueError(f"x must be [B,T,D], got {tuple(x.shape)}")
    B, T, D = x.shape
    hd = q_g.shape[-1]
    H = D // hd
    _check_attn_widths(T, D, H, hd, c)
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    _check(x, "x", bf, (B, T, D), dev)
    c = c.reshape(D).to(x.dtype).float().contiguous()
    ln_g = ln_g.float().contiguous()
    q_g = q_g.float().contiguous()
    k_g = k_g.float().contiguous()
    for t, name, dtype, shape in (
            (c, "c", f32, (D,)), (ln_g, "ln_g", f32, (D,)),
            (q_g, "q_g", f32, (hd,)), (k_g, "k_g", f32, (hd,)),
            (qattn.wqkv_q, "wqkv_q", i8, (D, 3 * D)),
            (qattn.wqkv_s, "wqkv_s", f32, (3 * D,)),
            (qattn.bqkv, "bqkv", f32, (3 * D,)),
            (qattn.wout_q, "wout_q", i8, (D, D)),
            (qattn.wout_s, "wout_s", f32, (D,))):
        _check(t, name, dtype, shape, dev)

    M = B * T

    def buf(*shape, dtype):
        return torch.empty(*shape, dtype=dtype, device=dev)

    out = buf(B, T, D, dtype=bf)
    scratch = (buf(M, D, dtype=i8), buf(M, dtype=f32),
               buf(M, 3 * D, dtype=f32), buf(M, D, dtype=f32),
               buf(M, D, dtype=i8), buf(M, dtype=f32))
    ptrs = [t.data_ptr() for t in (x, c, ln_g, qattn.wqkv_q, qattn.wqkv_s,
                                   qattn.bqkv, q_g, k_g, qattn.wout_q,
                                   qattn.wout_s, *scratch, out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(*ptrs, B, T, D, H, ln_eps, qk_eps, D ** -0.5,
                          hd ** -0.5, float(1.0 / math.sqrt(hd)), stream)
    if err != 0:
        raise RuntimeError(f"fused_attn_block_q8 launch failed: CUDA error "
                           f"{err}")
    fused_attn_block_q8.launches += 1
    return out


fused_attn_block_q8.launches = 0
