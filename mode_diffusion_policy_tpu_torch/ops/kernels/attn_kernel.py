"""The attention sub-block of NoiseBlockMoE: CUDA kernels, wrappers and
plain versions, with bf16 or int8 projections.

Counterparts of ``mode_diffusion_policy_tpu/ops/pallas/attn_kernel.py``.
``fused_attn_block`` (the Pallas ``_kernel``) computes

    out = bf16(x + o @ wout),  o = bf16(attn(qk_norm(split(qkv))))
    qkv = bf16(rmsnorm(x) * g + c) @ wqkv + bqkv

and ``fused_attn_block_q8`` (the Pallas ``_kernel_q8``)

    out = x + dot_i8(q(o), wout_q) * (os * sout)
    o   = attn(qk_norm(split(dot_i8(hq, wqkv_q) * (hs * sqkv) + bqkv)))
    hq, hs = q(rmsnorm(x) * g + c)

each with its JAX kernel's cast chain. Both: the norm in f32, q and k
head-RMS-normed in f32 and cast to the compute dtype, v cast, the causal
softmax within each sample in f32 and cast before the product with v,
``x + y`` summed in f32 and written in x.dtype. bf16 projections: ``h`` is
cast to the compute dtype before the QKV product, ``o`` before c_proj.
int8 projections: ``h`` stays f32 and is quantized per row, ``o`` stays f32
and is re-quantized per row. The cond ``c`` is one shared [1,1,D] row (the
hoisted routed path), one row per sample [B,1,D] (an inline call, the
samplers' off-schedule evaluations) or one per token [B,T,D], rounded to
x.dtype as the JAX kernels take it.

``fused_attn_block`` and ``fused_attn_block_q8`` launch
``csrc/fused_attn_block.cu`` and ``csrc/fused_attn_block_q8.cu`` for CUDA
tensors (and raise on what they cannot take: a per-token cond among
others) and run the plain versions, ``fused_attn_block_ref`` and
``fused_attn_block_q8_ref``, only for CPU tensors. Their ``.launches``
count kernel launches.
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


def fused_attn_block_ref(x, c, ln_g, wqkv, bqkv, q_g, k_g, wout, *,
                         ln_eps: float = 1e-6, qk_eps: float = 1e-6,
                         acc_dtype: torch.dtype = torch.float32,
                         red_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain PyTorch version (any device, any float dtype). x [B,T,D];
    c [1,1,D], [B,1,D] or [B,T,D]; wqkv [D,3D] (+bias [3D]), cast to
    x.dtype; q_g/k_g [hd]; wout [D,D], cast to x.dtype. ``acc_dtype`` is the
    accumulation type of the compute-dtype products (QKV, attention,
    c_proj) and ``red_dtype`` that of the norms' sums of squares and the
    softmax: float32 as in the kernel, or float64 for near-exact evaluations
    of the same cast chain. Returns x.dtype [B,T,D]."""
    B, T, D = x.shape
    dt = x.dtype

    def mm(a, b):
        return torch.matmul(a.to(acc_dtype), b.to(acc_dtype)).float()

    x32 = x.reshape(B * T, D).float()
    h = _rmsnorm_rows(x32, ln_g, ln_eps, red_dtype) + _cond_rows(c, x)
    qkv = mm(h.to(dt).float(), wqkv.to(dt)) + bqkv.float()
    o = _attend(qkv, q_g, k_g, B, T, dt, qk_eps, acc_dtype, red_dtype)
    y = mm(o.to(dt).float(), wout.to(dt))
    return (x32 + y).to(dt).reshape(B, T, D)


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


_ARGTYPES = {
    "fused_attn_block": ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                         + [ctypes.c_float] * 5 + [ctypes.c_void_p]),
    "fused_attn_block_q8": ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 5
                            + [ctypes.c_float] * 5 + [ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=None)
def _launcher(name):
    from ._build import load_library
    fn = getattr(load_library(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _prepare(name, x, c, ln_g, q_g, k_g):
    """Device and shape checks shared by both wrappers. Returns (B, T, D,
    H, hd, the cond rows as f32 [1 or B, D] rounded through x.dtype, their
    stride per sample, ln_g, q_g, k_g as contiguous f32)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, not {x.device}")
    if x.ndim != 3:
        raise ValueError(f"x must be [B,T,D], got {tuple(x.shape)}")
    B, T, D = x.shape
    hd = q_g.shape[-1]
    H = D // hd
    c_stride = _check_attn_widths(T, D, H, hd, c, B)
    _check(x, "x", torch.bfloat16, (B, T, D), x.device)
    c = c.reshape(-1, D).to(x.dtype).float().contiguous()
    f32 = [t.float().contiguous() for t in (ln_g, q_g, k_g)]
    for t, n, shape in ((c, "c", (B if c_stride else 1, D)),
                        (f32[0], "ln_g", (D,)), (f32[1], "q_g", (hd,)),
                        (f32[2], "k_g", (hd,))):
        _check(t, n, torch.float32, shape, x.device)
    return (B, T, D, H, hd, c, c_stride, *f32)


def _launch(name, ptrs, ints, x, ln_eps, qk_eps, D, hd):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher(name)(*ptrs, *ints, ln_eps, qk_eps, D ** -0.5,
                              hd ** -0.5, float(1.0 / math.sqrt(hd)), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def fused_attn_block(x, c, ln_g, wqkv, bqkv, q_g, k_g, wout, *,
                     ln_eps: float = 1e-6,
                     qk_eps: float = 1e-6) -> torch.Tensor:
    """``x + attn(ln_1(x) + c)`` with bf16 QKV and c_proj.

    CUDA tensors: one launch of the hand-written kernel (bf16 x, a shared
    [1,1,D] cond row or one per sample [B,1,D], T <= 16 tokens per sample,
    head dim a multiple of 32); a per-token cond raises. CPU tensors: the
    plain version ``fused_attn_block_ref``. Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_attn_block_ref(x, c, ln_g, wqkv, bqkv, q_g, k_g, wout,
                                    ln_eps=ln_eps, qk_eps=qk_eps)
    B, T, D, H, hd, c, c_stride, ln_g, q_g, k_g = _prepare(
        "fused_attn_block", x, c, ln_g, q_g, k_g)
    dev, bf = x.device, torch.bfloat16
    wqkv, wout = wqkv.to(bf), wout.to(bf)
    bqkv = bqkv.float().contiguous()
    for t, name, dtype, shape in ((wqkv, "wqkv", bf, (D, 3 * D)),
                                  (bqkv, "bqkv", torch.float32, (3 * D,)),
                                  (wout, "wout", bf, (D, D))):
        _check(t, name, dtype, shape, dev)
    M = B * T
    out = torch.empty(B, T, D, dtype=bf, device=dev)
    scratch = (torch.empty(M, D, dtype=bf, device=dev),
               torch.empty(M, 3 * D, dtype=torch.float32, device=dev),
               torch.empty(M, D, dtype=bf, device=dev))
    ptrs = [t.data_ptr() for t in (x, c, ln_g, wqkv, bqkv, q_g, k_g, wout,
                                   *scratch, out)]
    _launch("fused_attn_block", ptrs, (B, T, D, H, c_stride), x, ln_eps,
            qk_eps, D, hd)
    fused_attn_block.launches += 1
    return out


fused_attn_block.launches = 0


def fused_attn_block_q8(x, c, ln_g, qattn: QuantizedAttn, q_g, k_g, *,
                        ln_eps: float = 1e-6,
                        qk_eps: float = 1e-6) -> torch.Tensor:
    """``x + attn(ln_1(x) + c)`` with int8 QKV and c_proj.

    CUDA tensors: one launch of the hand-written kernel (bf16 x, a shared
    [1,1,D] cond row or one per sample [B,1,D], T <= 16 tokens per sample,
    head dim a multiple of 32); a per-token cond raises. CPU tensors: the
    plain version ``fused_attn_block_q8_ref``. Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_attn_block_q8_ref(x, c, ln_g, qattn, q_g, k_g,
                                       ln_eps=ln_eps, qk_eps=qk_eps)
    B, T, D, H, hd, c, c_stride, ln_g, q_g, k_g = _prepare(
        "fused_attn_block_q8", x, c, ln_g, q_g, k_g)
    dev, f32, i8 = x.device, torch.float32, torch.int8
    for t, name, dtype, shape in (
            (qattn.wqkv_q, "wqkv_q", i8, (D, 3 * D)),
            (qattn.wqkv_s, "wqkv_s", f32, (3 * D,)),
            (qattn.bqkv, "bqkv", f32, (3 * D,)),
            (qattn.wout_q, "wout_q", i8, (D, D)),
            (qattn.wout_s, "wout_s", f32, (D,))):
        _check(t, name, dtype, shape, dev)

    M = B * T

    def buf(*shape, dtype):
        return torch.empty(*shape, dtype=dtype, device=dev)

    out = buf(B, T, D, dtype=torch.bfloat16)
    scratch = (buf(M, D, dtype=i8), buf(M, dtype=f32),
               buf(M, 3 * D, dtype=f32), buf(M, D, dtype=f32),
               buf(M, D, dtype=i8), buf(M, dtype=f32))
    ptrs = [t.data_ptr() for t in (x, c, ln_g, qattn.wqkv_q, qattn.wqkv_s,
                                   qattn.bqkv, q_g, k_g, qattn.wout_q,
                                   qattn.wout_s, *scratch, out)]
    _launch("fused_attn_block_q8", ptrs, (B, T, D, H, c_stride), x, ln_eps,
            qk_eps, D, hd)
    fused_attn_block_q8.launches += 1
    return out


fused_attn_block_q8.launches = 0
