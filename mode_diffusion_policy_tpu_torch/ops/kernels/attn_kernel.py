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
tensors, with any of the three cond shapes and any number of tokens per
sample (raising on what they cannot take), and run the plain versions,
``fused_attn_block_ref`` and ``fused_attn_block_q8_ref``, only for CPU
tensors. Their ``.launches``
count kernel launches. Both kernels' projections run on wgmma tiles over
persistent CTAs (``csrc/wgmma_stages.cuh`` Proj), and the wrappers choose
the tiles by token count (``proj_tile_plan``), the plan of the whole-layer
kernel and the megakernel at the same row count. The bf16 kernel reads its
weights as they are stored; the int8 kernel reads the K-major copy of the
int8 weights (``quant.kmajor_attn``, made once per quantization by
``MoDeDiT.quantize_attn_``), which the plain version takes too, with the
same result.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..quant import AttnKMajor, QuantizedAttn
from ._common import (_attend, _check, _check_attn_widths, _cond_rows,
                      _rmsnorm_rows, _scratch, no_autodiff)
from .moe_kernel import WIDE_TILE_ROWS, launch_error, sm_count
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
                            red_dtype: torch.dtype = torch.float32,
                            qattn_t: AttnKMajor = None) -> torch.Tensor:
    """Plain PyTorch version (any device, any float dtype). x [B,T,D];
    c one shared [1,1,D] row or one per sample or token ([B,1,D],
    [B,T,D]); ``qattn`` the int8 projections; q_g/k_g [hd]. ``acc_dtype``
    is the accumulation type of the attention's compute-dtype products and
    ``red_dtype`` that of the norms' sums of squares and the softmax:
    float32 as in the kernel, or float64 for near-exact evaluations of the
    same cast chain. With ``qattn_t`` (``kmajor_attn(qattn)``) the products
    read the int8 weights from that K-major copy, as the CUDA kernel does,
    with the same result. Returns x.dtype [B,T,D]."""
    B, T, D = x.shape
    if qattn_t is None:
        wqkv, wout = qattn.wqkv_q, qattn.wout_q
    else:
        wqkv, wout = qattn_t.wqkv_t.T, qattn_t.wout_t.T
    x32 = x.reshape(B * T, D).float()
    h = _rmsnorm_rows(x32, ln_g, ln_eps, red_dtype) + _cond_rows(c, x)
    hq, hs = quant_rows(h)
    qkv = dot_i8(hq, wqkv).float() \
        * (hs * qattn.wqkv_s.float()[None]) + qattn.bqkv.float()
    o = _attend(qkv, q_g, k_g, B, T, x.dtype, qk_eps, acc_dtype, red_dtype)
    oq, os_ = quant_rows(o)
    y = dot_i8(oq, wout).float() * (os_ * qattn.wout_s.float()[None])
    return (x32 + y).to(x.dtype).reshape(B, T, D)


class ProjTilePlan(NamedTuple):
    """How one projection (QKV or c_proj; bf16 or int8) of the attention
    kernels, ``fused_layer_q8c`` and ``fused_dit_q8c`` covers its output
    [M, N] with wgmma tiles (``csrc/wgmma_stages.cuh`` Proj)."""

    tile_m: int      # rows of an output tile: 128 or 64
    tile_n: int      # columns of an output tile: 128 or 64
    ctas: int        # persistent CTAs at most (the card's SMs)
    n_mt: int        # row tiles over the M token rows
    n_nt: int        # column tiles over the N outputs
    tiles: int       # n_mt x n_nt


def proj_tile_plan(M: int, N: int, ctas: int, tile_m: int = None,
                   tile_n: int = None) -> ProjTilePlan:
    """The plan for M token rows and N output columns: 128 x 128 tiles
    above 256 token rows (as the MoE stages), 64 x 64 below, unless
    ``tile_m``/``tile_n`` say otherwise (64 or 128 each)."""
    wide = 128 if M > WIDE_TILE_ROWS else 64
    tm, tn = tile_m or wide, tile_n or wide
    if tm not in (64, 128) or tn not in (64, 128) or N % tn:
        raise ValueError(f"no projection tiles of {tm} x {tn} for N={N}")
    n_mt, n_nt = -(-M // tm), N // tn
    return ProjTilePlan(tm, tn, ctas, n_mt, n_nt, n_mt * n_nt)


def proj_tiles(plan: ProjTilePlan, M: int):
    """Every output tile of a projection as the kernel decodes tile t
    (column tile fastest, then row tile) and hands it to CTA t % grid:
    yields (cta, row range, column range)."""
    grid = min(plan.ctas, plan.tiles)
    for t in range(plan.tiles):
        nt, mt = t % plan.n_nt, t // plan.n_nt
        yield (t % grid, range(mt * plan.tile_m, min(M, (mt + 1) * plan.tile_m)),
               range(nt * plan.tile_n, (nt + 1) * plan.tile_n))


def proj_launch_args(M: int, D: int, device, tiles=None):
    """The launchers' plan arguments for the two projections of M
    token rows on a CUDA ``device`` (one CTA per SM): QKV tile rows,
    columns, c_proj tile rows, columns, CTAs. ``tiles``: the first four,
    or None for the default plans (``proj_tile_plan``); a tuning knob. The
    int8 products' exact sums do not depend on it; the bf16 products sum in
    the tensor core's order, which ``chip_smoke.py`` checks under each
    plan."""
    tm1, tn1, tm2, tn2 = tiles or (None,) * 4
    ctas = sm_count(device.index or 0)
    qkv = proj_tile_plan(M, 3 * D, ctas, tm1, tn1)
    out = proj_tile_plan(M, D, ctas, tm2, tn2)
    return [qkv.tile_m, qkv.tile_n, out.tile_m, out.tile_n, ctas]


_ARGTYPES = {
    "fused_attn_block": ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                         + [ctypes.c_float] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p]),
    "fused_attn_block_q8": ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 5
                            + [ctypes.c_float] * 5 + [ctypes.c_int] * 5
                            + [ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=None)
def _launcher(name):
    from ._build import load_library
    fn = getattr(load_library(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _prepare(name, x, c, ln_g, q_g, k_g, c_dtype=torch.float32):
    """Device and shape checks shared by both wrappers. Returns (B, T, D,
    H, hd, the cond rows [1, B or B*T, D] rounded to x.dtype, in ``c_dtype``
    (f32, or x.dtype itself for the int8 kernel), their count, ln_g, q_g,
    k_g as contiguous f32)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, not {x.device}")
    if x.ndim != 3:
        raise ValueError(f"x must be [B,T,D], got {tuple(x.shape)}")
    B, T, D = x.shape
    hd = q_g.shape[-1]
    H = D // hd
    c_rows = _check_attn_widths(T, D, H, hd, c, B)
    _check(x, "x", torch.bfloat16, (B, T, D), x.device)
    c = c.reshape(-1, D).to(x.dtype).to(c_dtype).contiguous()
    _check(c, "c", c_dtype, (c_rows, D), x.device)
    f32 = [t.float().contiguous() for t in (ln_g, q_g, k_g)]
    for t, n, shape in ((f32[0], "ln_g", (D,)), (f32[1], "q_g", (hd,)),
                        (f32[2], "k_g", (hd,))):
        _check(t, n, torch.float32, shape, x.device)
    return (B, T, D, H, hd, c, c_rows, *f32)


def _launch(name, ptrs, ints, x, ln_eps, qk_eps, D, hd, tail=()):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher(name)(*ptrs, *ints, ln_eps, qk_eps, D ** -0.5,
                              hd ** -0.5, float(1.0 / math.sqrt(hd)), *tail,
                              stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {launch_error(err)}")


def fused_attn_block(x, c, ln_g, wqkv, bqkv, q_g, k_g, wout, *,
                     ln_eps: float = 1e-6, qk_eps: float = 1e-6,
                     tiles=None) -> torch.Tensor:
    """``x + attn(ln_1(x) + c)`` with bf16 QKV and c_proj.

    CUDA tensors: one launch of the hand-written kernel (bf16 x, a shared
    [1,1,D] cond row, one per sample [B,1,D] or one per token [B,T,D], any
    T >= 1 tokens per sample, head dim a multiple of 32 up to 512). ``tiles`` (QKV rows, columns, c_proj rows, columns;
    64 or 128 each) overrides the
    projections' tile plan (``proj_launch_args``): the default plan is the
    one under which the kernel equals ``fused_layer_q8c``'s attention
    bit for bit. CPU tensors: the plain version ``fused_attn_block_ref``.
    Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_attn_block_ref(x, c, ln_g, wqkv, bqkv, q_g, k_g, wout,
                                    ln_eps=ln_eps, qk_eps=qk_eps)
    no_autodiff("fused_attn_block", x, c, ln_g, wqkv, bqkv, q_g, k_g, wout)
    B, T, D, H, hd, c, c_rows, ln_g, q_g, k_g = _prepare(
        "fused_attn_block", x, c, ln_g, q_g, k_g)
    dev, bf = x.device, torch.bfloat16
    wqkv, wout = wqkv.to(bf), wout.to(bf)
    bqkv = bqkv.float().contiguous()
    for t, name, dtype, shape in ((wqkv, "wqkv", bf, (D, 3 * D)),
                                  (bqkv, "bqkv", torch.float32, (3 * D,)),
                                  (wout, "wout", bf, (D, D))):
        _check(t, name, dtype, shape, dev)
    M = B * T
    plan = proj_launch_args(M, D, dev, tiles)
    out = torch.empty(B, T, D, dtype=bf, device=dev)
    # h, qkv, o
    keep, scratch = _scratch(dev, 2 * M * D, 4 * M * 3 * D, 2 * M * D)
    ptrs = [t.data_ptr() for t in (x, c, ln_g, wqkv, bqkv, q_g, k_g, wout)]
    _launch("fused_attn_block", ptrs + scratch + [out.data_ptr()],
            (B, T, D, H, c_rows), x, ln_eps, qk_eps, D, hd, plan)
    fused_attn_block.launches += 1
    return out


fused_attn_block.launches = 0


def check_kmajor_attn(qattn: QuantizedAttn, qattn_t: AttnKMajor, D, dev):
    """The CUDA int8 attention's weight checks: the column scales and bias
    of ``qattn``, the int8 weights of its K-major copy ``qattn_t``."""
    f32, i8 = torch.float32, torch.int8
    for t, name, dtype, shape in (
            (qattn_t.wqkv_t, "wqkv_t", i8, (3 * D, D)),
            (qattn.wqkv_s, "wqkv_s", f32, (3 * D,)),
            (qattn.bqkv, "bqkv", f32, (3 * D,)),
            (qattn_t.wout_t, "wout_t", i8, (D, D)),
            (qattn.wout_s, "wout_s", f32, (D,))):
        _check(t, name, dtype, shape, dev)


def attn_q8_scratch(M, D):
    """Bytes of the int8 attention stages' scratch over M rows: hq, hs,
    qkv (f32), o (f32), oq, os."""
    return M * D, 4 * M, 4 * M * 3 * D, 4 * M * D, M * D, 4 * M


def need_kmajor_attn(name, qattn_t):
    if qattn_t is None:
        raise ValueError(
            f"{name} on CUDA reads the K-major copy of the int8 projections: "
            "pass qattn_t=kmajor_attn(qattn) (made once per quantization by "
            "MoDeDiT.quantize_attn_)")


def fused_attn_block_q8(x, c, ln_g, qattn: QuantizedAttn, q_g, k_g, *,
                        ln_eps: float = 1e-6, qk_eps: float = 1e-6,
                        qattn_t: AttnKMajor = None,
                        tiles=None) -> torch.Tensor:
    """``x + attn(ln_1(x) + c)`` with int8 QKV and c_proj.

    CUDA tensors: one launch of the hand-written kernel (bf16 x, a shared
    [1,1,D] cond row, one per sample [B,1,D] or one per token [B,T,D], any
    T >= 1 tokens per sample, head dim a multiple of 32 up to 512), which needs ``qattn_t``, the K-major copy of the int8
    projections. ``tiles`` (QKV rows,
    columns, c_proj rows, columns; 64 or 128 each) overrides the
    projections' tile plan (``proj_launch_args``). CPU tensors: the plain
    version ``fused_attn_block_q8_ref``. Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_attn_block_q8_ref(x, c, ln_g, qattn, q_g, k_g,
                                       ln_eps=ln_eps, qk_eps=qk_eps,
                                       qattn_t=qattn_t)
    no_autodiff("fused_attn_block_q8", x, c, ln_g, qattn, q_g, k_g, qattn_t)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attn_block_q8 runs on CUDA or CPU, not "
                         f"{x.device}")
    need_kmajor_attn("fused_attn_block_q8", qattn_t)
    B, T, D, H, hd, c, c_rows, ln_g, q_g, k_g = _prepare(
        "fused_attn_block_q8", x, c, ln_g, q_g, k_g, c_dtype=x.dtype)
    dev = x.device
    check_kmajor_attn(qattn, qattn_t, D, dev)

    M = B * T
    plan = proj_launch_args(M, D, dev, tiles)
    out = torch.empty(B, T, D, dtype=torch.bfloat16, device=dev)
    keep, scratch = _scratch(dev, *attn_q8_scratch(M, D))
    ptrs = [t.data_ptr() for t in (x, c, ln_g, qattn_t.wqkv_t, qattn.wqkv_s,
                                   qattn.bqkv, q_g, k_g, qattn_t.wout_t,
                                   qattn.wout_s)]
    _launch("fused_attn_block_q8", ptrs + scratch + [out.data_ptr()],
            (B, T, D, H, c_rows), x, ln_eps, qk_eps, D, hd, plan)
    fused_attn_block_q8.launches += 1
    return out


fused_attn_block_q8.launches = 0
