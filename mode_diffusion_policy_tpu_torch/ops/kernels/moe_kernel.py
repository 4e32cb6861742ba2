"""The top-2 SwishGLU MoE of NoiseBlockMoE: CUDA kernels, wrappers and plain
versions, for int8 x int8 compute and for bf16 compute (bf16 or int8
expert weights).

Counterparts of ``mode_diffusion_policy_tpu/ops/pallas/moe_kernel.py``.
``fused_top2_mlp_q8c`` (the Pallas ``_kernel_q8c``) computes, for the
routing row ``step`` of the [S,2] tables (or single [2] rows),

    out   = seed + sum_{e in top2} sum_k p_e * dot_i8(q(act_e,k), W2_e,k) * s
    act_e = value * silu(gate),  [value | gate] = dot_i8(q(xm), W1_e) * s + b1
    xm    = rmsnorm(x) * ln_g cast to x.dtype, or x itself without ln_g
    seed  = xm with ``residual``, else 0

with the JAX kernel's cast chain: the MoE input quantized once per row,
``act`` re-quantized per row within each ``block_hidden`` column block, the
(slot, block) contributions added to the f32 accumulator in the JAX order,
and the sum written in x.dtype.

``fused_top2_mlp`` (the Pallas ``_kernel``) is the bf16-compute MoE of the
bf16 kernel configuration, with the same prenorm, seed and order:

    out   = seed + sum_{e in top2} sum_k p_e * (act_e,k W2_e,k)
    act_e = dt(value * silu(gate)),  [value | gate] = xm W1_e + b1

(products in the compute dtype ``dt`` = x.dtype, f32 accumulation), and
``fused_top2_mlp_q8`` (the Pallas ``_kernel_q8``) the same with int8
expert weights cast to ``dt`` in each product and their per-channel scales
applied after it: ``value = (xm W1v) * s1v + b1v``, ``contrib = (act W2) *
s2``.

All four MoE kernels (these three and the whole-layer kernel of
layer_kernel.py) run their expert products on wgmma tiles over persistent
CTAs; the wrappers choose the tiles by token count and pass the plan
(``moe_tile_plan``) to the launchers. The int8 x int8 products read the
K-major copy of the int8 experts (``quant.kmajor_experts``, made once per
quantization by ``MoDeDiT.quantize_experts_``), which the CUDA wrappers of
``fused_top2_mlp_q8c`` and ``fused_layer_q8c`` take as ``qexp_t``.

``fused_top2_mlp_q8c`` launches ``csrc/fused_top2_mlp_q8c.cu``,
``fused_top2_mlp`` and ``fused_top2_mlp_q8`` launch the two entry points
of ``csrc/fused_top2_mlp.cu``, for CUDA tensors (and raise on what they
cannot take); each runs its plain version (``..._ref``) only for CPU
tensors. Their ``.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..quant import ExpertsKMajor, QuantizedExperts
from ._common import (_check, _check_moe_widths, _hidden_block, _scratch,
                      _rmsnorm_rows, _routing_row, _tables, no_autodiff)
from .quant_math import dot_i8, quant_rows


def _moe_ref(x, top2_idx, top2_probs, w1, b1, w2, s1, s2, block_hidden,
             residual, ln_g, ln_eps, acc_dtype, red_dtype):
    """The bf16-compute MoE of ``fused_top2_mlp_ref`` (``s1 = s2 = None``)
    and ``fused_top2_mlp_q8_ref`` (int8 ``w1``/``w2`` with their scales)
    for the routing row (idx [2], p [2])."""
    B, T, D = x.shape
    dt = x.dtype
    HH = w1.shape[-1] // 2
    TH = _hidden_block(HH, block_hidden)
    xm = x.reshape(B * T, D)
    if ln_g is not None:
        xm = _rmsnorm_rows(xm.float(), ln_g, ln_eps, red_dtype).to(dt)
    acc = xm.float() if residual else torch.zeros(B * T, D, device=x.device)

    def mm(a, b):
        # int8 weights are cast to the compute dtype first (exact in bf16)
        if b.dtype == torch.int8:
            b = b.to(dt)
        return torch.matmul(a.to(acc_dtype), b.to(acc_dtype)).float()

    idx, probs = top2_idx, top2_probs
    for slot in range(2):
        e = idx[slot].to(w1.device)
        p = probs[slot].to(x.device)
        for kb in range(HH // TH):
            vc = slice(kb * TH, (kb + 1) * TH)
            gc = slice(HH + kb * TH, HH + (kb + 1) * TH)
            value, gate = mm(xm, w1[e][:, vc]), mm(xm, w1[e][:, gc])
            if s1 is not None:
                value = value * s1[e][vc].float()
                gate = gate * s1[e][gc].float()
            value = value + b1[e][vc].float()
            gate = gate + b1[e][gc].float()
            act = (value * F.silu(gate)).to(dt)
            contrib = mm(act, w2[e][vc])
            if s2 is not None:
                contrib = contrib * s2[e].float()
            acc = acc + p * contrib
    return acc.to(dt).reshape(B, T, D)


def fused_top2_mlp_ref(x, top2_idx, top2_probs, w1, b1, w2, *, step=None,
                       block_hidden: int = 1024, residual: bool = False,
                       ln_g=None, ln_eps: float = 1e-6,
                       acc_dtype: torch.dtype = torch.float32,
                       red_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Plain PyTorch version of the bf16-compute MoE (any device, any float
    dtype). x [B,T,D]; top2_idx/probs [S,2] tables with a ``step`` row
    selector, or single [2] rows; w1 [E,D,2H], b1 [E,2H], w2 [E,H,D], cast
    to x.dtype for the products. ``acc_dtype`` is the accumulation type of
    the products and ``red_dtype`` that of the prenorm's sum of squares:
    float32 as in the kernel, or float64 for near-exact evaluations of the
    same cast chain. Returns x.dtype [B,T,D]."""
    idx, probs = _routing_row(top2_idx, top2_probs, step)
    return _moe_ref(x, idx, probs, w1, b1, w2, None, None, block_hidden,
                    residual, ln_g, ln_eps, acc_dtype, red_dtype)


def fused_top2_mlp_q8_ref(x, top2_idx, top2_probs, qexp: QuantizedExperts,
                          *, step=None, block_hidden: int = 1024,
                          residual: bool = False, ln_g=None,
                          ln_eps: float = 1e-6,
                          acc_dtype: torch.dtype = torch.float32,
                          red_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Plain PyTorch version of the int8-weight, bf16-compute MoE: as
    ``fused_top2_mlp_ref`` with the int8 experts ``qexp`` cast to x.dtype
    in each product and their scales applied after it."""
    idx, probs = _routing_row(top2_idx, top2_probs, step)
    return _moe_ref(x, idx, probs, qexp.w1_q, qexp.b1, qexp.w2_q, qexp.w1_s,
                    qexp.w2_s, block_hidden, residual, ln_g, ln_eps,
                    acc_dtype, red_dtype)


def fused_top2_mlp_q8c_ref(x, top2_idx, top2_probs, qexp: QuantizedExperts,
                           *, step=None, block_hidden: int = 1024,
                           residual: bool = False, ln_g=None,
                           ln_eps: float = 1e-6,
                           red_dtype: torch.dtype = torch.float32,
                           qexp_t: ExpertsKMajor = None,
                           mlp_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Plain PyTorch version (any device, any float dtype). x [B,T,D];
    top2_idx/probs [S,2] tables with a ``step`` row selector, or single [2]
    rows; ``qexp`` the int8 experts. ``red_dtype`` is the accumulation type
    of the prenorm's sum of squares and ``mlp_dtype`` the type of the float
    arithmetic around the int8 products (dequantization, bias, SiLU, the
    gate-weighted sum): float32 as in the kernel, or float64 for
    near-exact evaluations. With ``qexp_t`` (``kmajor_experts(qexp)``)
    the products read the int8 weights from that K-major copy, as the
    CUDA kernels do, with the same result. Returns x.dtype [B,T,D]."""
    B, T, D = x.shape
    dt = x.dtype
    HH = qexp.w1_q.shape[-1] // 2
    TH = _hidden_block(HH, block_hidden)
    xm = x.reshape(B * T, D).float()
    if ln_g is not None:
        xm = _rmsnorm_rows(xm, ln_g, ln_eps, red_dtype).to(dt).float()
    acc = (xm if residual else torch.zeros_like(xm)).to(mlp_dtype)
    xq, sx = quant_rows(xm)
    sx = sx.to(mlp_dtype)
    idx, probs = _routing_row(top2_idx, top2_probs, step)
    for slot in range(2):
        e = idx[slot].to(qexp.w1_q.device)
        if qexp_t is None:
            w1, w2 = qexp.w1_q[e], qexp.w2_q[e]
        else:
            w1, w2 = qexp_t.w1_t[e].T, qexp_t.w2_t[e].T
        s1, b1, s2 = (qexp.w1_s[e].to(mlp_dtype),
                      qexp.b1[e].to(mlp_dtype), qexp.w2_s[e].to(mlp_dtype))
        p = probs[slot].to(x.device, mlp_dtype)
        for kb in range(HH // TH):
            vc = slice(kb * TH, (kb + 1) * TH)
            gc = slice(HH + kb * TH, HH + (kb + 1) * TH)
            value = (dot_i8(xq, w1[:, vc]).to(mlp_dtype)
                     * (sx * s1[vc][None]) + b1[vc])
            gate = (dot_i8(xq, w1[:, gc]).to(mlp_dtype)
                    * (sx * s1[gc][None]) + b1[gc])
            aq, sa = quant_rows(value * F.silu(gate))
            contrib = dot_i8(aq, w2[vc]).to(mlp_dtype) * (sa.to(mlp_dtype)
                                                          * s2[None])
            acc = acc + p * contrib
    return acc.to(dt).reshape(B, T, D)


class MoeTilePlan(NamedTuple):
    """How the wgmma expert products of ``fused_top2_mlp(_q8)``,
    ``fused_top2_mlp_q8c`` and ``fused_layer_q8c`` cover their outputs
    (``csrc/wgmma_stages.cuh``)."""

    tile: int        # rows and columns of an output tile: 128 or 64
    ctas: int        # persistent CTAs per stage at most (the card's SMs)
    n_mt: int        # row tiles over the M token rows
    up_tiles: int    # 2 slots x n_mt x H / tile   (act columns)
    down_tiles: int  # 128: n_mt x D / tile (out; each tile runs one pass
    #                  per (slot, hidden block) and sums them); 64: one
    #                  tile per pass, 2 H/TH x n_mt x D / tile (partials)


# token rows above which the products take 128 x 128 tiles (two consumer
# warpgroups); below, 64 x 64 tiles keep about 128 CTAs streaming the
# expert weights (b=1: 14 rows)
WIDE_TILE_ROWS = 256


def moe_tile_plan(M: int, D: int, HH: int, TH: int, ctas: int
                  ) -> MoeTilePlan:
    tile = 128 if M > WIDE_TILE_ROWS else 64
    n_mt = -(-M // tile)
    passes = 1 if tile == 128 else 2 * (HH // TH)
    return MoeTilePlan(tile, ctas, n_mt, 2 * n_mt * (HH // tile),
                       passes * n_mt * (D // tile))


def moe_tiles(plan: MoeTilePlan, stage: str, M: int, D: int, HH: int):
    """Every output tile of the ``stage`` ("up" or "down") as the kernel
    decodes tile t (column tile fastest, then row tile, then z) and hands
    it to CTA t % grid: yields (cta, z, row range, column range) of
    act[z] (up, z the slot: the value columns; the gate columns H + n are
    read beside them), of out (down, 128 x 128 tiles: z = 0) or of the
    partials part[z] (down, 64 x 64: z the (slot, hidden block))."""
    up = stage == "up"
    n_nt = (HH if up else D) // plan.tile
    n = plan.up_tiles if up else plan.down_tiles
    grid = min(plan.ctas, n)
    for t in range(n):
        nt, mt = t % n_nt, (t // n_nt) % plan.n_mt
        yield (t % grid, t // (n_nt * plan.n_mt),
               range(mt * plan.tile, min(M, (mt + 1) * plan.tile)),
               range(nt * plan.tile, (nt + 1) * plan.tile))


def launch_error(err: int) -> str:
    """A launcher's error code in words: CUDA's, or the two of
    ``csrc/wgmma_stages.cuh`` for a TMA tensor map that cannot be made."""
    return {-1: "the driver has no cuTensorMapEncodeTiled",
            -2: "cuTensorMapEncodeTiled refused a tensor"}.get(
                err, f"CUDA error {err}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def cuda_tile_plan(M, D, HH, TH, device) -> MoeTilePlan:
    """The plan for M token rows on a CUDA ``device``: one CTA per SM."""
    return moe_tile_plan(M, D, HH, TH, sm_count(device.index or 0))


def down_partials(plan, M, D, HH, TH, device):
    """The f32 partials [2 H/TH, M, D] of the down stage's passes under the
    small-tile plan, or None: 128 x 128 tiles sum them in registers."""
    if plan.tile == 128:
        return None
    return torch.empty(2 * (HH // TH), M, D, dtype=torch.float32,
                       device=device)


def moe_q8c_scratch(plan, M, D, HH, TH):
    """Bytes of the int8 MoE stages' scratch over M rows under ``plan``:
    xq, sx, act (f32), aq, sa, and the f32 partials of the small-tile plan
    (0: none)."""
    n_h = HH // TH
    part = 0 if plan.tile == 128 else 4 * 2 * n_h * M * D
    return M * D, 4 * M, 4 * 2 * M * HH, 2 * M * HH, 4 * 2 * M * n_h, part


_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int]
             + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    from ._build import load_library
    fn = load_library("fused_top2_mlp_q8c").fused_top2_mlp_q8c_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def need_kmajor_experts(name, qexp_t):
    if qexp_t is None:
        raise ValueError(
            f"{name} on CUDA reads the K-major copy of the int8 experts: "
            "pass qexp_t=kmajor_experts(qexp) (made once per quantization "
            "by MoDeDiT.quantize_experts_)")


def fused_top2_mlp_q8c(x, top2_idx, top2_probs, qexp: QuantizedExperts, *,
                       step=None, block_hidden: int = 1024,
                       residual: bool = False, ln_g=None,
                       ln_eps: float = 1e-6,
                       qexp_t: ExpertsKMajor = None) -> torch.Tensor:
    """The int8 top-2 MoE of x [B,T,D], optionally prenormed by ``ln_g``
    and seeded with its (prenormed) input (``residual``).

    CUDA tensors: one launch of the hand-written kernel (bf16 x, any token
    count, D and block_hidden multiples of 128), which needs ``qexp_t``,
    the K-major copy of the int8 experts. CPU tensors: the plain version
    ``fused_top2_mlp_q8c_ref``. Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_top2_mlp_q8c_ref(
            x, top2_idx, top2_probs, qexp, step=step,
            block_hidden=block_hidden, residual=residual, ln_g=ln_g,
            ln_eps=ln_eps, qexp_t=qexp_t)
    no_autodiff("fused_top2_mlp_q8c", x, top2_idx, top2_probs, qexp, ln_g,
                qexp_t)
    if x.device.type != "cuda":
        raise ValueError(f"fused_top2_mlp_q8c runs on CUDA or CPU, not "
                         f"{x.device}")
    need_kmajor_experts("fused_top2_mlp_q8c", qexp_t)
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
            (qexp_t.w1_t, "w1_t", i8, (E, H2, D)),
            (qexp.w1_s, "w1_s", f32, (E, H2)), (b1, "b1", f32, (E, H2)),
            (qexp_t.w2_t, "w2_t", i8, (E, D, HH)),
            (qexp.w2_s, "w2_s", f32, (E, D))):
        _check(t, name, dtype, shape, dev)
    idx, probs, S, s = _tables(top2_idx, top2_probs, step)
    _check(idx, "top2_idx", torch.int32, (S, 2), dev)
    _check(probs, "top2_probs", f32, (S, 2), dev)

    M = B * T
    plan = cuda_tile_plan(M, D, HH, TH, dev)
    keep, scr = _scratch(dev, 2 * M * D if ln_g is not None else 0,
                         *moe_q8c_scratch(plan, M, D, HH, TH))
    out = torch.empty(B, T, D, dtype=bf, device=dev)
    ptrs = [None if t is None else t.data_ptr() for t in (
        x, ln_g, qexp_t.w1_t, qexp.w1_s, b1, qexp_t.w2_t, qexp.w2_s, idx,
        probs)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(*ptrs, s, *scr, out.data_ptr(), M, D, HH, TH, E,
                          int(residual), ln_eps, D ** -0.5, plan.tile,
                          plan.ctas, stream)
    if err != 0:
        raise RuntimeError(f"fused_top2_mlp_q8c launch failed: "
                           f"{launch_error(err)}")
    fused_top2_mlp_q8c.launches += 1
    return out


fused_top2_mlp_q8c.launches = 0


def _bf16_argtypes(n_weights):
    return ([ctypes.c_void_p] * (4 + n_weights) + [ctypes.c_int]
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _bf16_launcher(entry: str, n_weights: int):
    from ._build import load_library
    fn = getattr(load_library("fused_top2_mlp"), entry)
    fn.argtypes = _bf16_argtypes(n_weights)
    fn.restype = ctypes.c_int
    return fn


def _launch_bf16(name, x, top2_idx, top2_probs, weights, step, block_hidden,
                 residual, ln_g, ln_eps):
    """Check the arguments of ``fused_top2_mlp`` or ``fused_top2_mlp_q8``
    on CUDA, allocate the output and scratch, and launch the kernel.
    ``weights`` are (tensor, name, dtype) rows in the launcher's argument
    order, the first one w1 [E, D, 2H]; the launcher also takes the tile
    plan of its wgmma products."""
    dev = x.device
    if x.ndim != 3:
        raise ValueError(f"x must be [B,T,D], got {tuple(x.shape)}")
    B, T, D = x.shape
    E, _, H2 = weights[0][0].shape
    HH = H2 // 2
    TH = _hidden_block(HH, block_hidden)
    _check_moe_widths(D, TH)
    bf, f32 = torch.bfloat16, torch.float32
    _check(x, "x", bf, (B, T, D), dev)
    if ln_g is not None:
        ln_g = ln_g.float().contiguous()
        _check(ln_g, "ln_g", f32, (D,), dev)
    shapes = {"w1": (E, D, H2), "b1": (E, H2), "w2": (E, HH, D),
              "w1_s": (E, H2), "w2_s": (E, D)}
    for t, wname, dtype in weights:
        _check(t, wname, dtype, shapes[wname.removesuffix("_q")], dev)
    idx, probs, S, s = _tables(top2_idx, top2_probs, step)
    _check(idx, "top2_idx", torch.int32, (S, 2), dev)
    _check(probs, "top2_probs", f32, (S, 2), dev)

    M = B * T
    plan = cuda_tile_plan(M, D, HH, TH, dev)

    def buf(*shape, dtype):
        return torch.empty(*shape, dtype=dtype, device=dev)

    xm = buf(M, D, dtype=bf) if ln_g is not None else None
    scratch = (xm, buf(2, M, HH, dtype=bf),
               down_partials(plan, M, D, HH, TH, dev))
    out = buf(B, T, D, dtype=bf)
    ptrs = [None if t is None else t.data_ptr() for t in (
        x, ln_g, *(w[0] for w in weights), idx, probs)]
    scr = [None if t is None else t.data_ptr() for t in (*scratch, out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bf16_launcher(f"{name}_launch", len(weights))(
            *ptrs, s, *scr, M, D, HH, TH, E, int(residual), ln_eps,
            D ** -0.5, plan.tile, plan.ctas, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {launch_error(err)}")
    return out


def fused_top2_mlp(x, top2_idx, top2_probs, w1, b1, w2, *, step=None,
                   block_hidden: int = 1024, residual: bool = False,
                   ln_g=None, ln_eps: float = 1e-6) -> torch.Tensor:
    """The bf16-compute top-2 MoE of x [B,T,D] with bf16 experts w1
    [E,D,2H], b1 [E,2H], w2 [E,H,D], optionally prenormed by ``ln_g`` and
    seeded with its (prenormed) input (``residual``).

    CUDA tensors: one launch of the hand-written kernel (bf16 x and
    weights, any token count, D and block_hidden multiples of 128). CPU
    tensors: the plain version ``fused_top2_mlp_ref``. Returns x.dtype
    [B,T,D]."""
    if x.device.type == "cpu":
        return fused_top2_mlp_ref(
            x, top2_idx, top2_probs, w1, b1, w2, step=step,
            block_hidden=block_hidden, residual=residual, ln_g=ln_g,
            ln_eps=ln_eps)
    no_autodiff("fused_top2_mlp", x, top2_idx, top2_probs, w1, b1, w2, ln_g)
    if x.device.type != "cuda":
        raise ValueError(f"fused_top2_mlp runs on CUDA or CPU, not {x.device}")
    bf = torch.bfloat16
    out = _launch_bf16("fused_top2_mlp", x, top2_idx, top2_probs,
                       ((w1, "w1", bf), (b1, "b1", bf), (w2, "w2", bf)),
                       step, block_hidden, residual, ln_g, ln_eps)
    fused_top2_mlp.launches += 1
    return out


fused_top2_mlp.launches = 0


def fused_top2_mlp_q8(x, top2_idx, top2_probs, qexp: QuantizedExperts, *,
                      step=None, block_hidden: int = 1024,
                      residual: bool = False, ln_g=None,
                      ln_eps: float = 1e-6) -> torch.Tensor:
    """``fused_top2_mlp`` with the int8 experts ``qexp``: weights cast to
    bf16 in each product, scales applied after it.

    CUDA tensors: one launch of the hand-written kernel. CPU tensors: the
    plain version ``fused_top2_mlp_q8_ref``. Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_top2_mlp_q8_ref(
            x, top2_idx, top2_probs, qexp, step=step,
            block_hidden=block_hidden, residual=residual, ln_g=ln_g,
            ln_eps=ln_eps)
    no_autodiff("fused_top2_mlp_q8", x, top2_idx, top2_probs, qexp, ln_g)
    if x.device.type != "cuda":
        raise ValueError(f"fused_top2_mlp_q8 runs on CUDA or CPU, not "
                         f"{x.device}")
    f32, i8 = torch.float32, torch.int8
    out = _launch_bf16("fused_top2_mlp_q8", x, top2_idx, top2_probs, (
        (qexp.w1_q, "w1_q", i8), (qexp.w1_s, "w1_s", f32),
        (qexp.b1.float().contiguous(), "b1", f32), (qexp.w2_q, "w2_q", i8),
        (qexp.w2_s, "w2_s", f32)), step, block_hidden, residual, ln_g, ln_eps)
    fused_top2_mlp_q8.launches += 1
    return out


fused_top2_mlp_q8.launches = 0
