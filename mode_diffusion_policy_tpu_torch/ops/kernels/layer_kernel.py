"""One whole NoiseBlockMoE inference layer: CUDA kernel, wrapper and plain version.

Counterpart of ``mode_diffusion_policy_tpu/ops/pallas/layer_kernel.py::
fused_layer_q8c`` (the Pallas ``_kernel``). It computes

    x_mid = x + c_proj(attn(qk_norm(split(wqkv(rmsnorm(x)*g1 + c) + b))))
    out   = ln2(x_mid) + sum_{e in top2} p_e * W2_e(q(act_e)) * s
    act_e = value * silu(gate),  [value | gate] = q(ln2(x_mid)) W1_e s + b1

with the JAX kernel's cast chain: ``h`` cast to the compute dtype before the
QKV product, q/k/v and the softmax probabilities cast before their
products, ``x_mid`` cast through the compute dtype, the accumulator seeded
with ``ln2(x_mid)`` (the norm REPLACES the residual), the MoE input
quantized once per row, and ``act`` re-quantized per row within each
``block_hidden`` column block.

With ``qattn`` (int8 attention projections) ``h`` is quantized per row in
f32 without the bf16 cast, ``qkv = (hq wqkv_q) * (hs * sqkv) + b``, and the
f32 attention rows are re-quantized per row before the int8 ``c_proj``.
Either way the plain layer is exactly the two-kernel composition that the
JAX package pins the fused layer to: ``fused_top2_mlp_q8c_ref(
fused_attn_block_ref(x)`` (or ``fused_attn_block_q8_ref`` with ``qattn``)
``, residual=True, ln_g=ln2_g)``.

``fused_dit_q8c`` is the same layer chained over all L layers of the DiT in
one cooperative launch of ``csrc/fused_dit_q8c.cu`` (counterpart of the
Pallas ``_mega_kernel``), from weights stacked on a leading L axis
(``MoDeDiT.stack_layers``) and per-layer [L,S,2] routing tables. Its GEMM
stages are the per-layer kernel's wgmma stages under the same tile plan
(``dit_tile_plan``), so it equals L chained ``fused_layer_q8c`` launches bit
for bit; on CUDA it reads the stack's K-major int8 copies (``DIT_KMAJOR``:
the experts' and, with int8 projections, the projections'), which
``MoDeDiT.stack_layers`` makes once per preset.

The CUDA layer kernel's int8 products (wgmma) read the experts from their
K-major copy ``qexp_t`` (``quant.kmajor_experts``, made once per
quantization by ``MoDeDiT.quantize_experts_``) and, with int8 projections,
the projections from theirs, ``qattn_t`` (``quant.kmajor_attn``, made by
``MoDeDiT.quantize_attn_``); the plain version takes them too and gives the
same result with or without them. With int8 projections the CUDA layer is
a launcher of the stages of ``fused_attn_block_q8`` then those of
``fused_top2_mlp_q8c``, so it equals that composition bit for bit.

``fused_layer_q8c`` and ``fused_dit_q8c`` launch their kernels for CUDA
tensors (and raise on what they cannot take) and run their plain PyTorch
versions, ``fused_layer_q8c_ref`` and ``fused_dit_q8c_ref``, only for CPU
tensors. ``fused_layer_q8c.launches`` and ``fused_dit_q8c.launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..quant import AttnKMajor, ExpertsKMajor, QuantizedAttn, QuantizedExperts
from ._common import (_check, _check_widths, _hidden_block, _scratch,
                      _tables, no_autodiff)
from .attn_kernel import (ProjTilePlan, attn_q8_scratch, check_kmajor_attn,
                          fused_attn_block_q8_ref, fused_attn_block_ref,
                          need_kmajor_attn, proj_launch_args, proj_tile_plan)
from .moe_kernel import (MoeTilePlan, cuda_tile_plan, fused_top2_mlp_q8c_ref,
                         launch_error, moe_q8c_scratch, moe_tile_plan,
                         need_kmajor_experts)


def fused_layer_q8c_ref(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g,
                        qexp: QuantizedExperts, top2_idx, top2_probs, *,
                        step=None, qattn: QuantizedAttn = None,
                        qexp_t: ExpertsKMajor = None,
                        qattn_t: AttnKMajor = None,
                        block_hidden: int = 1024,
                        eps1: float = 1e-6, eps_qk: float = 1e-6,
                        eps2: float = 1e-6,
                        acc_dtype: torch.dtype = torch.float32,
                        red_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Plain PyTorch version of the whole layer (any device, any float
    dtype). x [B,T,D]; c [1,1,D], [B,1,D] or [B,T,D]; wqkv [D,3D] (+bias
    [3D]); q_g/k_g [hd]; wout [D,D]; qexp int8 experts; top2_idx/probs
    [S,2] tables with a ``step`` row selector, or single [2] rows. With
    ``qattn`` the projections are int8 and wqkv/bqkv/wout are ignored;
    with ``qexp_t`` (``qattn_t``) the expert (projection) products read
    that K-major copy of qexp (qattn).
    ``acc_dtype`` is the accumulation type of the compute-dtype products
    (QKV, attention, c_proj) and ``red_dtype`` that of the other float
    reductions (the norms' sums of squares, the softmax): float32 as in the
    kernels, or float64 for near-exact evaluations of the same cast chain
    (the noise floors that ``chip_smoke.py`` holds the kernel paths
    against)."""
    moe = functools.partial(
        fused_top2_mlp_q8c_ref, top2_idx=top2_idx, top2_probs=top2_probs,
        qexp=qexp, step=step, block_hidden=block_hidden, residual=True,
        ln_g=ln2_g, ln_eps=eps2, red_dtype=red_dtype, qexp_t=qexp_t)
    kw = dict(ln_eps=eps1, qk_eps=eps_qk, acc_dtype=acc_dtype,
              red_dtype=red_dtype)
    # the two-kernel composition, exactly
    if qattn is not None:
        return moe(fused_attn_block_q8_ref(x, c, ln1_g, qattn, q_g, k_g,
                                           qattn_t=qattn_t, **kw))
    return moe(fused_attn_block_ref(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout,
                                    **kw))


# the keys of a MoDeDiT.stack_layers dict that hold QuantizedAttn's fields,
# in the order of its fields
STACKED_QATTN = ("wqkv", "sqkv", "bqkv", "wout", "sout")
# the keys of the stack's K-major int8 copies, in the order of the fields
# of ExpertsKMajor and AttnKMajor (the latter with int8 projections only)
DIT_KMAJOR = ("w1_t", "w2_t")
DIT_KMAJOR_ATTN = ("wqkv_t", "wout_t")


def _stacked_layer(stacked, l):
    """Layer ``l`` of a ``MoDeDiT.stack_layers`` dict: (attention weights
    for ``fused_layer_q8c_ref``, int8 experts, QuantizedAttn or None, and
    the K-major copies ExpertsKMajor and AttnKMajor, each None where the
    stack has none)."""
    qexp = QuantizedExperts(*(stacked[k][l]
                              for k in QuantizedExperts._fields))
    qexp_t = (ExpertsKMajor(*(stacked[k][l] for k in DIT_KMAJOR))
              if DIT_KMAJOR[0] in stacked else None)
    if "sqkv" in stacked:
        qa = QuantizedAttn(*(stacked[k][l] for k in STACKED_QATTN))
        qa_t = (AttnKMajor(*(stacked[k][l] for k in DIT_KMAJOR_ATTN))
                if DIT_KMAJOR_ATTN[0] in stacked else None)
        return (None, stacked["bqkv"][l], None), qexp, qa, qexp_t, qa_t
    return ((stacked["wqkv"][l], stacked["bqkv"][l], stacked["wout"][l]),
            qexp, None, qexp_t, None)


def fused_dit_q8c_ref(x, c, stacked, top2_idx, top2_probs, *, step=None,
                      block_hidden: int = 1024, eps1: float = 1e-6,
                      eps_qk: float = 1e-6, eps2: float = 1e-6,
                      acc_dtype: torch.dtype = torch.float32,
                      red_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the DiT megakernel: ``fused_layer_q8c_ref``
    chained over the L layers of ``stacked`` (``MoDeDiT.stack_layers``), x
    carried in its own dtype between layers. top2_idx/probs are [L,S,2]
    tables with a ``step`` row selector, or [L,2] single rows; c is
    [1,1,D], [B,1,D] or [B,T,D], every layer's cond. int8
    attention projections when ``stacked`` has "sqkv". Where the stack
    holds its K-major int8 copies (``DIT_KMAJOR``, ``DIT_KMAJOR_ATTN``) the
    int8 products read them, as the CUDA kernel does, with the same
    result."""
    for l in range(stacked["wqkv"].shape[0]):
        (wqkv, bqkv, wout), qexp, qa, qexp_t, qa_t = _stacked_layer(
            stacked, l)
        x = fused_layer_q8c_ref(
            x, c, stacked["ln1"][l], wqkv, bqkv, stacked["q_g"][l],
            stacked["k_g"][l], wout, stacked["ln2"][l], qexp, top2_idx[l],
            top2_probs[l], step=step, qattn=qa, qexp_t=qexp_t, qattn_t=qa_t,
            block_hidden=block_hidden, eps1=eps1, eps_qk=eps_qk, eps2=eps2,
            acc_dtype=acc_dtype, red_dtype=red_dtype)
    return x


# the two launchers of csrc/fused_layer_q8c.cu: bf16 projections, int8
# projections (whose tile plan comes before the MoE's); the ints after the
# scratch pointers are B, T, D, H, HH, TH, E and the count of cond rows
_LAUNCH_ARGTYPES = {
    "fused_layer_q8c_launch": (
        [ctypes.c_void_p] * 16 + [ctypes.c_int] + [ctypes.c_void_p] * 12
        + [ctypes.c_int] * 8 + [ctypes.c_float] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_void_p]),
    "fused_layer_q8c_q8_launch": (
        [ctypes.c_void_p] * 18 + [ctypes.c_int] + [ctypes.c_void_p] * 15
        + [ctypes.c_int] * 8 + [ctypes.c_float] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=None)
def _launcher(entry: str):
    from ._build import load_library
    fn = getattr(load_library("fused_layer_q8c"), entry)
    fn.argtypes = _LAUNCH_ARGTYPES[entry]
    fn.restype = ctypes.c_int
    return fn


def fused_layer_q8c(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g,
                    qexp: QuantizedExperts, top2_idx, top2_probs, *,
                    step=None, qattn: QuantizedAttn = None,
                    qexp_t: ExpertsKMajor = None, qattn_t: AttnKMajor = None,
                    block_hidden: int = 1024, eps1: float = 1e-6,
                    eps_qk: float = 1e-6, eps2: float = 1e-6) -> torch.Tensor:
    """One full NoiseBlockMoE inference layer.

    CUDA tensors: one launch of the hand-written kernel (bf16 activations,
    bf16 projections or int8 ones (``qattn``), one shared [1,1,D] cond row,
    one per sample [B,1,D] or one per token [B,T,D], any T >= 1, hd a
    multiple of 32 up to 512), which needs
    ``qexp_t``, the K-major copy of the int8 experts, and with ``qattn``
    also ``qattn_t``, that of the int8 projections. CPU tensors: the plain
    version ``fused_layer_q8c_ref``. Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_layer_q8c_ref(
            x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g, qexp, top2_idx,
            top2_probs, step=step, qattn=qattn, qexp_t=qexp_t,
            qattn_t=qattn_t, block_hidden=block_hidden, eps1=eps1,
            eps_qk=eps_qk, eps2=eps2)
    no_autodiff("fused_layer_q8c", x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout,
                ln2_g, qexp, top2_idx, top2_probs, qattn, qexp_t, qattn_t)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_q8c runs on CUDA or CPU, not {x.device}")
    need_kmajor_experts("fused_layer_q8c", qexp_t)
    if qattn is not None:
        need_kmajor_attn("fused_layer_q8c with int8 projections", qattn_t)

    dev = x.device
    if x.ndim != 3:
        raise ValueError(f"x must be [B,T,D], got {tuple(x.shape)}")
    B, T, D = x.shape
    hd = q_g.shape[-1]
    H = D // hd
    E, _, H2 = qexp.w1_q.shape
    HH = H2 // 2
    TH = _hidden_block(HH, block_hidden)
    c_rows = _check_widths(T, D, H, hd, TH, c, B)
    bf = torch.bfloat16
    _check(x, "x", bf, (B, T, D), dev)
    if qattn is None:
        wqkv = wqkv.to(bf)
        wout = wout.to(bf)
        _check(wqkv, "wqkv", bf, (D, 3 * D), dev)
        _check(wout, "wout", bf, (D, D), dev)
        bqkv = bqkv.float().contiguous()
    else:
        check_kmajor_attn(qattn, qattn_t, D, dev)
        bqkv = qattn.bqkv
    # the cond rows rounded to x.dtype: in f32 for the bf16-projection
    # stages, as they are (bf16) for the int8 ones
    c = c.reshape(c_rows * D).to(x.dtype)
    c = (c.float() if qattn is None else c).contiguous()
    _check(c, "c", torch.float32 if qattn is None else bf, (c_rows * D,),
           dev)
    ln1_g = ln1_g.float().contiguous()
    ln2_g = ln2_g.float().contiguous()
    q_g = q_g.float().contiguous()
    k_g = k_g.float().contiguous()
    b1 = qexp.b1.float().contiguous()
    for t, name, shape in ((ln1_g, "ln1_g", (D,)),
                           (ln2_g, "ln2_g", (D,)), (bqkv, "bqkv", (3 * D,)),
                           (q_g, "q_g", (hd,)), (k_g, "k_g", (hd,)),
                           (b1, "b1", (E, H2)),
                           (qexp.w1_s, "w1_s", (E, H2)),
                           (qexp.w2_s, "w2_s", (E, D))):
        _check(t, name, torch.float32, shape, dev)
    _check(qexp_t.w1_t, "w1_t", torch.int8, (E, H2, D), dev)
    _check(qexp_t.w2_t, "w2_t", torch.int8, (E, D, HH), dev)
    idx, probs, S, s = _tables(top2_idx, top2_probs, step)
    _check(idx, "top2_idx", torch.int32, (S, 2), dev)
    _check(probs, "top2_probs", torch.float32, (S, 2), dev)

    M = B * T
    plan = cuda_tile_plan(M, D, HH, TH, dev)
    moe_w = (ln2_g, qexp_t.w1_t, qexp.w1_s, b1, qexp_t.w2_t, qexp.w2_s, idx,
             probs)
    # the two projections' tile plans (QKV rows, columns, c_proj rows,
    # columns): fused_attn_block's and the megakernel's
    tail = proj_launch_args(M, D, dev)[:4]
    if qattn is None:
        entry = "fused_layer_q8c_launch"
        w = (x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, *moe_w)
        attn_bytes = (2 * M * D, 4 * M * 3 * D, 2 * M * D)   # h, qkv, o
    else:
        entry = "fused_layer_q8c_q8_launch"
        w = (x, c, ln1_g, qattn_t.wqkv_t, qattn.wqkv_s, bqkv, q_g, k_g,
             qattn_t.wout_t, qattn.wout_s, *moe_w)
        attn_bytes = attn_q8_scratch(M, D)
    # the attention's scratch, x_mid, xm, then the MoE stages'
    keep, scratch = _scratch(dev, *attn_bytes, 2 * M * D, 2 * M * D,
                             *moe_q8c_scratch(plan, M, D, HH, TH))
    out = torch.empty(B, T, D, dtype=bf, device=dev)
    p = [t.data_ptr() for t in w]
    scratch.append(out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher(entry)(*p, s, *scratch, B, T, D, H, HH, TH, E,
                               c_rows, eps1, eps_qk, eps2, D ** -0.5, hd ** -0.5,
                               float(1.0 / math.sqrt(hd)), *tail, plan.tile,
                               plan.ctas, stream)
    if err != 0:
        raise RuntimeError(f"fused_layer_q8c launch failed: "
                           f"{launch_error(err)}")
    fused_layer_q8c.launches += 1
    return out


fused_layer_q8c.launches = 0




class DitTilePlan(NamedTuple):
    """How the megakernel covers the outputs of its GEMM stages: the
    per-layer kernels' plans at the same row count (so that it gives their
    bits), on a grid of one CTA per SM that hands tile t of every stage to
    CTA t % grid."""

    tile: int             # 128 (two consumer warpgroups) or 64 (one)
    grid: int             # CTAs: one per SM
    qkv: ProjTilePlan     # QKV [M, 3D]
    out: ProjTilePlan     # c_proj [M, D]
    moe: MoeTilePlan      # the up and down stages (moe_kernel.moe_tiles)


def dit_tile_plan(M: int, D: int, HH: int, TH: int, ctas: int
                  ) -> DitTilePlan:
    """The megakernel's plan for M token rows on ``ctas`` SMs."""
    moe = moe_tile_plan(M, D, HH, TH, ctas)
    return DitTilePlan(moe.tile, ctas, proj_tile_plan(M, 3 * D, ctas),
                       proj_tile_plan(M, D, ctas), moe)


def dit_stage_names(int8_attn: bool, tile: int):
    """The stages of one layer of the megakernel, in order, each ended by a
    grid barrier (the intervals of its ``times`` buffer)."""
    names = ["ln1_quant" if int8_attn else "ln1", "qkv", "attn"]
    if int8_attn:
        names.append("o_quant")
    names += ["c_proj", "ln2_quant", "moe_up", "act_quant", "moe_down"]
    if tile == 64:
        names.append("moe_sum")
    return names


def need_kmajor_stack(stacked):
    """The CUDA megakernel reads the stack's K-major int8 copies: raise
    without them (``MoDeDiT.stack_layers`` makes them)."""
    keys = DIT_KMAJOR + (DIT_KMAJOR_ATTN if "sqkv" in stacked else ())
    missing = [k for k in keys if k not in stacked]
    if missing:
        raise ValueError(
            f"fused_dit_q8c on CUDA reads the K-major int8 copies of the "
            f"stack ({', '.join(missing)} missing): pass the stack of "
            "MoDeDiT.stack_layers, which makes them once per preset")


# the named slots of csrc/fused_dit_q8c.cu's pointer, int and float arrays
DIT_PTRS = ("x", "c", "ln1", "wqkv", "sqkv", "bqkv", "q_g", "k_g", "wout",
            "sout", "ln2", "w1_t", "w1_s", "b1", "w2_t", "w2_s", "idx",
            "probs", "h", "hs", "qkv", "o", "oq", "os", "xmid", "xm", "xq",
            "sx", "act", "aq", "sa", "part", "tmp", "out")
DIT_INTS = ("S", "step", "L", "B", "T", "D", "H", "HH", "TH", "E",
            "int8_attn", "tile", "c_rows")
DIT_FLOATS = ("eps1", "eps_qk", "eps2", "rs_D", "rs_hd", "scale")
# the launcher's info: grid, CTAs per SM, dynamic and static shared memory
# per CTA (bytes), ring stages, consumer warpgroups, registers per thread,
# local memory bytes per thread (stack frame and spills), the attention's
# key rows per block (T where a sample's keys fit at once)
DIT_INFO = ("grid", "ctas_per_sm", "dynamic_smem", "static_smem",
            "ring_stages", "consumer_warpgroups", "registers", "local_bytes",
            "attn_key_block")


# fused_dit_q8c_launch: the three arrays with their lengths, info, times,
# stream
_DIT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p] * 3


@functools.lru_cache(maxsize=None)
def _dit_launcher():
    from ._build import load_library
    fn = load_library("fused_dit_q8c").fused_dit_q8c_launch
    fn.argtypes = _DIT_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def dit_scratch(M, D, HH, TH, tile, int8_attn):
    """Bytes of the megakernel's per-layer scratch over M rows, in the order
    of its DIT_PTRS slots from "h" to "tmp" (0: unused)."""
    n_h = HH // TH
    q8 = int(int8_attn)
    return ((2 - q8) * M * D, 4 * M * q8, 4 * M * 3 * D, (2 + 2 * q8) * M * D,
            M * D * q8, 4 * M * q8, 2 * M * D, 2 * M * D, M * D, 4 * M,
            4 * 2 * M * HH, 2 * M * HH, 4 * 2 * M * n_h,
            0 if tile == 128 else 4 * 2 * n_h * M * D, 2 * M * D)


def fused_dit_q8c(x, c, stacked, top2_idx, top2_probs, *, step=None,
                  block_hidden: int = 1024, eps1: float = 1e-6,
                  eps_qk: float = 1e-6, eps2: float = 1e-6,
                  times=None) -> torch.Tensor:
    """All L NoiseBlockMoE inference layers of one denoise step.

    ``stacked`` is ``MoDeDiT.stack_layers()``: ln1/ln2 [L,D], q_g/k_g
    [L,hd], bqkv [L,3D] in f32; wqkv [L,D,3D] and wout [L,D,D] in bf16, or
    int8 with their f32 column scales sqkv [L,3D] / sout [L,D] and their
    K-major copies wqkv_t [L,3D,D] / wout_t [L,D,D]; the int8 experts w1_q
    [L,E,D,2H], w1_s/b1 [L,E,2H], w2_q [L,E,H,D], w2_s [L,E,D] and their
    K-major copies w1_t [L,E,2H,D], w2_t [L,E,D,H]. top2_idx/probs are
    [L,S,2] tables (int32 / f32) with a ``step`` row selector, or [L,2]
    single rows.

    CUDA tensors: ONE cooperative launch of the hand-written megakernel
    (bf16 activations, one shared [1,1,D] cond row, one per sample [B,1,D]
    or one per token [B,T,D], read by every layer; any T >= 1: a team
    streams a long sample's keys through its share of shared memory),
    which needs the K-major copies; a device without cooperative launch,
    a grid that does
    not fit or a tensor map that cannot be made raises. ``times``: None, or
    a CUDA int64 tensor [1 + L * len(dit_stage_names(...)), 2] that the
    kernel fills with %globaltimer (ns) and the clock of CTA 0 after every
    grid barrier. CPU tensors: the plain version ``fused_dit_q8c_ref``.
    Returns x.dtype [B,T,D]. The info of the last launch (``DIT_INFO``) is
    kept in ``fused_dit_q8c.last_grid``."""
    if x.device.type == "cpu":
        return fused_dit_q8c_ref(
            x, c, stacked, top2_idx, top2_probs, step=step,
            block_hidden=block_hidden, eps1=eps1, eps_qk=eps_qk, eps2=eps2)
    no_autodiff("fused_dit_q8c", x, c, stacked, top2_idx, top2_probs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dit_q8c runs on CUDA or CPU, not {x.device}")
    need_kmajor_stack(stacked)

    dev = x.device
    if x.ndim != 3:
        raise ValueError(f"x must be [B,T,D], got {tuple(x.shape)}")
    int8_attn = "sqkv" in stacked
    B, T, D = x.shape
    L = stacked["wqkv"].shape[0]
    hd = stacked["q_g"].shape[-1]
    H = D // hd
    E, _, H2 = stacked["w1_q"].shape[1:]
    HH = H2 // 2
    TH = _hidden_block(HH, block_hidden)
    c_rows = _check_widths(T, D, H, hd, TH, c, B)
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    _check(x, "x", bf, (B, T, D), dev)
    want = {"ln1": (f32, (L, D)), "bqkv": (f32, (L, 3 * D)),
            "q_g": (f32, (L, hd)), "k_g": (f32, (L, hd)),
            "ln2": (f32, (L, D)), "w1_t": (i8, (L, E, H2, D)),
            "w1_s": (f32, (L, E, H2)), "b1": (f32, (L, E, H2)),
            "w2_t": (i8, (L, E, D, HH)), "w2_s": (f32, (L, E, D))}
    if int8_attn:
        want.update(wqkv_t=(i8, (L, 3 * D, D)), sqkv=(f32, (L, 3 * D)),
                    wout_t=(i8, (L, D, D)), sout=(f32, (L, D)))
    else:
        want.update(wqkv=(bf, (L, D, 3 * D)), wout=(bf, (L, D, D)))
    for k, (dt, shape) in want.items():
        _check(stacked[k], k, dt, shape, dev)
    c = c.reshape(c_rows * D).to(x.dtype).float().contiguous()
    idx, probs, S, s = _tables(top2_idx, top2_probs, step, lead=(L,))
    _check(idx, "top2_idx", torch.int32, (L, S, 2), dev)
    _check(probs, "top2_probs", f32, (L, S, 2), dev)

    M = B * T
    tile = cuda_tile_plan(M, D, HH, TH, dev).tile
    if times is not None:
        n = 1 + L * len(dit_stage_names(int8_attn, tile))
        _check(times, "times", torch.int64, (n, 2), dev)
    keep, scratch = _scratch(dev, *dit_scratch(M, D, HH, TH, tile,
                                               int8_attn))
    out = torch.empty(B, T, D, dtype=bf, device=dev)
    w = {k: stacked[k] for k in want}
    w.update(x=x, c=c, idx=idx, probs=probs, out=out)
    if int8_attn:
        w.update(wqkv=w.pop("wqkv_t"), wout=w.pop("wout_t"))
    ptrs = {k: t.data_ptr() for k, t in w.items()}
    ptrs.update(zip(DIT_PTRS[DIT_PTRS.index("h"):DIT_PTRS.index("out")],
                    scratch))
    ints = dict(S=S, step=s, L=L, B=B, T=T, D=D, H=H, HH=HH, TH=TH, E=E,
                int8_attn=int(int8_attn), tile=tile, c_rows=c_rows)
    flts = dict(eps1=eps1, eps_qk=eps_qk, eps2=eps2, rs_D=D ** -0.5,
                rs_hd=hd ** -0.5, scale=float(1.0 / math.sqrt(hd)))
    p = (ctypes.c_uint64 * len(DIT_PTRS))(*(ptrs.get(k) or 0
                                            for k in DIT_PTRS))
    n_ = (ctypes.c_int * len(DIT_INTS))(*(ints[k] for k in DIT_INTS))
    f_ = (ctypes.c_float * len(DIT_FLOATS))(*(flts[k] for k in DIT_FLOATS))
    info = (ctypes.c_int * len(DIT_INFO))()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _dit_launcher()(
            p, len(DIT_PTRS), n_, len(DIT_INTS), f_, len(DIT_FLOATS), info,
            None if times is None else times.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_dit_q8c cooperative launch failed: "
                           f"{launch_error(err)}")
    fused_dit_q8c.launches += 1
    fused_dit_q8c.last_grid = tuple(info)
    return out


fused_dit_q8c.launches = 0
fused_dit_q8c.last_grid = None
