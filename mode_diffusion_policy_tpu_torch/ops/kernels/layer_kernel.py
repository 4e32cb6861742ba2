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
one launch of ``csrc/fused_dit_q8c.cu`` (counterpart of the Pallas
``_mega_kernel``), from weights stacked on a leading L axis
(``MoDeDiT.stack_layers``) and per-layer [L,S,2] routing tables.

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

import torch

from ..quant import QuantizedAttn, QuantizedExperts
from ._common import _check, _check_widths, _hidden_block, _tables
from .attn_kernel import fused_attn_block_q8_ref, fused_attn_block_ref
from .moe_kernel import fused_top2_mlp_q8c_ref


def fused_layer_q8c_ref(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g,
                        qexp: QuantizedExperts, top2_idx, top2_probs, *,
                        step=None, qattn: QuantizedAttn = None,
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
    ``qattn`` the projections are int8 and wqkv/bqkv/wout are ignored.
    ``acc_dtype`` is the accumulation type of the compute-dtype products
    (QKV, attention, c_proj) and ``red_dtype`` that of the other float
    reductions (the norms' sums of squares, the softmax): float32 as in the
    kernels, or float64 for near-exact evaluations of the same cast chain
    (the noise floors that ``chip_smoke.py`` holds the kernel paths
    against)."""
    moe = functools.partial(
        fused_top2_mlp_q8c_ref, top2_idx=top2_idx, top2_probs=top2_probs,
        qexp=qexp, step=step, block_hidden=block_hidden, residual=True,
        ln_g=ln2_g, ln_eps=eps2, red_dtype=red_dtype)
    kw = dict(ln_eps=eps1, qk_eps=eps_qk, acc_dtype=acc_dtype,
              red_dtype=red_dtype)
    # the two-kernel composition, exactly
    if qattn is not None:
        return moe(fused_attn_block_q8_ref(x, c, ln1_g, qattn, q_g, k_g,
                                           **kw))
    return moe(fused_attn_block_ref(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout,
                                    **kw))


# the keys of a MoDeDiT.stack_layers dict that hold QuantizedAttn's fields,
# in the order of its fields
STACKED_QATTN = ("wqkv", "sqkv", "bqkv", "wout", "sout")


def _stacked_layer(stacked, l):
    """Layer ``l`` of a ``MoDeDiT.stack_layers`` dict: (attention weights
    for ``fused_layer_q8c_ref``, int8 experts, QuantizedAttn or None)."""
    qexp = QuantizedExperts(*(stacked[k][l]
                              for k in QuantizedExperts._fields))
    if "sqkv" in stacked:
        qa = QuantizedAttn(*(stacked[k][l] for k in STACKED_QATTN))
        return (None, stacked["bqkv"][l], None), qexp, qa
    return (stacked["wqkv"][l], stacked["bqkv"][l], stacked["wout"][l]), \
        qexp, None


def fused_dit_q8c_ref(x, c, stacked, top2_idx, top2_probs, *, step=None,
                      block_hidden: int = 1024, eps1: float = 1e-6,
                      eps_qk: float = 1e-6, eps2: float = 1e-6,
                      acc_dtype: torch.dtype = torch.float32,
                      red_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the DiT megakernel: ``fused_layer_q8c_ref``
    chained over the L layers of ``stacked`` (``MoDeDiT.stack_layers``), x
    carried in its own dtype between layers. top2_idx/probs are [L,S,2]
    tables with a ``step`` row selector, or [L,2] single rows. int8
    attention projections when ``stacked`` has "sqkv"."""
    for l in range(stacked["wqkv"].shape[0]):
        (wqkv, bqkv, wout), qexp, qa = _stacked_layer(stacked, l)
        x = fused_layer_q8c_ref(
            x, c, stacked["ln1"][l], wqkv, bqkv, stacked["q_g"][l],
            stacked["k_g"][l], wout, stacked["ln2"][l], qexp, top2_idx[l],
            top2_probs[l], step=step, qattn=qa, block_hidden=block_hidden,
            eps1=eps1, eps_qk=eps_qk, eps2=eps2, acc_dtype=acc_dtype,
            red_dtype=red_dtype)
    return x


_LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                    + [ctypes.c_float] * 6 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    from ._build import load_library
    fn = load_library("fused_layer_q8c").fused_layer_q8c_launch
    fn.argtypes = _LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def fused_layer_q8c(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g,
                    qexp: QuantizedExperts, top2_idx, top2_probs, *,
                    step=None, qattn: QuantizedAttn = None,
                    block_hidden: int = 1024, eps1: float = 1e-6,
                    eps_qk: float = 1e-6, eps2: float = 1e-6) -> torch.Tensor:
    """One full NoiseBlockMoE inference layer.

    CUDA tensors: one launch of the hand-written kernel (bf16 activations,
    bf16 projections, a shared [1,1,D] cond row, T <= 16, hd a multiple of
    32). CPU tensors: the plain version ``fused_layer_q8c_ref``, with int8
    projections too (``qattn``). Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_layer_q8c_ref(
            x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g, qexp, top2_idx,
            top2_probs, step=step, qattn=qattn, block_hidden=block_hidden,
            eps1=eps1, eps_qk=eps_qk, eps2=eps2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_q8c runs on CUDA or CPU, not {x.device}")
    if qattn is not None:
        raise NotImplementedError(
            "fused_layer_q8c with int8 attention projections (qattn) has no "
            "CUDA kernel yet (ROADMAP.md Queue 2); fused_attn_block_q8 "
            "followed by fused_top2_mlp_q8c computes the same layer, and the "
            "DiT megakernel fused_dit_q8c has int8 projections too.")

    dev = x.device
    if x.ndim != 3:
        raise ValueError(f"x must be [B,T,D], got {tuple(x.shape)}")
    B, T, D = x.shape
    hd = q_g.shape[-1]
    H = D // hd
    E, _, H2 = qexp.w1_q.shape
    HH = H2 // 2
    TH = _hidden_block(HH, block_hidden)
    _check_widths(T, D, H, hd, TH, c)
    bf = torch.bfloat16
    _check(x, "x", bf, (B, T, D), dev)
    wqkv = wqkv.to(bf)
    wout = wout.to(bf)
    _check(wqkv, "wqkv", bf, (D, 3 * D), dev)
    _check(wout, "wout", bf, (D, D), dev)
    c = c.reshape(D).to(x.dtype).float().contiguous()
    ln1_g = ln1_g.float().contiguous()
    ln2_g = ln2_g.float().contiguous()
    bqkv = bqkv.float().contiguous()
    q_g = q_g.float().contiguous()
    k_g = k_g.float().contiguous()
    b1 = qexp.b1.float().contiguous()
    for t, name, shape in ((c, "c", (D,)), (ln1_g, "ln1_g", (D,)),
                           (ln2_g, "ln2_g", (D,)), (bqkv, "bqkv", (3 * D,)),
                           (q_g, "q_g", (hd,)), (k_g, "k_g", (hd,)),
                           (b1, "b1", (E, H2)),
                           (qexp.w1_s, "w1_s", (E, H2)),
                           (qexp.w2_s, "w2_s", (E, D))):
        _check(t, name, torch.float32, shape, dev)
    _check(qexp.w1_q, "w1_q", torch.int8, (E, D, H2), dev)
    _check(qexp.w2_q, "w2_q", torch.int8, (E, HH, D), dev)
    idx, probs, S, s = _tables(top2_idx, top2_probs, step)
    _check(idx, "top2_idx", torch.int32, (S, 2), dev)
    _check(probs, "top2_probs", torch.float32, (S, 2), dev)

    M = B * T
    n_h = HH // TH
    h = torch.empty(M, D, dtype=bf, device=dev)
    qkv = torch.empty(M, 3 * D, dtype=torch.float32, device=dev)
    o = torch.empty(M, D, dtype=bf, device=dev)
    xmid = torch.empty(M, D, dtype=bf, device=dev)
    xm = torch.empty(M, D, dtype=bf, device=dev)
    xq = torch.empty(M, D, dtype=torch.int8, device=dev)
    sx = torch.empty(M, dtype=torch.float32, device=dev)
    act = torch.empty(2, M, HH, dtype=torch.float32, device=dev)
    aq = torch.empty(2, M, HH, dtype=torch.int8, device=dev)
    sa = torch.empty(2, M, n_h, dtype=torch.float32, device=dev)
    part = torch.empty(2 * n_h, M, D, dtype=torch.float32, device=dev)
    out = torch.empty(B, T, D, dtype=bf, device=dev)
    p = [t.data_ptr() for t in (
        x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g, qexp.w1_q,
        qexp.w1_s, b1, qexp.w2_q, qexp.w2_s, idx, probs)]
    scratch = [t.data_ptr() for t in (h, qkv, o, xmid, xm, xq, sx, act, aq,
                                      sa, part, out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(*p, s, *scratch, B, T, D, H, HH, TH, E, eps1,
                          eps_qk, eps2, D ** -0.5, hd ** -0.5,
                          float(1.0 / math.sqrt(hd)), stream)
    if err != 0:
        raise RuntimeError(f"fused_layer_q8c launch failed: CUDA error {err}")
    fused_layer_q8c.launches += 1
    return out


fused_layer_q8c.launches = 0


_DIT_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p] * 18 + [ctypes.c_int] * 9
                 + [ctypes.c_float] * 6 + [ctypes.c_void_p] * 2)


@functools.lru_cache(maxsize=None)
def _dit_launcher():
    from ._build import load_library
    fn = load_library("fused_dit_q8c").fused_dit_q8c_launch
    fn.argtypes = _DIT_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def fused_dit_q8c(x, c, stacked, top2_idx, top2_probs, *, step=None,
                  block_hidden: int = 1024, eps1: float = 1e-6,
                  eps_qk: float = 1e-6, eps2: float = 1e-6) -> torch.Tensor:
    """All L NoiseBlockMoE inference layers of one denoise step.

    ``stacked`` is ``MoDeDiT.stack_layers()``: ln1/ln2 [L,D], q_g/k_g
    [L,hd], bqkv [L,3D] in f32; wqkv [L,D,3D] and wout [L,D,D] in bf16, or
    int8 with their f32 column scales sqkv [L,3D] / sout [L,D]; the int8
    experts w1_q [L,E,D,2H], w1_s/b1 [L,E,2H], w2_q [L,E,H,D], w2_s [L,E,D].
    top2_idx/probs are [L,S,2] tables (int32 / f32) with a ``step`` row
    selector, or [L,2] single rows.

    CUDA tensors: ONE cooperative launch of the hand-written megakernel
    (bf16 activations, a shared [1,1,D] cond row, T <= 16); a device
    without cooperative launch, or a grid that does not fit, raises.
    CPU tensors: the plain version ``fused_dit_q8c_ref``. Returns x.dtype
    [B,T,D]. The info of the last launch (grid size, CTAs per SM, shared
    memory per CTA) is kept in ``fused_dit_q8c.last_grid``."""
    if x.device.type == "cpu":
        return fused_dit_q8c_ref(
            x, c, stacked, top2_idx, top2_probs, step=step,
            block_hidden=block_hidden, eps1=eps1, eps_qk=eps_qk, eps2=eps2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dit_q8c runs on CUDA or CPU, not {x.device}")

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
    _check_widths(T, D, H, hd, TH, c)
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    wdt = i8 if int8_attn else bf
    _check(x, "x", bf, (B, T, D), dev)
    want = {"ln1": (f32, (L, D)), "wqkv": (wdt, (L, D, 3 * D)),
            "bqkv": (f32, (L, 3 * D)), "q_g": (f32, (L, hd)),
            "k_g": (f32, (L, hd)), "wout": (wdt, (L, D, D)),
            "ln2": (f32, (L, D)), "w1_q": (i8, (L, E, D, H2)),
            "w1_s": (f32, (L, E, H2)), "b1": (f32, (L, E, H2)),
            "w2_q": (i8, (L, E, HH, D)), "w2_s": (f32, (L, E, D))}
    if int8_attn:
        want.update(sqkv=(f32, (L, 3 * D)), sout=(f32, (L, D)))
    for k, (dt, shape) in want.items():
        _check(stacked[k], k, dt, shape, dev)
    c = c.reshape(D).to(x.dtype).float().contiguous()
    idx, probs, S, s = _tables(top2_idx, top2_probs, step, lead=(L,))
    _check(idx, "top2_idx", torch.int32, (L, S, 2), dev)
    _check(probs, "top2_probs", f32, (L, S, 2), dev)

    M = B * T
    n_h = HH // TH

    def buf(*shape, dtype):
        return torch.empty(*shape, dtype=dtype, device=dev)

    none = None
    h = none if int8_attn else buf(M, D, dtype=bf)
    o = none if int8_attn else buf(M, D, dtype=bf)
    hq, hs, o32, oq, os_ = ((buf(M, D, dtype=i8), buf(M, dtype=f32),
                             buf(M, D, dtype=f32), buf(M, D, dtype=i8),
                             buf(M, dtype=f32)) if int8_attn
                            else (none,) * 5)
    scratch = [h, hq, hs, buf(M, 3 * D, dtype=f32), o, o32, oq, os_,
               buf(M, D, dtype=bf), buf(M, D, dtype=bf), buf(M, D, dtype=i8),
               buf(M, dtype=f32), buf(2, M, HH, dtype=f32),
               buf(2, M, HH, dtype=i8), buf(2, M, n_h, dtype=f32),
               buf(2 * n_h, M, D, dtype=f32), buf(M, D, dtype=bf)]
    out = buf(B, T, D, dtype=bf)
    ptrs = [t.data_ptr() for t in (x, c, stacked["ln1"], stacked["wqkv"])]
    ptrs.append(stacked["sqkv"].data_ptr() if int8_attn else None)
    ptrs += [stacked[k].data_ptr() for k in ("bqkv", "q_g", "k_g", "wout")]
    ptrs.append(stacked["sout"].data_ptr() if int8_attn else None)
    ptrs += [stacked[k].data_ptr() for k in
             ("ln2", "w1_q", "w1_s", "b1", "w2_q", "w2_s")]
    ptrs += [idx.data_ptr(), probs.data_ptr()]
    scr = [None if t is None else t.data_ptr() for t in scratch]
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _dit_launcher()(
            *ptrs, S, s, *scr, out.data_ptr(), L, B, T, D, H, HH, TH, E,
            int(int8_attn), eps1, eps_qk, eps2, D ** -0.5, hd ** -0.5,
            float(1.0 / math.sqrt(hd)), info, stream)
    if err != 0:
        raise RuntimeError(f"fused_dit_q8c cooperative launch failed: CUDA "
                           f"error {err}")
    fused_dit_q8c.launches += 1
    fused_dit_q8c.last_grid = tuple(info)
    return out


fused_dit_q8c.launches = 0
fused_dit_q8c.last_grid = None
