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

``fused_layer_q8c`` launches ``csrc/fused_layer_q8c.cu`` for CUDA tensors
(and raises on what it cannot take) and runs ``fused_layer_q8c_ref``, the
plain PyTorch version, only for CPU tensors. ``fused_layer_q8c.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..quant import QuantizedExperts
from .quant_math import dot_i8, quant_rows


def _rmsnorm_rows(x32, g, eps):
    D = x32.shape[1]
    norm = torch.sqrt((x32 * x32).sum(dim=1, keepdim=True)) * (D ** -0.5)
    return x32 / norm.clamp_min(eps) * g.float()


def _headnorm(a, g, H, hd, eps):
    N = a.shape[0]
    a3 = a.reshape(N, H, hd)
    n = torch.sqrt((a3 * a3).sum(dim=-1, keepdim=True)) * (hd ** -0.5)
    inv = 1.0 / n.clamp_min(eps)
    return (a3 * inv * g.float()).reshape(N, H * hd)


def _routing_row(top2_idx, top2_probs, step):
    """The routing row ``step`` of [S,2] tables (or the single [2] row)."""
    idx = torch.as_tensor(top2_idx)
    probs = torch.as_tensor(top2_probs)
    if idx.ndim == 1:
        idx, probs = idx[None], probs[None]
    s = 0 if step is None else int(step)
    return idx[s].long(), probs[s].float()


def _hidden_block(HH, block_hidden):
    TH = min(block_hidden, HH)
    if HH % TH:
        raise ValueError(f"hidden size {HH} is not a multiple of "
                         f"block_hidden {TH}")
    return TH


def fused_layer_q8c_ref(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g,
                        qexp: QuantizedExperts, top2_idx, top2_probs, *,
                        step=None, block_hidden: int = 1024,
                        eps1: float = 1e-6, eps_qk: float = 1e-6,
                        eps2: float = 1e-6,
                        acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the whole layer (any device, any float
    dtype). x [B,T,D]; c [1,1,D], [B,1,D] or [B,T,D]; wqkv [D,3D] (+bias
    [3D]); q_g/k_g [hd]; wout [D,D]; qexp int8 experts; top2_idx/probs
    [S,2] tables with a ``step`` row selector, or single [2] rows.
    ``acc_dtype`` is the accumulation type of the compute-dtype products
    (QKV, attention, c_proj): float32 as in the kernels, or float64 for a
    near-exact evaluation of the same cast chain (the noise floor that
    ``chip_smoke.py`` holds the kernel path against)."""
    B, T, D = x.shape
    dt = x.dtype
    hd = q_g.shape[-1]
    H = D // hd
    HH = qexp.w1_q.shape[-1] // 2
    TH = _hidden_block(HH, block_hidden)
    N = B * T

    def mm(a, b):
        return torch.matmul(a.to(acc_dtype), b.to(acc_dtype)).float()

    x32 = x.reshape(N, D).float()
    c32 = torch.broadcast_to(c.float(), (B, T, D)).reshape(N, D)
    h = (_rmsnorm_rows(x32, ln1_g, eps1) + c32).to(dt).float()
    qkv = mm(h, wqkv.to(dt)) + bqkv.float()
    q, k, v = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
    qn = _headnorm(q, q_g, H, hd, eps_qk).to(dt).float()
    kn = _headnorm(k, k_g, H, hd, eps_qk).to(dt).float()
    v = v.to(dt).float()

    def heads(a):
        return a.reshape(B, T, H, hd).transpose(1, 2)

    sc = mm(heads(qn), heads(kn).transpose(-1, -2)) * float(1.0 / math.sqrt(hd))
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    sc = sc.masked_fill(~causal, -1e30)
    a = torch.softmax(sc, dim=-1).to(dt).float()
    o = mm(a, heads(v)).transpose(1, 2).reshape(N, D).to(dt).float()
    xmid = x32 + mm(o, wout.to(dt))

    xm = _rmsnorm_rows(xmid.to(dt).float(), ln2_g, eps2).to(dt).float()
    acc = xm
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


_LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                    + [ctypes.c_float] * 6 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    from ._build import load_library
    fn = load_library().fused_layer_q8c_launch
    fn.argtypes = _LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_layer_q8c(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g,
                    qexp: QuantizedExperts, top2_idx, top2_probs, *,
                    step=None, block_hidden: int = 1024, eps1: float = 1e-6,
                    eps_qk: float = 1e-6, eps2: float = 1e-6) -> torch.Tensor:
    """One full NoiseBlockMoE inference layer.

    CUDA tensors: one launch of the hand-written kernel (bf16 activations,
    a shared [1,1,D] cond row, T <= 16, hd a multiple of 32). CPU tensors:
    the plain version ``fused_layer_q8c_ref``. Returns x.dtype [B,T,D]."""
    if x.device.type == "cpu":
        return fused_layer_q8c_ref(
            x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g, qexp, top2_idx,
            top2_probs, step=step, block_hidden=block_hidden, eps1=eps1,
            eps_qk=eps_qk, eps2=eps2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_q8c runs on CUDA or CPU, not {x.device}")

    dev = x.device
    if x.ndim != 3:
        raise ValueError(f"x must be [B,T,D], got {tuple(x.shape)}")
    B, T, D = x.shape
    hd = q_g.shape[-1]
    H = D // hd
    E, _, H2 = qexp.w1_q.shape
    HH = H2 // 2
    TH = _hidden_block(HH, block_hidden)
    if not (1 <= T <= 16):
        raise ValueError(f"the CUDA kernel takes 1..16 tokens per sample, got {T}")
    if D % 128 or D > 4096 or H * hd != D or hd % 32 or hd > 512:
        raise ValueError(f"unsupported widths D={D}, head_dim={hd}")
    if TH % 128:
        raise ValueError(f"block_hidden {TH} must be a multiple of 128")
    if c.numel() != D:
        raise ValueError("the CUDA kernel takes one shared [1,1,D] cond row; "
                         f"got c of shape {tuple(c.shape)}")
    bf = torch.bfloat16
    _check(x, "x", bf, (B, T, D), dev)
    wqkv = wqkv.to(bf)
    wout = wout.to(bf)
    _check(wqkv, "wqkv", bf, (D, 3 * D), dev)
    _check(wout, "wout", bf, (D, D), dev)
    c = c.reshape(D).float().contiguous()
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
    idx = torch.as_tensor(top2_idx)
    probs = torch.as_tensor(top2_probs)
    if idx.ndim == 1:
        idx, probs = idx[None], probs[None]
    S = idx.shape[0]
    _check(idx, "top2_idx", torch.int32, (S, 2), dev)
    _check(probs, "top2_probs", torch.float32, (S, 2), dev)
    s = 0 if step is None else int(step)
    if not 0 <= s < S:
        raise IndexError(f"step {s} outside the {S}-row routing tables")

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
