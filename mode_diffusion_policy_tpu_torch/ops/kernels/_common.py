"""Pieces shared by the kernel modules' plain versions and wrappers: the
RMS norms, the causal attention of one layer, routing-table selection, the
wrappers' argument checks (the autodiff guard among them) and their scratch
memory."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.autograd import forward_ad


def _rmsnorm_rows(x32, g, eps, acc=torch.float32):
    D = x32.shape[1]
    xa = x32.to(acc)
    norm = (torch.sqrt((xa * xa).sum(dim=1, keepdim=True))
            * (D ** -0.5)).float()
    return x32 / norm.clamp_min(eps) * g.float()


def _headnorm(a, g, H, hd, eps, acc=torch.float32):
    N = a.shape[0]
    a3 = a.reshape(N, H, hd)
    aa = a3.to(acc)
    n = (torch.sqrt((aa * aa).sum(dim=-1, keepdim=True)) * (hd ** -0.5)).float()
    inv = 1.0 / n.clamp_min(eps)
    return (a3 * inv * g.float()).reshape(N, H * hd)


def _cond_rows(c, x):
    """The cond row(s) ``c`` ([1,1,D], [B,1,D] or [B,T,D]) rounded to
    x.dtype, as the JAX kernels take them, then broadcast to f32 [B*T, D]."""
    B, T, D = x.shape
    return torch.broadcast_to(c.to(x.dtype).float(), (B, T, D)).reshape(
        B * T, D)


def _attend(qkv, q_g, k_g, B, T, dt, eps_qk, acc_dtype, red_dtype):
    """Causal attention within each sample from f32 qkv rows [B*T, 3D]:
    head RMS-norm of q and k, q/k/v and the softmax probabilities cast to
    ``dt`` before their products. Returns the f32 rows o [B*T, D]."""
    D = qkv.shape[1] // 3
    hd = q_g.shape[-1]
    H = D // hd

    def mm(a, b):
        return torch.matmul(a.to(acc_dtype), b.to(acc_dtype)).float()

    q, k, v = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
    qn = _headnorm(q, q_g, H, hd, eps_qk, red_dtype).to(dt).float()
    kn = _headnorm(k, k_g, H, hd, eps_qk, red_dtype).to(dt).float()
    v = v.to(dt).float()

    def heads(a):
        return a.reshape(B, T, H, hd).transpose(1, 2)

    sc = mm(heads(qn), heads(kn).transpose(-1, -2)) * float(1.0 / math.sqrt(hd))
    causal = torch.ones(T, T, dtype=torch.bool, device=qkv.device).tril()
    sc = sc.masked_fill(~causal, -1e30)
    a = torch.softmax(sc.to(red_dtype), dim=-1).to(dt).float()
    return mm(a, heads(v)).transpose(1, 2).reshape(B * T, D)


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


def _tensors(args):
    """The tensors among ``args``, looking one level into tuples (the int8
    weight bundles are named tuples) and dicts (the megakernel's stack)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (tuple, list)):
            yield from (t for t in a if isinstance(t, torch.Tensor))
        elif isinstance(a, dict):
            yield from (t for t in a.values() if isinstance(t, torch.Tensor))


def autodiff_reason(*args) -> Optional[str]:
    """Why a kernel launch over ``args`` would lose a derivative, or None.

    The CUDA kernels are launched through ``ctypes`` on raw pointers and
    have no derivative: a tangent or a graph through their inputs would be
    dropped without a word. So a launch is refused inside a ``torch.func``
    transform (``jvp``, ``grad``, ``vmap``...), for a forward-mode dual
    tensor (``torch.autograd.forward_ad``), and for an input that requires
    grad while grad mode is on. Serving runs under ``torch.no_grad`` with
    plain tensors, where each test costs one flag read."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return "inside a torch.func transform (jvp, grad, vmap, ...)"
    duals = forward_ad._current_level >= 0
    grads = torch.is_grad_enabled()
    if not (duals or grads):
        return None
    for t in _tensors(args):
        if duals and forward_ad.unpack_dual(t).tangent is not None:
            return "an input is a forward-mode AD dual tensor"
        if grads and t.requires_grad:
            return "an input requires grad while grad mode is on"
    return None


def no_autodiff(name, *args):
    """Raise where ``autodiff_reason`` finds one: the kernel of ``name`` has
    no derivative. Its plain version (CPU tensors) is differentiable."""
    reason = autodiff_reason(*args)
    if reason is not None:
        raise RuntimeError(
            f"{name}: the CUDA kernel has no derivative, and {reason}; run "
            "this path under torch.no_grad() on plain tensors, or use the "
            "'reference' serving preset, whose plain modules differentiate")


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


def _check_attn_widths(T, D, H, hd, c, B):
    """Check the widths the CUDA kernels take and return the count of cond
    rows: 1 for one shared [1,1,D] row, B for one row per sample [B,1,D],
    B*T for one per token [B,T,D]. Any T >= 1 is taken: the attention
    stage keeps a sample's keys in shared memory where they fit and
    streams them in blocks of 16-row tiles where they do not. Head dims:
    multiples of 32 up to 512 (the stage's products step 16 columns, its
    loads take a float4 a lane, four at most)."""
    if T < 1:
        raise ValueError(f"the CUDA kernel takes 1 or more tokens, got {T}")
    if D % 128 or D > 4096 or H * hd != D or hd % 32 or hd > 512:
        raise ValueError(f"unsupported widths D={D}, head_dim={hd}")
    if c.numel() == D:
        return 1
    shape = tuple(c.shape)
    if shape == (B, 1, D):
        return B
    if shape == (B, T, D):
        return B * T
    raise ValueError(
        "the CUDA kernel takes one shared [1,1,D] cond row, one per sample "
        f"[B,1,D] or one per token [B,T,D] (B={B}, T={T}, D={D}); got c of "
        f"shape {shape}")


def _check_moe_widths(D, TH):
    if D % 128 or D > 4096:
        raise ValueError(f"unsupported width D={D}")
    if TH % 128:
        raise ValueError(f"block_hidden {TH} must be a multiple of 128")


def _check_widths(T, D, H, hd, TH, c, B):
    """The whole-layer kernels' widths (``_check_attn_widths`` and
    ``_check_moe_widths``); returns the count of cond rows."""
    c_rows = _check_attn_widths(T, D, H, hd, c, B)
    _check_moe_widths(D, TH)
    return c_rows


def _tables(top2_idx, top2_probs, step, lead=()):
    """Routing tables as [*lead, S, 2] (single rows get S = 1) and the
    checked row index."""
    idx = torch.as_tensor(top2_idx)
    probs = torch.as_tensor(top2_probs)
    if idx.ndim == len(lead) + 1:
        idx, probs = idx.unsqueeze(-2), probs.unsqueeze(-2)
    S = idx.shape[-2]
    s = 0 if step is None else int(step)
    if not 0 <= s < S:
        raise IndexError(f"step {s} outside the {S}-row routing tables")
    return idx, probs, S, s


def _scratch(device, *nbytes):
    """One allocation for the scratch buffers of a launch, ``nbytes`` each
    (0: no buffer, passed as a null pointer), each at a 256-byte boundary:
    one call into the caching allocator instead of one per buffer, which
    costs host time on every launch. Returns the allocation, which must
    outlive the launch, and the buffers' addresses."""
    ptrs, total = [], 0
    for n in nbytes:
        ptrs.append(total if n else None)
        total += -(-n // 256) * 256
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return buf, [None if p is None else base + p for p in ptrs]

