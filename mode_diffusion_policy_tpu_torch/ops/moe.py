"""Mixture-of-experts FFN compute on stacked expert weights (counterpart of
``moe_ffn_dense``, ``moe_ffn_topk_grouped`` and ``moe_ffn_top2_gather`` in
``mode_diffusion_policy_tpu/ops/moe.py``).

Weight layout (E experts, model dim D, hidden H = 4*D):
    w1 : [E, D, 2H]   (SwishGLU projection; columns [:H] value, [H:] gate)
    b1 : [E, 2H]
    w2 : [E, H, D]
"""
from __future__ import annotations

import torch

from .primitives import swish_glu


def moe_ffn_dense(x, router_probs, w1, b1, w2, act_dropout=None):
    """``out[b,t] = sum_e probs[b,t,e] * (swishglu(x W1_e + b1_e) W2_e)``,
    every expert evaluated (non-selected experts have probability 0).
    ``act_dropout`` (training) is applied to the SwishGLU activations,
    between SwishGLU and ``w2``."""
    h = torch.einsum("btd,edh->ebth", x, w1) + b1[:, None, None, :]
    act = swish_glu(h)
    if act_dropout is not None:
        act = act_dropout(act)
    eo = torch.einsum("ebth,ehd->ebtd", act, w2)
    return torch.einsum("bte,ebtd->btd", router_probs, eo)


def moe_ffn_topk_grouped(x, pair_probs, top_idx, w1, b1, w2,
                         act_dropout=None):
    """Top-k MoE that computes only the selected experts, the same weighted
    sum as ``moe_ffn_dense``: the (token, slot) pairs are sorted by expert
    id (stable), each expert's contiguous group runs its two products, the
    outputs are weighted by the pair probabilities and added back per
    token. The JAX package runs the groups through ``ragged_dot``; here
    one product per expert in stock torch ops (the group sizes are read on
    the host). x [B,T,D], pair_probs and top_idx [B,T,k]."""
    B, T, D = x.shape
    E = w1.shape[0]
    k = top_idx.shape[-1]
    N = B * T
    xf = x.reshape(N, D)
    flat_e = top_idx.reshape(N * k).long()
    order = torch.argsort(flat_e, stable=True)
    tok_sorted = torch.arange(N, device=x.device).repeat_interleave(k)[order]
    xs = xf[tok_sorted]
    sizes = torch.bincount(flat_e, minlength=E).tolist()
    h = torch.cat([xs_e @ w1[e] for e, xs_e in
                   enumerate(torch.split(xs, sizes))]) + b1[flat_e[order]]
    act = swish_glu(h)
    if act_dropout is not None:
        act = act_dropout(act)
    eo = torch.cat([a_e @ w2[e] for e, a_e in
                    enumerate(torch.split(act, sizes))])
    weighted = eo * pair_probs.reshape(N * k)[order][:, None].to(eo.dtype)
    out = torch.zeros(N, D, dtype=weighted.dtype, device=x.device)
    return out.index_add(0, tok_sorted, weighted).reshape(B, T, D)


def moe_ffn_top2_gather(x, top2_idx, top2_probs, w1, b1, w2):
    """The sigma-routed inference path: every token uses the same two
    experts, so gather their weights and compute ``p0*E_i0(x) + p1*E_i1(x)``."""
    idx = top2_idx.long()
    h = torch.einsum("btd,edh->ebth", x, w1[idx]) + b1[idx][:, None, None, :]
    eo = torch.einsum("ebth,ehd->ebtd", swish_glu(h), w2[idx])
    return torch.einsum("e,ebtd->btd", top2_probs, eo)
