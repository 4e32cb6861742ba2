"""Mixture-of-experts FFN compute on stacked expert weights (counterpart of
``moe_ffn_dense`` and ``moe_ffn_top2_gather`` in
``mode_diffusion_policy_tpu/ops/moe.py``).

Weight layout (E experts, model dim D, hidden H = 4*D):
    w1 : [E, D, 2H]   (SwishGLU projection; columns [:H] value, [H:] gate)
    b1 : [E, 2H]
    w2 : [E, H, D]
"""
from __future__ import annotations

import torch

from .primitives import swish_glu


def moe_ffn_dense(x, router_probs, w1, b1, w2):
    """``out[b,t] = sum_e probs[b,t,e] * (swishglu(x W1_e + b1_e) W2_e)``,
    every expert evaluated (non-selected experts have probability 0)."""
    h = torch.einsum("btd,edh->ebth", x, w1) + b1[:, None, None, :]
    eo = torch.einsum("ebth,ehd->ebtd", swish_glu(h), w2)
    return torch.einsum("bte,ebtd->btd", router_probs, eo)


def moe_ffn_top2_gather(x, top2_idx, top2_probs, w1, b1, w2):
    """The sigma-routed inference path: every token uses the same two
    experts, so gather their weights and compute ``p0*E_i0(x) + p1*E_i1(x)``."""
    idx = top2_idx.long()
    h = torch.einsum("btd,edh->ebth", x, w1[idx]) + b1[idx][:, None, None, :]
    eo = torch.einsum("ebth,ehd->ebtd", swish_glu(h), w2[idx])
    return torch.einsum("e,ebtd->btd", top2_probs, eo)
