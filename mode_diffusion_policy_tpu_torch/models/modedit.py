"""MoDeDiT, the Mixture-of-Denoising-Experts diffusion transformer, in PyTorch.

Counterpart of ``mode_diffusion_policy_tpu/models/modedit.py`` (inference
paths). Token layout (B batch, D embed):

    [ sigma_token | goal_token | static_cam_token gripper_cam_token | a_1 .. a_10 ]

with learned positional embeddings and causal self-attention. Expert weights
are stacked (``experts_w1`` [E, D, 2H], ``experts_b1`` [E, 2H],
``experts_w2`` [E, H, D]). Routing depends on sigma only (the router sees the
noise token), so inference precomputes per-sigma top-2 tables
(``precompute_routing``) and each block then runs, as the JAX block does:
with int8 experts and ``use_fused_layer`` (and the attention kernel), the
whole layer as one kernel launch (``ops/kernels/layer_kernel.py``);
otherwise the attention sub-block (with ``use_pallas_attn`` one kernel
launch, ``ops/kernels/attn_kernel.py``: ``fused_attn_block``, or
``fused_attn_block_q8`` with ``use_int8_attn``), then ln_2 and the top-2
MoE (``ops/kernels/moe_kernel.py``): the int8 MoE kernel with
``use_int8_moe``, the bf16 MoE kernel with ``use_pallas_moe`` (the bf16
kernel configuration), else the plain top-2 gather. With
``use_megakernel`` (int8 experts and the attention kernel) the whole block
stack of a denoise step is one launch (``forward_precomputed_mega``) over
weights stacked once on a leading layer axis (``stack_layers``).
A call without routing tables (a sampler's off-schedule evaluation) routes
inline; with ``use_pallas_attn`` its attention sub-block is still one
kernel launch, with the block's own cond token, one row per sample.

Every option of the JAX config is here too, with the JAX package's
kernel eligibility: the proprio embedding (``use_proprio``, created and
carried but never read, as in JAX), no goal token (``goal_conditioned``)
or noise token (``use_noise_token_as_input``), non-causal attention (no
attention kernel), a router over the tokens (``cond_router=False``), its
temperature and renormalization, the goal embedding added to the cond
token (``use_goal_in_routing``: one cond row per sample, which every
kernel takes), an always-on shared expert (``use_shared_expert``; the
router picks ``top_k - 1`` of the other experts), a parameter-free
identity expert (``identity_expert``: routed expert ``E_r - 1``, the
intended semantics the JAX package documents), block cross-attention
(``use_cross_attention``, over the cond token unless a context is
given), and the ``init_style`` of the seeded initializer.

Training (``forward(..., train=True)``) runs the plain PyTorch path only,
as the JAX package runs no kernel under ``train``: dropout on the attention
probabilities (``attn_pdrop``), on the SwishGLU activations of the experts
(``mlp_pdrop``) and on the embeddings (``embed_pdrob``), Gumbel top-k
routing (unless ``use_argmax``), goal drop, and per layer the router aux
outputs that ``load_balancing_loss`` and ``router_z_loss`` read
(``return_aux``). Its random draws come from one ``torch.Generator``; the
Gumbel noise can be passed in instead.

Parameter names and layouts follow the JAX tree (``blocks_{i}`` becomes
``blocks.{i}``), which ``utils/weights.py`` relies on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.attn_kernel import fused_attn_block, fused_attn_block_q8
from ..ops.kernels.layer_kernel import (DIT_KMAJOR, DIT_KMAJOR_ATTN,
                                        STACKED_QATTN, fused_dit_q8c,
                                        fused_layer_q8c)
from ..ops.kernels.moe_kernel import fused_top2_mlp, fused_top2_mlp_q8c
from ..ops.moe import (moe_ffn_dense, moe_ffn_top2_gather,
                       moe_ffn_topk_grouped)
from ..ops.primitives import (DenseP, RMSNorm, at_least_f32, dropout,
                              gumbel_topk_sample, swish_glu)
from ..ops.quant import (AttnKMajor, ExpertsKMajor, QuantizedAttn,
                         QuantizedExperts, kmajor_attn, kmajor_experts,
                         quantize_attn, quantize_experts)


@dataclasses.dataclass(frozen=True)
class MoDeDiTConfig:
    """The hyperparameters of the JAX ``MoDeDiTConfig``, with its defaults
    (the shipped model: goal-conditioned, causal, a cond-only router at
    temperature 1 with renormalized top-k, the noise token as the first
    input token), the training options and the kernel flags."""

    obs_dim: int = 2048            # FiLM-ResNet-50 feature dim
    goal_dim: int = 512            # CLIP text embedding dim
    action_dim: int = 7
    embed_dim: int = 1024
    n_layers: int = 12
    n_heads: int = 8
    goal_seq_len: int = 1
    obs_seq_len: int = 1
    action_seq_len: int = 10
    state_dim: int = 8             # proprio dim (state_embed, never read)
    goal_conditioned: bool = True
    causal: bool = True
    use_proprio: bool = False
    num_experts: int = 4
    top_k: int = 2
    cond_router: bool = True       # the router sees the cond token only
    router_normalize: bool = True
    router_temperature: float = 1.0
    use_goal_in_routing: bool = False
    use_shared_expert: bool = False
    identity_expert: bool = False
    use_cross_attention: bool = False
    noise_in_cross_attention: bool = False
    use_noise_token_as_input: bool = True
    init_style: str = "olmoe"
    dtype: torch.dtype = torch.float32
    # training (JAX MoDeDiTConfig defaults, conf/model/mode_agent.yaml)
    embed_pdrob: float = 0.0
    goal_drop: float = 0.1         # elementwise Bernoulli goal dropout
    attn_pdrop: float = 0.3
    mlp_pdrop: float = 0.1
    use_argmax: bool = False       # deterministic top-k in training too
    use_grouped_moe: bool = False  # training/eval inline path: only the
                                   # selected experts, sorted by expert
                                   # (ops/moe.moe_ffn_topk_grouped)
    use_int8_moe: bool = False     # int8 experts (quantized once, see
                                   # MoDeDiT.quantize_experts_); on the
                                   # routed inference path the int8 top-2
                                   # MoE function (fused_top2_mlp_q8c)
    use_pallas_moe: bool = False   # the bf16 top-2 MoE function
                                   # (fused_top2_mlp, ln_2 and the residual
                                   # fused) on the routed inference path;
                                   # use_int8_moe takes precedence
    use_pallas_attn: bool = False  # the attention sub-block (ln_1, the
                                   # cond add, QKV, QK-norm, attention,
                                   # c_proj, residual) as one kernel launch
                                   # on the inference paths outside the
                                   # fused layer: fused_attn_block, or
                                   # fused_attn_block_q8 with int8
                                   # projections (head_dim % 128 == 0)
    use_fused_layer: bool = False  # whole-layer kernel on the routed
                                   # inference path (see fused_layer)
    use_int8_attn: bool = False    # int8 wqkv/c_proj projections (per-row
                                   # activation quant): inside the fused
                                   # layer, or fused_attn_block_q8;
                                   # needs use_pallas_attn
    use_megakernel: bool = False   # the whole block stack in ONE launch
                                   # per denoise step (fused_dit_q8c) on
                                   # the hoisted routed path (see
                                   # megakernel)

    def __post_init__(self):
        # the JAX config's checks, and no others: a flag whose path needs
        # another is inert without it, as in the JAX package
        if self.use_int8_attn:
            if not self.use_pallas_attn:
                raise ValueError(
                    "use_int8_attn requires use_pallas_attn: the int8 "
                    "projections run inside the fused attention kernel")
            hd = self.embed_dim // self.n_heads
            if hd % 128:
                raise ValueError(
                    "use_int8_attn requires head_dim % 128 == 0; got "
                    f"{hd}")

    @property
    def seq_size(self) -> int:
        """Rows of the learned positional embedding."""
        return self.goal_seq_len + self.obs_seq_len - 1 + self.action_seq_len

    @property
    def total_tokens(self) -> int:
        """Tokens per sample: the noise token, the goal token, both camera
        tokens and the action tokens, as the options keep them."""
        return (int(self.use_noise_token_as_input)
                + (self.goal_seq_len if self.goal_conditioned else 0)
                + 2 + self.action_seq_len)

    @property
    def num_routed_experts(self) -> int:
        """Experts the router sees: the shared expert is not among them."""
        return self.num_experts - int(self.use_shared_expert)

    @property
    def router_top_k(self) -> int:
        """Experts the router picks: one fewer beside a shared expert."""
        return self.top_k - int(self.use_shared_expert)

    @property
    def num_mlp_experts(self) -> int:
        """Routed experts with weights. With ``identity_expert`` the last
        routed expert (``num_routed_experts - 1``) is a parameter-free
        passthrough: the JAX package's reading of the reference, whose
        registration (``expert_{E_r}``) and forward (``expert_{E_r-1}``)
        disagree."""
        return self.num_routed_experts - int(self.identity_expert)

    @property
    def fused_attn(self) -> bool:
        """Whether the attention sub-block outside the fused layer is one
        kernel launch (JAX ``NoiseBlockMoE``'s ``use_fused_attn``: causal
        attention, head_dim % 128 == 0)."""
        return self.use_pallas_attn and self.causal and \
            (self.embed_dim // self.n_heads) % 128 == 0

    @property
    def fused_layer(self) -> bool:
        """Whether the routed path runs the whole-layer kernel: it needs
        int8 top-2 routed experts, the attention kernel, and neither an
        identity or shared expert nor cross-attention (JAX
        ``NoiseBlockMoE.__call__``); otherwise ``use_fused_layer`` is
        inert."""
        return (self.use_fused_layer and self.use_int8_moe
                and self.router_top_k == 2 and self.fused_attn
                and self.plain_block)

    @property
    def megakernel(self) -> bool:
        """Whether the hoisted routed path runs the DiT megakernel: the
        JAX agent's conditions (int8 top-2 experts, ``use_pallas_attn``,
        head_dim % 128 == 0, neither an identity or shared expert nor
        cross-attention); otherwise ``use_megakernel`` is inert. Like the
        JAX agent's, they do not check ``causal``: the megakernel's
        attention is causal whatever the config says."""
        return (self.use_megakernel and self.use_int8_moe
                and self.use_pallas_attn and self.top_k == 2
                and (self.embed_dim // self.n_heads) % 128 == 0
                and self.plain_block)

    @property
    def plain_block(self) -> bool:
        """No identity or shared expert and no cross-attention: the block
        that the whole-layer kernel and the megakernel compute."""
        return not (self.identity_expert or self.use_shared_expert
                    or self.use_cross_attention)


def kernel_init(style: str, fan_in: int):
    """(std, clip) of the JAX ``kernel_init_for``: a truncated normal
    (``olmoe``: std 0.02 within +-0.04; ``switch_t``: std sqrt(0.1 /
    fan_in) within +-2 std), else normal(0.02) (clip None)."""
    if style == "olmoe":
        return 0.02, 0.04
    if style == "switch_t":
        std = math.sqrt(0.1 / fan_in)
        return std, 2 * std
    return 0.02, None


def _init_(p: torch.Tensor, std: float, clip, generator):
    """A draw of ``kernel_init``'s distribution into ``p``. The truncated
    normal is std * a standard normal truncated to +-clip/std, as
    ``jax.random.truncated_normal`` draws it (its std below ``std``)."""
    if clip is None:
        return p.normal_(0.0, std, generator=generator)
    torch.nn.init.trunc_normal_(p, 0.0, 1.0, -clip / std, clip / std,
                                generator=generator)
    return p.mul_(std)


class Attention(nn.Module):
    """Multi-head attention with per-head QK RMSNorm, causal or not. Self
    attention projects QKV with one fused kernel (``wqkv``); with
    ``cross=True`` the queries come from ``x`` (``wq``) and the keys and
    values from a ``context`` (``wkv``), the JAX module's names. Causal
    cross-attention masks a top-left tril(T, S), as the JAX module does
    (the reference's SDPA ``is_causal`` for T != S)."""

    def __init__(self, cfg: MoDeDiTConfig, device=None, causal: bool = True,
                 cross: bool = False):
        super().__init__()
        D, H = cfg.embed_dim, cfg.n_heads
        self.cfg = cfg
        self.causal = causal
        self.H, self.hd, self.dtype = H, D // H, cfg.dtype
        if cross:
            self.wq = DenseP(D, D, True, cfg.dtype, device)
            self.wkv = DenseP(D, 2 * D, True, cfg.dtype, device)
        else:
            self.wqkv = DenseP(D, 3 * D, True, cfg.dtype, device)
        self.c_proj = DenseP(D, D, False, cfg.dtype, device)
        self.q_norm = RMSNorm(self.hd, eps=1e-6, device=device)
        self.k_norm = RMSNorm(self.hd, eps=1e-6, device=device)
        # int8 projections, quantized from the f32 weights by
        # MoDeDiT.quantize_attn_ (use_int8_attn), and their K-major copy
        # for the CUDA int8 attention's products
        self.attn_q: Optional[QuantizedAttn] = None
        self.attn_qt: Optional[AttnKMajor] = None

    def forward(self, x, train: bool = False, generator=None, context=None):
        """In train mode the attention probabilities, cast to the compute
        dtype, go through dropout (``attn_pdrop``). ``context`` [B,S,D]:
        the keys' and values' input of cross-attention."""
        B, T, D = x.shape
        if context is None:
            q, k, v = self.wqkv(x).chunk(3, dim=-1)
            S = T
        else:
            q = self.wq(x)
            k, v = self.wkv(context).chunk(2, dim=-1)
            S = context.shape[1]
        q = q.reshape(B, T, self.H, self.hd)
        k, v = (t.reshape(B, S, self.H, self.hd) for t in (k, v))
        q, k = self.q_norm(q), self.k_norm(k)
        logits = at_least_f32(torch.einsum("bthd,bshd->bhts", q, k)) \
            / math.sqrt(self.hd)
        if self.causal:
            mask = torch.ones(T, S, dtype=torch.bool,
                              device=x.device).tril()
            logits = logits.masked_fill(~mask, float("-inf"))
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        if train:
            attn = dropout(attn, self.cfg.attn_pdrop, generator)
        y = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, D)
        return self.c_proj(y)


class CondRouterMLP(nn.Module):
    """Linear(D -> 2D) -> exact GELU -> Linear(2D -> E)."""

    def __init__(self, in_dim, num_experts, dtype, device=None):
        super().__init__()
        self.fc1 = DenseP(in_dim, 2 * in_dim, True, dtype, device)
        self.fc2 = DenseP(2 * in_dim, num_experts, True, dtype, device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class RouterCond(nn.Module):
    """Noise-conditioned top-k router over the routed experts
    (``num_routed_experts``, picking ``router_top_k``): it sees the cond
    token broadcast over the tokens (``cond_router``), or the tokens
    themselves; logits shifted by their max and divided by
    ``router_temperature``; deterministic top-k in eval (and with
    ``use_argmax``), Gumbel top-k sampling in training. Returns (mask
    [B,T,E], idx [B,T,k], router_probs [B,T,E] masked, renormalized with
    ``router_normalize``, probs [B,T,E], shifted logits [B,T,E])."""

    def __init__(self, cfg: MoDeDiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.mlp = CondRouterMLP(cfg.embed_dim, cfg.num_routed_experts,
                                 cfg.dtype, device)

    def forward(self, inputs, cond, train: bool = False, generator=None,
                gumbel=None):
        """``gumbel`` [B,T,E]: the training draw's Gumbel noise, else drawn
        from ``generator``."""
        cfg = self.cfg
        E, k = cfg.num_routed_experts, cfg.router_top_k
        T = inputs.shape[1]
        if cfg.cond_router:
            router_in = (cond.repeat_interleave(T // cond.shape[1], dim=1)
                         if cond.shape[1] != T else cond)
        else:
            router_in = inputs
        logits = at_least_f32(self.mlp(router_in))
        logits = (logits - logits.amax(dim=-1, keepdim=True)) \
            / cfg.router_temperature
        probs = torch.softmax(logits, dim=-1).clamp(1e-9, 1 - 1e-9)
        if train and not cfg.use_argmax:
            idx = gumbel_topk_sample(torch.log(probs), k,
                                     generator=generator, gumbel=gumbel)
        else:
            idx = torch.topk(probs, k, dim=-1).indices
        mask = F.one_hot(idx, E).to(probs.dtype).sum(dim=-2)
        router_probs = probs * mask
        if cfg.router_normalize:
            router_probs = router_probs / router_probs.sum(dim=-1,
                                                           keepdim=True)
        return mask, idx, router_probs, probs, logits


def _routing_row(idx, p, step):
    if step is None:
        return idx, p
    return idx[step], p[step]


class NoiseBlockMoE(nn.Module):
    """``x += attn(ln_1(x) + c)``; with cross-attention ``x +=
    cross_att(ln_3(x) (+ c), context)``; ``x = ln_2(x); x += MoE(x)`` (plus
    the shared expert): the second norm REPLACES the residual stream
    before the MoE, as in the reference."""

    def __init__(self, cfg: MoDeDiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, Hh, E = cfg.embed_dim, 4 * cfg.embed_dim, cfg.num_mlp_experts
        self.ln_1 = RMSNorm(D, eps=1e-6, device=device)
        self.ln_2 = RMSNorm(D, eps=1e-6, device=device)
        self.attn = Attention(cfg, device, causal=cfg.causal)
        if cfg.use_cross_attention:
            self.ln_3 = RMSNorm(D, eps=1e-6, device=device)
            self.cross_att = Attention(cfg, device, causal=True, cross=True)
        self.router = RouterCond(cfg, device)
        self.experts_w1 = nn.Parameter(torch.empty(E, D, 2 * Hh, device=device))
        self.experts_b1 = nn.Parameter(torch.zeros(E, 2 * Hh, device=device))
        self.experts_w2 = nn.Parameter(torch.empty(E, Hh, D, device=device))
        if cfg.use_shared_expert:
            # the always-on expert, added unweighted after the routed sum
            self.shared_w1 = nn.Parameter(torch.empty(D, 2 * Hh,
                                                      device=device))
            self.shared_b1 = nn.Parameter(torch.zeros(2 * Hh, device=device))
            self.shared_w2 = nn.Parameter(torch.empty(Hh, D, device=device))
        # int8 experts, quantized from the f32 weights by
        # MoDeDiT.quantize_experts_ (use_int8_moe), and their K-major copy
        # for the CUDA int8 MoE's products (top-2)
        self.experts_q: Optional[QuantizedExperts] = None
        self.experts_qt: Optional[ExpertsKMajor] = None

    def forward(self, x, c, *, moe_override=None, context=None,
                layer_impl=fused_layer_q8c, attn_impl=fused_attn_block_q8,
                attn_impl_bf16=fused_attn_block, moe_impl=fused_top2_mlp_q8c,
                moe_impl_bf16=fused_top2_mlp, train=False, generator=None,
                gumbel=None, return_aux=False):
        """moe_override: (idx [k], p [k]) rows, or (idx [S,k], p [S,k],
        step) sigma tables with the scheduled step; None routes inline.
        ``context`` [B,S,D]: the cross-attention's keys and values
        (``use_cross_attention``). ``layer_impl`` is the whole-layer
        function used on the routed path when ``cfg.fused_layer`` holds.
        Otherwise, with ``cfg.fused_attn``, the attention sub-block is
        ``attn_impl`` (int8 projections, when the block holds them) or
        ``attn_impl_bf16``, with the block's own cond ``c`` ([1,1,D]
        shared, or [B,1,D]); and on the routed path with top-2 routed
        experts, ln_2 and the MoE are ``moe_impl`` (int8 experts,
        ``cfg.use_int8_moe``) or ``moe_impl_bf16`` (the compute-dtype
        experts, ``cfg.use_pallas_moe``): with ln_2 fused in, or after it
        beside a shared expert; an identity expert keeps the plain top-2
        gather. Follows JAX ``NoiseBlockMoE.__call__`` and
        ``_override_out``.

        ``train`` runs the plain path with its dropouts and Gumbel routing
        (draws from ``generator``, or the given ``gumbel`` noise);
        ``return_aux`` runs the plain path too and returns ``(x, aux)``,
        aux the layer's router outputs (None on a routed call)."""
        cfg = self.cfg
        a = self.attn
        # no kernel in train mode or for the aux outputs, as in JAX
        kernels = not (train or return_aux)
        if kernels and moe_override is not None and cfg.use_int8_moe \
                and cfg.router_top_k == 2:
            if self.experts_q is None or (cfg.use_int8_attn
                                          and a.attn_q is None):
                raise RuntimeError("int8 weights missing: call "
                                   "MoDEAgent.quantize_for_inference()")
        if kernels and moe_override is not None and cfg.fused_layer:
            idx, p, *rest = moe_override
            int8_attn = cfg.use_int8_attn
            return layer_impl(
                x, c, self.ln_1.g, a.wqkv.kernel, a.wqkv.bias,
                a.q_norm.g, a.k_norm.g, a.c_proj.kernel, self.ln_2.g,
                self.experts_q, idx, p, step=rest[0] if rest else None,
                qattn=a.attn_q if int8_attn else None,
                qexp_t=self.experts_qt,
                qattn_t=a.attn_qt if int8_attn else None,
                eps1=self.ln_1.eps, eps_qk=a.q_norm.eps, eps2=self.ln_2.eps)
        if kernels and cfg.fused_attn:
            kw = dict(ln_eps=self.ln_1.eps, qk_eps=a.q_norm.eps)
            if cfg.use_int8_attn and a.attn_q is not None:
                x = attn_impl(x, c, self.ln_1.g, a.attn_q, a.q_norm.g,
                              a.k_norm.g, qattn_t=a.attn_qt, **kw)
            else:
                x = attn_impl_bf16(x, c, self.ln_1.g, a.wqkv.kernel,
                                   a.wqkv.bias, a.q_norm.g, a.k_norm.g,
                                   a.c_proj.kernel, **kw)
        else:
            x = x + self.attn(self.ln_1(x) + c, train, generator)
        if cfg.use_cross_attention and context is not None:
            q_in = self.ln_3(x)
            if cfg.noise_in_cross_attention:
                q_in = q_in + c
            x = x + self.cross_att(q_in, train, generator, context)
        if moe_override is not None:
            idx, p, *rest = moe_override
            step = rest[0] if rest else None
            impls = (moe_impl, moe_impl_bf16) if kernels else None
            if kernels and cfg.router_top_k == 2 \
                    and not (cfg.identity_expert or cfg.use_shared_expert) \
                    and (cfg.use_int8_moe or cfg.use_pallas_moe):
                # ln_2 fused into the MoE function, the normed input as
                # the residual seed
                return self._override_out(x, idx, p, step, impls,
                                          ln_g=self.ln_2.g,
                                          ln_eps=self.ln_2.eps)
            x = self.ln_2(x)
            res = self._override_out(x, idx, p, step, impls)
            if cfg.use_shared_expert:
                res = res + self._shared_out(x)
            return (res, None) if return_aux else res
        x = self.ln_2(x)
        w1, b1, w2 = self._experts()
        mask, idx, router_probs, probs, logits = self.router(
            x, c, train, generator, gumbel)
        drop = None
        if train and cfg.mlp_pdrop > 0.0:
            def drop(act):
                return dropout(act, cfg.mlp_pdrop, generator)
        out = self._experts_out(x, router_probs, idx, w1, b1, w2, drop)
        if cfg.use_shared_expert:
            out = out + self._shared_out(x, drop)
        x = x + out
        if not return_aux:
            return x
        B, T, _ = x.shape
        counts = mask.sum(dim=(0, 1))
        # the load balance over the routed experts only
        aux = {"logits": logits, "probs": probs, "router_mask": mask,
               "load_balancing_term": cfg.num_routed_experts * (
                   router_probs.mean(dim=(0, 1)) * (counts / (B * T))).sum(),
               "expert_counts": counts, "tokens": B * T}
        return x, aux

    def _experts(self):
        dt = self.cfg.dtype
        return (self.experts_w1.to(dt), self.experts_b1.to(dt),
                self.experts_w2.to(dt))

    def _override_out(self, x, idx, p, step, impls, ln_g=None,
                      ln_eps=1e-6):
        """``x + moe(x)`` on the routed path (JAX ``_override_out``):
        ``impls`` = (int8, bf16) MoE functions where kernels may run (None
        in train mode), ``ln_g`` fuses ln_2 into them. An identity expert,
        another top-k or no kernel flag takes the plain top-2 gather on the
        step's routing row; an identity selection adds ``p * x`` in place
        of an expert."""
        cfg = self.cfg
        dt = cfg.dtype
        kernel_mode = (impls is not None and not cfg.identity_expert
                       and cfg.router_top_k == 2
                       and (cfg.use_int8_moe or cfg.use_pallas_moe))
        if kernel_mode and cfg.use_int8_moe:
            return impls[0](x, idx, p, self.experts_q, step=step,
                            residual=True, ln_g=ln_g, ln_eps=ln_eps,
                            qexp_t=self.experts_qt)
        w1, b1, w2 = self._experts()
        if kernel_mode:
            return impls[1](x, idx, p, w1, b1, w2, step=step, residual=True,
                            ln_g=ln_g, ln_eps=ln_eps)
        idx, p = _routing_row(idx, p, step)
        if cfg.identity_expert:
            is_id = idx == cfg.num_mlp_experts
            zero = torch.zeros_like(p)
            out = moe_ffn_top2_gather(x, torch.where(is_id, 0, idx),
                                      torch.where(is_id, zero, p).to(dt),
                                      w1, b1, w2)
            p_id = torch.where(is_id, p, zero).sum()
            return x + out + p_id.to(x.dtype) * x
        return x + moe_ffn_top2_gather(x, idx, p.to(dt), w1, b1, w2)

    def _experts_out(self, x, router_probs, idx, w1, b1, w2, drop=None):
        """The routed experts' output on the inline path: the dense sum
        over the MLP experts, or with ``use_grouped_moe`` only the selected
        pairs (the same weighted sum; an identity selection computes
        expert 0 at probability 0); an identity expert adds its
        probability times ``x``. ``drop`` is the training dropout on the
        SwishGLU activations."""
        cfg = self.cfg
        E_m = cfg.num_mlp_experts
        rp = router_probs.to(cfg.dtype)
        if cfg.use_grouped_moe:
            pair_p = torch.gather(router_probs, -1, idx)
            if cfg.identity_expert:
                is_id = idx == E_m
                idx = torch.where(is_id, 0, idx)
                pair_p = torch.where(is_id, torch.zeros_like(pair_p), pair_p)
            out = moe_ffn_topk_grouped(x, pair_p.to(x.dtype), idx, w1, b1,
                                       w2, drop)
        else:
            out = moe_ffn_dense(x, rp[..., :E_m], w1, b1, w2, drop)
        if cfg.identity_expert:
            out = out + rp[..., E_m:] * x
        return out

    def _shared_out(self, x, drop=None):
        """The shared SwishGLU expert, one routed expert's shape."""
        dt = self.cfg.dtype
        act = swish_glu(x @ self.shared_w1.to(dt) + self.shared_b1.to(dt))
        if drop is not None:
            act = drop(act)
        return act @ self.shared_w2.to(dt)

    def route_for_cond(self, c):
        """Router only, on cond tokens [S,1,D]: top-k (idx [S,k] int32,
        probs [S,k] f32) for the per-sigma routing precompute."""
        _, idx, router_probs, _, _ = self.router(c, c)
        idx = idx[:, 0]
        p = torch.gather(router_probs[:, 0], 1, idx)
        return idx.to(torch.int32), p


class MoDeDiT(nn.Module):
    """The full MoDE DiT denoiser (inference and training)."""

    def __init__(self, cfg: MoDeDiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.embed_dim, cfg.dtype
        self.sigma_emb = DenseP(1, D, True, dt, device)
        self.sigma_linear = DenseP(D, D, False, dt, device)
        self.tok_emb = DenseP(cfg.obs_dim, D, False, dt, device)
        self.goal_emb = DenseP(cfg.goal_dim, D, False, dt, device)
        self.action_emb = DenseP(cfg.action_dim, D, False, dt, device)
        if cfg.use_proprio:
            # created, as in the JAX model, and never read by the forward
            self.state_embed = DenseP(cfg.state_dim, D, False, dt, device)
        self.pos_emb = nn.Parameter(torch.empty(1, cfg.seq_size, D,
                                                device=device))
        self.blocks = nn.ModuleList(NoiseBlockMoE(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln = RMSNorm(D, eps=1e-6, device=device)
        self.out = DenseP(D, cfg.action_dim, True, dt, device)
        # the whole-layer, whole-stack and half-layer functions of the
        # kernel paths: the CUDA kernels' wrappers; a caller may set the
        # plain versions (fused_layer_q8c_ref, fused_dit_q8c_ref,
        # fused_attn_block_q8_ref, fused_attn_block_ref,
        # fused_top2_mlp_q8c_ref, fused_top2_mlp_ref) to run them on the
        # same weights (chip_smoke.py compares the two)
        self.layer_impl = fused_layer_q8c
        self.dit_impl = fused_dit_q8c
        self.attn_impl = fused_attn_block_q8
        self.attn_impl_bf16 = fused_attn_block
        self.moe_impl = fused_top2_mlp_q8c
        self.moe_impl_bf16 = fused_top2_mlp
        # the f32 values of the leaves that the serving precast has cast
        # (precast_), which the int8 quantizers read
        self._f32_masters: Dict[str, torch.Tensor] = {}
        # the per-layer weights stacked for the megakernel (stack_layers_)
        self.stacked: Optional[Dict[str, torch.Tensor]] = None

    def _fan_in(self, name: str, p: torch.Tensor) -> int:
        """The fan-in that JAX ``kernel_init_for`` is called with for
        parameter ``name``: each embedding's input width (1 for the sigma
        embedding), the hidden width for the second expert product, the
        model width elsewhere."""
        cfg = self.cfg
        top = name.split(".", 1)[0]
        fans = {"sigma_emb": 1, "tok_emb": cfg.obs_dim,
                "goal_emb": cfg.goal_dim, "action_emb": cfg.action_dim}
        if top in fans:
            return fans[top]
        if name.endswith(("experts_w2", "shared_w2")):
            return 4 * cfg.embed_dim
        return cfg.embed_dim

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        """Random init with the JAX package's distributions for
        ``init_style``: dense and expert kernels from ``kernel_init`` (by
        their fan-in, see ``_fan_in``), the positional embedding
        truncated normal(0.02) within +-0.04 under ``olmoe`` and
        normal(0.02) otherwise, router kernels normal(0.02), norm scales
        one, biases zero. The draws come from ``generator``; they are not
        JAX's draws."""
        style = self.cfg.init_style
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "g":
                p.fill_(1.0)
            elif leaf in ("bias", "experts_b1", "shared_b1"):
                p.zero_()
            elif ".router." in name:
                p.normal_(0.0, 0.02, generator=generator)
            elif name == "pos_emb":
                _init_(p, 0.02, 0.04 if style == "olmoe" else None,
                       generator)
            else:
                _init_(p, *kernel_init(style, self._fan_in(name, p)),
                       generator)

    def f32_param(self, name: str) -> torch.Tensor:
        """The f32 value of parameter ``name``: its master copy when the
        serving precast has cast it, else the parameter itself."""
        m = self._f32_masters.get(name)
        return m if m is not None else self.get_parameter(name).float()

    @torch.no_grad()
    def quantize_experts_(self):
        """(Re)build every block's int8 experts from the f32 weights and,
        where an int8 MoE kernel can read them (``use_int8_moe``, two
        routed experts picked, no identity expert: the whole-layer kernel
        and the int8 MoE kernel), the
        K-major copy their products read (``kmajor_experts``: the int8
        expert bytes once more)."""
        cfg = self.cfg
        copy = (cfg.use_int8_moe and cfg.router_top_k == 2
                and not cfg.identity_expert)
        for i, blk in enumerate(self.blocks):
            blk.experts_q = quantize_experts(*(
                self.f32_param(f"blocks.{i}.{k}")
                for k in ("experts_w1", "experts_b1", "experts_w2")))
            blk.experts_qt = kmajor_experts(blk.experts_q) if copy else None

    @torch.no_grad()
    def quantize_attn_(self):
        """(Re)build every block's int8 attention projections from the f32
        weights, and the K-major copy that the int8 attention kernels'
        products read (``kmajor_attn``: the int8 projection bytes once
        more)."""
        for i, blk in enumerate(self.blocks):
            blk.attn.attn_q = quantize_attn(*(
                self.f32_param(f"blocks.{i}.attn.{k}")
                for k in ("wqkv.kernel", "wqkv.bias", "c_proj.kernel")))
            blk.attn.attn_qt = kmajor_attn(blk.attn.attn_q)

    @torch.no_grad()
    def precast_(self, dtype: torch.dtype):
        """Cast the matmul leaves (dense kernels and biases, pos_emb, the
        f32 routed and shared expert weights) to ``dtype`` in place, once, for serving; norm
        scales stay f32. Every consumer casts these leaves to the compute
        dtype anyway, so the result is bit-identical and the per-step casts
        become no-ops. The f32 values stay behind as masters
        (``f32_param``), so that quantizing later still starts from the f32
        weights; loading a state dict restores them first."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if (leaf in ("kernel", "bias", "pos_emb")
                    or leaf.startswith(("experts_", "shared_"))) \
                    and p.dtype != dtype:
                if p.dtype == torch.float32:
                    self._f32_masters.setdefault(name, p.data)
                p.data = p.data.to(dtype)

    @torch.no_grad()
    def restore_f32_(self):
        """Undo ``precast_``: the cast leaves get their f32 masters back."""
        for name, m in self._f32_masters.items():
            self.get_parameter(name).data = m
        self._f32_masters.clear()

    def _load_from_state_dict(self, *args, **kwargs):
        # called before the children load theirs: new weights replace the
        # f32 values, not their bf16 casts
        self.restore_f32_()
        super()._load_from_state_dict(*args, **kwargs)

    @torch.no_grad()
    def stack_layers(self) -> Dict[str, torch.Tensor]:
        """Per-layer leaves stacked on a leading L axis for the megakernel
        (``fused_dit_q8c``), in the dtypes it takes: ln1/ln2, q_g/k_g and
        bqkv in f32; wqkv/wout in the compute dtype (the serving precast's
        values), or int8 with their scales sqkv/sout under use_int8_attn;
        the int8 experts; and the K-major copies of the int8 weights that
        the CUDA megakernel's s8 wgmma products read (``DIT_KMAJOR``: w1_t
        [L,E,2H,D], w2_t [L,E,D,H], each layer's slice ``kmajor_experts``
        of its experts; with use_int8_attn ``DIT_KMAJOR_ATTN``: wqkv_t
        [L,3D,D], wout_t [L,D,D], ``kmajor_attn``). Reads the blocks' int8
        weights, so it runs after the quantizers."""
        dt = self.cfg.dtype
        blocks = list(self.blocks)
        if not self.cfg.causal:
            # the JAX stack asserts it (Attention's return_weights): the
            # megakernel's attention is causal only
            raise ValueError("the megakernel's layer stack needs causal "
                             "attention; this model has causal=False")
        if any(b.experts_q is None for b in blocks) or (
                self.cfg.use_int8_attn
                and any(b.attn.attn_q is None for b in blocks)):
            raise RuntimeError("int8 weights missing: call "
                               "MoDEAgent.quantize_for_inference()")

        def stack(fn):
            return torch.stack([fn(b) for b in blocks]).contiguous()

        out = {"ln1": stack(lambda b: b.ln_1.g.float()),
               "q_g": stack(lambda b: b.attn.q_norm.g.float()),
               "k_g": stack(lambda b: b.attn.k_norm.g.float()),
               "ln2": stack(lambda b: b.ln_2.g.float())}
        if self.cfg.use_int8_attn:
            for k, f in zip(STACKED_QATTN, QuantizedAttn._fields):
                out[k] = stack(lambda b, f=f: getattr(b.attn.attn_q, f))
        else:
            out["wqkv"] = stack(lambda b: b.attn.wqkv.kernel.to(dt))
            out["bqkv"] = stack(lambda b: b.attn.wqkv.bias.to(dt).float())
            out["wout"] = stack(lambda b: b.attn.c_proj.kernel.to(dt))
        for k in QuantizedExperts._fields:
            out[k] = stack(lambda b, k=k: getattr(b.experts_q, k))
        # the K-major copies: each layer's matrices transposed
        for k, src in zip(DIT_KMAJOR, ("w1_q", "w2_q")):
            out[k] = out[src].transpose(-1, -2).contiguous()
        if self.cfg.use_int8_attn:
            for k, src in zip(DIT_KMAJOR_ATTN, ("wqkv", "wout")):
                out[k] = out[src].transpose(-1, -2).contiguous()
        return out

    @torch.no_grad()
    def stack_layers_(self):
        """Build and cache ``stack_layers()`` in ``self.stacked``, once per
        preset (not per chunk), and point every block's int8 tensors and
        their K-major copies at their slices of the stack, so that no int8
        weight is held twice."""
        self.stacked = None
        st = self.stack_layers()
        for l, blk in enumerate(self.blocks):
            blk.experts_q = QuantizedExperts(
                *(st[k][l] for k in QuantizedExperts._fields))
            blk.experts_qt = ExpertsKMajor(*(st[k][l] for k in DIT_KMAJOR))
            if self.cfg.use_int8_attn:
                blk.attn.attn_q = QuantizedAttn(
                    *(st[k][l] for k in STACKED_QATTN))
                blk.attn.attn_qt = AttnKMajor(
                    *(st[k][l] for k in DIT_KMAJOR_ATTN))
        self.stacked = st
        return st

    def process_sigma_embeddings(self, sigma):
        """log(sigma)/4 -> Linear -> Linear; sigma [S] -> [S,1,D]."""
        s = (torch.log(at_least_f32(sigma)) / 4.0).reshape(-1, 1).to(
            self.cfg.dtype)
        return self.sigma_linear(self.sigma_emb(s))[:, None, :]

    def preprocess_goals(self, goals, train: bool = False, generator=None):
        """[B,(1,)goal] -> [B,1,goal]; in training, elementwise Bernoulli
        goal drop (``goal_drop``), the draw from ``generator``."""
        cfg = self.cfg
        if goals.ndim == 2:
            goals = goals[:, None, :]
        if goals.shape[-1] == 2 * cfg.obs_dim:
            goals = goals[..., : cfg.obs_dim]
        if train and cfg.goal_drop > 0.0:
            mask = torch.rand(goals.shape, generator=generator,
                              device=goals.device) < cfg.goal_drop
            goals = goals * (1.0 - mask.to(goals.dtype))
        return goals

    def _blocks(self, x, cond_token, moe_overrides, train=False,
                generator=None, gumbel=None, return_aux=False, context=None):
        """The block stack; returns ``(x, aux_layers)``, the per-layer aux
        outputs under ``return_aux`` (else an empty list)."""
        aux_layers = []
        for i, block in enumerate(self.blocks):
            ov = None if moe_overrides is None else moe_overrides[i]
            x = block(x, cond_token, moe_override=ov, context=context,
                      layer_impl=self.layer_impl, attn_impl=self.attn_impl,
                      attn_impl_bf16=self.attn_impl_bf16,
                      moe_impl=self.moe_impl,
                      moe_impl_bf16=self.moe_impl_bf16, train=train,
                      generator=generator,
                      gumbel=None if gumbel is None else gumbel[i],
                      return_aux=return_aux)
            if return_aux:
                x, aux = x
                aux_layers.append(aux)
        return x, aux_layers

    def cond_token(self, emb_t, goal_embed):
        """Every block's cond token: the sigma token [S|B,1,D], plus the
        goal embedding [B,1,D] under ``use_goal_in_routing`` (one row per
        sample)."""
        return emb_t + goal_embed if self.cfg.use_goal_in_routing else emb_t

    def forward(self, states: Dict[str, torch.Tensor], actions, goals, sigma,
                *, moe_overrides=None, train: bool = False, generator=None,
                gumbel=None, return_aux: bool = False, context=None):
        """Predict denoised actions. states['state_images'] [B,2,obs];
        actions [B,W,act] (pre-scaled by c_in); goals [B,(1,)goal]; sigma [B].

        ``train``: goal drop, embedding dropout and every block in train
        mode (draws from ``generator``; ``gumbel`` is an optional list of
        per-layer Gumbel noise [B,T,E]). ``return_aux`` returns ``(pred,
        aux_layers)``, the per-layer router outputs. ``context`` [B,S,D]:
        the cross-attention's keys and values (default: the cond token)."""
        emb_t = self.process_sigma_embeddings(sigma)
        static_x, goal_embed = self.embed_static_tokens(states, goals, train,
                                                        generator)
        x = self._step_tokens(static_x, emb_t, actions, train, generator)
        cond = self.cond_token(emb_t, goal_embed)
        x, aux_layers = self._blocks(
            x, cond, moe_overrides, train, generator, gumbel, return_aux,
            cond if context is None else context)
        pred = self.out(self.ln(x)[:, -self.cfg.action_seq_len:, :])
        return (pred, aux_layers) if return_aux else pred

    def _embed_drop(self, x, train, generator):
        """The embedding dropout (``embed_pdrob``) in train mode."""
        return dropout(x, self.cfg.embed_pdrob, generator) if train else x

    def embed_static_tokens(self, states, goals, train: bool = False,
                            generator=None):
        """Step-invariant tokens [B, g+2, D] (the goal token unless
        ``goal_conditioned`` is off, and both camera tokens,
        position-embedded) and the raw goal embedding; in train mode with
        the goal drop and the embedding dropout (draws from
        ``generator``)."""
        cfg = self.cfg
        dt = cfg.dtype
        goals = self.preprocess_goals(goals, train, generator)
        state_embed = self.tok_emb(states["state_images"].to(dt))
        goal_embed = self.goal_emb(goals.to(dt))
        pos = self.pos_emb.to(dt)
        g = cfg.goal_seq_len
        state_x = state_embed + pos[:, g:g + 1, :]
        static_x = (torch.cat([goal_embed + pos[:, :g, :], state_x], dim=1)
                    if cfg.goal_conditioned else state_x)
        return self._embed_drop(static_x, train, generator), goal_embed

    def _step_tokens(self, static_x, emb_t, actions, train: bool = False,
                     generator=None):
        dt = self.cfg.dtype
        B = actions.shape[0]
        g = self.cfg.goal_seq_len
        action_x = self._embed_drop(
            self.action_emb(actions.to(dt)) + self.pos_emb.to(dt)[:, g:, :],
            train, generator)
        seqs = [static_x.expand(B, -1, -1), action_x]
        if self.cfg.use_noise_token_as_input:
            seqs.insert(0, emb_t.expand(B, -1, -1))
        return torch.cat(seqs, dim=1)

    def forward_precomputed(self, static_x, goal_embed, emb_t, actions, *,
                            moe_overrides=None, context=None):
        """One denoise step from the hoisted invariants: embeds only the
        action tokens; ``emb_t`` [1,1,D] is the step's sigma token, and the
        cond token of every block (``cond_token``: shared, or one row per
        sample with the goal embedding) is also the cross-attention's
        context unless one is given."""
        B = actions.shape[0]
        x = self._step_tokens(static_x, emb_t, actions)
        cond = self.cond_token(emb_t, goal_embed)
        if context is None:
            context = cond
        if self.cfg.use_cross_attention and context.shape[0] != B:
            context = context.expand(B, -1, -1)
        x, _ = self._blocks(x, cond, moe_overrides, context=context)
        return self.out(self.ln(x[:, -self.cfg.action_seq_len:, :]))

    def forward_precomputed_mega(self, static_x, goal_embed, emb_t, actions,
                                 stacked: Dict[str, torch.Tensor],
                                 idx_tables, probs_tables, step):
        """``forward_precomputed`` with the whole block stack replaced by
        ONE launch of the DiT megakernel (``self.dit_impl``) over
        ``stacked`` (``stack_layers``) and the per-layer [L,S,2] routing
        tables at row ``step``; the cond token as there."""
        x = self._step_tokens(static_x, emb_t, actions)
        blk = self.blocks[0]
        x = self.dit_impl(x, self.cond_token(emb_t, goal_embed), stacked,
                          idx_tables, probs_tables, step=step,
                          eps1=blk.ln_1.eps, eps_qk=blk.attn.q_norm.eps,
                          eps2=blk.ln_2.eps)
        return self.out(self.ln(x[:, -self.cfg.action_seq_len:, :]))

    def precompute_routing(self, sigmas):
        """Per layer (idx [S,k] int32, probs [S,k] f32) for sigmas [S]."""
        emb = self.process_sigma_embeddings(sigmas)
        return [block.route_for_cond(emb) for block in self.blocks]


def load_balancing_loss(aux_layers) -> torch.Tensor:
    """Mean over layers of the layers' load-balancing terms."""
    terms = [a["load_balancing_term"] for a in aux_layers if a is not None]
    return torch.stack(terms).mean() if terms else torch.zeros(())


def router_z_loss(aux_layers, eps: float = 1e-6) -> torch.Tensor:
    """Mean over layers of the token mean of log(sum(exp(logits)) + eps)^2,
    on the max-shifted logits the router returns."""
    losses = [(torch.log(torch.exp(a["logits"]).sum(dim=-1) + eps) ** 2)
              .mean() for a in aux_layers if a is not None]
    return torch.stack(losses).mean() if losses else torch.zeros(())
