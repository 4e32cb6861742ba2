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
from ..ops.moe import moe_ffn_dense, moe_ffn_top2_gather
from ..ops.primitives import DenseP, RMSNorm
from ..ops.quant import (AttnKMajor, ExpertsKMajor, QuantizedAttn,
                         QuantizedExperts, kmajor_attn, kmajor_experts,
                         quantize_attn, quantize_experts)


@dataclasses.dataclass(frozen=True)
class MoDeDiTConfig:
    """The inference hyperparameters of the JAX ``MoDeDiTConfig`` at the
    values the served model uses: goal-conditioned, causal, a cond-only
    router (temperature 1, renormalized top-k) and the noise token as the
    first input token. The JAX config's other options (proprio, shared or
    identity experts, cross-attention, goal-in-routing, the other kernels)
    are not fields here; ROADMAP.md lists them."""

    obs_dim: int = 2048            # FiLM-ResNet-50 feature dim
    goal_dim: int = 512            # CLIP text embedding dim
    action_dim: int = 7
    embed_dim: int = 1024
    n_layers: int = 12
    n_heads: int = 8
    goal_seq_len: int = 1
    obs_seq_len: int = 1
    action_seq_len: int = 10
    num_experts: int = 4
    top_k: int = 2
    dtype: torch.dtype = torch.float32
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
    def fused_attn(self) -> bool:
        """Whether the attention sub-block outside the fused layer is one
        kernel launch (JAX ``NoiseBlockMoE``'s ``use_fused_attn``)."""
        return self.use_pallas_attn and \
            (self.embed_dim // self.n_heads) % 128 == 0

    @property
    def fused_layer(self) -> bool:
        """Whether the routed path runs the whole-layer kernel: it needs
        int8 top-2 experts and the attention kernel (JAX
        ``NoiseBlockMoE.__call__``); otherwise ``use_fused_layer`` is
        inert."""
        return (self.use_fused_layer and self.use_int8_moe
                and self.top_k == 2 and self.fused_attn)

    @property
    def megakernel(self) -> bool:
        """Whether the hoisted routed path runs the DiT megakernel: the
        conditions of the JAX agent (int8 top-2 experts, the attention
        kernel, head_dim % 128 == 0); otherwise ``use_megakernel`` is
        inert."""
        return (self.use_megakernel and self.use_int8_moe
                and self.top_k == 2 and self.fused_attn)

    @property
    def seq_size(self) -> int:
        return self.goal_seq_len + self.obs_seq_len - 1 + self.action_seq_len


class Attention(nn.Module):
    """Causal multi-head self-attention with per-head QK RMSNorm; QKV is one
    fused projection."""

    def __init__(self, cfg: MoDeDiTConfig, device=None):
        super().__init__()
        D, H = cfg.embed_dim, cfg.n_heads
        self.H, self.hd, self.dtype = H, D // H, cfg.dtype
        self.wqkv = DenseP(D, 3 * D, True, cfg.dtype, device)
        self.c_proj = DenseP(D, D, False, cfg.dtype, device)
        self.q_norm = RMSNorm(self.hd, eps=1e-6, device=device)
        self.k_norm = RMSNorm(self.hd, eps=1e-6, device=device)
        # int8 projections, quantized from the f32 weights by
        # MoDeDiT.quantize_attn_ (use_int8_attn), and their K-major copy
        # for the CUDA int8 attention's products
        self.attn_q: Optional[QuantizedAttn] = None
        self.attn_qt: Optional[AttnKMajor] = None

    def forward(self, x):
        B, T, D = x.shape
        q, k, v = (t.reshape(B, T, self.H, self.hd)
                   for t in self.wqkv(x).chunk(3, dim=-1))
        q, k = self.q_norm(q), self.k_norm(k)
        logits = torch.einsum("bthd,bshd->bhts", q, k).float() \
            / math.sqrt(self.hd)
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
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
    """Noise-conditioned top-k router (eval: deterministic top-k): it sees
    only the cond token, broadcast over the tokens. Returns
    (mask [B,T,E], idx [B,T,k], router_probs [B,T,E] masked and
    renormalized, probs [B,T,E], shifted logits [B,T,E])."""

    def __init__(self, cfg: MoDeDiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.mlp = CondRouterMLP(cfg.embed_dim, cfg.num_experts, cfg.dtype,
                                 device)

    def forward(self, inputs, cond):
        cfg = self.cfg
        T = inputs.shape[1]
        router_in = (cond.repeat_interleave(T // cond.shape[1], dim=1)
                     if cond.shape[1] != T else cond)
        logits = self.mlp(router_in).float()
        logits = logits - logits.amax(dim=-1, keepdim=True)
        probs = torch.softmax(logits, dim=-1).clamp(1e-9, 1 - 1e-9)
        idx = torch.topk(probs, cfg.top_k, dim=-1).indices
        mask = F.one_hot(idx, cfg.num_experts).to(probs.dtype).sum(dim=-2)
        router_probs = probs * mask
        router_probs = router_probs / router_probs.sum(dim=-1, keepdim=True)
        return mask, idx, router_probs, probs, logits


def _routing_row(idx, p, step):
    if step is None:
        return idx, p
    return idx[step], p[step]


class NoiseBlockMoE(nn.Module):
    """``x += attn(ln_1(x) + c); x = ln_2(x); x += MoE(x)``: the second norm
    REPLACES the residual stream before the MoE, as in the reference."""

    def __init__(self, cfg: MoDeDiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, Hh, E = cfg.embed_dim, 4 * cfg.embed_dim, cfg.num_experts
        self.ln_1 = RMSNorm(D, eps=1e-6, device=device)
        self.ln_2 = RMSNorm(D, eps=1e-6, device=device)
        self.attn = Attention(cfg, device)
        self.router = RouterCond(cfg, device)
        self.experts_w1 = nn.Parameter(torch.empty(E, D, 2 * Hh, device=device))
        self.experts_b1 = nn.Parameter(torch.zeros(E, 2 * Hh, device=device))
        self.experts_w2 = nn.Parameter(torch.empty(E, Hh, D, device=device))
        # int8 experts, quantized from the f32 weights by
        # MoDeDiT.quantize_experts_ (use_int8_moe), and their K-major copy
        # for the CUDA int8 MoE's products (top-2)
        self.experts_q: Optional[QuantizedExperts] = None
        self.experts_qt: Optional[ExpertsKMajor] = None

    def forward(self, x, c, *, moe_override=None, layer_impl=fused_layer_q8c,
                attn_impl=fused_attn_block_q8, attn_impl_bf16=fused_attn_block,
                moe_impl=fused_top2_mlp_q8c, moe_impl_bf16=fused_top2_mlp):
        """moe_override: (idx [k], p [k]) rows, or (idx [S,k], p [S,k],
        step) sigma tables with the scheduled step; None routes inline.
        ``layer_impl`` is the whole-layer function used on the routed path
        when ``cfg.fused_layer`` holds. Otherwise, with ``cfg.fused_attn``,
        the attention sub-block is ``attn_impl`` (int8 projections, when the
        block holds them) or ``attn_impl_bf16``, with the block's own cond
        ``c`` ([1,1,D] shared, or [B,1,D] inline); and on the routed path
        with top-2 routing, ln_2 and the MoE are ``moe_impl`` (int8 experts,
        ``cfg.use_int8_moe``) or ``moe_impl_bf16`` (the compute-dtype
        experts, ``cfg.use_pallas_moe``). Follows JAX
        ``NoiseBlockMoE.__call__`` and ``_override_out``."""
        cfg = self.cfg
        dt = cfg.dtype
        a = self.attn
        routed_top2 = moe_override is not None and cfg.top_k == 2
        kernel_moe = routed_top2 and cfg.use_int8_moe
        if routed_top2:
            idx, p, *rest = moe_override
            step = rest[0] if rest else None
        if kernel_moe:
            if self.experts_q is None or (cfg.use_int8_attn
                                          and a.attn_q is None):
                raise RuntimeError("int8 weights missing: call "
                                   "MoDEAgent.quantize_for_inference()")
            if cfg.fused_layer:
                int8_attn = cfg.use_int8_attn
                return layer_impl(
                    x, c, self.ln_1.g, a.wqkv.kernel, a.wqkv.bias,
                    a.q_norm.g, a.k_norm.g, a.c_proj.kernel, self.ln_2.g,
                    self.experts_q, idx, p, step=step,
                    qattn=a.attn_q if int8_attn else None,
                    qexp_t=self.experts_qt,
                    qattn_t=a.attn_qt if int8_attn else None,
                    eps1=self.ln_1.eps, eps_qk=a.q_norm.eps,
                    eps2=self.ln_2.eps)
        if cfg.fused_attn:
            kw = dict(ln_eps=self.ln_1.eps, qk_eps=a.q_norm.eps)
            if cfg.use_int8_attn and a.attn_q is not None:
                x = attn_impl(x, c, self.ln_1.g, a.attn_q, a.q_norm.g,
                              a.k_norm.g, qattn_t=a.attn_qt, **kw)
            else:
                x = attn_impl_bf16(x, c, self.ln_1.g, a.wqkv.kernel,
                                   a.wqkv.bias, a.q_norm.g, a.k_norm.g,
                                   a.c_proj.kernel, **kw)
        else:
            x = x + self.attn(self.ln_1(x) + c)
        if kernel_moe:
            # ln_2 fused into the MoE function, the normed input as the
            # residual seed
            return moe_impl(x, idx, p, self.experts_q, step=step,
                            residual=True, ln_g=self.ln_2.g,
                            ln_eps=self.ln_2.eps, qexp_t=self.experts_qt)
        w1, b1, w2 = (w.to(dt) for w in (self.experts_w1, self.experts_b1,
                                         self.experts_w2))
        if routed_top2 and cfg.use_pallas_moe:
            # the bf16 kernel configuration: ln_2 fused into the MoE
            # function, the normed input as the residual seed
            return moe_impl_bf16(x, idx, p, w1, b1, w2, step=step,
                                 residual=True, ln_g=self.ln_2.g,
                                 ln_eps=self.ln_2.eps)
        x = self.ln_2(x)
        if moe_override is not None:
            idx, p, *rest = moe_override
            idx, p = _routing_row(idx, p, rest[0] if rest else None)
            return x + moe_ffn_top2_gather(x, idx, p.to(dt), w1, b1, w2)
        _, _, router_probs, _, _ = self.router(x, c)
        return x + moe_ffn_dense(x, router_probs.to(dt), w1, b1, w2)

    def route_for_cond(self, c):
        """Router only, on cond tokens [S,1,D]: top-k (idx [S,k] int32,
        probs [S,k] f32) for the per-sigma routing precompute."""
        _, idx, router_probs, _, _ = self.router(c, c)
        idx = idx[:, 0]
        p = torch.gather(router_probs[:, 0], 1, idx)
        return idx.to(torch.int32), p


class MoDeDiT(nn.Module):
    """The full MoDE DiT denoiser (inference)."""

    def __init__(self, cfg: MoDeDiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.embed_dim, cfg.dtype
        self.sigma_emb = DenseP(1, D, True, dt, device)
        self.sigma_linear = DenseP(D, D, False, dt, device)
        self.tok_emb = DenseP(cfg.obs_dim, D, False, dt, device)
        self.goal_emb = DenseP(cfg.goal_dim, D, False, dt, device)
        self.action_emb = DenseP(cfg.action_dim, D, False, dt, device)
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

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        """Random init as in the JAX package (``init_style="olmoe"``):
        kernels normal(0, 0.02) clipped to +-0.04, router kernels
        normal(0, 0.02), norm scales one, biases zero."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "g":
                p.fill_(1.0)
            elif leaf in ("bias", "experts_b1"):
                p.zero_()
            elif ".router." in name:
                p.normal_(0.0, 0.02, generator=generator)
            else:
                p.normal_(0.0, 0.02, generator=generator).clamp_(-0.04, 0.04)

    def f32_param(self, name: str) -> torch.Tensor:
        """The f32 value of parameter ``name``: its master copy when the
        serving precast has cast it, else the parameter itself."""
        m = self._f32_masters.get(name)
        return m if m is not None else self.get_parameter(name).float()

    @torch.no_grad()
    def quantize_experts_(self):
        """(Re)build every block's int8 experts from the f32 weights and,
        where an int8 MoE kernel can read them (``use_int8_moe`` with top-2
        routing: the whole-layer kernel and the int8 MoE kernel), the
        K-major copy their products read (``kmajor_experts``: the int8
        expert bytes once more)."""
        copy = self.cfg.use_int8_moe and self.cfg.top_k == 2
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
        f32 expert weights) to ``dtype`` in place, once, for serving; norm
        scales stay f32. Every consumer casts these leaves to the compute
        dtype anyway, so the result is bit-identical and the per-step casts
        become no-ops. The f32 values stay behind as masters
        (``f32_param``), so that quantizing later still starts from the f32
        weights; loading a state dict restores them first."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if (leaf in ("kernel", "bias", "pos_emb")
                    or leaf.startswith("experts_")) and p.dtype != dtype:
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
        s = (torch.log(sigma.float()) / 4.0).reshape(-1, 1).to(self.cfg.dtype)
        return self.sigma_linear(self.sigma_emb(s))[:, None, :]

    def preprocess_goals(self, goals):
        cfg = self.cfg
        if goals.ndim == 2:
            goals = goals[:, None, :]
        if goals.shape[-1] == 2 * cfg.obs_dim:
            goals = goals[..., : cfg.obs_dim]
        return goals

    def _blocks(self, x, cond_token, moe_overrides):
        for i, block in enumerate(self.blocks):
            ov = None if moe_overrides is None else moe_overrides[i]
            x = block(x, cond_token, moe_override=ov,
                      layer_impl=self.layer_impl, attn_impl=self.attn_impl,
                      attn_impl_bf16=self.attn_impl_bf16,
                      moe_impl=self.moe_impl,
                      moe_impl_bf16=self.moe_impl_bf16)
        return x

    def forward(self, states: Dict[str, torch.Tensor], actions, goals, sigma,
                *, moe_overrides=None):
        """Predict denoised actions (eval). states['state_images'] [B,2,obs];
        actions [B,W,act] (pre-scaled by c_in); goals [B,(1,)goal]; sigma [B]."""
        cfg = self.cfg
        dt = cfg.dtype
        emb_t = self.process_sigma_embeddings(sigma)
        static_x, _ = self.embed_static_tokens(states, goals)
        g = cfg.goal_seq_len
        action_x = self.action_emb(actions.to(dt)) + self.pos_emb.to(dt)[:, g:, :]
        x = self._blocks(torch.cat([emb_t, static_x, action_x], dim=1), emb_t,
                         moe_overrides)
        return self.out(self.ln(x)[:, -cfg.action_seq_len:, :])

    def embed_static_tokens(self, states, goals):
        """Step-invariant tokens [B, g+2, D] (goal token + both camera tokens,
        position-embedded) and the raw goal embedding."""
        cfg = self.cfg
        dt = cfg.dtype
        goals = self.preprocess_goals(goals)
        state_embed = self.tok_emb(states["state_images"].to(dt))
        goal_embed = self.goal_emb(goals.to(dt))
        pos = self.pos_emb.to(dt)
        g = cfg.goal_seq_len
        state_x = state_embed + pos[:, g:g + 1, :]
        return torch.cat([goal_embed + pos[:, :g, :], state_x], dim=1), \
            goal_embed

    def _step_tokens(self, static_x, emb_t, actions):
        dt = self.cfg.dtype
        B = actions.shape[0]
        g = self.cfg.goal_seq_len
        action_x = self.action_emb(actions.to(dt)) + self.pos_emb.to(dt)[:, g:, :]
        return torch.cat([emb_t.expand(B, -1, -1), static_x.expand(B, -1, -1),
                          action_x], dim=1)

    def forward_precomputed(self, static_x, goal_embed, emb_t, actions, *,
                            moe_overrides=None):
        """One denoise step from the hoisted invariants: embeds only the
        action tokens; ``emb_t`` [1,1,D] is the step's sigma token and also
        the (shared) cond token of every block."""
        x = self._step_tokens(static_x, emb_t, actions)
        x = self._blocks(x, emb_t, moe_overrides)
        return self.out(self.ln(x[:, -self.cfg.action_seq_len:, :]))

    def forward_precomputed_mega(self, static_x, goal_embed, emb_t, actions,
                                 stacked: Dict[str, torch.Tensor],
                                 idx_tables, probs_tables, step):
        """``forward_precomputed`` with the whole block stack replaced by
        ONE launch of the DiT megakernel (``self.dit_impl``) over
        ``stacked`` (``stack_layers``) and the per-layer [L,S,2] routing
        tables at row ``step``."""
        x = self._step_tokens(static_x, emb_t, actions)
        blk = self.blocks[0]
        x = self.dit_impl(x, emb_t, stacked, idx_tables, probs_tables,
                          step=step, eps1=blk.ln_1.eps,
                          eps_qk=blk.attn.q_norm.eps, eps2=blk.ln_2.eps)
        return self.out(self.ln(x[:, -self.cfg.action_seq_len:, :]))

    def precompute_routing(self, sigmas):
        """Per layer (idx [S,k] int32, probs [S,k] f32) for sigmas [S]."""
        emb = self.process_sigma_embeddings(sigmas)
        return [block.route_for_cond(emb) for block in self.blocks]
