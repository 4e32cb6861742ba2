"""CLIP text tower, the frozen language-goal encoder (counterpart of
``mode_diffusion_policy_tpu/models/encoders/clip_text.py``).

Token embedding + learned positional embedding -> pre-LN transformer with
QuickGELU MLPs and a causal mask -> final LayerNorm -> the feature at the
EOT token -> text projection, as OpenAI CLIP's text path. The modules are
``nn.Linear`` / ``nn.LayerNorm`` in OpenAI's own layout, so an OpenAI CLIP
state dict loads by renaming (``convert_clip_text``); the attention is
spelled out in f32 as the JAX tower computes it (no fused attention), so
the two agree to f32 rounding. No Pallas kernel computes this tower (XLA
does), so stock PyTorch ops compute it here.

``LangClip`` (``__call__(list[str]) -> [B, 1, embed_dim]`` on its device)
runs once per new instruction: ``lang_cache.LangEmbeddingCache`` keeps
the results.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn

from ...utils.device import resolve_device
from .tokenizer import tokenize


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    # ViT-B/32's text tower (conf/config_calvin.yaml: clip_lang_model_name)
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512
    dtype: Any = torch.float32


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """Multi-head self-attention with one fused input projection (OpenAI's
    ``nn.MultiheadAttention`` weights: ``in_proj``, ``out_proj``): causal
    in the text tower, unmasked in the vision towers."""

    def __init__(self, width: int, heads: int, dtype, device=None,
                 causal: bool = True):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.in_proj = nn.Linear(width, 3 * width, dtype=dtype, device=device)
        self.out_proj = nn.Linear(width, width, dtype=dtype, device=device)

    def forward(self, x):
        B, T, C = x.shape
        hd = C // self.heads
        q, k, v = self.in_proj(x).split(C, dim=-1)
        q, k, v = (t.reshape(B, T, self.heads, hd).transpose(1, 2)
                   for t in (q, k, v))
        logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd)
        if self.causal:
            mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~mask, float("-inf"))
        attn = logits.softmax(dim=-1).to(x.dtype)
        y = (attn @ v).transpose(1, 2).reshape(B, T, C)
        return self.out_proj(y)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype, device=None,
                 causal: bool = True):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5, dtype=dtype, device=device)
        self.attn = CLIPAttention(width, heads, dtype, device, causal)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5, dtype=dtype, device=device)
        self.c_fc = nn.Linear(width, 4 * width, dtype=dtype, device=device)
        self.c_proj = nn.Linear(4 * width, width, dtype=dtype, device=device)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.width, device=device))
        self.positional_embedding = nn.Parameter(torch.empty(
            cfg.context_length, cfg.width, device=device))
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads, cfg.dtype, device)
            for _ in range(cfg.layers))
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5, dtype=cfg.dtype,
                                     device=device)
        self.text_projection = nn.Parameter(torch.empty(
            cfg.width, cfg.embed_dim, device=device))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        """The JAX tower's initializers: embeddings normal(0.02) and
        normal(0.01), the projection normal(0.02), dense kernels lecun
        normal with zero biases, LayerNorms one and zero."""
        self.token_embedding.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: [B, context_length] int -> [B, embed_dim]."""
        dt = self.cfg.dtype
        x = self.token_embedding[tokens].to(dt)
        x = x + self.positional_embedding[None].to(dt)
        for blk in self.resblocks:
            x = blk(x)
        x = self.ln_final(x)
        # the feature at the EOT token, the highest token id
        feats = x[torch.arange(x.shape[0], device=x.device),
                  tokens.argmax(dim=-1)]
        return feats @ self.text_projection.to(dt)


class LangClip:
    """Frozen language-goal encoder: ``__call__(texts: list[str]) ->
    [B, 1, embed_dim]`` on its device (CUDA unless ``device="cpu"``)."""

    def __init__(self, model: CLIPTextModel, model_name: str = "ViT-B/32"):
        self.model = model.eval().requires_grad_(False)
        self.cfg = model.cfg
        self.model_name = model_name
        self.device = self.model.token_embedding.device

    @classmethod
    def from_state_dict(cls, state_dict: Mapping[str, torch.Tensor],
                        cfg: CLIPTextConfig = CLIPTextConfig(), *,
                        model_name: str = "ViT-B/32", device="cuda"):
        """A tower holding ``state_dict`` (the port's names:
        ``convert_clip_text`` or ``utils/weights.from_jax_clip_text``)."""
        model = CLIPTextModel(cfg, resolve_device(device))
        model.load_state_dict(state_dict)
        return cls(model, model_name)

    @classmethod
    def initialize_random(cls, seed: int = 0,
                          cfg: CLIPTextConfig = CLIPTextConfig(), *,
                          device="cuda"):
        """A random-weight tower, drawn on the device from ``seed`` (for
        tests, and for runs without the published CLIP weights)."""
        dev = resolve_device(device)
        model = CLIPTextModel(cfg, dev)
        model.init_weights_(torch.Generator(device=dev).manual_seed(seed))
        return cls(model)

    @torch.no_grad()
    def __call__(self, texts: List[str]) -> torch.Tensor:
        tokens = tokenize(texts, self.cfg.context_length, truncate=True)
        tokens = torch.from_numpy(tokens.astype(np.int64)).to(self.device)
        return self.model(tokens)[:, None, :]


# ---------------------------------------------------------------------------
# Checkpoint conversion (OpenAI CLIP state dict -> the port's names)
# ---------------------------------------------------------------------------

def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32))


def _layer_count(keys) -> int:
    return len({k.split(".")[2] for k in keys
                if k.startswith("transformer.resblocks.")})


def convert_clip_text(state_dict: Mapping[str, Any]
                      ) -> Dict[str, torch.Tensor]:
    """The text-tower weights of an OpenAI CLIP state dict as a
    ``CLIPTextModel`` state dict (f32): a rename, the layouts are the
    same."""
    sd = state_dict
    out = {name: _f32(sd[name]) for name in (
        "token_embedding.weight", "positional_embedding", "text_projection",
        "ln_final.weight", "ln_final.bias")}
    out["token_embedding"] = out.pop("token_embedding.weight")
    for i in range(_layer_count(sd)):
        src, dst = f"transformer.resblocks.{i}.", f"resblocks.{i}."
        for a, b in (("ln_1.weight", "ln_1.weight"), ("ln_1.bias", "ln_1.bias"),
                     ("ln_2.weight", "ln_2.weight"), ("ln_2.bias", "ln_2.bias"),
                     ("attn.in_proj_weight", "attn.in_proj.weight"),
                     ("attn.in_proj_bias", "attn.in_proj.bias"),
                     ("attn.out_proj.weight", "attn.out_proj.weight"),
                     ("attn.out_proj.bias", "attn.out_proj.bias"),
                     ("mlp.c_fc.weight", "c_fc.weight"),
                     ("mlp.c_fc.bias", "c_fc.bias"),
                     ("mlp.c_proj.weight", "c_proj.weight"),
                     ("mlp.c_proj.bias", "c_proj.bias")):
            out[dst + b] = _f32(sd[src + a])
    return out


def infer_text_config(state_dict: Mapping[str, Any]) -> CLIPTextConfig:
    """The tower's config from an OpenAI CLIP state dict (64-wide heads)."""
    width = state_dict["ln_final.weight"].shape[0]
    return CLIPTextConfig(
        vocab_size=state_dict["token_embedding.weight"].shape[0],
        context_length=state_dict["positional_embedding"].shape[0],
        width=width,
        heads=width // 64,
        layers=_layer_count(state_dict),
        embed_dim=state_dict["text_projection"].shape[1],
    )
