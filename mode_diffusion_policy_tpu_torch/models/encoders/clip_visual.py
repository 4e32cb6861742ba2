"""CLIP visual towers: the vision transformer and the ModifiedResNet
(counterpart of ``mode_diffusion_policy_tpu/models/encoders/clip_visual.py``).

- ``CLIPVisionTransformer``: patch conv -> [class token; patches] +
  positional embedding -> ln_pre -> pre-LN transformer without a mask ->
  ln_post on the class token -> projection.
- ``ModifiedResNet``: a 3-conv stem with an average pool (no max pool),
  anti-aliased strides (an average pool before every stride-2 1x1 conv and
  in the downsample path) and a QKV attention pool over [mean; HW tokens]
  instead of global average pooling.

The modules keep OpenAI's own names and layouts (convs OIHW, Linears
[out, in], BatchNorm ``weight``/``bias``/``running_mean``/``running_var``),
so ``convert_clip_visual`` renames an OpenAI CLIP state dict; its
transformer blocks are the text tower's ``ResidualAttentionBlock`` without
the causal mask, as in the JAX package. BatchNorms normalize with their
running statistics, always (the towers are frozen wherever CLIP is used).
``encode_image`` takes the JAX package's NHWC images. No Pallas kernel
computes these towers (XLA does), so stock PyTorch ops compute them here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils.device import resolve_device
from .clip_text import ResidualAttentionBlock, _f32


# ---------------------------------------------------------------------------
# Vision transformer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CLIPViTConfig:
    input_resolution: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512
    dtype: Any = torch.float32


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.width, cfg.patch_size
        n_tok = (cfg.input_resolution // p) ** 2 + 1
        self.conv1 = nn.Conv2d(3, w, p, p, bias=False, dtype=cfg.dtype,
                               device=device)
        self.class_embedding = nn.Parameter(torch.empty(w, device=device))
        self.positional_embedding = nn.Parameter(torch.empty(n_tok, w,
                                                             device=device))
        self.ln_pre = nn.LayerNorm(w, eps=1e-5, dtype=cfg.dtype, device=device)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(w, cfg.heads, cfg.dtype, device,
                                   causal=False)
            for _ in range(cfg.layers))
        self.ln_post = nn.LayerNorm(w, eps=1e-5, dtype=cfg.dtype,
                                    device=device)
        self.proj = nn.Parameter(torch.empty(w, cfg.output_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, 3] NHWC float -> [B, output_dim]."""
        dt = self.cfg.dtype
        x = self.conv1(x.to(dt).permute(0, 3, 1, 2))        # [B, W, g, g]
        B = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                     # [B, g*g, W]
        cls = self.class_embedding.to(dt).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding[None].to(dt)
        x = self.ln_pre(x)
        for blk in self.resblocks:
            x = blk(x)
        return self.ln_post(x[:, 0, :]) @ self.proj.to(dt)


# ---------------------------------------------------------------------------
# ModifiedResNet
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModifiedResNetConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)   # RN50
    output_dim: int = 1024
    heads: int = 32
    input_resolution: int = 224
    width: int = 64
    dtype: Any = torch.float32


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm over NCHW with its running statistics, in train mode too
    (the JAX towers' ``use_running_average=True``)."""

    def __init__(self, ch: int, dtype, device=None, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, dtype=dtype, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(ch, dtype=dtype, device=device))
        self.register_buffer("running_var",
                             torch.ones(ch, dtype=dtype, device=device))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


def _conv(cin, cout, k, dtype, device, stride=1):
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False, dtype=dtype,
                     device=device)


class CLIPBottleneck(nn.Module):
    """All convs stride 1; an average pool after conv2 when ``stride`` > 1;
    the downsample path average pool -> 1x1 conv -> BatchNorm."""

    def __init__(self, inplanes: int, planes: int, stride: int,
                 has_downsample: bool, dtype, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 1, dtype, device)
        self.bn1 = FrozenBatchNorm2d(planes, dtype, device)
        self.conv2 = _conv(planes, planes, 3, dtype, device)
        self.bn2 = FrozenBatchNorm2d(planes, dtype, device)
        self.conv3 = _conv(planes, planes * 4, 1, dtype, device)
        self.bn3 = FrozenBatchNorm2d(planes * 4, dtype, device)
        # OpenAI's nn.Sequential(AvgPool2d, conv, bn): indices 0 (the conv
        # weights sit at downsample.0 in its state dict) and 1
        self.downsample = nn.ModuleDict({
            "0": _conv(inplanes, planes * 4, 1, dtype, device),
            "1": FrozenBatchNorm2d(planes * 4, dtype, device),
        }) if has_downsample else None

    def _pool(self, x):
        return F.avg_pool2d(x, self.stride) if self.stride > 1 else x

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self._pool(out)))
        identity = x
        if self.downsample is not None:
            identity = self.downsample["1"](self.downsample["0"](
                self._pool(x)))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """[mean; HW tokens] + positional embedding, one multi-head attention
    step whose only query is the mean token, then ``c_proj``."""

    def __init__(self, embed_dim: int, heads: int, output_dim: int,
                 n_tokens: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(
            n_tokens, embed_dim, device=device))
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, nn.Linear(embed_dim, embed_dim, dtype=dtype,
                                          device=device))
        self.c_proj = nn.Linear(embed_dim, output_dim, dtype=dtype,
                                device=device)

    def forward(self, x):
        """x: [B, H, W, C] -> [B, output_dim]."""
        B, H, W, C = x.shape
        x = x.reshape(B, H * W, C)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding[None].to(x.dtype)
        hd = C // self.heads
        q = self.q_proj(x[:, :1]).reshape(B, 1, self.heads, hd)
        k = self.k_proj(x).reshape(B, -1, self.heads, hd)
        v = self.v_proj(x).reshape(B, -1, self.heads, hd)
        logits = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(hd)
        attn = logits.softmax(dim=-1).to(x.dtype)
        y = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, C)
        return self.c_proj(y)


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: ModifiedResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w, dt = cfg.width, cfg.dtype
        # the 3-conv stem (the first conv strided)
        self.conv1 = _conv(3, w // 2, 3, dt, device, stride=2)
        self.bn1 = FrozenBatchNorm2d(w // 2, dt, device)
        self.conv2 = _conv(w // 2, w // 2, 3, dt, device)
        self.bn2 = FrozenBatchNorm2d(w // 2, dt, device)
        self.conv3 = _conv(w // 2, w, 3, dt, device)
        self.bn3 = FrozenBatchNorm2d(w, dt, device)
        in_ch = w
        for s, n_blocks in enumerate(cfg.layers):
            planes = w * (2 ** s)
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                has_ds = b == 0 and (stride > 1 or in_ch != planes * 4)
                blocks.append(CLIPBottleneck(in_ch, planes, stride, has_ds,
                                             dt, device))
                in_ch = planes * 4
            self.add_module(f"layer{s + 1}", nn.ModuleList(blocks))
        n_tok = (cfg.input_resolution // 32) ** 2 + 1
        self.attnpool = AttentionPool2d(w * 32, cfg.heads, cfg.output_dim,
                                        n_tok, dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, 3] NHWC float -> [B, output_dim]."""
        x = x.to(self.cfg.dtype).permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        for s in range(len(self.cfg.layers)):
            for blk in getattr(self, f"layer{s + 1}"):
                x = blk(x)
        return self.attnpool(x.permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# Checkpoint conversion (OpenAI CLIP state dict -> the port's modules)
# ---------------------------------------------------------------------------

def infer_visual_config(state_dict: Mapping[str, Any]):
    """The visual tower's architecture from an OpenAI CLIP state dict, as
    CLIP's ``build_model`` sniffs it. Returns ('vit', CLIPViTConfig) or
    ('resnet', ModifiedResNetConfig)."""
    sd = state_dict
    if "visual.proj" in sd:
        width = sd["visual.conv1.weight"].shape[0]
        patch = sd["visual.conv1.weight"].shape[-1]
        layers = len({k.split(".")[3] for k in sd
                      if k.startswith("visual.transformer.resblocks.")})
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        return "vit", CLIPViTConfig(
            input_resolution=patch * grid, patch_size=patch, width=width,
            layers=layers, heads=width // 64,
            output_dim=sd["visual.proj"].shape[1])
    counts = []
    for b in (1, 2, 3, 4):
        blocks = {k.split(".")[2] for k in sd
                  if k.startswith(f"visual.layer{b}.")}
        counts.append(len(blocks))
    width = sd["visual.layer1.0.conv1.weight"].shape[0]
    embed_dim = width * 32
    output_dim = sd["visual.attnpool.c_proj.weight"].shape[0]
    spacial = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1)
                    ** 0.5)
    return "resnet", ModifiedResNetConfig(
        layers=tuple(counts), output_dim=output_dim,
        heads=embed_dim // 64, input_resolution=spacial * 32, width=width)


# OpenAI's ViT block names -> the port's ResidualAttentionBlock's
_VIT_BLOCK = (("attn.in_proj_weight", "attn.in_proj.weight"),
              ("attn.in_proj_bias", "attn.in_proj.bias"),
              ("mlp.c_fc.", "c_fc."), ("mlp.c_proj.", "c_proj."))


def convert_clip_visual(state_dict: Mapping[str, Any]):
    """An OpenAI CLIP state dict -> (kind, config, state dict of the port's
    visual tower, f32 on the CPU): ``build_visual`` loads it."""
    kind, cfg = infer_visual_config(state_dict)
    out: Dict[str, torch.Tensor] = {}
    for k, v in state_dict.items():
        if not k.startswith("visual.") or k.endswith("num_batches_tracked"):
            continue
        k = k[len("visual."):]
        if kind == "vit" and k.startswith("transformer.resblocks."):
            k = k[len("transformer."):]
            for a, b in _VIT_BLOCK:
                k = k.replace(a, b)
        out[k] = _f32(v)
    return kind, cfg, out


def build_visual(kind: str, cfg, state_dict: Mapping[str, torch.Tensor], *,
                 device="cuda") -> nn.Module:
    """The visual tower of ``kind`` holding ``state_dict``
    (``convert_clip_visual``'s), frozen, on ``device``."""
    dev = resolve_device(device)
    model = (CLIPVisionTransformer(cfg, dev) if kind == "vit"
             else ModifiedResNet(cfg, dev))
    model.load_state_dict(state_dict)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def random_visual_state_dict(kind: str, cfg, seed: int = 0, *,
                             device="cpu") -> Dict[str, torch.Tensor]:
    """A random-weight visual tower of ``kind`` as an OpenAI CLIP state
    dict (``visual.``-prefixed, OpenAI's names and layouts, BatchNorm
    ``num_batches_tracked`` included), drawn on ``device`` from ``seed``:
    for tests and runs without the published weights. Convs and Linears
    draw normal(0, fan_in^-1/2), embeddings normal(0, width^-1/2), biases
    and BatchNorm shifts normal(0, 0.05), norm scales 1 + normal(0, 0.1),
    running variances uniform(0.5, 1.5)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = (CLIPVisionTransformer(cfg, dev) if kind == "vit"
             else ModifiedResNet(cfg, dev))
    out = {}
    for name, t in model.state_dict().items():
        t = torch.empty(t.shape, dtype=torch.float32, device=dev)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            t.uniform_(0.5, 1.5, generator=gen)
        elif leaf in ("bias", "running_mean"):
            t.normal_(0.0, 0.05, generator=gen)
        elif t.ndim == 1:      # LayerNorm / BatchNorm scales, class token
            t.normal_(0.0, 0.1, generator=gen)
            if leaf == "weight":
                t += 1.0
        elif "embedding" in leaf or leaf == "proj":
            t.normal_(0.0, t.shape[-1] ** -0.5, generator=gen)
        else:                  # conv OIHW, Linear [out, in]
            t.normal_(0.0, (t[0].numel()) ** -0.5, generator=gen)
        if kind == "vit" and name.startswith("resblocks."):
            name = "transformer." + name
            for a, b in _VIT_BLOCK:
                name = name.replace(b, a)
        out["visual." + name] = t
        if leaf == "running_var":
            out["visual." + name[:-len("running_var")]
                + "num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.int64, device=dev)
    return out


@torch.no_grad()
def encode_image(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """CLIP's ``encode_image``: NHWC images [B, H, W, 3] on the tower's
    device -> [B, output_dim]."""
    return model(images)
