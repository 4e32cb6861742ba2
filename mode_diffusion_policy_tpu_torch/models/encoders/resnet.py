"""FiLM-conditioned ResNet-50 camera encoder (counterpart of
``mode_diffusion_policy_tpu/models/encoders/resnet.py``: ``FiLMResNetPolicy``
with bottleneck blocks, the inference BatchNorm fold and the space-to-depth
stem).

Public functions take the JAX package's NHWC images; convolutions run
NCHW through ``torch.nn.functional.conv2d`` (the JAX package leaves them to
XLA as well). Conv weights are stored OIHW as ``weight``; BatchNorm keeps
the JAX names: ``scale``/``bias`` parameters and ``mean``/``var`` buffers.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.primitives import DenseP

STAGE_SIZES = {50: (3, 4, 6, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
BN_EPS = 1e-5


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C], channel order (r_h, r_w, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


def fold_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """Exact rewrite of a 7x7 stride-2 pad-3 conv kernel (OIHW [O,C,7,7]) as
    the 4x4 stride-1 kernel [O,4C,4,4] over a 2x2 space-to-depth input with
    padding (2,1) on each axis: tap k of the 7-tap kernel is tap 2n+r-1 of
    the zero-padded 8-tap kernel, n in [0,4), r in [0,2)."""
    O, C = w7.shape[:2]
    w8 = F.pad(w7, (1, 0, 1, 0))
    w = w8.reshape(O, C, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return w.reshape(O, 4 * C, 4, 4)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` semantics: input and weight cast to ``dtype``;
    padding given per axis as (before, after)."""

    def __init__(self, cin, cout, k, stride=1, pad=None, use_bias=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.stride = stride
        p = k // 2
        self.pad = pad if pad is not None else ((p, p), (p, p))
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if use_bias else None)

    def forward(self, x):
        (pt, pb), (pl, pr) = self.pad
        x = x.to(self.dtype)
        if pt == pb and pl == pr:
            padding = (pt, pl)
        else:
            x = F.pad(x, (pl, pr, pt, pb))
            padding = 0
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, self.stride, padding)


class BatchNorm(nn.Module):
    """Inference BatchNorm over NCHW channels with running statistics."""

    def __init__(self, ch, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("mean", torch.zeros(ch, device=device))
        self.register_buffer("var", torch.ones(ch, device=device))

    def forward(self, x):
        y = F.batch_norm(x.float(), self.mean, self.var, self.scale,
                         self.bias, training=False, eps=BN_EPS)
        return y.to(self.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, torchvision v1.5 style) -> 1x1 (x4), with a
    1x1 projection shortcut when the shape changes. ``folded`` blocks carry
    conv biases in place of their BatchNorms."""

    def __init__(self, cin, planes, stride=1, has_downsample=False,
                 dtype=torch.float32, folded=False, device=None):
        super().__init__()
        self.folded = folded
        self.has_downsample = has_downsample
        specs = [("1", cin, planes, 1, 1), ("2", planes, planes, 3, stride),
                 ("3", planes, planes * EXPANSION, 1, 1)]
        if has_downsample:
            specs.append(("downsample", cin, planes * EXPANSION, 1, stride))
        for name, ci, co, k, s in specs:
            conv = f"conv{name}" if name != "downsample" else "downsample_conv"
            bn = f"bn{name}" if name != "downsample" else "downsample_bn"
            self.add_module(conv, Conv2d(ci, co, k, s, use_bias=folded,
                                         dtype=dtype, device=device))
            if not folded:
                self.add_module(bn, BatchNorm(co, dtype, device))

    def _cbn(self, x, conv, bn):
        x = getattr(self, conv)(x)
        return x if self.folded else getattr(self, bn)(x)

    def forward(self, x):
        out = F.relu(self._cbn(x, "conv1", "bn1"))
        out = F.relu(self._cbn(out, "conv2", "bn2"))
        out = self._cbn(out, "conv3", "bn3")
        identity = (self._cbn(x, "downsample_conv", "downsample_bn")
                    if self.has_downsample else x)
        return F.relu(out + identity)


class ResNetBackbone(nn.Module):
    """Headless ResNet-50 trunk with stage-level FiLM; NCHW in and out."""

    def __init__(self, depth=50, dtype=torch.float32, folded=False,
                 device=None):
        super().__init__()
        if depth not in STAGE_SIZES:
            raise NotImplementedError(
                f"ResNet-{depth} is not ported yet (ROADMAP.md Queue 1)")
        self.folded = folded
        if folded:
            self.conv1 = Conv2d(12, 64, 4, 1, pad=((2, 1), (2, 1)),
                                use_bias=True, dtype=dtype, device=device)
        else:
            self.conv1 = Conv2d(3, 64, 7, 2, dtype=dtype, device=device)
            self.bn1 = BatchNorm(64, dtype, device)
        self.stages = []
        cin = 64
        for s, (n, width) in enumerate(zip(STAGE_SIZES[depth], STAGE_WIDTHS)):
            names = []
            for b in range(n):
                stride = 2 if (s > 0 and b == 0) else 1
                has_ds = b == 0 and (stride != 1 or cin != width * EXPANSION)
                name = f"layer{s + 1}_{b}"
                self.add_module(name, Bottleneck(cin, width, stride, has_ds,
                                                 dtype, folded, device))
                names.append(name)
                cin = width * EXPANSION
            self.stages.append(names)

    def forward(self, x_nhwc, stage_films):
        if self.folded:
            x = space_to_depth_2x2(x_nhwc).permute(0, 3, 1, 2)
            x = self.conv1(x)
        else:
            x = self.bn1(self.conv1(x_nhwc.permute(0, 3, 1, 2)))
        x = F.max_pool2d(F.relu(x), 3, 2, 1)
        for names, (gamma, beta) in zip(self.stages, stage_films):
            for name in names:
                x = getattr(self, name)(x)
            x = (1.0 + gamma[:, :, None, None]) * x + beta[:, :, None, None]
        return x


class FiLMResNetPolicy(nn.Module):
    """Backbone + zero-init stage FiLM ``(1+gamma)*x + beta`` + global
    average pool: images [B,H,W,3] (NHWC), condition [B,cond] or
    [B,1,cond] -> [B, 2048]."""

    def __init__(self, condition_dim, depth=50, dtype=torch.float32,
                 folded=False, device=None):
        super().__init__()
        self.dtype = dtype
        for s, width in enumerate(STAGE_WIDTHS):
            ch = width * EXPANSION
            for part in ("gamma", "beta"):
                d = DenseP(condition_dim, ch, dtype=dtype, device=device)
                nn.init.zeros_(d.kernel)
                self.add_module(f"film{s + 1}_{part}", d)
        self.resnet = ResNetBackbone(depth, dtype, folded, device)

    def forward(self, x, condition):
        if condition.ndim == 3:
            condition = condition[:, 0, :]
        condition = condition.to(self.dtype)
        films = [(getattr(self, f"film{s + 1}_gamma")(condition),
                  getattr(self, f"film{s + 1}_beta")(condition))
                 for s in range(len(STAGE_WIDTHS))]
        x = self.resnet(x.to(self.dtype), films)
        return x.mean(dim=(2, 3))


def _fold_conv_bn(weight, sd, bn, eps=BN_EPS):
    s = sd[f"{bn}.scale"] / torch.sqrt(sd[f"{bn}.var"] + eps)
    return (weight * s[:, None, None, None],
            sd[f"{bn}.bias"] - sd[f"{bn}.mean"] * s)


def fold_resnet_params(state_dict: Dict[str, torch.Tensor], eps=BN_EPS
                       ) -> Dict[str, torch.Tensor]:
    """Fold every conv+BatchNorm pair of an unfolded ``FiLMResNetPolicy``
    state dict into conv weight+bias and rewrite the stem for the
    space-to-depth input; returns the state dict of the ``folded=True``
    module. FiLM denses pass through."""
    sd = {k: v.float() for k, v in state_dict.items()}
    out = {}
    for key, val in sd.items():
        mod, _, leaf = key.rpartition(".")
        parent, _, name = mod.rpartition(".")
        if name.startswith("bn") or name == "downsample_bn":
            continue
        bn = ("downsample_bn" if name == "downsample_conv" else
              "bn" + name[len("conv"):] if name.startswith("conv") else None)
        bn_key = f"{parent}.{bn}" if parent else bn
        if leaf == "weight" and bn and f"{bn_key}.scale" in sd:
            w, b = _fold_conv_bn(val, sd, bn_key, eps)
            if key == "resnet.conv1.weight":
                w = fold_stem_kernel(w)
            out[key] = w
            out[f"{mod}.bias"] = b
        else:
            out[key] = val
    return out

