"""Eval-time camera preprocessing (counterpart of the eval subset of
``mode_diffusion_policy_tpu/ops/image.py``): Resize -> /255 -> CLIP
normalize, on raw uint8 frames [B, T, H, W, 3] in the JAX package's NHWC
layout. The training augmentations wait for the training slice.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

# CLIP normalization stats
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_images(x: torch.Tensor, size: int, *,
                  antialias: bool = True) -> torch.Tensor:
    """Resize [..., H, W, C] images to [..., size, size, C] (bilinear,
    antialiased when shrinking), returned in float32. Already-``size``
    inputs skip the resize: a same-size bilinear resize is the identity."""
    x = x.float()
    if x.shape[-3] == size and x.shape[-2] == size:
        return x
    lead = x.shape[:-3]
    nchw = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(size, size), mode="bilinear",
                        align_corners=False, antialias=antialias)
    return out.permute(0, 2, 3, 1).reshape(lead + (size, size, x.shape[-1]))


def scale_and_normalize(x: torch.Tensor, mean: Sequence[float] = CLIP_MEAN,
                        std: Sequence[float] = CLIP_STD) -> torch.Tensor:
    """uint8/float [0,255] -> [0,1] -> CLIP-normalized float32."""
    x = x.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def preprocess_camera(x: torch.Tensor, *, size: int = 224,
                      mean: Sequence[float] = CLIP_MEAN,
                      std: Sequence[float] = CLIP_STD) -> torch.Tensor:
    """Eval pipeline on raw uint8 [B, T, H, W, 3]: Resize -> /255 ->
    Normalize. Returns float32 [B, T, size, size, 3] on x's device."""
    B, T = x.shape[:2]
    flat = resize_images(x.reshape((B * T,) + tuple(x.shape[2:])), size)
    return scale_and_normalize(flat, mean, std).reshape(B, T, size, size, 3)
