"""Camera preprocessing and the training augmentations (counterpart of
``mode_diffusion_policy_tpu/ops/image.py``), on raw uint8 frames
[B, T, H, W, 3] in the JAX package's NHWC layout.

Eval: Resize -> /255 -> CLIP normalize. Train (``preprocess_camera(...,
train=True)``): Resize -> random shift -> /255 -> (optional) colour jitter
-> (optional) random erasing -> normalize.

Every random function takes its draws as an argument (``shifts``,
``factors``, ``draws``...), beside a ``draw_*`` function that takes them
from a ``torch.Generator``; a test can hand the JAX function's own
``jax.random`` draws to the transform.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

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


def draw_shifts(generator, B: int, pad: int, device=None) -> torch.Tensor:
    """Integer crop offsets [B, 2] in [0, 2*pad] for ``random_shift_aug``."""
    return torch.randint(0, 2 * pad + 1, (B, 2), generator=generator,
                         device=device)


def random_shift_aug(x: torch.Tensor, pad: int,
                     shifts: torch.Tensor) -> torch.Tensor:
    """DrQ-v2 random shift: replicate-pad [B, H, W, C] by ``pad``, then crop
    each image at its integer offset ``shifts[b]`` (rows, cols)."""
    B, H, W, C = x.shape
    padded = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                   mode="replicate").permute(0, 2, 3, 1)
    s = shifts.to(x.device).long()
    rows = (s[:, 0:1] + torch.arange(H, device=x.device))[:, :, None]
    cols = (s[:, 1:2] + torch.arange(W, device=x.device))[:, None, :]
    return padded[torch.arange(B, device=x.device)[:, None, None], rows, cols]


def add_gaussian_noise(x, noise, mean=0.0, std=1.0):
    """``x + noise * std + mean`` with ``noise`` standard normal of x's
    shape."""
    return x + noise * std + mean


def add_depth_noise(x, gamma, rate=1000.0):
    """Multiplicative gamma noise: ``gamma / rate * x`` with ``gamma`` one
    draw of Gamma(shape) (``draw_depth_gamma``)."""
    return gamma / rate * x


def draw_depth_gamma(generator, shape=1000.0, device=None):
    return torch._standard_gamma(torch.full((), float(shape), device=device),
                                 generator=generator)


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 luma of [..., 3] -> [..., 1]."""
    w = torch.tensor([0.2989, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return (x * w).sum(dim=-1, keepdim=True)


def _blend(img1, img2, ratio):
    return (ratio * img1 + (1.0 - ratio) * img2).clamp(0.0, 1.0)


def rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0, 1] -> HSV in [0, 1] (hue wraps)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.amax(dim=-1)
    minc = x.amin(dim=-1)
    delta = maxc - minc
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), zero)
    safe = delta.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int64), 6)[..., None]

    def choose(*opts):
        return torch.stack(opts, dim=-1).gather(-1, i)[..., 0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


def draw_color_jitter(generator, B: int, *, brightness=0.3, contrast=0.3,
                      saturation=0.3, hue=0.1, device=None):
    """Per-image factors ``fb``, ``fc``, ``fs`` [B,1,1,1] ~ U[max(0, 1-a),
    1+a], hue shifts ``fh`` [B,1,1] ~ U[-hue, hue], and one order ``perm``
    of the four ops for the call."""
    def u(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=device) \
            * (hi - lo) + lo
    shp = (B, 1, 1, 1)
    return {"fb": u(shp, max(0.0, 1 - brightness), 1 + brightness),
            "fc": u(shp, max(0.0, 1 - contrast), 1 + contrast),
            "fs": u(shp, max(0.0, 1 - saturation), 1 + saturation),
            "fh": u((B, 1, 1), -hue, hue),
            "perm": torch.randperm(4, generator=generator, device=device)}


def color_jitter(x: torch.Tensor, factors: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """torchvision ColorJitter semantics on [B, H, W, 3] floats in [0, 1]
    with the draws of ``draw_color_jitter``: brightness, contrast,
    saturation and hue in the order ``perm``, one order per call and the
    factors per image, as the JAX package does."""
    fb, fc, fs, fh = (factors[k] for k in ("fb", "fc", "fs", "fh"))

    def do_brightness(img):
        return _blend(img, torch.zeros_like(img), fb)

    def do_contrast(img):
        mean = rgb_to_grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
        return _blend(img, mean, fc)

    def do_saturation(img):
        return _blend(img, rgb_to_grayscale(img).expand_as(img), fs)

    def do_hue(img):
        hsv = rgb_to_hsv(img)
        h = torch.remainder(hsv[..., 0] + fh, 1.0)
        return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))

    ops = (do_brightness, do_contrast, do_saturation, do_hue)
    for i in factors["perm"].tolist():
        x = ops[i](x)
    return x


def draw_random_erasing(generator, B: int, *, scale=(0.02, 0.33),
                        ratio=(0.3, 3.3), attempts: int = 10, device=None):
    """The draws of ``random_erasing``: ``apply`` [B] uniform, ``area``
    [B, attempts] ~ U(scale), ``log_r`` [B, attempts] ~ U(log ratio),
    ``u_i``, ``u_j`` [B] uniform."""
    def u(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=generator, device=device) \
            * (hi - lo) + lo
    return {"apply": u((B,)), "area": u((B, attempts), *scale),
            "log_r": u((B, attempts), math.log(ratio[0]), math.log(ratio[1])),
            "u_i": u((B,)), "u_j": u((B,))}


def random_erasing(x: torch.Tensor, draws: Dict[str, torch.Tensor], *,
                   p: float = 0.2, value: float = 0.0, **_) -> torch.Tensor:
    """torchvision RandomErasing semantics on [B, H, W, C] with the draws of
    ``draw_random_erasing``: per image, with probability ``p``, set a
    rectangle of area fraction ``area`` and aspect exp(``log_r``) to
    ``value``, the first of the candidates that fits (none: no erase)."""
    B, H, W, _ = x.shape
    dev = x.device
    area = draws["area"].to(dev) * (H * W)
    aspect = torch.exp(draws["log_r"].to(dev))
    h = torch.round(torch.sqrt(area * aspect)).to(torch.int32)
    w = torch.round(torch.sqrt(area / aspect)).to(torch.int32)
    valid = (h < H) & (w < W) & (h > 0) & (w > 0)
    pick = valid.to(torch.int32).argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    h = h.gather(1, pick)[:, 0]
    w = w.gather(1, pick)[:, 0]
    i0 = (draws["u_i"].to(dev) * (H - h + 1).float()).to(torch.int32)
    j0 = (draws["u_j"].to(dev) * (W - w + 1).float()).to(torch.int32)
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    inside = ((rows >= i0[:, None, None]) & (rows < (i0 + h)[:, None, None])
              & (cols >= j0[:, None, None]) & (cols < (j0 + w)[:, None, None]))
    apply = (draws["apply"].to(dev) < p) & any_valid
    mask = inside & apply[:, None, None]
    return torch.where(mask[..., None],
                       torch.tensor(value, dtype=x.dtype, device=dev), x)


def random_word_dropout(x: torch.Tensor, u: torch.Tensor, p: float = 0.1):
    """Zero each element of the language embedding where its uniform draw
    ``u`` (x's shape) is at most ``p``; no rescaling."""
    return x * (u > p).to(x.dtype)


def relative_actions(actions, robot_obs, max_pos: float = 0.02,
                     max_orn: float = 0.05):
    """Absolute -> relative actions; actions/robot_obs [..., 7+]."""
    rel_pos = (actions[..., :3] - robot_obs[..., :3]).clamp(
        -max_pos, max_pos) / max_pos
    diff = actions[..., 3:6] - robot_obs[..., 3:6]
    rel_orn = torch.remainder(diff + math.pi, 2 * math.pi) - math.pi
    rel_orn = rel_orn.clamp(-max_orn, max_orn) / max_orn
    return torch.cat([rel_pos, rel_orn, actions[..., -1:]], dim=-1)


def normalize_vector(x, mean=0.0, std=1.0):
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    return (x - torch.as_tensor(mean, dtype=torch.float32,
                                device=x.device)) / std


def draw_camera_augmentation(generator, B: int, *, shift_pad: int = 10,
                             jitter: Optional[dict] = None,
                             erasing: Optional[dict] = None, device=None):
    """The draws of one ``preprocess_camera(train=True)`` call over B
    images (B*T for [B, T, ...] frames), in the order the pipeline uses
    them: shifts, colour jitter, erasing."""
    out = {}
    if shift_pad > 0:
        out["shifts"] = draw_shifts(generator, B, shift_pad, device)
    if jitter is not None:
        out["jitter"] = draw_color_jitter(generator, B, **jitter,
                                          device=device)
    if erasing is not None:
        kw = {k: erasing[k] for k in ("scale", "ratio", "attempts")
              if k in erasing}
        out["erasing"] = draw_random_erasing(generator, B, **kw,
                                             device=device)
    return out


def preprocess_camera(x: torch.Tensor, *, size: int = 224,
                      shift_pad: int = 10, train: bool = False,
                      mean: Sequence[float] = CLIP_MEAN,
                      std: Sequence[float] = CLIP_STD,
                      jitter: Optional[dict] = None,
                      erasing: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[dict] = None) -> torch.Tensor:
    """The per-camera pipeline on raw uint8 [B, T, H, W, 3]: Resize ->
    (train) random shift -> /255 -> (train) colour jitter -> (train) random
    erasing -> Normalize. Returns float32 [B, T, size, size, 3] on x's
    device. In train mode the draws come from ``draws``
    (``draw_camera_augmentation``'s dict) or else from ``generator``;
    ``jitter`` / ``erasing`` are the option dicts of the two optional
    augmentations."""
    B, T = x.shape[:2]
    flat = resize_images(x.reshape((B * T,) + tuple(x.shape[2:])), size)
    if train:
        if draws is None:
            draws = draw_camera_augmentation(
                generator, B * T, shift_pad=shift_pad, jitter=jitter,
                erasing=erasing, device=x.device)
        if shift_pad > 0:
            flat = random_shift_aug(flat, shift_pad, draws["shifts"])
    flat = flat / 255.0
    if train and jitter is not None:
        flat = color_jitter(flat, draws["jitter"])
    if train and erasing is not None:
        flat = random_erasing(flat, draws["erasing"], **erasing)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((flat - m) / s).reshape(B, T, size, size, 3)
