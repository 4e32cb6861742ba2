"""FiLM-conditioned ResNet camera encoders (counterpart of
``mode_diffusion_policy_tpu/models/encoders/resnet.py``):
``FiLMResNetPolicy`` at depths 18, 34 (basic blocks) and 50 (bottleneck
blocks) with stage-level FiLM, the scratch ResNet-18
``ResNetEncoderWithFiLM`` with per-block FiLM (``FilmModule``) and a
projection head (and its 128-wide ``ResNetTokenEncoderWithFiLM``), the
identity ``NoEncoder``, the inference BatchNorm fold and the space-to-depth
stem.

Public functions take the JAX package's NHWC images; convolutions run
NCHW through ``torch.nn.functional.conv2d`` (the JAX package leaves them to
XLA as well). Conv weights are stored OIHW as ``weight``; BatchNorm keeps
the JAX names: ``scale``/``bias`` parameters and ``mean``/``var`` buffers.
In train mode (``forward(..., train=True)``) BatchNorm normalizes on batch
statistics with flax's semantics and hands its running-statistics update
to ``batch_stats_updates``; ``norm="group"`` builds GroupNorm(32) under the
same names.

The int8 encoders of the ``max-throughput`` preset (``q8``, counterpart of
the JAX ``QuantConv``, ``quantize_resnet_params`` and ``infer_q8_skip``)
replace each folded conv by an int8 x int8 -> int32 conv. PyTorch has no
int8 convolution for CUDA tensors, so ``conv2d_i8`` builds the int8 patch
matrix from shifted slices of the padded NHWC input and multiplies it with
``torch._int_mm`` on CUDA (exactly, in float64, on the CPU); the JAX
package leaves this conv to XLA too. Their weights are buffers:
``kernel_q`` (int8 OIHW), ``scale``, ``bias`` and, with static activation
scales, ``act_scale``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.primitives import DenseP, at_least_f32
from ...parallel.collectives import weighted_mean
from ...parallel.mesh import active as mesh_active

STAGE_SIZES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4           # bottleneck blocks (depth 50); basic blocks: 1
BN_EPS = 1e-5
BN_MOMENTUM = 0.9      # flax's convention: new = 0.9 * old + 0.1 * batch


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


def pad_only_taps(size: int, k: int, stride: int, pad: int) -> bool:
    """Whether some tap of a ``k``-tap window at ``stride`` over ``size``
    rows, zero-padded by ``pad`` on each side, meets padding alone: tap
    ``i`` reads row ``i - pad + stride * o`` for each output ``o``."""
    n_out = (size + 2 * pad - k) // stride + 1
    for i in range(k):
        first = max(0, -((i - pad) // stride))  # first o with a row >= 0
        last = min(n_out - 1, (size - 1 - i + pad) // stride)
        if first > last:
            return True
    return False


@contextlib.contextmanager
def _onednn_off():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


class _ConvEveryTap(torch.autograd.Function):
    """``F.conv2d``, its forward unchanged, whose backward runs without
    oneDNN.

    PyTorch's CPU bf16 conv backward goes through oneDNN, which, for a
    strided conv where some tap of the window meets padding alone, leaves
    those taps of the weight gradient unwritten: they hold whatever the
    allocator's memory held (NaN at times), where XLA writes 0. With oneDNN
    off, ``convolution_backward`` takes ATen's own im2col + GEMM path, in
    bf16 as before, which writes every element."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.geometry = (stride, padding, b is not None)
        return F.conv2d(x, w, b, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, has_bias = ctx.geometry
        need = ctx.needs_input_grad
        with _onednn_off():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, w, [w.shape[0]] if has_bias else None,
                [stride, stride], list(padding), [1, 1], False, [0, 0], 1,
                [need[0], need[1], has_bias and need[2]])
        return gx, gw, gb, None, None


class Conv2d(nn.Module):
    """flax ``nn.Conv`` semantics: input and weight cast to ``dtype``;
    padding given per axis as (before, after).

    A bf16 conv on the CPU that takes gradients, with stride > 1 and a map
    small enough that some tap of the window meets padding alone
    (``pad_only_taps`` on either axis), runs its backward through
    ``_ConvEveryTap``, without oneDNN, so every tap of the weight gradient
    is written (0 at those taps, as JAX's). Its forward, and every other
    conv (CUDA, f32, stride 1, larger maps), is ``F.conv2d`` as it was."""

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
        w = self.weight.to(self.dtype)
        if self._every_tap(x, w, padding):
            return _ConvEveryTap.apply(x, w, b, self.stride, padding)
        return F.conv2d(x, w, b, self.stride, padding)

    def _every_tap(self, x, w, padding) -> bool:
        if not (x.device.type == "cpu" and x.dtype == torch.bfloat16
                and self.stride > 1 and padding != 0
                and torch.is_grad_enabled()
                and (x.requires_grad or w.requires_grad)):
            return False
        k = w.shape[-1]
        return any(pad_only_taps(n, k, self.stride, p)
                   for n, p in zip(x.shape[-2:], padding))


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact: ``torch._int_mm``
    on CUDA (it needs M > 16 and K, N multiples of 8), float64 on the CPU
    (every partial sum of this model's convs is far below 2**53)."""
    if a.device.type == "cuda":
        return torch._int_mm(a.contiguous(), b.contiguous())
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def conv_operands_i8(xq: torch.Tensor, w: torch.Tensor, stride: int,
                     pad):
    """The two int8 operands of ``conv2d_i8`` and its NHWC output shape:
    the patch matrix [B*Ho*Wo, kh*kw*C], built from shifted slices of the
    padded NHWC input, its K axis in the order (kh, kw, C) of the HWIO
    kernel flattened, and the kernel as a [kh*kw*C, O] matrix."""
    (pt, pb), (pl, pr) = pad
    O, C, kh, kw = w.shape
    xh = xq.permute(0, 2, 3, 1)
    if pt or pb or pl or pr:
        xh = F.pad(xh, (0, 0, pl, pr, pt, pb))
    B, Hp, Wp, _ = xh.shape
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    cols = [xh[:, i:i + stride * (Ho - 1) + 1:stride,
               j:j + stride * (Wo - 1) + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    patches = cols[0] if len(cols) == 1 else torch.stack(cols, dim=3)
    return (patches.reshape(B * Ho * Wo, kh * kw * C),
            w.permute(2, 3, 1, 0).reshape(kh * kw * C, O), (B, Ho, Wo, O))


def conv2d_i8(xq: torch.Tensor, w: torch.Tensor, stride: int,
              pad) -> torch.Tensor:
    """int8 NCHW ``xq`` conv int8 OIHW ``w`` -> int32 NCHW (a view with
    channels-last strides), with ``pad`` ((top, bottom), (left, right)):
    ``conv_operands_i8`` multiplied by ``int_mm``."""
    a, b, shape = conv_operands_i8(xq, w, stride, pad)
    return int_mm(a, b).reshape(shape).permute(0, 3, 1, 2)


class QuantConv(nn.Module):
    """int8 inference conv of the folded encoders: per-output-channel int8
    weights (``quantize_resnet_params``) and symmetric activation
    quantization, the conv int8 x int8 -> int32 (``conv2d_i8``), then
    ``y * post + bias`` in f32, cast to ``dtype``.

    Dynamic activation scale (``static_act=False``): one scale per call,
    max |x| over the whole tensor / 127, so the output depends on the
    batch; while ``collect`` is set, the per-input-channel max |x| and
    mean x^2 are recorded in ``calib`` (max over calls), which the
    calibration reads. Static (``static_act=True``): per-input-channel
    scales ``act_scale / 127`` whose inverse is already folded into
    ``kernel_q``, so the epilogue needs no activation factor. Both
    quantize by reciprocal multiply with round-half-even, as the JAX
    ``QuantConv`` does."""

    def __init__(self, cin, cout, k, stride=1, pad=None,
                 dtype=torch.float32, static_act=False, device=None):
        super().__init__()
        self.stride = stride
        p = k // 2
        self.pad = pad if pad is not None else ((p, p), (p, p))
        self.dtype = dtype
        self.static_act = static_act
        self.register_buffer("kernel_q", torch.zeros(
            cout, cin, k, k, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(cout, device=device))
        self.register_buffer("bias", torch.zeros(cout, device=device))
        if static_act:
            self.register_buffer("act_scale", torch.ones(cin, device=device))
        self.collect = False
        self.calib: Dict[str, torch.Tensor] = {}

    def quantize_input(self, x):
        """int8 NCHW activations of x and the f32 per-output-channel
        factor of the epilogue."""
        x32 = x.float()
        if self.static_act:
            sx = self.act_scale / 127.0
            inv = (1.0 / sx)[None, :, None, None]
            post = self.scale
        else:
            amax_c = x.abs().amax(dim=(0, 2, 3)).float()
            if self.collect:
                msq_c = (x32 * x32).mean(dim=(0, 2, 3))
                for k, v in (("act_amax", amax_c), ("act_msq", msq_c)):
                    old = self.calib.get(k)
                    self.calib[k] = v if old is None else torch.maximum(old, v)
            sx = amax_c.max().clamp_min(1e-6) / 127.0
            inv = 1.0 / sx
            post = sx * self.scale
        return torch.round(x32 * inv).clamp_(-127, 127).to(torch.int8), post

    def epilogue(self, y, post):
        """int32 NCHW conv sums -> ``y * post + bias`` in f32, cast to
        ``dtype``."""
        return (y.float() * post[None, :, None, None]
                + self.bias[None, :, None, None]).to(self.dtype)

    def forward(self, x):
        xq, post = self.quantize_input(x)
        return self.epilogue(
            conv2d_i8(xq, self.kernel_q, self.stride, self.pad), post)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels with flax's semantics: inference on the
    running statistics; in train mode on the batch statistics (f32, the
    biased variance), with the running statistics' update ``0.9 * old +
    0.1 * batch`` (flax momentum 0.9 is torch's 0.1; the batch variance is
    the biased one, where ``F.batch_norm`` would keep the unbiased).

    The update is returned, not applied: while ``batch_stats_updates``
    holds a ``sink`` dict, a train-mode forward writes its new running
    values there, and the caller applies them. A rematerialized forward
    (``torch.utils.checkpoint``) runs again in the backward pass, after
    the sink is gone, so the update is taken exactly once per step.

    In a data-parallel step (``parallel.mesh.data_parallel``) the batch
    mean and ``E[x^2]`` are means over the global batch: one reduction of
    the pair, weighted by each rank's rows, before the clamp, so the
    running statistics agree on every rank (JAX's GSPMD batch statistics;
    not ``nn.SyncBatchNorm``, whose variance is two-pass and whose running
    variance is the unbiased one). A rematerialized forward issues the
    reduction again, in the same order on every rank."""

    def __init__(self, ch, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("mean", torch.zeros(ch, device=device))
        self.register_buffer("var", torch.ones(ch, device=device))
        self.sink: Optional[Dict[str, torch.Tensor]] = None
        self.sink_key = ""

    def forward(self, x, train: bool = False):
        x32 = at_least_f32(x)
        scale, bias = self.scale.to(x32.dtype), self.bias.to(x32.dtype)
        if not train:
            y = F.batch_norm(x32, self.mean.to(x32.dtype),
                             self.var.to(x32.dtype), scale, bias,
                             training=False, eps=BN_EPS)
            return y.to(self.dtype)
        # flax's statistics: the "fast" variance E[x^2] - E[x]^2, clamped
        # at 0, differentiated through (not F.batch_norm's two-pass one);
        # in a data-parallel step both moments are global-batch means
        mean = x32.mean(dim=(0, 2, 3))
        ex2 = (x32 * x32).mean(dim=(0, 2, 3))
        mesh = mesh_active()
        if mesh is not None:
            mean, ex2 = weighted_mean(torch.stack([mean, ex2]), x32.shape[0],
                                      mesh).unbind(0)
        var = (ex2 - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + BN_EPS) * scale
        y = (x32 - mean[:, None, None]) * mul[:, None, None] \
            + bias[:, None, None]
        if self.sink is not None:
            with torch.no_grad():
                self.sink[self.sink_key + "mean"] = \
                    BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean
                self.sink[self.sink_key + "var"] = \
                    BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var
        return y.to(self.dtype)


class GroupNorm(nn.Module):
    """GroupNorm(min(32, C)) under a BatchNorm's parameter names (``scale``,
    ``bias``; no running statistics): the JAX encoders' ``norm="group"``,
    the same in train and eval."""

    def __init__(self, ch, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.groups = min(32, ch)
        self.scale = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))

    def forward(self, x, train: bool = False):
        x32 = at_least_f32(x)
        return F.group_norm(x32, self.groups, self.scale.to(x32.dtype),
                            self.bias.to(x32.dtype),
                            eps=BN_EPS).to(self.dtype)


NORMS = {"batch": BatchNorm, "group": GroupNorm}


def make_norm(kind: str, ch, dtype, device):
    if kind not in NORMS:
        raise ValueError(f"unknown encoder norm kind {kind!r} "
                         "(expected 'batch' or 'group')")
    return NORMS[kind](ch, dtype, device)


@contextlib.contextmanager
def batch_stats_updates(module: nn.Module, prefix: str = ""):
    """While open, every train-mode ``BatchNorm`` forward under ``module``
    writes its new running statistics into the yielded dict, keyed by the
    buffer's path (``prefix`` + module path + ``.mean`` / ``.var``)."""
    sink: Dict[str, torch.Tensor] = {}
    bns = [(n, m) for n, m in module.named_modules()
           if isinstance(m, BatchNorm)]
    for n, m in bns:
        m.sink, m.sink_key = sink, f"{prefix}{n}." if n else prefix
    try:
        yield sink
    finally:
        for _, m in bns:
            m.sink = None


def expansion(depth: int) -> int:
    return EXPANSION if depth == 50 else 1


def out_dim(depth: int) -> int:
    """Features of a ``FiLMResNetPolicy`` of this depth: 2048 or 512."""
    return STAGE_WIDTHS[-1] * expansion(depth)


class _Block(nn.Module):
    """The convs of a residual block, each followed by its norm unless
    ``folded`` (then the conv carries a bias); ``specs`` are (name, in,
    out, kernel, stride), the shortcut's named "downsample"."""

    def _add_convs(self, specs, dtype, folded, q8, device, norm):
        self.folded = folded
        for name, ci, co, k, s in specs:
            conv = f"conv{name}" if name != "downsample" else "downsample_conv"
            bn = f"bn{name}" if name != "downsample" else "downsample_bn"
            self.add_module(conv, QuantConv(
                ci, co, k, s, dtype=dtype, static_act=q8 == "static",
                device=device) if q8 else Conv2d(
                    ci, co, k, s, use_bias=folded, dtype=dtype,
                    device=device))
            if not folded:
                self.add_module(bn, make_norm(norm, co, dtype, device))

    def _cbn(self, x, conv, bn, train):
        x = getattr(self, conv)(x)
        return x if self.folded else getattr(self, bn)(x, train)

    def _shortcut(self, x, train):
        return (self._cbn(x, "downsample_conv", "downsample_bn", train)
                if self.has_downsample else x)


def _film(x, film):
    """Per-block FiLM ``gamma * x + beta`` on NCHW ``x``."""
    if film is None:
        return x
    gamma, beta = film
    return gamma[:, :, None, None] * x + beta[:, :, None, None]


class BasicBlock(_Block):
    """3x3 (stride here) -> 3x3, with a 1x1 projection shortcut when the
    shape changes, and an optional per-block FiLM after the second norm
    (the scratch ResNet-18)."""

    def __init__(self, cin, planes, stride=1, has_downsample=False,
                 dtype=torch.float32, folded=False, q8=False, device=None,
                 norm="batch"):
        super().__init__()
        self.has_downsample = has_downsample
        specs = [("1", cin, planes, 3, stride), ("2", planes, planes, 3, 1)]
        if has_downsample:
            specs.append(("downsample", cin, planes, 1, stride))
        self._add_convs(specs, dtype, folded, q8, device, norm)

    def forward(self, x, train: bool = False, film=None):
        out = F.relu(self._cbn(x, "conv1", "bn1", train))
        out = _film(self._cbn(out, "conv2", "bn2", train), film)
        return F.relu(out + self._shortcut(x, train))


class Bottleneck(_Block):
    """1x1 -> 3x3 (stride here, torchvision v1.5 style) -> 1x1 (x4), with a
    1x1 projection shortcut when the shape changes. ``folded`` blocks carry
    conv biases in place of their BatchNorms."""

    def __init__(self, cin, planes, stride=1, has_downsample=False,
                 dtype=torch.float32, folded=False, q8=False, device=None,
                 norm="batch"):
        super().__init__()
        self.has_downsample = has_downsample
        specs = [("1", cin, planes, 1, 1), ("2", planes, planes, 3, stride),
                 ("3", planes, planes * EXPANSION, 1, 1)]
        if has_downsample:
            specs.append(("downsample", cin, planes * EXPANSION, 1, stride))
        self._add_convs(specs, dtype, folded, q8, device, norm)

    def forward(self, x, train: bool = False, film=None):
        out = F.relu(self._cbn(x, "conv1", "bn1", train))
        out = F.relu(self._cbn(out, "conv2", "bn2", train))
        out = _film(self._cbn(out, "conv3", "bn3", train), film)
        return F.relu(out + self._shortcut(x, train))


class ResNetBackbone(nn.Module):
    """Headless ResNet-18/34 (basic blocks) or -50 (bottleneck) trunk; NCHW
    in and out.

    ``q8`` (folded trunks only): False, True (int8 convs with dynamic
    activation scales) or "static" (calibrated scales); ``q8_skip`` names
    the stages ("stem", "layer1" .. "layer4") whose convs stay float.
    ``norm``: "batch" (BatchNorm) or "group" (GroupNorm(32), the JAX
    encoders' training-mode swap) on the unfolded trunk."""

    def __init__(self, depth=50, dtype=torch.float32, folded=False,
                 q8=False, q8_skip: Tuple[str, ...] = (), device=None,
                 norm="batch"):
        super().__init__()
        if depth not in STAGE_SIZES:
            raise ValueError(f"no ResNet-{depth}: depths "
                             f"{sorted(STAGE_SIZES)}")
        if q8 and not folded:
            raise ValueError("int8 convs (q8) run on the folded trunk only")
        self.folded = folded
        if q8 and "stem" not in q8_skip:
            self.conv1 = QuantConv(12, 64, 4, 1, pad=((2, 1), (2, 1)),
                                   dtype=dtype, static_act=q8 == "static",
                                   device=device)
        elif folded:
            self.conv1 = Conv2d(12, 64, 4, 1, pad=((2, 1), (2, 1)),
                                use_bias=True, dtype=dtype, device=device)
        else:
            self.conv1 = Conv2d(3, 64, 7, 2, dtype=dtype, device=device)
            self.bn1 = make_norm(norm, 64, dtype, device)
        block, exp = ((Bottleneck, EXPANSION) if depth == 50
                      else (BasicBlock, 1))
        self.stages = []
        cin = 64
        for s, (n, width) in enumerate(zip(STAGE_SIZES[depth], STAGE_WIDTHS)):
            names = []
            for b in range(n):
                stride = 2 if (s > 0 and b == 0) else 1
                has_ds = b == 0 and (stride != 1 or cin != width * exp)
                name = f"layer{s + 1}_{b}"
                q8_b = False if f"layer{s + 1}" in q8_skip else q8
                self.add_module(name, block(cin, width, stride, has_ds,
                                            dtype, folded, q8_b, device,
                                            norm))
                names.append(name)
                cin = width * exp
            self.stages.append(names)

    def forward(self, x_nhwc, stage_films=None, train: bool = False,
                block_films=None):
        """``stage_films``: per stage (gamma, beta) applied after it as
        ``(1 + gamma) x + beta``; ``block_films``: per stage a list of per
        block (gamma, beta), applied inside each block."""
        if self.folded:
            x = space_to_depth_2x2(x_nhwc).permute(0, 3, 1, 2)
            x = self.conv1(x)
        else:
            x = self.bn1(self.conv1(x_nhwc.permute(0, 3, 1, 2)), train)
        x = F.max_pool2d(F.relu(x), 3, 2, 1)
        for s, names in enumerate(self.stages):
            for b, name in enumerate(names):
                film = None if block_films is None else block_films[s][b]
                x = getattr(self, name)(x, train, film)
            if stage_films is not None:
                gamma, beta = stage_films[s]
                x = (1.0 + gamma[:, :, None, None]) * x \
                    + beta[:, :, None, None]
        return x


class FiLMResNetPolicy(nn.Module):
    """Backbone + zero-init stage FiLM ``(1+gamma)*x + beta`` + global
    average pool: images [B,H,W,3] (NHWC), condition [B,cond] or
    [B,1,cond] -> [B, 2048] (depth 50) or [B, 512] (18, 34).
    ``train=True`` normalizes on batch statistics (see ``BatchNorm``)."""

    def __init__(self, condition_dim, depth=50, dtype=torch.float32,
                 folded=False, q8=False, q8_skip: Tuple[str, ...] = (),
                 device=None, norm="batch"):
        super().__init__()
        self.dtype = dtype
        for s, width in enumerate(STAGE_WIDTHS):
            ch = width * expansion(depth)
            for part in ("gamma", "beta"):
                d = DenseP(condition_dim, ch, dtype=dtype, device=device)
                nn.init.zeros_(d.kernel)
                self.add_module(f"film{s + 1}_{part}", d)
        self.resnet = ResNetBackbone(depth, dtype, folded, q8,
                                     tuple(q8_skip), device, norm)

    def forward(self, x, condition, train: bool = False):
        if condition.ndim == 3:
            condition = condition[:, 0, :]
        condition = condition.to(self.dtype)
        films = [(getattr(self, f"film{s + 1}_gamma")(condition),
                  getattr(self, f"film{s + 1}_beta")(condition))
                 for s in range(len(STAGE_WIDTHS))]
        x = self.resnet(x.to(self.dtype), films, train)
        return x.mean(dim=(2, 3))


class FilmModule(nn.Module):
    """SiLU -> Dense(4 * hidden) (``fc``): the (gamma, beta) pairs of a
    stage's two blocks."""

    def __init__(self, condition_dim, hidden, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.fc = DenseP(condition_dim, 4 * hidden, dtype=dtype,
                         device=device)

    def forward(self, c):
        first, second = self.fc(F.silu(c)).chunk(2, dim=-1)
        return [tuple(first.chunk(2, dim=-1)), tuple(second.chunk(2, dim=-1))]


class ResNetEncoderWithFiLM(nn.Module):
    """The scratch ResNet-18 with per-block FiLM (``film_module{1..4}``)
    and a projection head ``fc``: images [B,H,W,3] or [B,T,H,W,3],
    condition [B,cond] or [B,1,cond] (or None: no FiLM) -> [B, latent_dim]
    (or [B,T,latent_dim])."""

    def __init__(self, condition_dim, latent_dim=512, dtype=torch.float32,
                 folded=False, q8=False, q8_skip: Tuple[str, ...] = (),
                 device=None, norm="batch"):
        super().__init__()
        self.dtype = dtype
        self.latent_dim = latent_dim
        for s, width in enumerate(STAGE_WIDTHS):
            self.add_module(f"film_module{s + 1}", FilmModule(
                condition_dim, width, dtype, device))
        self.resnet = ResNetBackbone(18, dtype, folded, q8, tuple(q8_skip),
                                     device, norm)
        self.fc = DenseP(STAGE_WIDTHS[-1], latent_dim, dtype=dtype,
                         device=device)

    def forward(self, x, condition=None, train: bool = False):
        series = x.ndim == 5
        if series:
            B, T = x.shape[:2]
            x = x.reshape((B * T,) + tuple(x.shape[2:]))
            if condition is not None:
                condition = torch.cat([condition] * T, dim=0)
        films = None
        if condition is not None:
            if condition.ndim == 3:
                condition = condition[:, 0, :]
            condition = condition.to(self.dtype)
            films = [getattr(self, f"film_module{s + 1}")(condition)
                     for s in range(len(STAGE_WIDTHS))]
        x = self.resnet(x.to(self.dtype), None, train, films)
        x = self.fc(x.mean(dim=(2, 3)))
        return x.reshape(B, T, self.latent_dim) if series else x


class NoEncoder(nn.Module):
    """Identity passthrough: ``forward(x, condition=None, train=False)``
    returns ``x``."""

    def forward(self, x, condition=None, train: bool = False):
        return x


class ResNetTokenEncoderWithFiLM(ResNetEncoderWithFiLM):
    """The token-output variant of the scratch FiLM ResNet-18: the same
    computation and parameter tree as ``ResNetEncoderWithFiLM``, with a
    128-wide projection head by default."""

    def __init__(self, condition_dim, latent_dim=128, dtype=torch.float32,
                 folded=False, q8=False, q8_skip: Tuple[str, ...] = (),
                 device=None, norm="batch"):
        super().__init__(condition_dim, latent_dim, dtype, folded, q8,
                         q8_skip, device, norm)


def make_encoder(resnet_type: str, condition_dim, dtype=torch.float32,
                 **kw) -> nn.Module:
    """The agent's camera encoder for ``resnet_type`` (JAX ``MoDEAgent``):
    ``FiLMResNetPolicy`` at depth 34 or 50, the scratch
    ``ResNetEncoderWithFiLM`` (latent 512) otherwise."""
    if str(resnet_type) in ("34", "50"):
        return FiLMResNetPolicy(condition_dim, int(resnet_type), dtype, **kw)
    return ResNetEncoderWithFiLM(condition_dim, 512, dtype, **kw)


def _fold_conv_bn(weight, sd, bn, eps=BN_EPS):
    s = sd[f"{bn}.scale"] / torch.sqrt(sd[f"{bn}.var"] + eps)
    return (weight * s[:, None, None, None],
            sd[f"{bn}.bias"] - sd[f"{bn}.mean"] * s)


def fold_resnet_params(state_dict: Dict[str, torch.Tensor], eps=BN_EPS
                       ) -> Dict[str, torch.Tensor]:
    """Fold every conv+BatchNorm pair of an unfolded ``FiLMResNetPolicy``
    or ``ResNetEncoderWithFiLM`` state dict into conv weight+bias and
    rewrite the stem for the space-to-depth input; returns the state dict
    of the ``folded=True`` module. FiLM denses and the head pass
    through."""
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



def _q8_skipped(mod: str, skip) -> bool:
    """Whether conv module ``mod`` (a state-dict path) stays float under
    ``skip``: the stem is the trunk's "conv1", a stage name covers its
    blocks ("layer1" -> "resnet.layer1_*")."""
    parts = mod.split(".")
    if len(parts) < 2 or parts[0] != "resnet":
        return False
    name = parts[1]
    return (name == "conv1" and "stem" in skip) or any(
        name.startswith(s_) for s_ in skip if s_ != "stem")


def quantize_resnet_params(folded: Dict[str, torch.Tensor], act_amax=None,
                           headroom: float = 1.0, skip=()
                           ) -> Dict[str, torch.Tensor]:
    """Quantize every conv of a folded encoder state dict to symmetric
    per-output-channel int8 (``kernel_q`` OIHW, ``scale`` = max(|w|) / 127
    per output channel, dividing: ``q = round(w / scale)``); FiLM denses
    pass through. Returns the state dict of the ``q8`` module.

    With ``act_amax`` ({conv: {"act_amax": per-input-channel clip}}, as
    ``agent._clip_candidates`` builds it) the activation scales
    ``s_c = max(amax_c * headroom, 1e-6) / 127`` are folded into each
    float kernel before its quantization and kept as ``act_scale``, for
    the static ``q8="static"`` modules. ``skip`` holds stage names
    ("stem", "layer1" .. "layer4") whose convs stay float; it must match
    the module's ``q8_skip``."""
    skip = tuple(skip)
    out = {}
    quantized = set()
    for key, val in folded.items():
        mod, _, leaf = key.rpartition(".")
        if leaf != "weight" or val.ndim != 4 or _q8_skipped(mod, skip):
            continue
        kf = val.float()
        if act_amax is not None and mod in act_amax:
            amax_c = (act_amax[mod]["act_amax"].float() * headroom
                      ).clamp_min(1e-6)
            # conv(w * s_c, x / s_c) == conv(w, x)
            kf = kf * (amax_c / 127.0)[None, :, None, None]
            out[f"{mod}.act_scale"] = amax_c
        s = kf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
        out[f"{mod}.kernel_q"] = torch.round(
            kf / s[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
        out[f"{mod}.scale"] = s
        quantized.add(mod)
    for key, val in folded.items():
        mod, _, leaf = key.rpartition(".")
        if mod not in quantized:
            out[key] = val
        elif leaf == "bias":
            out[key] = val.float()
    return out


def infer_q8_skip(q8_state: Dict[str, torch.Tensor]) -> Tuple[str, ...]:
    """The ``skip`` stages of a ``quantize_resnet_params`` state dict,
    recovered from the convs that kept their float ``weight``."""
    skip = []
    if "resnet.conv1.weight" in q8_state:
        skip.append("stem")
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        blocks = {k.split(".")[1] for k in q8_state
                  if k.startswith(f"resnet.{stage}_")}
        if blocks and all(f"resnet.{b}.conv1.weight" in q8_state
                          for b in blocks):
            skip.append(stage)
    return tuple(skip)


def calibration_stats(module: nn.Module, run) -> Dict[str, Dict[str, torch.Tensor]]:
    """Run ``run()`` with every dynamic ``QuantConv`` of ``module``
    recording its input statistics; returns {conv path: {"act_amax",
    "act_msq"}} (per input channel, max over the calls), the counterpart of
    the JAX module's sown "calib" collection."""
    convs = {n: m for n, m in module.named_modules()
             if isinstance(m, QuantConv) and not m.static_act}
    with contextlib.ExitStack() as stack:
        for m in convs.values():
            m.calib, m.collect = {}, True
            stack.callback(setattr, m, "collect", False)
        run()
    return {n: dict(m.calib) for n, m in convs.items() if m.calib}
