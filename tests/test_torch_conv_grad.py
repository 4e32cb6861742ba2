"""The port's encoder conv (``models/encoders/resnet.Conv2d``) in bf16 on
the CPU: every element of its weight gradient is written. A 3x3 conv at
stride 2 over a 1x1 map meets padding alone at 8 of its 9 taps, and
oneDNN's bf16 backward leaves those taps of the weight gradient holding
the allocator's old memory. Before each repeat the allocator is handed
freed buffers full of NaN, so an unwritten tap shows as non-zero or
non-finite. The gradients are held to ``jax.grad`` of the JAX package's
conv (``_conv``, flax ``nn.Conv`` in bf16) on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mode_diffusion_policy_tpu.models.encoders import resnet as jres
from mode_diffusion_policy_tpu_torch.models.encoders import resnet as tres
from torch_threads import two_torch_threads  # noqa: F401

C, B, REPEATS = 64, 4, 10
# the port's and JAX's bf16 gradients differ by the rounding of a few
# bf16 sums: within two bf16 ulps (2**-7) of the gradient's largest
# magnitude
BF16_REL = 2.0 ** -7


def _dirty_allocator(*numels):
    for n in numels:
        for dt in (torch.bfloat16, torch.float32):
            junk = torch.full((n,), float("nan"), dtype=dt)
            del junk


def _pad_only_mask(hw, stride):
    """[3, 3] True at the taps that meet padding alone: where the weight
    gradient of an all-ones input and cotangent is 0 (exact in float64)."""
    x = torch.ones(1, 1, hw, hw, dtype=torch.float64)
    w = torch.ones(1, 1, 3, 3, dtype=torch.float64, requires_grad=True)
    F.conv2d(x, w, None, stride, 1).sum().backward()
    return (w.grad[0, 0] == 0).numpy()


def _inputs(hw, stride, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, hw, hw, C)).astype(np.float32)       # NHWC
    k = (r.standard_normal((3, 3, C, C)) / np.sqrt(9 * C)).astype(
        np.float32)                                                 # HWIO
    n_out = (hw + 2 - 3) // stride + 1
    g = r.standard_normal((B, n_out, n_out, C)).astype(np.float32)
    return x, k, g


def _jax_grads(x, k, g, stride):
    conv = jres._conv(C, 3, stride, "conv", jnp.bfloat16)

    def loss(kernel, xx):
        y = conv.apply({"params": {"kernel": kernel}}, xx)
        return jnp.sum(y.astype(jnp.float32) * g)

    gk, gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(x))
    return np.asarray(gk).transpose(3, 2, 0, 1), np.asarray(gx)  # OIHW


def _port_grads(x, k, g, stride):
    conv = tres.Conv2d(C, C, 3, stride, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    _dirty_allocator(C * C * 9, B * C * 9)
    y = conv(xt)
    (y.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    return conv.weight.grad.numpy(), xt.grad.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("stride,hw", [(2, 1), (1, 1), (2, 2)],
                         ids=["stride2_1x1", "stride1_1x1", "stride2_2x2"])
def test_bf16_weight_grad_writes_every_tap(stride, hw):
    """At each of ``REPEATS`` fresh allocations the weight gradient is
    finite, exactly 0 at the taps that meet padding alone (as JAX's is),
    and within ``BF16_REL`` of JAX's; so is the input gradient."""
    x, k, g = _inputs(hw, stride)
    jk, jx = _jax_grads(x, k, g, stride)
    pad = _pad_only_mask(hw, stride)
    assert pad.any()                  # every case has padding-only taps
    assert not np.any(jk[:, :, pad])
    for _ in range(REPEATS):
        gk, gx = _port_grads(x, k, g, stride)
        assert np.isfinite(gk).all() and np.isfinite(gx).all()
        assert not np.any(gk[:, :, pad]), "a padding-only tap is not 0"
        scale = np.abs(jk).max()
        assert np.abs(gk - jk).max() <= BF16_REL * scale
        assert np.abs(gx - jx).max() <= BF16_REL * np.abs(jx).max()


def test_bf16_forward_is_unchanged():
    """The repair touches the backward only: the forward equals
    ``F.conv2d`` in bf16 bit for bit, at a geometry it reroutes."""
    x, k, _ = _inputs(1, 2)
    conv = tres.Conv2d(C, C, 3, 2, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    want = F.conv2d(xt.detach().bfloat16(), conv.weight.detach().bfloat16(),
                    None, 2, (1, 1))
    assert torch.equal(conv(xt), want)


def test_pad_only_taps_rule():
    """``pad_only_taps`` agrees with enumerating every tap and output."""
    for size in range(1, 9):
        for k in (1, 3, 7):
            for stride in (1, 2, 3):
                for pad in range(k // 2 + 1):
                    n_out = (size + 2 * pad - k) // stride + 1
                    if n_out < 1:
                        continue
                    want = any(
                        not any(0 <= i - pad + stride * o < size
                                for o in range(n_out)) for i in range(k))
                    assert tres.pad_only_taps(size, k, stride, pad) == want
