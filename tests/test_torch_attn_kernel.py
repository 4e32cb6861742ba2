"""The attention sub-block's plain PyTorch versions against the JAX Pallas
kernels (interpret mode, as tests/test_pallas_attn.py runs them) on the CPU
at D=256, 2 heads of 128, B=3, T=14: ``fused_attn_block_ref`` (bf16
projections) against ``fused_attn_block`` with a shared cond row, one per
sample and one per token, in f32 within 2e-5 and in bf16; and
``fused_attn_block_q8_ref`` (int8 projections) against
``fused_attn_block_q8`` with a shared cond row and one per sample. Each
composed with the plain MoE is the plain fused layer, exactly.

Tolerance of the int8 variant: tests/test_torch_layer_kernel.py's
flip-aware gate. The int8
products are exact on both sides, but f32 sums taken in another order
(XLA vs PyTorch) now and then move a per-row int8 rounding of ``h`` or
``o`` by one step, and one such flip moves a whole output row by about a
quantum times a weight. So mean <= 1e-4, max <= 5e-3, and 90% of the
elements within 2e-5. ``test_int8_flips_explain_the_difference`` shows
that those flips are the whole difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.ops.pallas import quant_math as jqm
from mode_diffusion_policy_tpu.ops.pallas.attn_kernel import (
    fused_attn_block as jax_attn)
from mode_diffusion_policy_tpu.ops.pallas.attn_kernel import (
    fused_attn_block_q8 as jax_attn_q8)
from mode_diffusion_policy_tpu.ops.quant import quantize_attn as jax_qattn
from mode_diffusion_policy_tpu_torch.ops.kernels._common import (
    _attend, _cond_rows, _rmsnorm_rows)
from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
    fused_attn_block, fused_attn_block_q8, fused_attn_block_q8_ref,
    fused_attn_block_ref)
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
    fused_layer_q8c_ref)
from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
    fused_top2_mlp_q8c_ref)
from mode_diffusion_policy_tpu_torch.ops.kernels.quant_math import (
    dot_i8, quant_rows)
from mode_diffusion_policy_tpu_torch.ops.quant import (quantize_attn,
                                                       quantize_experts)

B, T, D, H = 3, 14, 256, 2
HD = D // H


def _inputs(seed, c_rows=1, c_tokens=1, b=B):
    r = np.random.default_rng(seed)

    def f(*shape, sc=0.05, off=0.0):
        return (r.standard_normal(shape) * sc + off).astype(np.float32)

    return dict(x=f(b, T, D, sc=0.5), c=f(c_rows, c_tokens, D, sc=0.2),
                ln=f(D, sc=0.1, off=1.0), wqkv=f(D, 3 * D),
                bqkv=f(3 * D, sc=0.02), qg=f(HD, sc=0.1, off=1.0),
                kg=f(HD, sc=0.1, off=1.0), wout=f(D, D))


def _jax(a):
    qa = jax_qattn(*(jnp.asarray(a[k]) for k in ("wqkv", "bqkv", "wout")))
    return np.asarray(jax_attn_q8(
        jnp.asarray(a["x"]), jnp.asarray(a["c"]), jnp.asarray(a["ln"]), qa,
        jnp.asarray(a["qg"]), jnp.asarray(a["kg"]), block_samples=4,
        interpret=True))


def _qa(a):
    return quantize_attn(*(torch.from_numpy(a[k])
                           for k in ("wqkv", "bqkv", "wout")))


def _torch(a, fn=fused_attn_block_q8_ref, dt=torch.float32):
    return fn(torch.from_numpy(a["x"]).to(dt), torch.from_numpy(a["c"]),
              torch.from_numpy(a["ln"]), _qa(a), torch.from_numpy(a["qg"]),
              torch.from_numpy(a["kg"]))


def _close(got, want):
    d = np.abs(got - want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert d.mean() <= 1e-4, d.mean()
    assert d.max() <= 5e-3, d.max()
    assert (d <= 2e-5).mean() >= 0.9, (d <= 2e-5).mean()


@pytest.mark.parametrize("c_rows", [1, B], ids=["shared-c", "per-sample-c"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_attn_matches_jax_kernel(seed, c_rows):
    a = _inputs(seed, c_rows)
    got = _torch(a).numpy()
    _close(got, _jax(a))


C_SHAPES = {"shared-c": (1, 1), "per-sample-c": (B, 1), "per-token-c": (B, T)}


def _bf16_args(a, dt):
    return ((torch.from_numpy(a["x"]).to(dt),) + tuple(
        torch.from_numpy(a[k]) for k in ("c", "ln", "wqkv", "bqkv", "qg",
                                         "kg", "wout")))


def _jax_bf16(a, dt=jnp.float32):
    return jax_attn(jnp.asarray(a["x"]).astype(dt), *(
        jnp.asarray(a[k]) for k in ("c", "ln", "wqkv", "bqkv", "qg", "kg",
                                    "wout")), block_samples=4, interpret=True)


@pytest.mark.parametrize("c_shape", list(C_SHAPES))
@pytest.mark.parametrize("seed", [10, 11])
def test_plain_bf16_projection_attn_matches_jax_kernel(seed, c_shape):
    """f32: within 2e-5 (the JAX f32 CPU forward gate); no int8 rounding on
    this path, so nothing flips."""
    a = _inputs(seed, *C_SHAPES[c_shape])
    got = fused_attn_block_ref(*_bf16_args(a, torch.float32)).numpy()
    np.testing.assert_allclose(got, np.asarray(_jax_bf16(a)), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("c_shape", list(C_SHAPES))
def test_plain_bf16_projection_attn_bf16_matches_jax_kernel(c_shape):
    """bf16: the same cast chain on both sides; f32 sums of bf16 products in
    another order move some outputs by one bf16 step (2^-8 relative), so
    mean |diff| <= 2^-8 * mean |out| and max |diff| <= 2^-5 * max |out|,
    chip_smoke.py's layer gates."""
    a = _inputs(12, *C_SHAPES[c_shape])
    got = fused_attn_block_ref(*_bf16_args(a, torch.bfloat16))
    want = np.asarray(_jax_bf16(a, jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    assert d.mean() <= 2.0 ** -8 * np.abs(want).mean(), d.mean()
    assert d.max() <= 2.0 ** -5 * np.abs(want).max(), d.max()


def test_cpu_bf16_wrapper_runs_plain_version_without_counting():
    a = _inputs(13, B)
    args = _bf16_args(a, torch.float32)
    before = fused_attn_block.launches
    torch.testing.assert_close(fused_attn_block(*args),
                               fused_attn_block_ref(*args), rtol=0, atol=0)
    assert fused_attn_block.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_attn_block(torch.zeros(1, 2, 64, device="meta"),
                         *([None] * 7))


@pytest.mark.parametrize("c_shape", list(C_SHAPES))
def test_cuda_width_check_takes_shared_and_per_sample_cond(c_shape):
    """The CUDA wrappers' cond: a shared row (stride 0) or one row per
    sample (stride D); a per-token cond raises, and the whole-layer and
    megakernel launchers take only the shared row."""
    from mode_diffusion_policy_tpu_torch.ops.kernels._common import (
        _check_attn_widths)
    c = torch.zeros(*C_SHAPES[c_shape], D)
    if c_shape == "per-token-c":
        with pytest.raises(ValueError, match="per sample"):
            _check_attn_widths(T, D, H, HD, c, B)
    else:
        assert _check_attn_widths(T, D, H, HD, c, B) == \
            (0 if c_shape == "shared-c" else D)
    if c_shape != "shared-c":
        with pytest.raises(ValueError, match="shared"):
            _check_attn_widths(T, D, H, HD, c)


@pytest.mark.parametrize("c_shape", ["shared-c", "per-sample-c"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_layer_is_the_bf16_two_kernel_composition(dt, c_shape):
    """With bf16 projections the plain layer equals the plain attention
    block followed by the plain MoE (ln_2 fused, normed input as the
    residual seed), exactly: tests/test_pallas_layer.py's composition, and
    what the CUDA fused_attn_block then fused_top2_mlp_q8c is held to
    against one fused_layer_q8c launch on the card."""
    a = _inputs(14, *C_SHAPES[c_shape])
    qe, ln2, idx, probs = _experts(15)
    x, c, ln1, wqkv, bqkv, qg, kg, wout = _bf16_args(a, dt)
    want = fused_layer_q8c_ref(x, c, ln1, wqkv, bqkv, qg, kg, wout, ln2, qe,
                               idx, probs, step=1, block_hidden=128)
    got = fused_top2_mlp_q8c_ref(
        fused_attn_block_ref(x, c, ln1, wqkv, bqkv, qg, kg, wout), idx,
        probs, qe, step=1, block_hidden=128, residual=True, ln_g=ln2)
    assert got.dtype == dt
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _experts(seed):
    r = np.random.default_rng(seed)
    E, HH = 4, 256
    w1, b1, w2 = (torch.from_numpy((r.standard_normal(s) * sc).astype(
        np.float32)) for s, sc in (((E, D, 2 * HH), 0.05), ((E, 2 * HH), 0.02),
                                   ((E, HH, D), 0.05)))
    ln2 = torch.from_numpy((1.0 + 0.1 * r.standard_normal(D)).astype(
        np.float32))
    idx = torch.tensor([[0, 2], [3, 1]], dtype=torch.int32)
    probs = torch.tensor([[0.7, 0.3], [0.55, 0.45]])
    return quantize_experts(w1, b1, w2), ln2, idx, probs


def test_cpu_wrapper_runs_plain_version_without_counting():
    a = _inputs(2)
    before = fused_attn_block_q8.launches
    got = _torch(a, fn=fused_attn_block_q8)
    torch.testing.assert_close(got, _torch(a), rtol=0, atol=0)
    assert fused_attn_block_q8.launches == before


def test_attn_wrapper_rejects_other_devices():
    x = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_attn_block_q8(x, None, None, None, None, None)


def test_bf16_follows_cast_chain():
    """In bf16 the plain version returns bf16 near its f32 evaluation."""
    a = _inputs(3)
    out32 = _torch(a)
    out16 = _torch(a, dt=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    assert (out16.float() - out32).abs().mean() < 2e-2


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_layer_is_the_two_kernel_composition(dt):
    """With int8 projections the plain layer equals the plain attention
    block followed by the plain MoE (ln_2 fused, normed input as the
    residual seed), exactly: tests/test_pallas_layer.py's composition."""
    a = _inputs(4)
    qe, ln2, idx, probs = _experts(5)
    x, c = torch.from_numpy(a["x"]).to(dt), torch.from_numpy(a["c"])
    ln1, qg, kg = (torch.from_numpy(a[k]) for k in ("ln", "qg", "kg"))
    qa = _qa(a)
    want = fused_layer_q8c_ref(x, c, ln1, None, None, qg, kg, None, ln2, qe,
                               idx, probs, step=1, qattn=qa,
                               block_hidden=128)
    got = fused_top2_mlp_q8c_ref(
        fused_attn_block_q8_ref(x, c, ln1, qa, qg, kg), idx, probs, qe,
        step=1, block_hidden=128, residual=True, ln_g=ln2)
    assert got.dtype == dt
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- where the port and the JAX kernel differ ------------------------------

def _port_chain(a, hq_hs=None, oq_os=None):
    """The plain version's steps written out with the port's helpers,
    optionally with the int8 rows of h and o handed in; returns (out, the
    int8 rows and scales it used)."""
    x = torch.from_numpy(a["x"])
    b = x.shape[0]
    qa = _qa(a)
    x32 = x.reshape(b * T, D)
    h = _rmsnorm_rows(x32, torch.from_numpy(a["ln"]), 1e-6) \
        + _cond_rows(torch.from_numpy(a["c"]), x)
    hq, hs = hq_hs if hq_hs is not None else quant_rows(h)
    qkv = dot_i8(hq, qa.wqkv_q).float() * (hs * qa.wqkv_s[None]) + qa.bqkv
    o = _attend(qkv, torch.from_numpy(a["qg"]), torch.from_numpy(a["kg"]), b,
                T, torch.float32, 1e-6, torch.float32, torch.float32)
    oq, os_ = oq_os if oq_os is not None else quant_rows(o)
    y = dot_i8(oq, qa.wout_q).float() * (os_ * qa.wout_s[None])
    return (x32 + y).reshape(b, T, D).numpy(), (hq, hs), (oq, os_)


def _jax_chain(a):
    """The JAX kernel's body (_kernel_q8) on whole arrays, with the JAX
    package's quant_rows and its one-hot head norm: returns (out, (hq, hs),
    (oq, os))."""
    qa = jax_qattn(*(jnp.asarray(a[k]) for k in ("wqkv", "bqkv", "wout")))
    b = a["x"].shape[0]
    x32 = jnp.asarray(a["x"]).reshape(b * T, D)
    norm = jnp.sqrt(jnp.sum(x32 * x32, axis=1, keepdims=True)) * (D ** -0.5)
    h = x32 / jnp.maximum(norm, 1e-6) * jnp.asarray(a["ln"]) \
        + jnp.asarray(a["c"]).reshape(-1, 1, D).repeat(b // len(a["c"]), 0
                                                      ).repeat(T, 1
                                                               ).reshape(-1, D)
    hq, hs = jqm.quant_rows(h)
    qkv = jqm.dot_i8(hq, qa.wqkv_q).astype(jnp.float32) \
        * (hs * qa.wqkv_s[None, :]) + qa.bqkv
    onehot = (np.arange(D)[:, None] // HD == np.arange(H)[None]).astype(
        np.float32)

    def headnorm(t, g):
        n = jnp.sqrt(jnp.dot(t * t, onehot)) * (HD ** -0.5)
        rows = jnp.dot(1.0 / jnp.maximum(n, 1e-6), onehot.T)
        return t * rows * jnp.tile(jnp.asarray(g), H)[None]

    q = headnorm(qkv[:, :D], a["qg"]).reshape(b, T, H, HD)
    k = headnorm(qkv[:, D:2 * D], a["kg"]).reshape(b, T, H, HD)
    v = qkv[:, 2 * D:].reshape(b, T, H, HD)
    sc = jnp.einsum("bthd,bshd->bhts", q, k) * float(1.0 / np.sqrt(HD))
    sc = jnp.where(jnp.tril(jnp.ones((T, T), bool)), sc, -1e30)
    o = jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(sc, axis=-1),
                   v).reshape(b * T, D)
    oq, os_ = jqm.quant_rows(o)
    y = jqm.dot_i8(oq, qa.wout_q).astype(jnp.float32) * (os_ * qa.wout_s)
    out = np.asarray(x32 + y).reshape(b, T, D)
    return out, (hq, hs), (oq, os_)


# 64 samples: enough int8 entries (229,376 per quantization) that the two
# packages' f32 roundings put some of them on different sides of a .5
FLIP_B = 64


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_int8_flips_explain_the_difference(seed):
    """The int8 rows of h and o that each package's own quant_rows makes
    from its own f32 values differ in a few entries, each by one step; with
    the JAX rows handed to the port's chain the outputs agree within 2e-5.
    So the distance between the port's plain version and the JAX kernel is
    those rounding flips and nothing else. Two JAX evaluations of the same
    kernel body (the Pallas kernel in interpret mode and the body on whole
    arrays) differ by such flips as well: a flipped entry of oq moves its
    whole output row (up to ~7e-3 here), so that comparison is gated on the
    mean and on the share of untouched elements only."""
    a = _inputs(seed, b=FLIP_B)
    kernel = _jax(a)
    ref = _torch(a).numpy()
    out_p, (hq_p, _), (oq_p, _) = _port_chain(a)
    np.testing.assert_array_equal(out_p, ref)      # the chain as written out
    out_j, (hq_j, hs_j), (oq_j, os_j) = _jax_chain(a)
    d = np.abs(out_j - kernel)
    assert d.mean() <= 1e-4 and (d <= 2e-5).mean() >= 0.9
    flips = {}
    for name, p, j in (("hq", hq_p, hq_j), ("oq", oq_p, oq_j)):
        diff = p.numpy().astype(np.int32) - np.asarray(j).astype(np.int32)
        assert np.abs(diff).max() <= 1, name
        flips[name] = int((diff != 0).sum())
    assert flips["hq"] + flips["oq"] > 0, "no flip at this seed"
    out_s, _, _ = _port_chain(a, *(
        tuple(torch.from_numpy(np.array(t)) for t in pair)
        for pair in ((hq_j, hs_j), (oq_j, os_j))))
    np.testing.assert_allclose(out_s, out_j, rtol=0, atol=2e-5)
    print(f"seed {seed}: {flips['hq']} of {hq_p.numel()} hq and "
          f"{flips['oq']} of {oq_p.numel()} oq entries differ by one step; "
          f"port vs JAX kernel max {np.abs(ref - kernel).max():.2e}, JAX "
          f"body vs JAX kernel max {d.max():.2e}; with the JAX rows "
          f"substituted max {np.abs(out_s - out_j).max():.2e}")
