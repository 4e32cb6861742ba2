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
    """The CUDA wrappers' cond: a shared row (1 cond row), one row per
    sample (B rows) or one per token (B*T rows: each x row reads its own),
    at T=1, 14, 17 and 160 tokens per sample; a cond with another row count
    raises."""
    from mode_diffusion_policy_tpu_torch.ops.kernels._common import (
        _check_attn_widths)
    for t in (1, T, 17, 160):
        b_rows, t_rows = C_SHAPES[c_shape]
        c = torch.zeros(b_rows, t if c_shape == "per-token-c" else t_rows, D)
        want = {"shared-c": 1, "per-sample-c": B,
                "per-token-c": B * t}[c_shape]
        assert _check_attn_widths(t, D, H, HD, c, B) == want
        if c_shape != "shared-c":
            with pytest.raises(ValueError, match="per token"):
                _check_attn_widths(t, D, H, HD, c, B + 1)


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


# ---- the K-major copy of the int8 projections that the CUDA kernels'
# wgmma products read, and the projections' tile plan (no card needed)

from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (  # noqa: E402,E501
    need_kmajor_attn, proj_tile_plan, proj_tiles)
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (  # noqa: E402,E501
    fused_layer_q8c)
from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (  # noqa: E402,E501
    fused_top2_mlp_q8c, need_kmajor_experts)
from mode_diffusion_policy_tpu_torch.ops.quant import (  # noqa: E402
    AttnKMajor, kmajor_attn, kmajor_experts)


@pytest.fixture(scope="module")
def kmajor():
    a = _inputs(30)
    qa = _qa(a)
    return a, qa, kmajor_attn(qa)


def test_kmajor_attn_is_the_transpose_of_the_jax_layout(kmajor):
    """``kmajor_attn`` holds the JAX quantizer's int8 projections
    transposed ([3D, D] and [D, D]), as a copy beside them."""
    a, qa, qt = kmajor
    jqa = jax_qattn(*(jnp.asarray(a[k]) for k in ("wqkv", "bqkv", "wout")))
    assert isinstance(qt, AttnKMajor)
    assert qt.wqkv_t.shape == (3 * D, D) and qt.wout_t.shape == (D, D)
    for t in qt:
        assert t.dtype == torch.int8 and t.is_contiguous()
    np.testing.assert_array_equal(qt.wqkv_t.numpy(),
                                  np.asarray(jqa.wqkv_q).T)
    np.testing.assert_array_equal(qt.wout_t.numpy(), np.asarray(jqa.wout_q).T)
    assert qt.wqkv_t.data_ptr() != qa.wqkv_q.data_ptr()


@pytest.mark.parametrize("c_rows", [1, B], ids=["shared-c", "per-sample-c"])
def test_plain_attn_from_the_kmajor_copy_gives_the_same_bits(kmajor, c_rows):
    """The plain int8 attention block reading its projections from the
    K-major copy (the layout of the CUDA kernels' wgmma products) gives the
    same bits as from the JAX layout: the int8 products are exact."""
    a, qa, qt = kmajor
    c = torch.from_numpy(_inputs(31, c_rows=c_rows)["c"])
    args = (torch.from_numpy(a["x"]), c, torch.from_numpy(a["ln"]), qa,
            torch.from_numpy(a["qg"]), torch.from_numpy(a["kg"]))
    got = fused_attn_block_q8_ref(*args, qattn_t=qt)
    torch.testing.assert_close(got, fused_attn_block_q8_ref(*args), rtol=0,
                               atol=0)
    # and the CPU wrapper hands the copy to the plain version
    torch.testing.assert_close(fused_attn_block_q8(*args, qattn_t=qt), got,
                               rtol=0, atol=0)


def test_plain_int8_layer_from_both_kmajor_copies_gives_the_same_bits(
        kmajor):
    a, qa, qt = kmajor
    qe, ln2, idx, probs = _experts(32)
    args = (torch.from_numpy(a["x"]), torch.from_numpy(a["c"]),
            torch.from_numpy(a["ln"]), None, None, torch.from_numpy(a["qg"]),
            torch.from_numpy(a["kg"]), None, ln2, qe, idx, probs)
    kw = dict(step=1, qattn=qa, block_hidden=128)
    got = fused_layer_q8c_ref(*args, qattn_t=qt, qexp_t=kmajor_experts(qe),
                              **kw)
    torch.testing.assert_close(got, fused_layer_q8c_ref(*args, **kw), rtol=0,
                               atol=0)


@pytest.mark.parametrize("check, copy", [
    (need_kmajor_attn, "int8 projections"),
    (need_kmajor_experts, "int8 experts")], ids=["attn", "experts"])
def test_cuda_int8_wrappers_need_the_kmajor_copies(check, copy):
    """On CUDA the int8 wrappers read the K-major copies and raise without
    them (the CPU and meta tensors of these tests stop at the device check
    before it: ``test_*_rejects_other_devices``)."""
    with pytest.raises(ValueError, match=f"K-major copy of the {copy}"):
        check("the kernel", None)
    check("the kernel", object())


@pytest.mark.parametrize("fn, n_args, copy", [
    (fused_attn_block_q8, 5, "qattn_t"),
    (fused_top2_mlp_q8c, 3, "qexp_t"),
    (fused_layer_q8c, 11, "qexp_t")],
    ids=["fused_attn_block_q8", "fused_top2_mlp_q8c", "fused_layer_q8c"])
def test_int8_wrappers_with_their_copies_still_reject_other_devices(
        fn, n_args, copy):
    x = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(x, *([None] * n_args), **{copy: object()})


@pytest.mark.parametrize("tiles", [(128, 128), (128, 64), (64, 128),
                                   (64, 64), (None, None)],
                         ids=["128x128", "128x64", "64x128", "64x64",
                              "default"])
@pytest.mark.parametrize("M", [14, 39, 1792])
def test_proj_tile_plan_covers_every_output_once(M, tiles):
    """The plan the wrappers pass to the wgmma projections, decoded as the
    kernel decodes it, at the flagship widths (QKV N = 3072, c_proj N =
    1024): every output element lies in exactly one tile and the CTAs
    share the tiles evenly."""
    D, ctas = 1024, 132
    for N in (3 * D, D):
        plan = proj_tile_plan(M, N, ctas, *tiles)
        if tiles[0] is None:
            wide = 128 if M > 256 else 64
            assert (plan.tile_m, plan.tile_n) == (wide, wide)
        hits = np.zeros((M, N), np.int32)
        per_cta = np.zeros(ctas, np.int32)
        for cta, rows, cols in proj_tiles(plan, M):
            assert rows.start < M and len(cols) == plan.tile_n
            hits[rows.start:rows.stop, cols.start:cols.stop] += 1
            per_cta[cta] += 1
        assert (hits == 1).all()
        used = per_cta[:min(ctas, plan.tiles)]
        assert used.sum() == plan.tiles and used.max() - used.min() <= 1


def test_proj_tile_plan_refuses_tiles_the_kernel_has_not():
    with pytest.raises(ValueError, match="no projection tiles"):
        proj_tile_plan(1792, 3072, 132, 256, 128)
    with pytest.raises(ValueError, match="no projection tiles"):
        proj_tile_plan(14, 96, 132, 64, 64)


# ---- the bf16 projections' tile plan, shared with the whole-layer kernel
# and the megakernel (no card needed)

from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (  # noqa: E402,E501
    dit_tile_plan)


@pytest.mark.parametrize("tiles", [None, (64, 64, 64, 64),
                                   (128, 128, 128, 128)],
                         ids=["default", "64x64", "128x128"])
def test_cpu_bf16_wrapper_takes_a_tile_plan(tiles):
    """``tiles`` only chooses the CUDA kernel's projection tiles: the CPU
    wrapper runs the plain version whatever it is, uncounted."""
    a = _inputs(33, B)
    args = _bf16_args(a, torch.float32)
    before = fused_attn_block.launches
    torch.testing.assert_close(fused_attn_block(*args, tiles=tiles),
                               fused_attn_block_ref(*args), rtol=0, atol=0)
    assert fused_attn_block.launches == before


@pytest.mark.parametrize("B_", [1, 128])
def test_bf16_projection_plan_covers_every_output_once(B_):
    """The bf16 projections' default plan at the flagship widths (QKV N =
    3072, c_proj N = 1024, 132 SMs) at b=1 and b=128 x 14 tokens: every
    output element in exactly one tile, 64 x 64 tiles at b=1 and 128 x 128
    at b=128, the plan the whole-layer kernel and the megakernel run at the
    same row count (so that their bf16 sums, in the tensor core's order,
    give the same bits)."""
    D, ctas, M = 1024, 132, B_ * 14
    mega = dit_tile_plan(M, D, 4096, 1024, ctas)
    for N, shared in ((3 * D, mega.qkv), (D, mega.out)):
        plan = proj_tile_plan(M, N, ctas)
        assert plan == shared
        assert (plan.tile_m, plan.tile_n) == ((64, 64) if B_ == 1
                                              else (128, 128))
        hits = np.zeros((M, N), np.int32)
        for cta, rows, cols in proj_tiles(plan, M):
            hits[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert (hits == 1).all()
