"""The int8 x int8 top-2 MoE's plain PyTorch version
(``fused_top2_mlp_q8c_ref``) against the JAX Pallas kernel (interpret
mode, as tests/test_pallas_moe.py runs it), in f32 on the CPU at D=256,
hidden 256 with block_hidden 128 (two hidden blocks, so ``act`` is
re-quantized per block), 4 experts, B=3, T=14: every argument combination
the JAX kernel takes (residual on or off, ln_2 fused or not, [S,2] tables
with a step or single [2] rows).

Tolerance: tests/test_torch_layer_kernel.py's flip-aware gate (mean <=
1e-4, max <= 5e-3, 90% of the elements within 2e-5): the int8 products are
exact on both sides, and an f32 sum in another order now and then moves an
int8 rounding of the input or of ``act`` by one step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.ops.pallas.moe_kernel import (
    fused_top2_mlp_q8c as jax_moe)
from mode_diffusion_policy_tpu.ops.quant import (
    quantize_experts as jax_qexp)
from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
    fused_top2_mlp_q8c, fused_top2_mlp_q8c_ref)
from mode_diffusion_policy_tpu_torch.ops.quant import (QuantizedExperts,
                                                   quantize_experts)
from torch_threads import two_torch_threads  # noqa: F401

B, T, D, HH, E = 3, 14, 256, 256, 4
IDX = np.array([[0, 2], [3, 1], [2, 3], [1, 0]], np.int32)
PROBS = np.array([[0.7, 0.3], [0.55, 0.45], [0.5, 0.5], [0.6, 0.4]],
                 np.float32)


def _inputs(seed):
    r = np.random.default_rng(seed)

    def f(*shape, sc=0.05, off=0.0):
        return (r.standard_normal(shape) * sc + off).astype(np.float32)

    return dict(x=f(B, T, D, sc=0.5), ln=f(D, sc=0.1, off=1.0),
                w1=f(E, D, 2 * HH), b1=f(E, 2 * HH, sc=0.02),
                w2=f(E, HH, D))


def _close(got, want):
    d = np.abs(got - want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert d.mean() <= 1e-4, d.mean()
    assert d.max() <= 5e-3, d.max()
    assert (d <= 2e-5).mean() >= 0.9, (d <= 2e-5).mean()


def _routing(tables):
    """[S,2] tables with step 3, or the single [2] rows of that step."""
    if tables:
        return IDX, PROBS, 3
    return IDX[3], PROBS[3], None


def _port(a, tables, residual, ln, fn=fused_top2_mlp_q8c_ref,
          dt=torch.float32, **kw):
    idx, probs, step = _routing(tables)
    q = quantize_experts(*(torch.from_numpy(a[k]) for k in ("w1", "b1", "w2")))
    return fn(torch.from_numpy(a["x"]).to(dt), torch.from_numpy(idx),
              torch.from_numpy(probs), q, step=step, block_hidden=128,
              residual=residual,
              ln_g=torch.from_numpy(a["ln"]) if ln else None, **kw)


@pytest.mark.parametrize("tables", [True, False], ids=["tables", "rows"])
@pytest.mark.parametrize("ln", [True, False], ids=["ln2", "no-ln"])
@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "no-residual"])
def test_plain_moe_matches_jax_kernel(residual, ln, tables):
    a = _inputs(seed=int(residual) + 2 * int(ln) + 4 * int(tables))
    idx, probs, step = _routing(tables)
    q = jax_qexp(*(jnp.asarray(a[k]) for k in ("w1", "b1", "w2")))
    want = np.asarray(jax_moe(
        jnp.asarray(a["x"]), jnp.asarray(idx), jnp.asarray(probs), q,
        step=None if step is None else jnp.int32(step), block_tokens=16,
        block_hidden=128, interpret=True, residual=residual,
        ln_g=jnp.asarray(a["ln"]) if ln else None))
    _close(_port(a, tables, residual, ln).numpy(), want)


def test_rows_select_like_their_table_row():
    a = _inputs(8)
    torch.testing.assert_close(_port(a, False, True, True),
                               _port(a, True, True, True), rtol=0, atol=0)


def test_residual_seeds_with_the_prenormed_input():
    """With ln_2 the residual seed is ln_2(x) in the compute dtype, not x:
    the block's ln_2 replaces the residual stream (the reference's block
    semantics)."""
    a = _inputs(9)
    for dt in (torch.float32, torch.bfloat16):
        with_res = _port(a, True, True, True, dt=dt).float()
        without = _port(a, True, False, True, dt=dt).float()
        x = torch.from_numpy(a["x"]).to(dt).float()
        xn = (x / torch.sqrt((x * x).mean(-1, keepdim=True)).clamp_min(1e-6)
              * torch.from_numpy(a["ln"])).to(dt).float()
        seed = (with_res - without).abs().mean()
        assert (with_res - without - xn).abs().mean() < 0.02 * seed
        assert (with_res - without - x).abs().mean() > 0.05 * seed


def test_f64_prenorm_is_a_near_copy():
    """red_dtype=float64 (chip_smoke.py's near-exact evaluation) moves only
    the prenorm's rounding."""
    a = _inputs(10)
    out32 = _port(a, True, True, True)
    out64 = _port(a, True, True, True, red_dtype=torch.float64)
    d = (out64 - out32).abs()
    assert d.mean() <= 1e-4 and d.max() <= 5e-3


def test_f64_mlp_is_a_near_copy():
    """mlp_dtype=float64 (chip_smoke.py's near-exact evaluation of the MoE's
    float arithmetic) moves only roundings: at float32 it is the plain
    version bit for bit, at float64 a near copy."""
    a = _inputs(12)
    out32 = _port(a, True, True, True)
    torch.testing.assert_close(
        _port(a, True, True, True, mlp_dtype=torch.float32), out32, rtol=0,
        atol=0)
    d = (_port(a, True, True, True, mlp_dtype=torch.float64) - out32).abs()
    assert d.mean() <= 1e-4 and d.max() <= 5e-3


def test_cpu_wrapper_runs_plain_version_without_counting():
    a = _inputs(11)
    before = fused_top2_mlp_q8c.launches
    got = _port(a, True, True, True, fn=fused_top2_mlp_q8c)
    torch.testing.assert_close(got, _port(a, True, True, True), rtol=0,
                               atol=0)
    assert fused_top2_mlp_q8c.launches == before


def test_moe_wrapper_rejects_other_devices():
    x = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_top2_mlp_q8c(x, None, None, None)


# ---- the bf16-compute MoE (fused_top2_mlp) and its int8-weight variant
# (fused_top2_mlp_q8), at the shapes of tests/test_pallas_moe.py: D=128,
# hidden 256 with block_hidden 128 (two hidden blocks), 4 experts; B=2 x
# T=14 tokens, or B=1 x T=13 (padded to the JAX kernel's token block).
# Gates: the JAX tests' own (tests/test_pallas_moe.py:33-34, 61-62, 91-92).

from mode_diffusion_policy_tpu.ops.pallas.moe_kernel import (  # noqa: E402
    fused_top2_mlp as jax_bf16_moe, fused_top2_mlp_q8 as jax_q8_moe)
from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (  # noqa: E402,E501
    fused_top2_mlp, fused_top2_mlp_q8, fused_top2_mlp_q8_ref,
    fused_top2_mlp_ref)

D16, HH16 = 128, 256
# (routing, residual, ln_2, padded token count): every flag on and off
CASES16 = [("tables", True, True, False), ("rows", False, False, True),
           ("tables", False, True, True), ("rows", True, False, False)]
CASE_IDS = ["tables-res-ln", "rows-pad", "tables-ln-pad", "rows-res"]


def _inputs16(seed, pad):
    r = np.random.default_rng(seed)
    shape = (1, 13, D16) if pad else (2, 14, D16)

    def f(*s, sc=0.02, off=0.0):
        return (r.standard_normal(s) * sc + off).astype(np.float32)

    return dict(x=f(*shape, sc=1.0), ln=f(D16, sc=0.1, off=1.0),
                w1=f(E, D16, 2 * HH16), b1=f(E, 2 * HH16),
                w2=f(E, HH16, D16))


def _jax16(fn, a, routing, residual, ln, weights, jdt):
    idx, probs, step = _routing(routing == "tables")
    return np.asarray(fn(
        jnp.asarray(a["x"], jdt), jnp.asarray(idx), jnp.asarray(probs),
        *weights, step=None if step is None else jnp.int32(step),
        block_tokens=8, block_hidden=128, interpret=True, residual=residual,
        ln_g=jnp.asarray(a["ln"]) if ln else None), np.float32)


def _port16(fn, a, routing, residual, ln, weights, dt=torch.float32):
    idx, probs, step = _routing(routing == "tables")
    return fn(torch.from_numpy(a["x"]).to(dt), torch.from_numpy(idx),
              torch.from_numpy(probs), *weights, step=step, block_hidden=128,
              residual=residual,
              ln_g=torch.from_numpy(a["ln"]) if ln else None)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("routing,residual,ln,pad", CASES16, ids=CASE_IDS)
def test_plain_bf16_moe_matches_jax_kernel(routing, residual, ln, pad,
                                           dtype):
    """fused_top2_mlp_ref against the Pallas _kernel (interpret mode) on
    the same experts in the compute dtype: f32 within atol 2e-5 / rtol
    1e-4, bf16 within 2e-2 / 2e-2 (the JAX tests' gates)."""
    a = _inputs16(20 + CASES16.index((routing, residual, ln, pad)), pad)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = _jax16(jax_bf16_moe, a, routing, residual, ln,
                  [jnp.asarray(a[k], jdt) for k in ("w1", "b1", "w2")], jdt)
    got = _port16(fused_top2_mlp_ref, a, routing, residual, ln,
                  [torch.from_numpy(a[k]).to(tdt) for k in ("w1", "b1", "w2")],
                  tdt)
    assert got.dtype == tdt and tuple(got.shape) == a["x"].shape
    tol = 2e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=1e-4 if dtype == "f32" else 2e-2)


@pytest.mark.parametrize("routing,residual,ln,pad", CASES16, ids=CASE_IDS)
def test_plain_q8_weight_moe_matches_jax_kernel(routing, residual, ln, pad):
    """fused_top2_mlp_q8_ref against the Pallas _kernel_q8 (interpret mode)
    on the same int8 experts, in f32: within atol 1e-4 / rtol 1e-3."""
    a = _inputs16(30 + CASES16.index((routing, residual, ln, pad)), pad)
    jq = jax_qexp(*(jnp.asarray(a[k]) for k in ("w1", "b1", "w2")))
    tq = quantize_experts(*(torch.from_numpy(a[k]) for k in ("w1", "b1",
                                                             "w2")))
    want = _jax16(jax_q8_moe, a, routing, residual, ln, [jq], jnp.float32)
    got = _port16(fused_top2_mlp_q8_ref, a, routing, residual, ln, [tq])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)


def test_q8_weight_moe_with_unit_scales_is_the_bf16_moe():
    """Unit scales on int8-valued weights: the int8-weight version equals
    the bf16 version on the same weights, bit for bit (in bf16, as the two
    CUDA kernels are held on the card)."""
    a = _inputs16(40, False)
    r = np.random.default_rng(41)
    w1 = r.integers(-127, 128, (E, D16, 2 * HH16)).astype(np.int8)
    w2 = r.integers(-127, 128, (E, HH16, D16)).astype(np.int8)
    q = QuantizedExperts(torch.from_numpy(w1), torch.ones(E, 2 * HH16),
                         torch.from_numpy(a["b1"]).bfloat16().float(),
                         torch.from_numpy(w2), torch.ones(E, D16))
    x = torch.from_numpy(a["x"] * 0.01).bfloat16()
    for tables, res, ln in ((True, True, True), (False, False, False)):
        idx, probs, step = _routing(tables)
        kw = dict(step=step, block_hidden=128, residual=res,
                  ln_g=torch.from_numpy(a["ln"]) if ln else None)
        args = (x, torch.from_numpy(idx), torch.from_numpy(probs))
        want = fused_top2_mlp_ref(
            *args, torch.from_numpy(w1).bfloat16(), q.b1.bfloat16(),
            torch.from_numpy(w2).bfloat16(), **kw)
        torch.testing.assert_close(fused_top2_mlp_q8_ref(*args, q, **kw),
                                   want, rtol=0, atol=0)


def test_bf16_moe_wrappers_run_plain_versions_without_counting():
    a = _inputs16(42, True)
    w = [torch.from_numpy(a[k]) for k in ("w1", "b1", "w2")]
    q = quantize_experts(*w)
    before = (fused_top2_mlp.launches, fused_top2_mlp_q8.launches)
    for kern, ref, weights in ((fused_top2_mlp, fused_top2_mlp_ref, w),
                               (fused_top2_mlp_q8, fused_top2_mlp_q8_ref,
                                [q])):
        torch.testing.assert_close(
            _port16(kern, a, "tables", True, True, weights),
            _port16(ref, a, "tables", True, True, weights), rtol=0, atol=0)
    assert (fused_top2_mlp.launches, fused_top2_mlp_q8.launches) == before


@pytest.mark.parametrize("fn,n_weights", [(fused_top2_mlp, 3),
                                          (fused_top2_mlp_q8, 1)],
                         ids=["fused_top2_mlp", "fused_top2_mlp_q8"])
def test_bf16_moe_wrappers_reject_other_devices(fn, n_weights):
    x = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(x, None, None, *([None] * n_weights))


@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "no-residual"])
def test_plain_q8c_moe_from_the_kmajor_copy_gives_the_same_bits(residual):
    """The int8 MoE's plain version reading the experts from the K-major
    copy (the layout of the whole-layer kernel's wgmma products) gives the
    same bits as from the JAX layout: the int8 products are exact."""
    from mode_diffusion_policy_tpu_torch.ops.quant import kmajor_experts
    a = _inputs(12)
    q = quantize_experts(*(torch.from_numpy(a[k]) for k in ("w1", "b1", "w2")))
    got = _port(a, True, residual, True, qexp_t=kmajor_experts(q))
    assert torch.equal(got, _port(a, True, residual, True))
