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
from mode_diffusion_policy_tpu_torch.ops.quant import quantize_experts

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
