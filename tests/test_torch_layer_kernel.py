"""The whole-layer function's plain PyTorch version against the JAX Pallas
kernel (interpret mode, as tests/test_pallas_layer.py runs it), in f32 at a
small layer: D=256, 2 heads of 128, hidden 1024, 4 experts, B=4, T=14.

Tolerance: the int8 products are exact in both, and the quantized tensors
agree exactly; f32 sums taken in another order (XLA vs PyTorch on the CPU)
differ in the last bits, which now and then moves an int8 rounding by one
step. One such flip moves a whole output row by about one quantum times a
weight (up to ~1e-3 per element), i.e. ~2.4e-5 on the mean per flipped row
at B*T = 42 rows. The gate: mean <= 1e-4 (a few flips), max <= 5e-3, and
90% of the elements within 2e-5 (the rows no flip reached).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.ops.pallas.layer_kernel import (
    fused_layer_q8c as jax_fused_layer)
from mode_diffusion_policy_tpu.ops.quant import (
    quantize_experts as jax_quantize)
from mode_diffusion_policy_tpu_torch.ops.kernels import layer_kernel
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
    fused_layer_q8c, fused_layer_q8c_ref)
from mode_diffusion_policy_tpu_torch.ops.quant import quantize_experts

IDX = np.array([[0, 2], [3, 1], [2, 3]], np.int32)
PROBS = np.array([[0.7, 0.3], [0.55, 0.45], [0.5, 0.5]], np.float32)


def _inputs(B=4, T=14, D=256, H=2, HH=1024, E=4, seed=0, c_rows=1):
    r = np.random.default_rng(seed)

    def f(*shape, sc=0.05, off=0.0):
        return (r.standard_normal(shape) * sc + off).astype(np.float32)

    hd = D // H
    return dict(x=f(B, T, D, sc=0.5), c=f(c_rows, 1, D, sc=0.2),
                ln1=f(D, sc=0.1, off=1.0), wqkv=f(D, 3 * D),
                bqkv=f(3 * D, sc=0.02), qg=f(hd, sc=0.1, off=1.0),
                kg=f(hd, sc=0.1, off=1.0), wout=f(D, D),
                ln2=f(D, sc=0.1, off=1.0), w1=f(E, D, 2 * HH),
                b1=f(E, 2 * HH, sc=0.02), w2=f(E, HH, D))


_ORDER = ("x", "c", "ln1", "wqkv", "bqkv", "qg", "kg", "wout", "ln2")


def _jax(a, idx, probs, step, block_hidden):
    q = jax_quantize(*(jnp.asarray(a[k]) for k in ("w1", "b1", "w2")))
    out = jax_fused_layer(
        *(jnp.asarray(a[k]) for k in _ORDER), q, jnp.asarray(idx),
        jnp.asarray(probs), step=None if step is None else jnp.int32(step),
        block_samples=4, block_hidden=block_hidden, interpret=True)
    return np.asarray(out)


def _torch(a, idx, probs, step, block_hidden, fn=fused_layer_q8c):
    q = quantize_experts(*(torch.from_numpy(a[k]) for k in ("w1", "b1", "w2")))
    return fn(*(torch.from_numpy(a[k]) for k in _ORDER), q,
              torch.from_numpy(idx), torch.from_numpy(probs), step=step,
              block_hidden=block_hidden).numpy()


def _close(got, want):
    d = np.abs(got - want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert d.mean() <= 1e-4, d.mean()
    assert d.max() <= 5e-3, d.max()
    assert (d <= 2e-5).mean() >= 0.9, (d <= 2e-5).mean()


@pytest.mark.parametrize("block_hidden", [128, 1024])
@pytest.mark.parametrize("step", [0, 1, 2])
def test_plain_layer_matches_jax_kernel(block_hidden, step):
    a = _inputs(seed=step)
    _close(_torch(a, IDX, PROBS, step, block_hidden),
           _jax(a, IDX, PROBS, step, block_hidden))


def test_plain_layer_single_row_and_per_sample_cond():
    a = _inputs(B=3, seed=5, c_rows=3)
    a["c"] = a["c"].reshape(3, 1, -1)
    _close(_torch(a, IDX[1], PROBS[1], None, 1024),
           _jax(a, IDX[1], PROBS[1], None, 1024))


def test_block_hidden_changes_the_act_scales():
    """act is re-quantized per block_hidden columns: 128 and 1024 give
    different results, so the argument is live (not ignored)."""
    a = _inputs(seed=7)
    o128 = _torch(a, IDX, PROBS, 0, 128)
    o1024 = _torch(a, IDX, PROBS, 0, 1024)
    assert np.abs(o128 - o1024).max() > 1e-4


def test_cpu_wrapper_runs_plain_version_without_counting():
    a = _inputs(B=2, seed=3)
    before = fused_layer_q8c.launches
    got = _torch(a, IDX, PROBS, 1, 1024)
    want = _torch(a, IDX, PROBS, 1, 1024, fn=fused_layer_q8c_ref)
    np.testing.assert_array_equal(got, want)
    assert fused_layer_q8c.launches == before


def test_plain_layer_bf16_follows_cast_chain():
    """In bf16 the plain version returns bf16 and stays near its own f32
    evaluation (each cast is one bf16 rounding)."""
    a = _inputs(B=2, seed=4)
    q = quantize_experts(*(torch.from_numpy(a[k]) for k in ("w1", "b1", "w2")))
    args = [torch.from_numpy(a[k]) for k in _ORDER]
    out32 = fused_layer_q8c_ref(*args, q, torch.from_numpy(IDX),
                                torch.from_numpy(PROBS), step=0)
    args[0] = args[0].to(torch.bfloat16)
    out16 = fused_layer_q8c_ref(*args, q, torch.from_numpy(IDX),
                                torch.from_numpy(PROBS), step=0)
    assert out16.dtype == torch.bfloat16
    assert (out16.float() - out32).abs().mean() < 2e-2


def test_hidden_block_must_divide():
    with pytest.raises(ValueError, match="block_hidden"):
        layer_kernel._hidden_block(1024, 384)


def test_plain_layer_f64_accumulation_is_a_near_copy():
    """acc_dtype=float64 (the near-exact evaluation chip_smoke.py uses as a
    noise floor) changes only the rounding of the float products."""
    a = _inputs(B=2, seed=6)
    q = quantize_experts(*(torch.from_numpy(a[k]) for k in ("w1", "b1", "w2")))
    args = [torch.from_numpy(a[k]) for k in _ORDER]
    tabs = (torch.from_numpy(IDX), torch.from_numpy(PROBS))
    out32 = fused_layer_q8c_ref(*args, q, *tabs, step=2)
    out64 = fused_layer_q8c_ref(*args, q, *tabs, step=2,
                                acc_dtype=torch.float64)
    assert out64.dtype == torch.float32
    d = (out64 - out32).abs()
    assert d.mean() <= 1e-4 and d.max() <= 5e-3


def test_build_needs_nvcc_and_writes_under_ignored_build_dir(monkeypatch,
                                                             tmp_path):
    from mode_diffusion_policy_tpu_torch.ops.kernels import _build
    assert [p.name for p in _build.sources()] == [
        "fused_attn_block.cu", "fused_attn_block_q8.cu", "fused_dit_q8c.cu",
        "fused_layer_q8c.cu", "fused_top2_mlp.cu", "fused_top2_mlp_q8c.cu"]
    assert [p.name for p in _build.headers()] == ["layer_stages.cuh"]
    for src in _build.sources():
        lib = _build.library_path(src)
        assert lib.parent == _build.BUILD_DIR
        assert lib.parent.relative_to(_build.PKG_DIR.parent).parts[0] == \
            "build"
        assert lib.name.startswith(f"lib{src.stem}_")
        assert lib == _build.library_path(src)   # stable for unchanged sources
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
