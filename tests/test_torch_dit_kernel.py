"""The DiT megakernel's plain PyTorch version and the int8 attention
projections against the JAX package, in f32 on the CPU at a small stack:
L=3 layers, D=256, 2 heads of 128, hidden 256 or 1024, 4 experts, B=2,
T=14, with [L,S,2] routing tables and a nonzero step. The JAX side runs its
Pallas kernels in interpret mode, as tests/test_pallas_layer.py does.

Tolerances:
- quantize_attn: the int8 weights equal, the scales within 1e-7 relative
  (the same f32 division on both sides).
- layer and stack outputs: tests/test_torch_layer_kernel.py's flip-aware
  gate. Both sides' int8 products are exact; f32 sums taken in another
  order now and then move an int8 rounding by one step, and one such flip
  moves a whole row by about a quantum times a weight. So mean <= 1e-4,
  max <= 5e-3, and 90% of the elements within 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.ops.pallas.layer_kernel import (
    fused_dit_q8c as jax_dit)
from mode_diffusion_policy_tpu.ops.pallas.layer_kernel import (
    fused_layer_q8c as jax_layer)
from mode_diffusion_policy_tpu.ops.quant import quantize_attn as jax_qattn
from mode_diffusion_policy_tpu.ops.quant import (
    quantize_experts as jax_qexp)
from mode_diffusion_policy_tpu_torch.ops.kernels import _build
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
    fused_dit_q8c, fused_dit_q8c_ref, fused_layer_q8c_ref)
from mode_diffusion_policy_tpu_torch.ops.quant import (QuantizedAttn,
                                                       QuantizedExperts,
                                                       quantize_attn,
                                                       quantize_experts)

L, S = 3, 4
# per-layer routing tables [L, S, 2]
IDX = np.array([[[0, 2], [3, 1], [2, 3], [1, 0]],
                [[1, 3], [0, 2], [3, 0], [2, 1]],
                [[2, 0], [1, 3], [0, 1], [3, 2]]], np.int32)
PROBS = np.array([[[0.7, 0.3], [0.55, 0.45], [0.5, 0.5], [0.6, 0.4]],
                  [[0.8, 0.2], [0.52, 0.48], [0.65, 0.35], [0.5, 0.5]],
                  [[0.58, 0.42], [0.9, 0.1], [0.51, 0.49], [0.7, 0.3]]],
                 np.float32)


def _layers(B=2, T=14, D=256, H=2, HH=1024, E=4, seed=0):
    r = np.random.default_rng(seed)

    def f(*shape, sc=0.05, off=0.0):
        return (r.standard_normal(shape) * sc + off).astype(np.float32)

    hd = D // H
    layers = [dict(ln1=f(D, sc=0.1, off=1.0), wqkv=f(D, 3 * D),
                   bqkv=f(3 * D, sc=0.02), q_g=f(hd, sc=0.1, off=1.0),
                   k_g=f(hd, sc=0.1, off=1.0), wout=f(D, D),
                   ln2=f(D, sc=0.1, off=1.0), w1=f(E, D, 2 * HH),
                   b1=f(E, 2 * HH, sc=0.02), w2=f(E, HH, D))
              for _ in range(L)]
    return f(B, T, D, sc=0.5), f(1, 1, D, sc=0.2), layers


def _stack(layers, int8_attn, lib):
    """The megakernel's stacked dict from per-layer numpy weights, built
    with the JAX package's (lib="jax") or the port's quantizers."""
    if lib == "jax":
        qexp, qatt, arr, stk = jax_qexp, jax_qattn, jnp.asarray, jnp.stack
    else:
        qexp, qatt, arr, stk = (quantize_experts, quantize_attn,
                                torch.from_numpy, torch.stack)
    st = {k: stk([arr(lw[k]) for lw in layers])
          for k in ("ln1", "q_g", "k_g", "ln2")}
    qs = [qexp(*(arr(lw[k]) for k in ("w1", "b1", "w2"))) for lw in layers]
    for i, k in enumerate(QuantizedExperts._fields):
        st[k] = stk([q[i] for q in qs])
    if int8_attn:
        qa = [qatt(*(arr(lw[k]) for k in ("wqkv", "bqkv", "wout")))
              for lw in layers]
        for i, k in enumerate(("wqkv", "sqkv", "bqkv", "wout", "sout")):
            st[k] = stk([q[i] for q in qa])
    else:
        for k in ("wqkv", "bqkv", "wout"):
            st[k] = stk([arr(lw[k]) for lw in layers])
    return st


def _close(got, want):
    d = np.abs(got - want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert d.mean() <= 1e-4, d.mean()
    assert d.max() <= 5e-3, d.max()
    assert (d <= 2e-5).mean() >= 0.9, (d <= 2e-5).mean()


@pytest.mark.parametrize("seed,shape", [(0, (256, 768)), (1, (256, 256)),
                                        (2, (128, 384))])
def test_quantize_attn_matches_jax(seed, shape):
    r = np.random.default_rng(seed)
    wqkv = (r.standard_normal(shape) * 0.05).astype(np.float32)
    wqkv[:, 3] = 0.0                  # an all-zero column: the 1e-12 clamp
    bqkv = (r.standard_normal(shape[1]) * 0.02).astype(np.float32)
    wout = (r.standard_normal((shape[0], shape[0])) * 0.05).astype(np.float32)
    want = jax_qattn(jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(wout))
    got = quantize_attn(torch.from_numpy(wqkv), torch.from_numpy(bqkv),
                        torch.from_numpy(wout))
    assert isinstance(got, QuantizedAttn)
    for name, g, w in zip(QuantizedAttn._fields, got, want):
        w = np.asarray(w)
        if w.dtype == np.int8:
            assert g.dtype == torch.int8
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-7, atol=0,
                                       err_msg=name)


def test_quantize_attn_divides_by_the_clamped_scale():
    """s = max(amax, 1e-12) / 127 per column and q = round(w / s): a
    column of tiny weights still spans the int8 range."""
    w = torch.full((4, 3), 1e-13)
    w[0, 1] = -1e-13
    q = quantize_attn(w, torch.zeros(3), torch.ones(4, 4))
    assert torch.all(q.wqkv_s == torch.tensor(1e-12) / 127.0)
    assert q.wqkv_q[0, 0] == 13 and q.wqkv_q[0, 1] == -13


@pytest.mark.parametrize("step", [0, 2])
def test_plain_layer_int8_attn_matches_jax_kernel(step):
    x, c, layers = _layers(B=4, seed=10 + step)
    lw = layers[0]
    qa_j = jax_qattn(*(jnp.asarray(lw[k]) for k in ("wqkv", "bqkv", "wout")))
    q_j = jax_qexp(*(jnp.asarray(lw[k]) for k in ("w1", "b1", "w2")))
    want = np.asarray(jax_layer(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(lw["ln1"]), None, None,
        jnp.asarray(lw["q_g"]), jnp.asarray(lw["k_g"]), None,
        jnp.asarray(lw["ln2"]), q_j, jnp.asarray(IDX[0]),
        jnp.asarray(PROBS[0]), step=jnp.int32(step), qattn=qa_j,
        block_samples=4, block_hidden=1024, interpret=True))
    qa = quantize_attn(*(torch.from_numpy(lw[k])
                         for k in ("wqkv", "bqkv", "wout")))
    q = quantize_experts(*(torch.from_numpy(lw[k]) for k in ("w1", "b1", "w2")))
    got = fused_layer_q8c_ref(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(lw["ln1"]),
        None, None, torch.from_numpy(lw["q_g"]), torch.from_numpy(lw["k_g"]),
        None, torch.from_numpy(lw["ln2"]), q, torch.from_numpy(IDX[0]),
        torch.from_numpy(PROBS[0]), step=step, qattn=qa).numpy()
    _close(got, want)


@pytest.mark.parametrize("int8_attn", [False, True],
                         ids=["bf16-attn", "int8-attn"])
@pytest.mark.parametrize("step,HH,block_hidden", [(1, 1024, 1024),
                                                  (3, 256, 128)])
def test_plain_dit_matches_jax_megakernel(int8_attn, step, HH, block_hidden):
    x, c, layers = _layers(HH=HH, seed=step)
    want = np.asarray(jax_dit(
        jnp.asarray(x), jnp.asarray(c), _stack(layers, int8_attn, "jax"),
        jnp.asarray(IDX), jnp.asarray(PROBS), step=jnp.int32(step),
        block_samples=4, block_hidden=block_hidden, interpret=True))
    before = fused_dit_q8c.launches
    got = fused_dit_q8c(torch.from_numpy(x), torch.from_numpy(c),
                        _stack(layers, int8_attn, "torch"),
                        torch.from_numpy(IDX), torch.from_numpy(PROBS),
                        step=step, block_hidden=block_hidden).numpy()
    assert fused_dit_q8c.launches == before   # CPU: the plain version
    _close(got, want)


@pytest.mark.parametrize("int8_attn", [False, True],
                         ids=["bf16-attn", "int8-attn"])
def test_port_stack_quantizes_like_jax(int8_attn):
    _, _, layers = _layers(seed=4)
    want = _stack(layers, int8_attn, "jax")
    got = _stack(layers, int8_attn, "torch")
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        if w.dtype == np.int8:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("int8_attn", [False, True],
                         ids=["bf16-attn", "int8-attn"])
def test_plain_dit_is_the_chained_plain_layer(int8_attn):
    """fused_dit_q8c_ref == fused_layer_q8c_ref chained over the layers,
    exactly, in f32 and in bf16 (x carried in its dtype between layers)."""
    x, c, layers = _layers(seed=6)
    st = _stack(layers, int8_attn, "torch")
    idx, probs = torch.from_numpy(IDX), torch.from_numpy(PROBS)
    for dt in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dt)
        want = xt
        for l in range(L):
            qa = (QuantizedAttn(*(st[k][l] for k in ("wqkv", "sqkv", "bqkv",
                                                     "wout", "sout")))
                  if int8_attn else None)
            want = fused_layer_q8c_ref(
                want, torch.from_numpy(c), st["ln1"][l], st["wqkv"][l],
                st["bqkv"][l], st["q_g"][l], st["k_g"][l], st["wout"][l],
                st["ln2"][l],
                QuantizedExperts(*(st[k][l] for k in QuantizedExperts._fields)),
                idx[l], probs[l], step=2, qattn=qa)
        got = fused_dit_q8c_ref(xt, torch.from_numpy(c), st, idx, probs,
                                step=2)
        assert got.dtype == dt
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_dit_single_rows_and_f64_accumulation():
    """[L,2] single routing rows select like a one-row table, and
    acc_dtype=float64 (chip_smoke.py's noise floor) stays a near copy."""
    x, c, layers = _layers(seed=8)
    st = _stack(layers, False, "torch")
    args = (torch.from_numpy(x), torch.from_numpy(c), st)
    rows = fused_dit_q8c_ref(*args, torch.from_numpy(IDX[:, 1]),
                             torch.from_numpy(PROBS[:, 1]))
    table = fused_dit_q8c_ref(*args, torch.from_numpy(IDX),
                              torch.from_numpy(PROBS), step=1)
    torch.testing.assert_close(rows, table, rtol=0, atol=0)
    exact = fused_dit_q8c_ref(*args, torch.from_numpy(IDX),
                              torch.from_numpy(PROBS), step=1,
                              acc_dtype=torch.float64)
    d = (exact - table).abs()
    assert d.mean() <= 1e-4 and d.max() <= 5e-3


def test_dit_wrapper_rejects_other_devices():
    x = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_dit_q8c(x, None, {}, None, None)


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """An edit to a shared header (csrc/*.cuh) renames every library, so a
    stale build is never reused."""
    before = {s.name: _build.library_path(s) for s in _build.sources()}
    edited = tmp_path / "layer_stages.cuh"
    edited.write_text(_build.headers()[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "headers", lambda: [edited])
    after = {s.name: _build.library_path(s) for s in _build.sources()}
    assert all(before[k] != after[k] for k in before)


def test_plain_layer_red_dtype_reaches_the_norms():
    """red_dtype=float64 (the second near-exact evaluation chip_smoke.py
    takes a noise floor from) moves the norms' and the softmax's rounding:
    with int8 projections, where the float products are few, the output
    still changes, and stays a near copy."""
    x, c, layers = _layers(seed=12)
    st = _stack(layers, True, "torch")
    args = (torch.from_numpy(x), torch.from_numpy(c),
            {k: v[:1] for k, v in st.items()}, torch.from_numpy(IDX[:1]),
            torch.from_numpy(PROBS[:1]))
    out32 = fused_dit_q8c_ref(*args, step=0)
    out64 = fused_dit_q8c_ref(*args, step=0, acc_dtype=torch.float64,
                              red_dtype=torch.float64)
    d = (out64 - out32).abs()
    assert d.max() > 0
    assert d.mean() <= 1e-4 and d.max() <= 5e-3
