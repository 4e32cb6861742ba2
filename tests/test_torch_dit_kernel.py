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


# ---- the megakernel's K-major stack, tile plan and launch interface (no
# card needed)

import ctypes  # noqa: E402
import re  # noqa: E402

from mode_diffusion_policy_tpu_torch.models.modedit import MoDeDiT  # noqa: E402,E501
from mode_diffusion_policy_tpu_torch.models.modedit import \
    MoDeDiTConfig  # noqa: E402
from mode_diffusion_policy_tpu_torch.ops.kernels import attn_kernel  # noqa: E402,E501
from mode_diffusion_policy_tpu_torch.ops.kernels import layer_kernel  # noqa: E402,E501
from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (  # noqa: E402,E501
    proj_tiles)
from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (  # noqa: E402,E501
    moe_tiles)
from mode_diffusion_policy_tpu_torch.ops.quant import (  # noqa: E402
    kmajor_attn, kmajor_experts)


def _kmajor(st):
    """The stack with the K-major int8 copies that MoDeDiT.stack_layers
    adds: each layer's matrices transposed."""
    out = dict(st)
    for k, src in zip(layer_kernel.DIT_KMAJOR, ("w1_q", "w2_q")):
        out[k] = st[src].transpose(-1, -2).contiguous()
    if "sqkv" in st:
        for k, src in zip(layer_kernel.DIT_KMAJOR_ATTN, ("wqkv", "wout")):
            out[k] = st[src].transpose(-1, -2).contiguous()
    return out


@pytest.fixture(scope="module", params=[False, True],
                ids=["bf16-attn", "int8-attn"])
def stacked_model(request):
    """A 3-layer port DiT (D=256, 2 heads) with int8 experts, the megakernel
    on and int8 projections or not, quantized and stacked once."""
    cfg = MoDeDiTConfig(obs_dim=64, goal_dim=32, embed_dim=256, n_layers=3,
                        n_heads=2, num_experts=4, top_k=2, use_int8_moe=True,
                        use_pallas_attn=True, use_fused_layer=True,
                        use_int8_attn=request.param, use_megakernel=True)
    m = MoDeDiT(cfg, device="cpu")
    m.init_weights_(torch.Generator().manual_seed(0))
    m.quantize_experts_()
    if request.param:
        m.quantize_attn_()
    m.stack_layers_()
    return m


def test_stack_layers_makes_the_kmajor_copies_once(stacked_model):
    """stack_layers_ makes the stacked K-major copies of the int8 experts
    (and projections) once per preset; every block's experts_qt (attn_qt)
    is a slice of them, in their storage, equal to kmajor_experts
    (kmajor_attn) of that layer."""
    m = stacked_model
    st = m.stacked
    L, E = len(m.blocks), m.cfg.num_experts
    D, H2 = m.cfg.embed_dim, st["w1_q"].shape[-1]
    assert st["w1_t"].shape == (L, E, H2, D)
    assert st["w2_t"].shape == (L, E, D, H2 // 2)
    int8_attn = m.cfg.use_int8_attn
    assert ("wqkv_t" in st) == int8_attn and ("wout_t" in st) == int8_attn
    for l, blk in enumerate(m.blocks):
        want = kmajor_experts(blk.experts_q)
        for k, t, w in zip(layer_kernel.DIT_KMAJOR, blk.experts_qt, want):
            assert t.untyped_storage().data_ptr() == \
                st[k].untyped_storage().data_ptr()
            assert t.data_ptr() == st[k][l].data_ptr()
            torch.testing.assert_close(t, w, rtol=0, atol=0)
        if int8_attn:
            want = kmajor_attn(blk.attn.attn_q)
            for k, t, w in zip(layer_kernel.DIT_KMAJOR_ATTN, blk.attn.attn_qt,
                               want):
                assert t.untyped_storage().data_ptr() == \
                    st[k].untyped_storage().data_ptr()
                assert t.data_ptr() == st[k][l].data_ptr()
                torch.testing.assert_close(t, w, rtol=0, atol=0)


def test_restacking_replaces_the_kmajor_copies(stacked_model):
    """A second stack_layers_ (a preset applied again) builds one new stack
    and points the blocks at it: no K-major copy survives beside it."""
    m = stacked_model
    old = m.stacked["w1_t"].untyped_storage().data_ptr()
    m.stack_layers_()
    new = m.stacked["w1_t"].untyped_storage().data_ptr()
    assert new != old
    assert all(b.experts_qt.w1_t.untyped_storage().data_ptr() == new
               for b in m.blocks)


@pytest.mark.parametrize("int8_attn", [False, True],
                         ids=["bf16-attn", "int8-attn"])
def test_plain_dit_from_the_kmajor_stack_gives_the_same_bits(int8_attn):
    """The plain megakernel fed the stacked K-major copies (the layout the
    CUDA kernel's s8 products read) gives the bits of the JAX layout: the
    int8 products are exact. And it still matches the JAX megakernel
    (interpret mode) within test_plain_dit_matches_jax_megakernel's
    tolerance."""
    x, c, layers = _layers(seed=14)
    st = _stack(layers, int8_attn, "torch")
    args = (torch.from_numpy(x), torch.from_numpy(c))
    tabs = (torch.from_numpy(IDX), torch.from_numpy(PROBS))
    got = fused_dit_q8c_ref(*args, _kmajor(st), *tabs, step=2)
    torch.testing.assert_close(got, fused_dit_q8c_ref(*args, st, *tabs,
                                                      step=2),
                               rtol=0, atol=0)
    want = np.asarray(jax_dit(
        jnp.asarray(x), jnp.asarray(c), _stack(layers, int8_attn, "jax"),
        jnp.asarray(IDX), jnp.asarray(PROBS), step=jnp.int32(2),
        block_samples=4, block_hidden=1024, interpret=True))
    _close(got.numpy(), want)


@pytest.mark.parametrize("int8_attn", [False, True],
                         ids=["bf16-attn", "int8-attn"])
def test_cuda_dit_needs_the_kmajor_stack(int8_attn):
    """On CUDA the megakernel reads the stack's K-major int8 copies and
    refuses a stack without them (the CPU and meta tensors of these tests
    stop at the device check before it)."""
    _, _, layers = _layers(seed=15)
    st = _stack(layers, int8_attn, "torch")
    with pytest.raises(ValueError, match="K-major int8 copies"):
        layer_kernel.need_kmajor_stack(st)
    full = _kmajor(st)
    layer_kernel.need_kmajor_stack(full)
    if int8_attn:
        # the experts' copies alone do not do for int8 projections
        del full["wout_t"]
        with pytest.raises(ValueError, match="wout_t missing"):
            layer_kernel.need_kmajor_stack(full)


@pytest.mark.parametrize("B", [1, 128])
def test_dit_tile_plan_covers_every_output_once(B):
    """The megakernel's plan at the flagship widths (D=1024, hidden 4096,
    block_hidden 1024, 132 SMs), decoded as the kernel decodes it: the
    per-layer kernels' plans at the same row count (128 x 128 tiles above
    256 token rows, 64 x 64 below), every output element of the QKV,
    c_proj, up and down stages in exactly one tile, on a grid of one CTA
    per SM."""
    D, HH, TH, ctas = 1024, 4096, 1024, 132
    M = B * 14
    plan = layer_kernel.dit_tile_plan(M, D, HH, TH, ctas)
    tile = 128 if M > 256 else 64
    assert plan.tile == tile and plan.grid == ctas
    for proj, N in ((plan.qkv, 3 * D), (plan.out, D)):
        assert (proj.tile_m, proj.tile_n) == (tile, tile)
        hits = np.zeros((M, N), np.int32)
        for cta, rows, cols in proj_tiles(proj, M):
            assert 0 <= cta < ctas
            hits[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert (hits == 1).all()
    moe = plan.moe
    assert moe.tile == tile
    up = np.zeros((2, M, HH), np.int32)
    for cta, z, rows, cols in moe_tiles(moe, "up", M, D, HH):
        assert 0 <= cta < ctas
        up[z, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (up == 1).all()
    # down: one sum per output (128 x 128), or one partial per (slot,
    # hidden block) and output (64 x 64)
    n_z = 1 if tile == 128 else 2 * (HH // TH)
    down = np.zeros((n_z, M, D), np.int32)
    for cta, z, rows, cols in moe_tiles(moe, "down", M, D, HH):
        down[z, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (down == 1).all()


@pytest.mark.parametrize("int8_attn", [False, True],
                         ids=["bf16-attn", "int8-attn"])
@pytest.mark.parametrize("tile", [64, 128])
def test_dit_stages_and_scratch_match_the_kernel(int8_attn, tile):
    """The stage names (the intervals of the kernel's clock buffer) follow
    its grid barriers: eight per layer, one more with int8 projections and
    one more with 64-row tiles; the scratch fills the pointer slots from
    "h" to "tmp", each used buffer where the kernel reads one."""
    names = layer_kernel.dit_stage_names(int8_attn, tile)
    assert len(names) == 8 + int8_attn + (tile == 64)
    assert names[1] == "qkv" and names[-1] == ("moe_sum" if tile == 64
                                               else "moe_down")
    scratch = layer_kernel.dit_scratch(14, 256, 1024, 256, tile, int8_attn)
    slots = layer_kernel.DIT_PTRS
    used = dict(zip(slots[slots.index("h"):slots.index("out")], scratch))
    assert len(used) == len(scratch)
    assert all(used[k] > 0 for k in ("h", "qkv", "o", "xmid", "xm", "xq",
                                     "sx", "act", "aq", "sa", "tmp"))
    assert (used["oq"] > 0) == (used["hs"] > 0) == (used["os"] > 0) \
        == int8_attn
    assert (used["part"] > 0) == (tile == 64)


# ---- the launchers' C interfaces against the wrappers' ctypes types

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
            "const float*": ctypes.c_void_p,
            "const unsigned long long*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float}


def _c_signature(source, entry):
    text = (_build.CSRC_DIR / source).read_text()
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text,
                  re.S)
    assert m, entry
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    return [_C_TYPES[p.rsplit(" ", 1)[0].replace(" *", "*")] for p in params]


@pytest.mark.parametrize("source, entry, argtypes", [
    ("fused_attn_block.cu", "fused_attn_block_launch",
     attn_kernel._ARGTYPES["fused_attn_block"]),
    ("fused_attn_block_q8.cu", "fused_attn_block_q8_launch",
     attn_kernel._ARGTYPES["fused_attn_block_q8"]),
    ("fused_layer_q8c.cu", "fused_layer_q8c_launch",
     layer_kernel._LAUNCH_ARGTYPES["fused_layer_q8c_launch"]),
    ("fused_layer_q8c.cu", "fused_layer_q8c_q8_launch",
     layer_kernel._LAUNCH_ARGTYPES["fused_layer_q8c_q8_launch"]),
    ("fused_dit_q8c.cu", "fused_dit_q8c_launch", layer_kernel._DIT_ARGTYPES),
], ids=["fused_attn_block", "fused_attn_block_q8", "fused_layer_q8c",
        "fused_layer_q8c_q8", "fused_dit_q8c"])
def test_launcher_argtypes_match_the_c_signatures(source, entry, argtypes):
    """Each wrapper's ctypes argument types follow its launcher's C
    parameters one for one (pointers, ints, floats): a launcher that gains
    an argument its wrapper does not pass would read garbage on the card."""
    assert _c_signature(source, entry) == list(argtypes)


@pytest.mark.parametrize("enum, names", [
    ("Ptr", layer_kernel.DIT_PTRS), ("Int", layer_kernel.DIT_INTS),
    ("Flt", layer_kernel.DIT_FLOATS)], ids=["pointers", "ints", "floats"])
def test_dit_slots_match_the_kernel(enum, names):
    """The wrapper fills the megakernel's pointer, int and float arrays in
    the order of the kernel's slot enums (kX, iS, fEps1, ...)."""
    text = (_build.CSRC_DIR / "fused_dit_q8c.cu").read_text()
    body = re.search(r"enum " + enum + r" \{(.*?)\};", text, re.S).group(1)
    slots = [s.strip() for s in body.split(",") if s.strip()]
    assert slots[-1].startswith("kNum")
    kernel = [s[1:].lower() for s in slots[:-1]]
    assert kernel == [n.replace("_", "").lower() for n in names]


def test_build_hash_covers_a_new_header(tmp_path, monkeypatch):
    """A header added to csrc/ enters every library's hash, as the headers
    there already do."""
    before = {s.name: _build.library_path(s) for s in _build.sources()}
    extra = tmp_path / "new_stages.cuh"
    extra.write_text("// a new shared header\n")
    headers = _build.headers()
    monkeypatch.setattr(_build, "headers", lambda: [*headers, extra])
    after = {s.name: _build.library_path(s) for s in _build.sources()}
    assert all(before[k] != after[k] for k in before)
