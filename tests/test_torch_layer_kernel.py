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


@pytest.mark.parametrize("step", [0, 2])
def test_plain_layer_per_sample_cond_matches_jax_kernel(step):
    """A [B,1,D] cond (one row per sample, as ``use_goal_in_routing``
    makes it) with [S,2] tables at HH=256: the plain layer against the JAX
    kernel, whose ``c`` takes the same rows."""
    a = _inputs(B=4, HH=256, seed=20 + step, c_rows=4)
    _close(_torch(a, IDX, PROBS, step, 128), _jax(a, IDX, PROBS, step, 128))


def test_cuda_widths_take_a_cond_row_per_sample():
    """The CUDA wrappers' check for the whole-layer kernels: one shared row
    (1 cond row), one per sample [B,1,D] (B rows) or one per token [B,T,D]
    (B*T rows), at T=1, 14, 17 and 160; a row count other than 1, B and
    B*T raises."""
    from mode_diffusion_policy_tpu_torch.ops.kernels._common import \
        _check_widths
    B, D = 3, 256
    for T in (1, 14, 17, 160):
        assert _check_widths(T, D, 2, 128, 256, torch.zeros(1, 1, D), B) == 1
        assert _check_widths(T, D, 2, 128, 256, torch.zeros(B, 1, D),
                             B) == B
        assert _check_widths(T, D, 2, 128, 256, torch.zeros(B, T, D),
                             B) == B * T
        for bad in ((B + 1, 1, D), (B, T + 1, D), (1, T + 1, D)):
            with pytest.raises(ValueError, match="per token"):
                _check_widths(T, D, 2, 128, 256, torch.zeros(bad), B)


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
    assert [p.name for p in _build.headers()] == [
        "int8_stages.cuh", "layer_stages.cuh", "wgmma_stages.cuh"]
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


# ---- the K-major expert copy that the CUDA layer kernel's wgmma products
# read, and the tile plan of its expert products (no card needed)

from mode_diffusion_policy_tpu_torch.models import modedit  # noqa: E402
from mode_diffusion_policy_tpu_torch.ops.kernels import _build  # noqa: E402
from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (  # noqa: E402,E501
    moe_tile_plan, moe_tiles)
from mode_diffusion_policy_tpu_torch.ops.quant import (  # noqa: E402
    ExpertsKMajor, kmajor_experts)


@pytest.fixture(scope="module")
def experts():
    a = _inputs(seed=3)
    q = quantize_experts(*(torch.from_numpy(a[k]) for k in ("w1", "b1", "w2")))
    return a, q, kmajor_experts(q)


def test_kmajor_copy_is_the_transpose_of_the_jax_layout(experts):
    _, q, qt = experts
    E, D, H2 = q.w1_q.shape
    assert qt.w1_t.shape == (E, H2, D) and qt.w2_t.shape == (E, D, H2 // 2)
    for t in qt:
        assert t.dtype == torch.int8 and t.is_contiguous()
    assert torch.equal(qt.w1_t, q.w1_q.transpose(1, 2))
    assert torch.equal(qt.w2_t, q.w2_q.transpose(1, 2))
    # a copy: the JAX-layout tensors stay as they are, beside it
    assert qt.w1_t.data_ptr() != q.w1_q.data_ptr()


@pytest.mark.parametrize("step", [0, 1, 2])
def test_plain_layer_from_the_kmajor_copy_gives_the_same_bits(experts, step):
    a, q, qt = experts
    args = (*(torch.from_numpy(a[k]) for k in _ORDER), q,
            torch.from_numpy(IDX), torch.from_numpy(PROBS))
    got = fused_layer_q8c_ref(*args, step=step, qexp_t=qt, block_hidden=128)
    want = fused_layer_q8c_ref(*args, step=step, block_hidden=128)
    assert torch.equal(got, want)


def _tiny_dit(**flags):
    cfg = modedit.MoDeDiTConfig(obs_dim=64, goal_dim=32, embed_dim=256,
                                n_layers=2, n_heads=2, num_experts=4,
                                top_k=2, **flags)
    m = modedit.MoDeDiT(cfg, device="cpu")
    m.init_weights_(torch.Generator().manual_seed(0))
    return m.eval()


def test_kmajor_copy_is_made_once_per_quantization_not_per_call(monkeypatch):
    made = []

    def counting(q):
        made.append(q)
        return kmajor_experts(q)

    monkeypatch.setattr(modedit, "kmajor_experts", counting)
    m = _tiny_dit(use_int8_moe=True, use_pallas_attn=True,
                  use_fused_layer=True)
    m.quantize_experts_()
    assert len(made) == len(m.blocks)
    for blk in m.blocks:
        assert isinstance(blk.experts_qt, ExpertsKMajor)
        assert torch.equal(blk.experts_qt.w1_t,
                           blk.experts_q.w1_q.transpose(1, 2))
    passed = []

    def layer(*args, qexp_t=None, **kw):
        passed.append(qexp_t)
        return fused_layer_q8c_ref(*args, qexp_t=qexp_t, **kw)

    m.layer_impl = layer
    r = np.random.default_rng(4)
    sigmas = torch.tensor([20.0, 1.0, 0.05])
    with torch.no_grad():
        sx, ge = m.embed_static_tokens(
            {"state_images": torch.from_numpy(
                r.standard_normal((2, 2, 64)).astype(np.float32))},
            torch.from_numpy(r.standard_normal((2, 1, 32)).astype(np.float32)))
        emb = m.process_sigma_embeddings(sigmas)
        routing = m.precompute_routing(sigmas)
        acts = torch.from_numpy(r.standard_normal((2, 10, 7)).astype(
            np.float32))
        for step in range(2):
            m.forward_precomputed(sx, ge, emb[step][None], acts,
                                  moe_overrides=[(i, p, step)
                                                 for i, p in routing])
    assert len(made) == len(m.blocks)          # no copy made per call
    assert len(passed) == 2 * len(m.blocks)
    assert [id(t) for t in passed] == 2 * [id(b.experts_qt) for b in m.blocks]
    # the int8 MoE kernel of the two-kernel layer reads it too; without
    # int8 experts (or top-2 routing) no int8 MoE kernel runs, and no copy
    # is paid for
    two = _tiny_dit(use_int8_moe=True, use_pallas_attn=True)
    two.quantize_experts_()
    assert all(isinstance(b.experts_qt, ExpertsKMajor) for b in two.blocks)
    bf16 = _tiny_dit(use_pallas_attn=True)
    bf16.quantize_experts_()
    assert all(b.experts_qt is None for b in bf16.blocks)


@pytest.mark.parametrize("stage", ["up", "down"])
@pytest.mark.parametrize("M", [14, 39, 1792])
def test_tile_plan_covers_every_output_once(M, stage):
    """The plan the wrappers pass to the wgmma stages (tile by token count,
    persistent CTAs), decoded as the kernels decode it, at the flagship
    widths: every element of act (up, value columns), of the output (down,
    128 x 128 tiles: each sums all its (slot, hidden block) passes) or of
    the partials (down, 64 x 64 tiles: one tile per pass) lies in exactly
    one tile, and the CTAs share the tiles evenly."""
    D, HH, TH, ctas = 1024, 4096, 1024, 132
    plan = moe_tile_plan(M, D, HH, TH, ctas)
    assert plan.tile == (128 if M > 256 else 64)
    cols = HH if stage == "up" else D
    nz = 2 if stage == "up" else 1 if plan.tile == 128 else 2 * HH // TH
    hits = np.zeros((nz, M, cols), np.int32)
    per_cta = np.zeros(ctas, np.int32)
    for cta, z, rows, cs in moe_tiles(plan, stage, M, D, HH):
        assert rows.start < M and len(cs) == plan.tile
        hits[z, rows.start:rows.stop, cs.start:cs.stop] += 1
        per_cta[cta] += 1
    assert (hits == 1).all()
    n = plan.up_tiles if stage == "up" else plan.down_tiles
    used = per_cta[:min(ctas, n)]
    assert used.sum() == n and used.max() - used.min() <= 1


def test_nvcc_flags_keep_sm_90a():
    """wgmma and setmaxnreg exist only for sm_90a."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags


@pytest.mark.parametrize("mode", ["max-throughput", "b1-latency-max"])
def test_kmajor_copies_of_the_int8_presets_are_made_once_not_per_call(
        monkeypatch, mode):
    """Under the presets with int8 projections, quantize_experts_ and
    quantize_attn_ make the K-major copies of the int8 experts and
    projections once per quantization; the block hands the same copies to
    the kernels' functions on every call: the routed path (the two int8
    kernels, or the whole-layer kernel) and an inline call (the int8
    attention kernel)."""
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block_q8_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp_q8c_ref)
    from mode_diffusion_policy_tpu_torch.ops.quant import (AttnKMajor,
                                                           kmajor_attn)
    from mode_diffusion_policy_tpu_torch.serving import PRESET_FLAGS
    made = {"experts": 0, "attn": 0}

    def counting(key, fn):
        def wrapped(q):
            made[key] += 1
            return fn(q)
        return wrapped

    monkeypatch.setattr(modedit, "kmajor_experts",
                        counting("experts", kmajor_experts))
    monkeypatch.setattr(modedit, "kmajor_attn", counting("attn", kmajor_attn))
    m = _tiny_dit(**PRESET_FLAGS[mode])
    m.quantize_experts_()
    m.quantize_attn_()
    L = len(m.blocks)
    assert made == {"experts": L, "attn": L}
    for blk in m.blocks:
        qt = blk.attn.attn_qt
        assert isinstance(qt, AttnKMajor)
        assert torch.equal(qt.wqkv_t, blk.attn.attn_q.wqkv_q.T)
        assert torch.equal(qt.wout_t, blk.attn.attn_q.wout_q.T)
        assert isinstance(blk.experts_qt, ExpertsKMajor)
    passed = []

    def hook(fn, key):
        def wrapped(*args, **kw):
            passed.append((key, id(kw.get(key))))
            return fn(*args, **kw)
        return wrapped

    m.layer_impl = hook(hook(fused_layer_q8c_ref, "qexp_t"), "qattn_t")
    m.attn_impl = hook(fused_attn_block_q8_ref, "qattn_t")
    m.moe_impl = hook(fused_top2_mlp_q8c_ref, "qexp_t")
    r = np.random.default_rng(5)
    sigmas = torch.tensor([20.0, 1.0, 0.05])
    with torch.no_grad():
        states = {"state_images": torch.from_numpy(
            r.standard_normal((2, 2, 64)).astype(np.float32))}
        goals = torch.from_numpy(r.standard_normal((2, 1, 32)).astype(
            np.float32))
        acts = torch.from_numpy(r.standard_normal((2, 10, 7)).astype(
            np.float32))
        sx, ge = m.embed_static_tokens(states, goals)
        emb = m.process_sigma_embeddings(sigmas)
        routing = m.precompute_routing(sigmas)
        for step in range(2):
            m.forward_precomputed(sx, ge, emb[step][None], acts,
                                  moe_overrides=[(i, p, step)
                                                 for i, p in routing])
        m.forward(states, acts, goals, sigmas[:2])          # routes inline
    assert made == {"experts": L, "attn": L}       # no copy made per call
    # per routed step and block: the whole-layer function (b1-latency-max)
    # or the attention then the MoE function (max-throughput) get both
    # copies; per inline block the attention function gets its copy
    routed = [k for b in m.blocks for k in (("qattn_t", id(b.attn.attn_qt)),
                                            ("qexp_t", id(b.experts_qt)))]
    inline = [("qattn_t", id(b.attn.attn_qt)) for b in m.blocks]
    assert passed == 2 * routed + inline
