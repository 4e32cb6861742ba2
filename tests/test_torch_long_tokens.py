"""More than 16 tokens per sample, and a cond row per token, against the JAX
package, in f32 on the CPU.

The Pallas kernels take any token count T (a block-diagonal causal mask
over whole samples) and a cond of [1,1,D], [B,1,D] or [B,T,D]; so do the
port's kernels. Here the port's plain versions, which its CUDA wrappers
run for CPU tensors, are held to the Pallas kernels in interpret mode (as
tests/test_pallas_layer.py runs them) at the JAX kernel tests' shapes:
D=256, 2 heads of 128, hidden 256, B=4, at T=17 and T=20, with a shared,
a per-sample and a per-token cond: ``fused_attn_block``,
``fused_attn_block_q8``, ``fused_layer_q8c`` with bf16 and int8
projections, and ``fused_dit_q8c`` over 2 layers. Then the shipped CALVIN
config with ``act_seq_len=16`` (T=20) through the port's loader and
builders against JAX's, and a ``parity`` and a ``b1-latency`` chunk of a
small agent with a 16-action window against JAX's Pallas-interpret
chunks, the initial noise passed in.

Gates. ``fused_attn_block`` in f32 has no int8 rounding: max |diff| <=
2e-5. Where int8 rounding enters, the flip-aware gate of
tests/test_torch_layer_kernel.py: mean <= 1e-4, max <= 5e-3 and 90% of
the elements within 2e-5 (f32 sums taken in another order now and then
move an int8 rounding by one step, which moves a whole row). The
megakernel is held layer by layer on the JAX layer's input, as
tests/test_torch_dit_kernel.py holds it (one flip in an early layer
carries into every later one), and its 2-layer launch equals its layers
chained on each side. One flip can move its row by more than 5e-3 (up to
~8e-3 here: a flipped entry of the quantized attention rows or of the MoE
input). Where the max exceeds 5e-3, the case passes only if the flips
are the whole difference: the port's plain version with one or more of
its roundings that lie within 1e-4 of a tie, in the rows that differ,
taken the other way must equal the JAX output within 2e-5 everywhere.
The chunks: action MAE <= 2e-5, as tests/test_torch_variants.py's
goal-routing chunk.
"""
import contextlib
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu import serving as jserving
from mode_diffusion_policy_tpu.config import builders as jbuilders
from mode_diffusion_policy_tpu.config import loader as jloader
from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JACfg
from mode_diffusion_policy_tpu.models.edm import samplers as jsamplers
from mode_diffusion_policy_tpu.ops.pallas.attn_kernel import (
    fused_attn_block as jax_attn)
from mode_diffusion_policy_tpu.ops.pallas.attn_kernel import (
    fused_attn_block_q8 as jax_attn_q8)
from mode_diffusion_policy_tpu.ops.pallas.layer_kernel import (
    fused_dit_q8c as jax_dit)
from mode_diffusion_policy_tpu.ops.pallas.layer_kernel import (
    fused_layer_q8c as jax_layer)
from mode_diffusion_policy_tpu.ops.quant import quantize_attn as jax_qattn
from mode_diffusion_policy_tpu.ops.quant import (
    quantize_experts as jax_qexp)
from mode_diffusion_policy_tpu_torch.config import builders as tbuilders
from mode_diffusion_policy_tpu_torch.config import loader as tloader
from mode_diffusion_policy_tpu_torch.models.agent import \
    MoDEAgentConfig as TACfg
from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
from mode_diffusion_policy_tpu_torch.ops.kernels import (attn_kernel,
                                                         moe_kernel,
                                                         quant_math)
from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
    fused_attn_block, fused_attn_block_q8)
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
    fused_dit_q8c, fused_layer_q8c)
from mode_diffusion_policy_tpu_torch.ops.quant import (
    QuantizedExperts, quantize_attn, quantize_experts)
from mode_diffusion_policy_tpu_torch.utils.weights import from_jax_params
from torch_threads import two_torch_threads  # noqa: F401

CONF = pathlib.Path(__file__).resolve().parents[1] / "conf"
B, D, H, HH, E = 4, 256, 2, 256, 4
HD = D // H
TOKENS = (17, 20)
# the cond's leading shape at T tokens per sample
CONDS = {"shared": lambda T: (1, 1), "per-sample": lambda T: (B, 1),
         "per-token": lambda T: (B, T)}
# [L, S, 2] routing tables of the 2-layer stack; the layer cases take
# layer 0's
IDX = np.array([[[0, 2], [3, 1]], [[1, 3], [2, 0]]], np.int32)
PROBS = np.array([[[0.7, 0.3], [0.55, 0.45]], [[0.6, 0.4], [0.8, 0.2]]],
                 np.float32)
STEP = 1
TOL = 2e-5


def _inputs(T, cond, seed, L=1):
    """x [B,T,D], the cond of shape ``CONDS[cond]`` and L layers' weights,
    from a seed with numpy."""
    r = np.random.default_rng(seed)

    def f(*shape, sc=0.05, off=0.0):
        return (r.standard_normal(shape) * sc + off).astype(np.float32)

    layers = [dict(ln1=f(D, sc=0.1, off=1.0), wqkv=f(D, 3 * D),
                   bqkv=f(3 * D, sc=0.02), q_g=f(HD, sc=0.1, off=1.0),
                   k_g=f(HD, sc=0.1, off=1.0), wout=f(D, D),
                   ln2=f(D, sc=0.1, off=1.0), w1=f(E, D, 2 * HH),
                   b1=f(E, 2 * HH, sc=0.02), w2=f(E, HH, D))
              for _ in range(L)]
    return f(B, T, D, sc=0.5), f(*CONDS[cond](T), D, sc=0.2), layers


@contextlib.contextmanager
def _roundings(flips=(), ties=None):
    """The plain versions' per-row int8 quantization (``quant_rows``,
    numbered in the order of its calls) with the entries ``flips``, (call,
    row, column), rounded the other way; every entry whose rounding lies
    within 1e-4 of a tie is appended to ``ties``."""
    n = [0]

    def quant_rows(v):
        q, s = quant_math.quant_rows(v)
        call, n[0] = n[0], n[0] + 1
        z = v.float() * (1.0 / s)
        tie = ((z - z.floor() - 0.5).abs() < 1e-4) & (q.abs() < 127)
        if ties is not None:
            ties.extend((call, r, c) for r, c in torch.nonzero(tie).tolist())
        for i, r, c in flips:
            if i == call:
                q[r, c] = int(2 * z[r, c].floor() + 1) - int(q[r, c])
        return q, s

    mods = (attn_kernel, moe_kernel)
    try:
        for m in mods:
            m.quant_rows = quant_rows
        yield
    finally:
        for m in mods:
            m.quant_rows = quant_math.quant_rows


def _flip_gate(got, want, run):
    """The flip-aware gate on ``got`` (the port) against ``want`` (JAX);
    past the max, the flips must be the whole difference: ``run()``, the
    port's plain version, with its near-tie roundings in the rows that
    differ taken the other way (all at once, or one at a time) equals
    ``want`` within 2e-5."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert d.mean() <= 1e-4, d.mean()
    assert (d <= 2e-5).mean() >= 0.9, (d <= 2e-5).mean()
    if d.max() <= 5e-3:
        return
    ties = []
    with _roundings(ties=ties):
        np.testing.assert_array_equal(run(), got)
    rows = d.reshape(-1, D).max(1) > TOL
    near = [t for t in ties if rows[t[1]]]
    for flips in [near] + [[t] for t in near]:
        with _roundings(flips):
            if np.abs(run() - want).max() <= TOL:
                return
    raise AssertionError(f"max {d.max()} past 5e-3 in rows "
                         f"{np.nonzero(rows)[0].tolist()}, not explained by "
                         f"flipping the near-tie roundings {near}")


def _attn_args(lib, x, c, w):
    arr = jnp.asarray if lib == "jax" else torch.from_numpy
    return (arr(x), arr(c), arr(w["ln1"]))


def _qattn(lib, w):
    if lib == "jax":
        return jax_qattn(*(jnp.asarray(w[k]) for k in ("wqkv", "bqkv",
                                                      "wout")))
    return quantize_attn(*(torch.from_numpy(w[k])
                           for k in ("wqkv", "bqkv", "wout")))


@pytest.mark.parametrize("cond", list(CONDS))
@pytest.mark.parametrize("T", TOKENS)
def test_attn_block_matches_jax(T, cond):
    """``fused_attn_block`` (projections in the compute dtype, f32 here):
    no int8 rounding, so within 2e-5."""
    x, c, (w,) = _inputs(T, cond, seed=T)
    want = jax_attn(*_attn_args("jax", x, c, w),
                    *(jnp.asarray(w[k]) for k in ("wqkv", "bqkv", "q_g",
                                                  "k_g", "wout")),
                    interpret=True)
    got = fused_attn_block(*_attn_args("torch", x, c, w),
                           *(torch.from_numpy(w[k])
                             for k in ("wqkv", "bqkv", "q_g", "k_g",
                                       "wout")))
    assert got.shape == (B, T, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("cond", list(CONDS))
@pytest.mark.parametrize("T", TOKENS)
def test_attn_block_q8_matches_jax(T, cond):
    x, c, (w,) = _inputs(T, cond, seed=10 + T)
    want = jax_attn_q8(*_attn_args("jax", x, c, w), _qattn("jax", w),
                       jnp.asarray(w["q_g"]), jnp.asarray(w["k_g"]),
                       interpret=True)

    def run():
        return fused_attn_block_q8(
            *_attn_args("torch", x, c, w), _qattn("torch", w),
            torch.from_numpy(w["q_g"]), torch.from_numpy(w["k_g"])).numpy()

    _flip_gate(run(), want, run)


_LAYER_KEYS = ("ln1", "wqkv", "bqkv", "q_g", "k_g", "wout", "ln2")


@pytest.mark.parametrize("int8_proj", [False, True],
                         ids=["bf16-proj", "int8-proj"])
@pytest.mark.parametrize("cond", list(CONDS))
@pytest.mark.parametrize("T", TOKENS)
def test_fused_layer_matches_jax(T, cond, int8_proj):
    x, c, (w,) = _inputs(T, cond, seed=20 + T)
    jq = jax_qexp(*(jnp.asarray(w[k]) for k in ("w1", "b1", "w2")))
    want = jax_layer(
        jnp.asarray(x), jnp.asarray(c),
        *(jnp.asarray(w[k]) for k in _LAYER_KEYS), jq,
        jnp.asarray(IDX[0]), jnp.asarray(PROBS[0]), step=jnp.int32(STEP),
        qattn=_qattn("jax", w) if int8_proj else None, interpret=True)
    tq = quantize_experts(*(torch.from_numpy(w[k])
                            for k in ("w1", "b1", "w2")))

    def run():
        return fused_layer_q8c(
            torch.from_numpy(x), torch.from_numpy(c),
            *(torch.from_numpy(w[k]) for k in _LAYER_KEYS), tq,
            torch.from_numpy(IDX[0]), torch.from_numpy(PROBS[0]), step=STEP,
            qattn=_qattn("torch", w) if int8_proj else None).numpy()

    _flip_gate(run(), want, run)


def _stack(layers, int8_attn, lib):
    """The megakernel's stacked dict (``MoDeDiT.stack_layers``'s keys) from
    per-layer numpy weights, with the JAX package's or the port's
    quantizers."""
    if lib == "jax":
        qexp, arr, stk = jax_qexp, jnp.asarray, jnp.stack
    else:
        qexp, arr, stk = quantize_experts, torch.from_numpy, torch.stack
    st = {k: stk([arr(lw[k]) for lw in layers])
          for k in ("ln1", "q_g", "k_g", "ln2")}
    qs = [qexp(*(arr(lw[k]) for k in ("w1", "b1", "w2"))) for lw in layers]
    for i, k in enumerate(QuantizedExperts._fields):
        st[k] = stk([q[i] for q in qs])
    if int8_attn:
        qa = [_qattn(lib, lw) for lw in layers]
        for i, k in enumerate(("wqkv", "sqkv", "bqkv", "wout", "sout")):
            st[k] = stk([q[i] for q in qa])
    else:
        for k in ("wqkv", "bqkv", "wout"):
            st[k] = stk([arr(lw[k]) for lw in layers])
    return st


# bf16 projections (b1-latency) at each token count and cond; int8
# projections (b1-latency-max) with the per-token cond at T=20. The plain
# megakernel is the plain layer chained, whose int8 projections
# test_fused_layer_matches_jax holds in every case.
@pytest.mark.parametrize("T,cond,int8_proj", [
    *((T, cond, False) for T in TOKENS for cond in CONDS),
    (20, "per-token", True)])
def test_megakernel_two_layers_matches_jax(T, cond, int8_proj):
    """``fused_dit_q8c`` over 2 layers, each layer on the JAX layer's
    input (one-layer launches of the JAX megakernel) by the flip-aware
    gate; both 2-layer launches equal their layers chained."""
    x, c, layers = _inputs(T, cond, seed=30 + T, L=2)
    jst, tst = _stack(layers, int8_proj, "jax"), _stack(layers, int8_proj,
                                                       "torch")
    kw = dict(step=jnp.int32(STEP), interpret=True)
    jc, tc = jnp.asarray(c), torch.from_numpy(c)
    h, ht = jnp.asarray(x), torch.from_numpy(x)
    for l, w in enumerate(layers):
        h_in = np.array(h)
        h = jax_dit(h, jc, {k: v[l:l + 1] for k, v in jst.items()},
                    jnp.asarray(IDX[l:l + 1]), jnp.asarray(PROBS[l:l + 1]),
                    **kw)
        tone = {k: v[l:l + 1] for k, v in tst.items()}

        def run():
            return fused_dit_q8c(torch.from_numpy(h_in), tc, tone,
                                 torch.from_numpy(IDX[l:l + 1]),
                                 torch.from_numpy(PROBS[l:l + 1]),
                                 step=STEP).numpy()

        _flip_gate(run(), h, run)
        ht = fused_dit_q8c(ht, tc, tone, torch.from_numpy(IDX[l:l + 1]),
                           torch.from_numpy(PROBS[l:l + 1]), step=STEP)
    whole = jax_dit(jnp.asarray(x), jc, jst, jnp.asarray(IDX),
                    jnp.asarray(PROBS), **kw)
    np.testing.assert_array_equal(np.asarray(whole), np.asarray(h))
    got = fused_dit_q8c(torch.from_numpy(x), tc, tst, torch.from_numpy(IDX),
                        torch.from_numpy(PROBS), step=STEP)
    torch.testing.assert_close(got, ht, rtol=0, atol=0)


def test_shipped_config_with_16_actions_builds_like_jax():
    """``training_calvin act_seq_len=16`` / ``evaluate_calvin``: the shipped
    CALVIN config through the port's loader and builders equals JAX's
    field by field, with a 16-action window and T=20 tokens per sample."""
    cfg = tloader.load_config(CONF, "config_calvin", ["act_seq_len=16"])
    assert cfg == jloader.load_config(CONF, "config_calvin",
                                      ["act_seq_len=16"])
    got = tbuilders.build_agent_config(cfg["model"])
    want = jbuilders.build_agent(cfg["model"])[0].cfg
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.act_window_size == 16 and got.n_layers == 12
    assert got.dit_config().total_tokens == 20
    assert want.dit_config().total_tokens == 20


# ---- a small agent with a 16-action window ---------------------------------

AGENT_DIMS = dict(latent_dim=D, n_layers=2, n_heads=H, cond_dim=32,
                  resnet_type="18", num_sampling_steps=3, act_window_size=16)
IMG = 32


def _fill(path, s, r):
    name = str(path[-1].key)
    key = jax.tree_util.keystr(path)
    v = r.standard_normal(s.shape).astype(np.float32)
    if name == "var":
        return r.uniform(0.5, 1.5, s.shape).astype(np.float32)
    if name in ("g", "scale"):
        return 1.0 + 0.1 * v
    if name in ("mean", "bias"):
        return 0.05 * v
    if name == "kernel" and len(s.shape) == 4:
        return v / np.sqrt(np.prod(s.shape[:3]))
    if "router" in key:
        return 0.5 * v               # spread the router logits
    return 0.05 * v


@pytest.fixture(scope="module")
def agent_case():
    """The JAX agent, its numpy-made variables and the chunk's inputs."""
    jagent = JAgent(JACfg(**AGENT_DIMS))
    shapes = jax.eval_shape(
        lambda k: jagent.init_variables(k, image_hw=(IMG, IMG)),
        jax.random.PRNGKey(0))
    r = np.random.default_rng(7)
    v = jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, r),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    d = dict(rgb=r.uniform(-1, 1, (2, 1, IMG, IMG, 3)).astype(np.float32),
             lang=r.standard_normal((2, 1, 32)).astype(np.float32),
             noise=r.standard_normal((2, 16, 7)).astype(np.float32))
    return jagent, v, d


def _jax_chunk(jagent, v, d, mode):
    agent, v = jserving.apply_serving_mode(jagent, v, mode)
    v = agent.precast_for_serving(v)
    rgb, lang = jnp.asarray(d["rgb"]), jnp.asarray(d["lang"])
    emb, _ = agent.embed_visual_obs(v, rgb, rgb, lang)
    routing = agent.precompute_routing(v, agent.sigmas[:-1])
    den = agent.make_denoiser(v, emb, lang, routing, sigmas=agent.sigmas)
    x0 = jnp.asarray(d["noise"]) * agent.cfg.sigma_max
    out = jsamplers.sample_loop("ddim", den, x0, agent.sigmas,
                                jax.random.PRNGKey(0))
    return np.asarray(out), agent.cfg


@pytest.mark.parametrize("mode", ["parity", "b1-latency"])
def test_chunk_with_16_actions_matches_jax(agent_case, mode):
    """T=20 through the served path: ``parity`` runs the whole-layer
    function per layer, ``b1-latency`` the megakernel's, each against the
    JAX agent's chunk through its Pallas kernels in interpret mode."""
    jagent, v, d = agent_case
    want, jcfg = _jax_chunk(jagent, v, d, mode)
    agent = from_jax_params(jax.tree.map(np.asarray, v), TACfg(**AGENT_DIMS),
                            device="cpu")
    policy = RolloutPolicy.with_serving_mode(agent, mode=mode)
    dit = policy.agent.inner_model
    assert dit.cfg.total_tokens == 20
    if mode == "parity":
        assert jcfg.use_fused_layer and dit.cfg.fused_layer
    else:
        assert jcfg.use_megakernel and dit.cfg.megakernel
    obs = {k: torch.from_numpy(d["rgb"]) for k in ("rgb_static",
                                                  "rgb_gripper")}
    got = policy.predict_chunk(obs, {"lang_emb": torch.from_numpy(d["lang"])},
                               torch.from_numpy(d["noise"])).numpy()
    assert got.shape == want.shape == (2, 16, 7) and np.isfinite(got).all()
    mae = float(np.abs(got - want).mean())
    print(f"{mode} chunk, 16 actions (T=20) vs JAX: action MAE {mae:.4e}, "
          f"max abs {float(np.abs(got - want).max()):.4e}")
    assert mae <= TOL
