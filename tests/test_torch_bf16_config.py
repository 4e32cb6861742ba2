"""The bf16 kernel configuration and the flag combinations the port's config
used to refuse, as whole action chunks against the JAX agent on the same
weights and the same initial noise (10-step DDIM of a 2-layer D=256 DiT
with 2 heads of 128, f32 on the CPU; the JAX side runs its Pallas kernels
in interpret mode, the port its kernels' plain versions).

- The bf16 kernel configuration (``use_pallas_moe`` and
  ``use_pallas_attn``, no int8: the JAX bench's ``BENCH_INT8=0`` flag set,
  with ``use_fused_layer`` set and inert) served by ``RolloutPolicy(agent)``
  with no preset: frames -> 2x FiLM-ResNet-50 -> routing -> per layer and
  step ``fused_attn_block`` then ``fused_top2_mlp``.
- (a) ``use_fused_layer`` without int8 experts: inert; the attention kernel
  then the plain top-2 gather.
- (b) ``use_megakernel`` without ``use_fused_layer``: the megakernel runs,
  as in the JAX agent (int8 top-2 experts and the attention kernel).
- (c) int8 attention projections without int8 experts:
  ``fused_attn_block_q8`` then the bf16 MoE kernel.
- (d) the whole-layer kernel with int8 projections, the megakernel off
  (``max-throughput``'s flags with ``use_fused_layer``): one
  ``fused_layer_q8c(qattn=)`` call per layer and step, which the port ran
  only on the CPU before its CUDA launcher existed.

(a)-(d) start from the same random camera features (the encoders are held
by tests/test_torch_slice.py), through ``MoDEAgent.denoise_actions``.

Gate: action MAE <= 1e-3 (the parity budget). With int8 projections, (c)
and (d), one int8 rounding flip moves a whole sample
(tests/test_torch_slice.py explains why): an int8 rounding whose float64
value lies within float32 noise of a step's .5 goes either way, on either
side. There the gate is max(1e-3, 2 x (the port's flips + JAX's flips)),
each side's flips measured as the distance of its chunk from the same
chunk with its kernels evaluated near-exactly (the same cast chain with
the products, norms and softmax in float64): the port's through its
kernels' plain versions, JAX's through numpy versions of its Pallas
kernels that round to int8, written in this file (``_np_attn_q8``,
``_np_layer_q8c``) and sharing no code with the port. The test prints
both distances.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JCfg
from mode_diffusion_policy_tpu.models.edm import samplers as jsamplers
from mode_diffusion_policy_tpu.ops.image import preprocess_camera as jpre
from mode_diffusion_policy_tpu.ops.pallas import attn_kernel as jak
from mode_diffusion_policy_tpu.ops.pallas import layer_kernel as jlk
from mode_diffusion_policy_tpu_torch.models.agent import \
    MoDEAgentConfig as TCfg
from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera as tpre
from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
    fused_attn_block_q8_ref)
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
    fused_layer_q8c_ref)
from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
    fused_top2_mlp_ref)
from mode_diffusion_policy_tpu_torch.utils.weights import from_jax_params
from torch_threads import two_torch_threads  # noqa: F401

DIMS = dict(latent_dim=256, n_layers=2, n_heads=2, cond_dim=32,
            num_experts=4, top_k=2)
B, IMG = 2, 32
BF16_CONFIG = dict(use_pallas_moe=True, use_pallas_attn=True,
                   use_int8_moe=False, use_fused_layer=True,
                   use_int8_attn=False, use_megakernel=False)
REPAIRED = {
    "a-fused-layer-without-int8": dict(use_fused_layer=True,
                                       use_pallas_attn=True),
    "b-megakernel-without-fused-layer": dict(use_int8_moe=True,
                                             use_pallas_moe=True,
                                             use_pallas_attn=True,
                                             use_megakernel=True),
    "c-int8-attn-without-int8-moe": dict(use_pallas_attn=True,
                                         use_int8_attn=True,
                                         use_pallas_moe=True),
    "d-fused-layer-int8-attn-without-megakernel": dict(
        use_int8_moe=True, use_pallas_moe=True, use_pallas_attn=True,
        use_fused_layer=True, use_int8_attn=True),
}


def _random_variables(agent, seed=0):
    shapes = jax.eval_shape(
        lambda k: agent.init_variables(k, image_hw=(IMG, IMG)),
        jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)

    def fill(path, s):
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
            return 0.5 * v
        return 0.05 * v

    return jax.tree_util.tree_map_with_path(
        fill, {"params": shapes["params"],
               "batch_stats": shapes["batch_stats"]})


@pytest.fixture(scope="module")
def setup():
    v = _random_variables(JAgent(JCfg(resnet_type="50", **DIMS)))
    r = np.random.default_rng(1)
    data = dict(
        u8s=r.integers(0, 256, (B, 1, IMG, IMG, 3), dtype=np.uint8),
        u8g=r.integers(0, 256, (B, 1, IMG, IMG, 3), dtype=np.uint8),
        states=r.standard_normal((B, 2, 2048)).astype(np.float32),
        lang=r.standard_normal((B, 1, 32)).astype(np.float32),
        noise=r.standard_normal((B, 10, 7)).astype(np.float32))
    return v, data


def _jax_denoise(agent, v, emb, lang, noise):
    routing = agent.precompute_routing(v, agent.sigmas[:-1])
    den = agent.make_denoiser(v, emb, lang, routing, sigmas=agent.sigmas)
    x0 = jnp.asarray(noise) * agent.cfg.sigma_max
    return np.asarray(jsamplers.sample_loop("ddim", den, x0, agent.sigmas,
                                            jax.random.PRNGKey(0)))


def _counting(dit, names):
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(dit, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)
        setattr(dit, name, wrapped)
    return counts


F32 = np.float32


def _np_quant_rows(x):
    """The kernels' per-row int8 quantization, in float32: (the int8
    values as floats, the per-row scale)."""
    x = x.astype(F32)
    s = np.maximum(np.abs(x).max(1, keepdims=True), F32(1e-6)) / F32(127.0)
    return np.clip(np.round(x * (F32(1.0) / s)), -127, 127), s


def _np_dot(a, b):
    """A product in float64, rounded to float32 (exact for int8 operands)."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(F32)


def _np_rms(a, n, eps):
    """max(rms, eps) over the last axis's groups of n, the sum of squares
    in float64."""
    a64 = a.astype(np.float64).reshape(*a.shape[:-1], -1, n)
    rms = (np.sqrt((a64 * a64).sum(-1, keepdims=True)) * n ** -0.5).astype(F32)
    return np.maximum(rms, F32(eps))


def _np_rmsnorm(a, g, eps):
    return a / _np_rms(a, a.shape[-1], eps)[..., 0] * g.astype(F32)


def _np_attn_q8(x, c, ln_g, q_g, k_g, qattn, *, ln_eps, qk_eps):
    """JAX's ``fused_attn_block_q8`` (the Pallas ``_kernel_q8``, and the
    attention half of ``fused_layer_q8c``) in numpy: its float32 cast chain
    with the products, norms and softmax in float64. Returns x + attn(x),
    float32 [B*T, D]."""
    B, T, D = x.shape
    hd = q_g.shape[-1]
    H = D // hd

    def headnorm(a, g):
        inv = F32(1.0) / _np_rms(a, hd, qk_eps)
        return (a.reshape(-1, H, hd) * inv * g.astype(F32)).reshape(-1, D)

    def heads(a):
        return a.reshape(B, T, H, hd).transpose(0, 2, 1, 3)

    x32 = x.reshape(B * T, D).astype(F32)
    c32 = np.broadcast_to(c.astype(F32), (B, T, D)).reshape(B * T, D)
    hq, hs = _np_quant_rows(_np_rmsnorm(x32, ln_g, ln_eps) + c32)
    qkv = _np_dot(hq, qattn.wqkv_q) * (hs * qattn.wqkv_s) + qattn.bqkv
    q = heads(headnorm(qkv[:, :D], q_g))
    k = heads(headnorm(qkv[:, D:2 * D], k_g))
    sc = _np_dot(q, k.transpose(0, 1, 3, 2)) * F32(1.0 / np.sqrt(hd))
    sc = np.where(np.tril(np.ones((T, T), bool)), sc, F32(-1e30))
    sc = sc.astype(np.float64)
    ex = np.exp(sc - sc.max(-1, keepdims=True))
    a = (ex / ex.sum(-1, keepdims=True)).astype(F32)
    o = _np_dot(a, heads(qkv[:, 2 * D:])).transpose(0, 2, 1, 3)
    oq, os_ = _np_quant_rows(o.reshape(B * T, D))
    return x32 + _np_dot(oq, qattn.wout_q) * (os_ * qattn.wout_s)


def _np_layer_q8c(x, c, ln1_g, q_g, k_g, ln2_g, qexp, qattn, idx, probs, *,
                  eps1, eps2, eps_qk, block_hidden):
    """JAX's ``fused_layer_q8c`` with int8 projections (the Pallas
    ``_kernel``) in numpy, as ``_np_attn_q8``: ln_2 of x + attn(x), plus
    the int8 top-2 MoE of it."""
    acc = _np_rmsnorm(_np_attn_q8(x, c, ln1_g, q_g, k_g, qattn, ln_eps=eps1,
                                  qk_eps=eps_qk), ln2_g, eps2)
    xq, sx = _np_quant_rows(acc)
    HH = qexp.w1_q.shape[-1] // 2
    TH = min(block_hidden, HH)
    for e, p in zip(idx, probs):
        for k0 in range(0, HH, TH):
            vc, gc = slice(k0, k0 + TH), slice(HH + k0, HH + k0 + TH)
            value = (_np_dot(xq, qexp.w1_q[e][:, vc])
                     * (sx * qexp.w1_s[e][vc]) + qexp.b1[e][vc])
            gate = (_np_dot(xq, qexp.w1_q[e][:, gc])
                    * (sx * qexp.w1_s[e][gc]) + qexp.b1[e][gc])
            aq, sa = _np_quant_rows(value * (gate / (F32(1.0)
                                                     + np.exp(-gate))))
            acc = acc + F32(p) * (_np_dot(aq, qexp.w2_q[e][vc])
                                  * (sa * qexp.w2_s[e]))
    return acc.astype(x.dtype).reshape(x.shape)


def _on_host(fn, x, *args):
    """fn(numpy x, numpy args) as a host callback in a traced chunk, of
    x's shape and dtype."""
    return jax.pure_callback(
        lambda *a: fn(*jax.tree.map(np.asarray, a)).astype(x.dtype).reshape(
            x.shape),
        jax.ShapeDtypeStruct(x.shape, x.dtype), x, *args,
        vmap_method="sequential")


def _near_exact_attn_q8(x, c, ln_g, qa, q_g, k_g, *, ln_eps=1e-6,
                        qk_eps=1e-6, **_):
    """Takes the place of JAX's ``fused_attn_block_q8``: ``_np_attn_q8``."""
    return _on_host(functools.partial(_np_attn_q8, ln_eps=ln_eps,
                                      qk_eps=qk_eps), x, c, ln_g, q_g, k_g, qa)


def _near_exact_layer_q8c(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g,
                          qexp, top2_idx, top2_probs, *, step=None,
                          qattn=None, block_hidden=1024, eps1=1e-6,
                          eps_qk=1e-6, eps2=1e-6, **_):
    """Takes the place of JAX's ``fused_layer_q8c`` with int8 projections:
    the routing row ``step``, then ``_np_layer_q8c``."""
    assert qattn is not None
    idx = jnp.asarray(top2_idx, jnp.int32)
    probs = jnp.asarray(top2_probs, jnp.float32)
    if idx.ndim == 2:
        row = 0 if step is None else jnp.reshape(step, ())
        idx, probs = idx[row], probs[row]
    return _on_host(functools.partial(_np_layer_q8c, eps1=eps1, eps2=eps2,
                                      eps_qk=eps_qk,
                                      block_hidden=block_hidden),
                    x, c, ln1_g, q_g, k_g, ln2_g, qexp, qattn, idx, probs)


IMPLS = ("layer_impl", "dit_impl", "attn_impl", "attn_impl_bf16",
         "moe_impl", "moe_impl_bf16")


def test_bf16_configuration_chunk_matches_jax(setup):
    """The bf16 kernel configuration served by RolloutPolicy(agent), no
    preset: the whole chunk against the JAX agent's, and per denoise step
    one attention and one bf16 MoE call per layer, nothing else."""
    v, d = setup
    jagent = JAgent(JCfg(resnet_type="50", **DIMS, **BF16_CONFIG))
    jv = jagent.precast_for_serving(v)
    lang = jnp.asarray(d["lang"])
    emb, _ = jagent.embed_visual_obs(jv, jpre(None, jnp.asarray(d["u8s"]),
                                              size=IMG),
                                     jpre(None, jnp.asarray(d["u8g"]),
                                          size=IMG), lang)
    want = _jax_denoise(jagent, jv, emb, lang, d["noise"])

    agent = from_jax_params(jax.tree.map(np.asarray, v), TCfg(**DIMS),
                            device="cpu")
    agent.configure_(**BF16_CONFIG)
    policy = RolloutPolicy(agent)
    counts = _counting(policy.agent.inner_model, IMPLS)
    obs = {"rgb_static": tpre(torch.from_numpy(d["u8s"]), size=IMG),
           "rgb_gripper": tpre(torch.from_numpy(d["u8g"]), size=IMG)}
    got = policy.predict_chunk(obs, {"lang_emb": torch.from_numpy(d["lang"])},
                               torch.from_numpy(d["noise"])).numpy()
    assert got.shape == (B, 10, 7) and np.isfinite(got).all()
    mae = np.abs(got - want).mean()
    assert mae <= 1e-3, mae
    L = DIMS["n_layers"] * 10
    assert counts == {**dict.fromkeys(IMPLS, 0), "attn_impl_bf16": L,
                      "moe_impl_bf16": L}, counts


@pytest.mark.parametrize("name", list(REPAIRED))
def test_repaired_combination_chunk_matches_jax(setup, name, monkeypatch):
    """Each flag combination the port's config refused before builds, runs
    the functions the JAX package runs for it, and gives the JAX agent's
    chunk from the same camera features."""
    v, d = setup
    flags = REPAIRED[name]
    jagent = JAgent(JCfg(resnet_type="50", **DIMS, **flags))
    jv = jagent.quantize_for_inference(v) if (
        flags.get("use_int8_moe") or flags.get("use_int8_attn")) else v
    want = _jax_denoise(jagent, jv,
                        {"state_images": jnp.asarray(d["states"])},
                        jnp.asarray(d["lang"]), d["noise"])

    agent = from_jax_params(jax.tree.map(np.asarray, v), TCfg(**DIMS),
                            device="cpu")
    agent.configure_(**flags).quantize_for_inference()
    dit = agent.inner_model
    counts = _counting(dit, IMPLS)

    def chunk():
        return agent.denoise_actions(
            {"state_images": torch.from_numpy(d["states"])},
            torch.from_numpy(d["lang"]), noise=torch.from_numpy(d["noise"]),
            use_routing_precompute=True).numpy()

    got = chunk()
    assert got.shape == (B, 10, 7) and np.isfinite(got).all()
    L, S = DIMS["n_layers"], 10
    want_counts = dict.fromkeys(IMPLS, 0)
    if name.startswith("a"):
        want_counts["attn_impl_bf16"] = L * S      # then the plain gather
    elif name.startswith("b"):
        want_counts["dit_impl"] = S
    elif name.startswith("c"):
        want_counts.update(attn_impl=L * S, moe_impl_bf16=L * S)
    else:
        want_counts["layer_impl"] = L * S
    assert counts == want_counts, counts
    tol = 1e-3
    if name[0] in "cd":
        # each side's int8 flips: its chunk's distance from the chunk with
        # its kernels evaluated near-exactly (products, norms and softmax
        # in f64); the port's through its plain versions, JAX's through
        # numpy versions of its Pallas kernels
        f64 = dict(acc_dtype=torch.float64, red_dtype=torch.float64)
        if name.startswith("c"):
            dit.attn_impl = functools.partial(fused_attn_block_q8_ref, **f64)
            dit.moe_impl_bf16 = functools.partial(fused_top2_mlp_ref, **f64)
            monkeypatch.setattr(jak, "fused_attn_block_q8",
                                _near_exact_attn_q8)
        else:
            dit.layer_impl = functools.partial(fused_layer_q8c_ref, **f64)
            monkeypatch.setattr(jlk, "fused_layer_q8c", _near_exact_layer_q8c)
        got64 = chunk()
        want64 = _jax_denoise(jagent, jv,
                              {"state_images": jnp.asarray(d["states"])},
                              jnp.asarray(d["lang"]), d["noise"])
        port_flips = np.abs(got - got64).mean()
        jax_flips = np.abs(want - want64).mean()
        tol = max(tol, 2.0 * (port_flips + jax_flips))
        print(f"{name}: MAE {np.abs(got - want).mean():.3e}, gate {tol:.3e}; "
              f"port {port_flips:.3e} and JAX {jax_flips:.3e} from their "
              f"near-exact chunks, which are "
              f"{np.abs(got64 - want64).mean():.3e} apart")
    mae = np.abs(got - want).mean()
    assert mae <= tol, (mae, tol)
