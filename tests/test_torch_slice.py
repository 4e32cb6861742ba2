"""The whole served slice against the JAX package on the same weights and
the same initial noise: uint8 frames -> eval preprocessing -> 2x FiLM-ResNet-50
-> per-sigma routing -> hoisted 10-step DDIM of the 2-layer DiT -> action
chunk, f32 on the CPU, under the ``parity`` preset (int8 experts,
whole-layer function), the ``b1-latency`` and ``b1-latency-max`` presets
(the whole block stack as one function per step, bf16 or int8 attention
projections; the JAX side runs its Pallas kernels in interpret mode) and
the ``reference`` preset. Also the EDM pieces on their own.

Gate: action MAE <= 1e-3 (the parity preset's budget); in f32 the two
agree far closer (rare int8 rounding flips aside). ``b1-latency-max``, which
the JAX package documents as over that budget, re-quantizes every token row
twice more per layer (before QKV and before c_proj), and one int8 flip there
moves a whole sample's chunk; there the gate is max(1e-3, 2 x the larger
distance between the port's plain evaluation and two near-exact ones: the
products accumulated in f64, and the products, norms and softmax too), the
rule chip_smoke.py holds the megakernel paths to.

The port loads only the JAX parameters (``utils/weights.from_jax_params``):
every int8 tensor, the attention projections' included, is derived from
them by the preset (``quantize_for_inference``), on both sides.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JCfg
from mode_diffusion_policy_tpu.models.edm import precond as jprecond
from mode_diffusion_policy_tpu.models.edm import samplers as jsamplers
from mode_diffusion_policy_tpu.models.edm import schedules as jsched
from mode_diffusion_policy_tpu.ops.image import preprocess_camera as jpre
from mode_diffusion_policy_tpu.serving import apply_serving_mode as japply
from mode_diffusion_policy_tpu_torch.models.agent import \
    MoDEAgentConfig as TCfg
from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
from mode_diffusion_policy_tpu_torch.models.edm import precond as tprecond
from mode_diffusion_policy_tpu_torch.models.edm import samplers as tsamplers
from mode_diffusion_policy_tpu_torch.models.edm import schedules as tsched
from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera as tpre
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
    fused_dit_q8c, fused_dit_q8c_ref)
from mode_diffusion_policy_tpu_torch.utils.weights import from_jax_params

DIMS = dict(latent_dim=256, n_layers=2, n_heads=2, cond_dim=32,
            num_experts=4, top_k=2)
B, IMG = 2, 32


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
    jagent = JAgent(JCfg(resnet_type="50", **DIMS))
    v = _random_variables(jagent)
    r = np.random.default_rng(1)
    data = dict(
        u8s=r.integers(0, 256, (B, 1, IMG, IMG, 3), dtype=np.uint8),
        u8g=r.integers(0, 256, (B, 1, IMG, IMG, 3), dtype=np.uint8),
        lang=r.standard_normal((B, 1, 32)).astype(np.float32),
        noise=r.standard_normal((B, 10, 7)).astype(np.float32))
    return jagent, v, data


def _jax_chunk(agent, v, d, mode):
    """The JAX RolloutPolicy path (serving preset, preprocessing, encoders,
    routing precompute, hoisted denoiser, DDIM) with explicit noise; returns
    the chunk and the preset's JAX config."""
    agent, v = japply(agent, v, mode)
    v = agent.precast_for_serving(v)
    lang = jnp.asarray(d["lang"])
    emb, _ = agent.embed_visual_obs(
        v, jpre(None, jnp.asarray(d["u8s"]), size=IMG),
        jpre(None, jnp.asarray(d["u8g"]), size=IMG), lang)
    routing = agent.precompute_routing(v, agent.sigmas[:-1])
    den = agent.make_denoiser(v, emb, lang, routing, sigmas=agent.sigmas)
    x0 = jnp.asarray(d["noise"]) * agent.cfg.sigma_max
    return np.asarray(jsamplers.sample_loop("ddim", den, x0, agent.sigmas,
                                            jax.random.PRNGKey(0))), \
        agent.cfg


def _port_chunk(v, d, mode):
    agent = from_jax_params(jax.tree.map(np.asarray, v), TCfg(**DIMS),
                            device="cpu")
    policy = RolloutPolicy.with_serving_mode(agent, mode=mode)
    obs = {"rgb_static": tpre(torch.from_numpy(d["u8s"]), size=IMG),
           "rgb_gripper": tpre(torch.from_numpy(d["u8g"]), size=IMG)}
    goal = {"lang_emb": torch.from_numpy(d["lang"])}
    chunk = policy.predict_chunk(obs, goal, torch.from_numpy(d["noise"]))
    return policy, obs, goal, chunk.numpy()


FLAGS = ("use_int8_moe", "use_fused_layer", "use_int8_attn",
         "use_megakernel")


def _counting(fn, counts, key):
    def wrapped(*a, **k):
        counts[key] += 1
        return fn(*a, **k)
    return wrapped


@pytest.mark.parametrize("mode", ["parity", "reference", "b1-latency",
                                  "b1-latency-max"])
def test_slice_matches_jax(setup, mode):
    jagent, v, d = setup
    want, jcfg = _jax_chunk(jagent, v, d, mode)
    policy, obs, goal, got = _port_chunk(v, d, mode)
    assert got.shape == (B, 10, 7) and np.isfinite(got).all()
    dit = policy.agent.inner_model
    tol = 1e-3
    if mode == "b1-latency-max":
        for red in (torch.float32, torch.float64):
            dit.dit_impl = functools.partial(
                fused_dit_q8c_ref, acc_dtype=torch.float64, red_dtype=red)
            exact = policy.predict_chunk(obs, goal,
                                         torch.from_numpy(d["noise"]))
            tol = max(tol, 2.0 * np.abs(got - exact.numpy()).mean())
        dit.dit_impl = fused_dit_q8c
    mae = np.abs(got - want).mean()
    assert mae <= tol, (mae, tol)
    kernels = mode != "reference"
    b1 = mode.startswith("b1-latency")
    assert policy.agent.cfg.use_fused_layer == kernels
    assert (policy.agent.folded is not None) == kernels
    if kernels:
        # the JAX flag map (as tests/test_serving_modes.py pins it) and the
        # port's flags for the same preset
        assert jcfg.use_int8_moe and jcfg.use_pallas_moe
        assert jcfg.use_pallas_attn and jcfg.use_fused_layer
        assert jcfg.use_megakernel == b1
        assert jcfg.use_int8_attn == (mode == "b1-latency-max")
        for flag in FLAGS:
            assert getattr(policy.agent.cfg, flag) == getattr(jcfg, flag), \
                flag
    assert (dit.stacked is not None) == b1
    if b1:
        # one whole-stack call per denoise step, no per-layer call
        counts = {"dit": 0, "layer": 0}
        dit.dit_impl = _counting(dit.dit_impl, counts, "dit")
        dit.layer_impl = _counting(dit.layer_impl, counts, "layer")
        again = policy.predict_chunk(obs, goal, torch.from_numpy(d["noise"]))
        assert counts == {"dit": 10, "layer": 0}
        np.testing.assert_array_equal(again.numpy(), got)
    if mode == "parity":
        # the chunked stepper hands out the chunk one action at a time
        policy.reset()
        noise = torch.from_numpy(d["noise"])
        policy.lang = lambda texts: torch.from_numpy(d["lang"][:len(texts)])
        goal_text = {"lang_text": ["open the drawer", "push the block"]}
        acts = [policy.step(obs, goal_text, noise) for _ in range(10)]
        np.testing.assert_allclose(torch.stack(acts, 1).numpy(), got,
                                   atol=1e-6)


def test_schedules_match():
    for name in tsched.NOISE_SCHEDULES:
        np.testing.assert_array_equal(
            tsched.get_noise_schedule(10, name),
            jsched.get_noise_schedule(10, name))


def test_edm_scalings_and_ddim_match():
    sig = np.array([80.0, 3.0, 0.01], np.float32)
    for j, t in zip(jprecond.edm_scalings(jnp.asarray(sig)),
                    tprecond.edm_scalings(torch.from_numpy(sig))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    sigmas = jsched.get_noise_schedule(10, "exponential")
    x0 = np.random.default_rng(3).standard_normal((2, 10, 7)).astype(
        np.float32) * 80.0

    def jden(x, s, i):
        return jnp.tanh(x) * 0.5 + 0.01 * i

    def tden(x, s, i):
        return torch.tanh(x) * 0.5 + 0.01 * i

    want = jsamplers.sample_ddim(jden, jnp.asarray(x0), sigmas)
    got = tsamplers.sample_loop("ddim", tden, torch.from_numpy(x0), sigmas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_denoise_without_routing_precompute_matches(setup):
    """The non-hoisted denoiser (router inline, every token embedded each
    step) against the JAX one: f32, same weights and noise."""
    jagent, v, d = setup
    lang = jnp.asarray(d["lang"])
    emb, _ = jagent.embed_visual_obs(
        v, jpre(None, jnp.asarray(d["u8s"]), size=IMG),
        jpre(None, jnp.asarray(d["u8g"]), size=IMG), lang)
    den = jagent.make_denoiser(v, emb, lang, None, sigmas=jagent.sigmas)
    want = np.asarray(jsamplers.sample_loop(
        "ddim", den, jnp.asarray(d["noise"]) * 80.0, jagent.sigmas))
    agent = from_jax_params(jax.tree.map(np.asarray, v), TCfg(**DIMS),
                            device="cpu")
    tlang = torch.from_numpy(d["lang"])
    temb = agent.embed_visual_obs(tpre(torch.from_numpy(d["u8s"]), size=IMG),
                                  tpre(torch.from_numpy(d["u8g"]), size=IMG),
                                  tlang)
    got = agent.denoise_actions(temb, tlang,
                                noise=torch.from_numpy(d["noise"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_embeddings_match():
    from mode_diffusion_policy_tpu.models.edm import embeddings as jemb
    from mode_diffusion_policy_tpu_torch.models.edm import embeddings as temb
    t = np.array([0.1, 1.0, 7.5], np.float32)
    np.testing.assert_allclose(
        temb.sinusoidal_pos_emb(torch.from_numpy(t), 16).numpy(),
        np.asarray(jemb.sinusoidal_pos_emb(jnp.asarray(t), 16)),
        atol=1e-6, rtol=1e-6)
    jm = jemb.SinusoidalPosEmbedding(16)
    jv = jm.init(jax.random.PRNGKey(0), jnp.asarray(t))
    tm = temb.SinusoidalPosEmbedding(16, device="cpu")
    tm.load_state_dict({f"{a}.{b}": torch.from_numpy(np.array(leaf))
                        for a, sub in jv["params"].items()
                        for b, leaf in sub.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(jv, jnp.asarray(t))),
                               atol=1e-5, rtol=1e-5)
    jf = jemb.FourierFeatures(8)
    fv = jf.init(jax.random.PRNGKey(1), jnp.asarray(t))
    tf = temb.FourierFeatures(8, device="cpu")
    tf.weight.data = torch.from_numpy(np.array(fv["params"]["weight"]))
    with torch.no_grad():
        np.testing.assert_allclose(
            tf(torch.from_numpy(t)).numpy(),
            np.asarray(jf.apply(fv, jnp.asarray(t))), atol=1e-5, rtol=1e-5)
