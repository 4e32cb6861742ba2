"""The whole served slice against the JAX package on the same weights and
the same initial noise: uint8 frames -> eval preprocessing -> 2x FiLM-ResNet-50
-> per-sigma routing -> hoisted 10-step DDIM of the 2-layer DiT -> action
chunk, f32 on the CPU, under the ``parity`` preset (int8 experts,
whole-layer function), the ``b1-latency`` and ``b1-latency-max`` presets
(the whole block stack as one function per step, bf16 or int8 attention
projections; the JAX side runs its Pallas kernels in interpret mode), the
``max-throughput`` preset (int8 encoders calibrated on the chunk's frames,
the int8-projection attention function and the MoE function per layer) and
the ``reference`` preset. Also the EDM pieces on their own, and an
off-schedule call of the hoisted denoiser.

Gate: action MAE <= 1e-3 (the parity preset's budget); in f32 the two
agree far closer (rare int8 rounding flips aside). ``b1-latency-max`` and
``max-throughput``, which the JAX package documents as over that budget,
re-quantize every token row twice more per layer (before QKV and before
c_proj), and one int8 flip there moves a whole sample's chunk
(tests/test_torch_attn_kernel.py shows such flips are the whole difference
at one layer); there the gate is max(1e-3, 2 x the larger distance between
the port's plain evaluation and two near-exact ones: the products
accumulated in f64, and the products, norms and softmax too), the rule
chip_smoke.py holds the megakernel and two-kernel paths to.

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
from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
    fused_attn_block_q8, fused_attn_block_q8_ref)
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
    fused_dit_q8c, fused_dit_q8c_ref)
from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
    fused_top2_mlp_q8c, fused_top2_mlp_q8c_ref)
from mode_diffusion_policy_tpu_torch.utils.weights import from_jax_params
from torch_threads import two_torch_threads  # noqa: F401

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
    the chunk and the preset's JAX config. ``max-throughput`` calibrates its
    int8 encoders on the chunk's own frames."""
    lang = jnp.asarray(d["lang"])
    rgb_s = jpre(None, jnp.asarray(d["u8s"]), size=IMG)
    rgb_g = jpre(None, jnp.asarray(d["u8g"]), size=IMG)
    calib = (dict(rgb_static=rgb_s, rgb_gripper=rgb_g, lang_emb=lang)
             if mode == "max-throughput" else None)
    agent, v = japply(agent, v, mode, calib_batch=calib)
    v = agent.precast_for_serving(v)
    emb, _ = agent.embed_visual_obs(v, rgb_s, rgb_g, lang)
    routing = agent.precompute_routing(v, agent.sigmas[:-1])
    den = agent.make_denoiser(v, emb, lang, routing, sigmas=agent.sigmas)
    x0 = jnp.asarray(d["noise"]) * agent.cfg.sigma_max
    return np.asarray(jsamplers.sample_loop("ddim", den, x0, agent.sigmas,
                                            jax.random.PRNGKey(0))), \
        agent.cfg


def _port_chunk(v, d, mode):
    agent = from_jax_params(jax.tree.map(np.asarray, v), TCfg(**DIMS),
                            device="cpu")
    obs = {"rgb_static": tpre(torch.from_numpy(d["u8s"]), size=IMG),
           "rgb_gripper": tpre(torch.from_numpy(d["u8g"]), size=IMG)}
    goal = {"lang_emb": torch.from_numpy(d["lang"])}
    calib = ({**obs, **goal} if mode == "max-throughput" else None)
    policy = RolloutPolicy.with_serving_mode(agent, mode=mode,
                                             calib_batch=calib)
    chunk = policy.predict_chunk(obs, goal, torch.from_numpy(d["noise"]))
    return policy, obs, goal, chunk.numpy()


FLAGS = ("use_int8_moe", "use_pallas_attn", "use_fused_layer",
         "use_int8_attn", "use_megakernel")


def _counting(fn, counts, key):
    def wrapped(*a, **k):
        counts[key] += 1
        return fn(*a, **k)
    return wrapped


@pytest.mark.parametrize("mode", ["parity", "reference", "b1-latency",
                                  "b1-latency-max", "max-throughput"])
def test_slice_matches_jax(setup, mode):
    jagent, v, d = setup
    want, jcfg = _jax_chunk(jagent, v, d, mode)
    policy, obs, goal, got = _port_chunk(v, d, mode)
    assert got.shape == (B, 10, 7) and np.isfinite(got).all()
    dit = policy.agent.inner_model
    tol = 1e-3
    if mode in ("b1-latency-max", "max-throughput"):
        for red in (torch.float32, torch.float64):
            dit.dit_impl = functools.partial(
                fused_dit_q8c_ref, acc_dtype=torch.float64, red_dtype=red)
            dit.attn_impl = functools.partial(
                fused_attn_block_q8_ref, acc_dtype=torch.float64,
                red_dtype=red)
            dit.moe_impl = functools.partial(fused_top2_mlp_q8c_ref,
                                             red_dtype=red)
            exact = policy.predict_chunk(obs, goal,
                                         torch.from_numpy(d["noise"]))
            tol = max(tol, 2.0 * np.abs(got - exact.numpy()).mean())
        dit.dit_impl = fused_dit_q8c
        dit.attn_impl, dit.moe_impl = fused_attn_block_q8, fused_top2_mlp_q8c
    mae = np.abs(got - want).mean()
    assert mae <= tol, (mae, tol)
    kernels = mode != "reference"
    b1 = mode.startswith("b1-latency")
    two_kernel = mode == "max-throughput"
    assert policy.agent.cfg.use_fused_layer == (kernels and not two_kernel)
    assert (policy.agent.folded is not None) == kernels
    assert (policy.agent.q8 is not None) == two_kernel
    if kernels:
        # the JAX flag map (as tests/test_serving_modes.py pins it) and the
        # port's flags for the same preset
        assert jcfg.use_int8_moe and jcfg.use_pallas_moe
        assert jcfg.use_pallas_attn
        assert jcfg.use_fused_layer == (not two_kernel)
        assert jcfg.use_megakernel == b1
        assert jcfg.use_int8_attn == (mode in ("b1-latency-max",
                                               "max-throughput"))
        for flag in FLAGS:
            assert getattr(policy.agent.cfg, flag) == getattr(jcfg, flag), \
                flag
    assert (dit.stacked is not None) == b1
    if kernels:
        # per denoise step: one whole-stack call (b1), or one whole-layer
        # call per layer (parity), or one attention and one MoE call per
        # layer (max-throughput)
        counts = dict.fromkeys(("dit", "layer", "attn", "moe"), 0)
        for key in counts:
            impl = f"{key}_impl"
            setattr(dit, impl, _counting(getattr(dit, impl), counts, key))
        again = policy.predict_chunk(obs, goal, torch.from_numpy(d["noise"]))
        L = DIMS["n_layers"]
        assert counts == {"dit": 10 if b1 else 0,
                          "layer": 10 * L if mode == "parity" else 0,
                          "attn": 10 * L if two_kernel else 0,
                          "moe": 10 * L if two_kernel else 0}, counts
        np.testing.assert_array_equal(again.numpy(), got)
    if mode == "parity":
        # the chunked stepper hands out the chunk one action at a time
        policy.reset()
        noise = torch.from_numpy(d["noise"])
        policy.lang = lambda texts: torch.from_numpy(d["lang"][:len(texts)])
        goal_text = {"lang_text": ["open the drawer", "push the block"]}
        acts = [policy.step(obs, goal_text, noise) for _ in range(10)]
        assert all(isinstance(a, np.ndarray) for a in acts)
        np.testing.assert_allclose(np.stack(acts, 1), got, atol=1e-6)


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


def test_off_schedule_step_routes_inline(setup):
    """A negative step index is off the schedule: the hoisted denoiser
    routes and embeds that call inline at its own sigma, as the JAX
    denoiser does, instead of reading a row of its per-step tables."""
    jagent, v, d = setup
    lang = jnp.asarray(d["lang"])
    emb, _ = jagent.embed_visual_obs(
        v, jpre(None, jnp.asarray(d["u8s"]), size=IMG),
        jpre(None, jnp.asarray(d["u8g"]), size=IMG), lang)
    x = d["noise"] * 3.0
    sigma = np.full((B,), 0.37, np.float32)
    jden = jagent.make_denoiser(v, emb, lang, jagent.precompute_routing(
        v, jagent.sigmas[:-1]), sigmas=jagent.sigmas)
    want = np.asarray(jden(jnp.asarray(x), jnp.asarray(sigma), -1))
    agent = from_jax_params(jax.tree.map(np.asarray, v), TCfg(**DIMS),
                            device="cpu")
    tlang = torch.from_numpy(d["lang"])
    temb = agent.embed_visual_obs(tpre(torch.from_numpy(d["u8s"]), size=IMG),
                                  tpre(torch.from_numpy(d["u8g"]), size=IMG),
                                  tlang)
    args = (torch.from_numpy(x), torch.from_numpy(sigma), -1)
    with torch.no_grad():
        got = agent.make_denoiser(temb, tlang, agent.precompute_routing())(
            *args).numpy()
        inline = agent.make_denoiser(temb, tlang)(*args).numpy()
    np.testing.assert_allclose(got, inline, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
