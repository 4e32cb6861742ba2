"""The evaluation sweep's samplers on the served presets: a small agent
(2 layers, D=256, f32 on the CPU, 4-step schedules) through the port against
the JAX agent with the same preset (Pallas kernels in interpret mode), on
the same weights, frames, initial noise and sampler noise (the JAX key
splits replayed into the port's noise function).

- ``dpmpp_2s_ancestral`` makes 3 of its 7 evaluations off the schedule
  (step index -1): those route and embed inline, and under the kernel
  presets run the attention sub-block through the attention function with
  one cond row per sample (``fused_attn_block`` under ``parity``,
  ``fused_attn_block_q8`` under ``max-throughput``).
- ``heun`` makes all 7 on the schedule (the second evaluation of each step
  at the next scheduled sigma).

Under both presets each denoiser call is held against JAX's on the JAX
trajectory. The whole chunk is compared under ``parity``. Under
``max-throughput`` it is not: its per-row re-quantizations flip one int8
rounding in a few of the 7 calls, and at 4 steps the sampler carries that
further than the port's valid evaluations of itself move. Measured: 3.3e-3
against a gate of 1e-3 for dpmpp_2s_ancestral, and 5.3e-2 against 1.9e-2
for heun. Also an off-schedule call of the hoisted denoiser under
``max-throughput`` against the JAX one on the same inputs.
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
from mode_diffusion_policy_tpu.serving import apply_serving_mode as japply
from mode_diffusion_policy_tpu_torch.models.agent import \
    MoDEAgentConfig as TCfg
from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera as tpre
from mode_diffusion_policy_tpu_torch.models.edm import samplers as tsamplers
from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
    fused_attn_block_ref)
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
    fused_layer_q8c_ref)
from mode_diffusion_policy_tpu_torch.utils.weights import from_jax_params
from test_torch_samplers import JaxNoise
from test_torch_slice import B, DIMS, IMG, _counting, _random_variables
from torch_threads import two_torch_threads  # noqa: F401

STEPS = 4
KEY = 7


@pytest.fixture(scope="module")
def setup():
    v = _random_variables(JAgent(JCfg(resnet_type="50", **DIMS)))
    r = np.random.default_rng(4)
    data = dict(
        u8s=r.integers(0, 256, (B, 1, IMG, IMG, 3), dtype=np.uint8),
        u8g=r.integers(0, 256, (B, 1, IMG, IMG, 3), dtype=np.uint8),
        lang=r.standard_normal((B, 1, 32)).astype(np.float32),
        noise=r.standard_normal((B, 10, 7)).astype(np.float32))
    return v, data


def _jax_side(v, d, mode, sampler):
    """The JAX preset applied to an agent with this sampler and schedule;
    returns (agent, variables, its embeddings, the language embedding)."""
    agent = JAgent(JCfg(resnet_type="50", sampler_type=sampler,
                        num_sampling_steps=STEPS, **DIMS))
    lang = jnp.asarray(d["lang"])
    rgb_s = jpre(None, jnp.asarray(d["u8s"]), size=IMG)
    rgb_g = jpre(None, jnp.asarray(d["u8g"]), size=IMG)
    calib = (dict(rgb_static=rgb_s, rgb_gripper=rgb_g, lang_emb=lang)
             if mode == "max-throughput" else None)
    agent, v = japply(agent, v, mode, calib_batch=calib)
    v = agent.precast_for_serving(v)
    emb, _ = agent.embed_visual_obs(v, rgb_s, rgb_g, lang)
    return agent, v, emb, lang


def _port_side(v, d, mode, sampler):
    agent = from_jax_params(
        jax.tree.map(np.asarray, v),
        TCfg(sampler_type=sampler, num_sampling_steps=STEPS, **DIMS),
        device="cpu")
    obs = {"rgb_static": tpre(torch.from_numpy(d["u8s"]), size=IMG),
           "rgb_gripper": tpre(torch.from_numpy(d["u8g"]), size=IMG)}
    goal = {"lang_emb": torch.from_numpy(d["lang"])}
    calib = {**obs, **goal} if mode == "max-throughput" else None
    policy = RolloutPolicy.with_serving_mode(agent, mode=mode,
                                             calib_batch=calib)
    emb = policy.agent.embed_visual_obs(obs["rgb_static"],
                                        obs["rgb_gripper"], goal["lang_emb"])
    return policy, emb, goal["lang_emb"]


@pytest.fixture(scope="module")
def presets(setup):
    """Both sides under each preset, built once per mode: (JAX agent,
    variables, embeddings, language embedding, port policy, embeddings,
    language embedding). The sampler is a field of the agents' configs that
    no preset reads, so one pair serves both samplers."""
    v, d = setup
    return {mode: (*_jax_side(v, d, mode, "ddim"),
                   *_port_side(v, d, mode, "ddim"))
            for mode in ("parity", "max-throughput")}


def _jax_chunk(jagent, jv, jemb, jlang, x0, sampler):
    """The JAX agent's chunk with its hoisted denoiser, and every denoiser
    call it made: (x, sigma, step index, output)."""
    calls = []
    den = jagent.make_denoiser(
        jv, jemb, jlang, jagent.precompute_routing(jv, jagent.sigmas[:-1]),
        sigmas=jagent.sigmas)

    def recorded(x, sigma, step_idx):
        out = den(x, sigma, step_idx)
        jax.debug.callback(lambda *a: calls.append(tuple(
            np.array(t) for t in a)), x, sigma, step_idx, out, ordered=True)
        return out

    chunk = np.asarray(jsamplers.sample_loop(
        sampler, recorded, jnp.asarray(x0), jagent.sigmas,
        jax.random.PRNGKey(KEY)))
    jax.effects_barrier()
    return chunk, calls


def _port_chunk(ag, emb, lang, noise, sampler):
    ag.configure_(sampler_type=sampler)
    return ag.denoise_actions(
        emb, lang, noise=torch.from_numpy(noise),
        use_routing_precompute=True,
        noise_fn=JaxNoise(jax.random.PRNGKey(KEY))).numpy()


def _count_kernels(dit, kernels):
    counts = dict.fromkeys(kernels, 0)
    for key in kernels:
        setattr(dit, key, _counting(getattr(dit, key), counts, key))
    return counts


KERNELS = ("layer_impl", "dit_impl", "attn_impl", "attn_impl_bf16",
           "moe_impl")


@pytest.mark.parametrize("sampler", ["dpmpp_2s_ancestral", "heun"])
@pytest.mark.parametrize("mode", ["parity", "max-throughput"])
def test_sweep_sampler_calls_match_jax(setup, presets, mode, sampler):
    """The port's sampler driven through the JAX chunk's own trajectory:
    at every call the port's hoisted denoiser runs on the input the JAX
    denoiser had (and the JAX output is handed back, so the trajectories
    stay equal). The same step indices, call by call; the port's kernel
    functions called as the presets route them (on the schedule the
    whole-layer function, or attention and MoE; off it the attention
    function alone); and each call's output within one int8 rounding flip
    of JAX's: a flip moves a whole row, or every row when it is in the
    sigma token's row that all tokens attend to (up to ~1e-2 here, see
    tests/test_torch_attn_kernel.py::test_int8_flips_explain_the_difference),
    so every call is held to mean 2e-3 and max 2e-2, and the calls without
    a flip to 1e-4: at least half of the on-schedule calls and at least one
    of the off-schedule ones. A wrong routing, cond or kernel on a kind of
    call moves every call of that kind far beyond that."""
    v, d = setup
    jagent, jv, jemb, jlang, policy, _, lang = presets[mode]
    x0 = d["noise"] * jagent.cfg.sigma_max
    want, jcalls = _jax_chunk(jagent, jv, jemb, jlang, x0, sampler)
    ag = policy.agent.configure_(sampler_type=sampler)
    np.testing.assert_array_equal(ag.sigmas, jagent.sigmas)
    emb = {k: torch.from_numpy(np.array(t)) for k, t in jemb.items()}
    counts = _count_kernels(ag.inner_model, KERNELS)
    den = ag.make_denoiser(emb, lang, ag.precompute_routing())
    steps, diffs = [], []

    def forced(x, sigma, step_idx):
        jx, js, jstep, jout = jcalls[len(steps)]
        steps.append(int(step_idx))
        got = den(torch.from_numpy(jx), torch.from_numpy(js), step_idx)
        diffs.append(np.abs(got.numpy() - jout))
        return torch.from_numpy(jout)

    with torch.no_grad():
        chunk = tsamplers.sample_loop(
            sampler, forced, torch.from_numpy(x0), ag.sigmas,
            noise_fn=JaxNoise(jax.random.PRNGKey(KEY))).numpy()
    assert steps == [int(c[2]) for c in jcalls]
    on = sum(i >= 0 for i in steps)
    off = len(steps) - on
    assert (on, off) == ((STEPS, STEPS - 1) if sampler == "dpmpp_2s_ancestral"
                         else (2 * STEPS - 1, 0))
    L = DIMS["n_layers"]
    want_counts = ({"layer_impl": on * L, "attn_impl_bf16": off * L}
                   if mode == "parity" else
                   {"attn_impl": (on + off) * L, "moe_impl": on * L})
    assert counts == dict.fromkeys(KERNELS, 0) | want_counts, counts
    # the sampler's own arithmetic and noise on the JAX outputs (one ulp of
    # FMA contraction in the compiled JAX scan aside)
    np.testing.assert_allclose(chunk, want, rtol=0, atol=1e-3)
    for i, dd in zip(steps, diffs):
        assert dd.mean() <= 2e-3 and dd.max() <= 2e-2, (i, dd.mean(),
                                                        dd.max())
    exact = [i for i, dd in zip(steps, diffs) if dd.max() <= 1e-4]
    assert 2 * sum(i >= 0 for i in exact) >= on, (steps, exact)
    assert off == 0 or any(i < 0 for i in exact), (steps, exact)


@pytest.mark.parametrize("sampler", ["dpmpp_2s_ancestral", "heun"])
def test_parity_sweep_chunk_matches_jax(setup, presets, sampler):
    """The whole parity chunk, each side with its own encoders and its own
    trajectory: within max(1e-3, 2 x the port's distance to its other valid
    evaluations) (tests/test_torch_slice.py's rule): products, norms and
    softmax in f64, and the initial noise moved by one ulp either way.
    heun's last correction divides the difference of two denoiser outputs
    by the last sigma (0.001), so one int8 rounding flip anywhere moves the
    chunk ~20x as far as on the DDIM path, and the port's own valid
    evaluations differ as much (1.4e-2 here)."""
    v, d = setup
    jagent, jv, jemb, jlang, policy, emb, lang = presets["parity"]
    want, _ = _jax_chunk(jagent, jv, jemb, jlang,
                         d["noise"] * jagent.cfg.sigma_max, sampler)
    ag = policy.agent
    got = _port_chunk(ag, emb, lang, d["noise"], sampler)
    assert got.shape == (B, 10, 7) and np.isfinite(got).all()
    dit = ag.inner_model
    kernels = {k: getattr(dit, k) for k in ("layer_impl", "attn_impl_bf16")}
    floors = [np.abs(got - _port_chunk(ag, emb, lang, np.nextafter(
        d["noise"], sgn * np.inf), sampler)).mean() for sgn in (1, -1)]
    for red in (torch.float32, torch.float64):
        dit.layer_impl = functools.partial(
            fused_layer_q8c_ref, acc_dtype=torch.float64, red_dtype=red)
        dit.attn_impl_bf16 = functools.partial(
            fused_attn_block_ref, acc_dtype=torch.float64, red_dtype=red)
        floors.append(np.abs(got - _port_chunk(ag, emb, lang, d["noise"],
                                               sampler)).mean())
    for key, fn in kernels.items():
        setattr(dit, key, fn)
    tol = max(1e-3, 2.0 * max(floors))
    mae = np.abs(got - want).mean()
    assert mae <= tol, (mae, tol, floors)


def test_off_schedule_call_runs_int8_projections(setup, presets):
    """Under max-throughput an off-schedule call of the hoisted denoiser
    routes inline and runs the int8-projection attention function, as the
    JAX denoiser runs fused_attn_block_q8: the same embeddings, inputs and
    sigma on both sides, within the flip-aware gate of
    tests/test_torch_modedit.py (mean 1e-4, max 5e-3). Before, the port ran
    the plain block with bf16 (here f32) projections on this call."""
    v, d = setup
    jagent, jv, jemb, jlang, policy, _, lang = presets["max-throughput"]
    x = d["noise"] * 3.0
    sigma = np.full((B,), 0.37, np.float32)
    jden = jagent.make_denoiser(jv, jemb, jlang, jagent.precompute_routing(
        jv, jagent.sigmas[:-1]), sigmas=jagent.sigmas)
    want = np.asarray(jden(jnp.asarray(x), jnp.asarray(sigma), -1))
    ag = policy.agent
    emb = {k: torch.from_numpy(np.array(t)) for k, t in jemb.items()}
    calls = []
    q8 = ag.inner_model.attn_impl
    ag.inner_model.attn_impl = lambda x, c, *a, **k: calls.append(
        tuple(c.shape)) or q8(x, c, *a, **k)
    with torch.no_grad():
        got = ag.make_denoiser(emb, lang, ag.precompute_routing())(
            torch.from_numpy(x), torch.from_numpy(sigma), -1).numpy()
    d_ = np.abs(got - want)
    assert np.isfinite(got).all()
    assert d_.mean() <= 1e-4, d_.mean()
    assert d_.max() <= 5e-3, d_.max()
    assert calls == [(B, 1, DIMS["latent_dim"])] * DIMS["n_layers"]
