"""Every model variant of the JAX config against the JAX package, f32 on the
CPU, on the same numpy-made weights (``utils/weights.from_jax_params``) and
explicit noise.

The DiT (embed 64, 2 layers, 4 heads, as tests/test_modedit_parity.py) in
four variants, the option sets that chip_smoke.py's ``variants`` phase
serves at full width: the goal embedding in the cond token
(``use_goal_in_routing``), a shared expert (5 experts, top-3: the router
picks 2 of 4), an identity expert with cross-attention (noise in its
queries), and the plain paths (non-causal, a router over the tokens at
temperature 0.7 without renormalization, no goal or noise token, the
proprio embedding, ``init_style="normal"``):

- the eval forward, and the train forward with its router aux outputs
  (dropouts off, JAX's Gumbel draw replaced by given noise on both sides);
- the routed fast path (``forward_precomputed`` on the sigma tables) for
  every variant and for ``cond_router=False`` alone, and the JAX agent's
  two chunks (tables from sigma alone vs inline routing) for
  ``use_goal_in_routing`` and ``cond_router=False``, which differ; the
  port reproduces each;
- the serving flags of every variant under every preset, and the
  ``parity`` preset at head dim 16 (no attention kernel; JAX falls back);
- a ``parity`` chunk of ``use_goal_in_routing`` at the kernels' shape
  (D=256, 2 heads of 128): the whole-layer function with one cond row per
  sample, against JAX's Pallas kernel in interpret mode;
- the megakernel under ``causal=False`` (its attention is causal whatever
  the config says, in JAX as in the port);
- training on the plain path for every variant, the config builder, the
  checkpoint converter on synthetic reference state dicts, and the
  initializer's distributions per ``init_style``.

Gate: 2e-5 in f32. The int8 chunks are held by their action MAE (the
measure of tests/test_torch_slice.py) within the same 2e-5, at head dim 16
(the int8 MoE alone) and at the kernels' shape (no int8 rounding flips
between the two at these inputs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu import serving as jserving
from mode_diffusion_policy_tpu.config import builders as jbuilders
from mode_diffusion_policy_tpu.models import agent as jagent_mod
from mode_diffusion_policy_tpu.models import modedit as jmodedit
from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JACfg
from mode_diffusion_policy_tpu.models.edm import samplers as jsamplers
from mode_diffusion_policy_tpu.models.modedit import MoDeDiT as JDiT
from mode_diffusion_policy_tpu.models.modedit import MoDeDiTConfig as JDCfg
from mode_diffusion_policy_tpu.utils import checkpoint_convert as jconv
from mode_diffusion_policy_tpu_torch.config import builders as tbuilders
from mode_diffusion_policy_tpu_torch.models.agent import MoDEAgent
from mode_diffusion_policy_tpu_torch.models.agent import \
    MoDEAgentConfig as TACfg
from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
from mode_diffusion_policy_tpu_torch.models.modedit import MoDeDiT as TDiT
from mode_diffusion_policy_tpu_torch.models.modedit import \
    MoDeDiTConfig as TDCfg
from mode_diffusion_policy_tpu_torch.models.modedit import (
    kernel_init, load_balancing_loss, router_z_loss)
from mode_diffusion_policy_tpu_torch.serving import preset_flags
from mode_diffusion_policy_tpu_torch.utils import checkpoint_convert as tconv
from mode_diffusion_policy_tpu_torch.utils.weights import (
    dit_state_dict, from_jax_params, load_dit_, port_tree)
from torch_threads import two_torch_threads  # noqa: F401

DIMS = dict(obs_dim=64, goal_dim=32, embed_dim=64, n_layers=2, n_heads=4)
NO_DROP = dict(embed_pdrob=0.0, goal_drop=0.0, attn_pdrop=0.0, mlp_pdrop=0.0)
VARIANTS = {
    "goal_routing": dict(use_goal_in_routing=True),
    "shared": dict(use_shared_expert=True, num_experts=5, top_k=3),
    "identity_cross": dict(identity_expert=True, use_cross_attention=True,
                           noise_in_cross_attention=True),
    "plain_paths": dict(causal=False, cond_router=False,
                        router_normalize=False, router_temperature=0.7,
                        goal_conditioned=False,
                        use_noise_token_as_input=False, use_proprio=True,
                        init_style="normal"),
}
B = 3
TOL = 2e-5


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


def _dit_params(opts, seed=0):
    cfg = JDCfg(**DIMS, **opts)
    shapes = jax.eval_shape(
        lambda k: JDiT(cfg).init(
            k, {"state_images": jnp.zeros((1, 2, 64))}, jnp.zeros((1, 10, 7)),
            jnp.zeros((1, 1, 32)), jnp.ones((1,))), jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s, r),
                                            shapes["params"])


def _inputs(seed=1):
    r = np.random.default_rng(seed)
    return dict(states=r.standard_normal((B, 2, 64)).astype(np.float32),
                goals=r.standard_normal((B, 1, 32)).astype(np.float32),
                actions=r.standard_normal((B, 10, 7)).astype(np.float32),
                sigma=np.array([3.0, 0.5, 40.0], np.float32))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    opts = {**VARIANTS[request.param], **NO_DROP}
    params = _dit_params(opts)
    port = TDiT(TDCfg(**DIMS, **opts), device="cpu")
    load_dit_(port, params)
    return request.param, opts, params, port.eval(), _inputs()


def _jax_apply(opts, params, d, **kw):
    return JDiT(JDCfg(**DIMS, **opts)).apply(
        {"params": params}, {"state_images": jnp.asarray(d["states"])},
        jnp.asarray(d["actions"]), jnp.asarray(d["goals"]),
        jnp.asarray(d["sigma"]), **kw)


def _port_apply(port, d, **kw):
    with torch.no_grad():
        return port({"state_images": torch.from_numpy(d["states"])},
                    torch.from_numpy(d["actions"]),
                    torch.from_numpy(d["goals"]),
                    torch.from_numpy(d["sigma"]), **kw)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_eval_forward_matches_jax(variant):
    name, opts, params, port, d = variant
    _close(_port_apply(port, d).numpy(), _jax_apply(opts, params, d))
    if opts.get("use_proprio"):
        # created as in JAX, where init makes no leaf for it
        assert port.state_embed.kernel.shape == (8, 64)
        assert "state_embed" not in params


def test_train_forward_with_aux_matches_jax(variant, monkeypatch):
    """Train mode with return_aux: Gumbel top-k routing on the given noise
    (JAX's draw replaced by it), the per-layer load-balancing terms over
    the routed experts, logits, masks and both aux losses."""
    name, opts, params, port, d = variant
    cfg = TDCfg(**DIMS, **opts)
    T = cfg.total_tokens
    r = np.random.default_rng(7)
    gum = [r.gumbel(size=(B, T, cfg.num_routed_experts)).astype(np.float32)
           for _ in range(DIMS["n_layers"])]
    calls = []

    def gumbel_topk(key, log_probs, k):
        g = gum[len(calls) % len(gum)]
        calls.append(1)
        return jax.lax.top_k(log_probs + jnp.asarray(g), k)[1]

    monkeypatch.setattr(jmodedit, "gumbel_topk_sample", gumbel_topk)
    key = jax.random.PRNGKey(3)
    want, jaux = _jax_apply(opts, params, d, train=True, return_aux=True,
                            rngs={"dropout": key, "router": key,
                                  "goal_mask": key})
    got, taux = _port_apply(port, d, train=True, return_aux=True,
                            gumbel=[torch.from_numpy(g) for g in gum])
    assert len(calls) == DIMS["n_layers"]
    _close(got.numpy(), want)
    for ja, ta in zip(jaux, taux):
        # the shifted logits reach tens: the gate relative to their size
        jl = np.asarray(ja["logits"])
        _close(ta["logits"].numpy(), jl, TOL * max(1.0, np.abs(jl).max()))
        np.testing.assert_array_equal(ta["router_mask"].numpy(),
                                      np.asarray(ja["router_mask"]))
        np.testing.assert_array_equal(ta["expert_counts"].numpy(),
                                      np.asarray(ja["expert_counts"]))
        _close(ta["load_balancing_term"].numpy(), ja["load_balancing_term"])
    _close(load_balancing_loss(taux).numpy(),
           jmodedit.load_balancing_loss(jaux))
    _close(router_z_loss(taux).numpy(), jmodedit.router_z_loss(jaux))


SCHED = np.array([80.0, 12.0, 1.5, 0.2, 0.01], np.float32)


ROUTED = {"goal_routing": dict(use_goal_in_routing=True),
          "cond_router_off": dict(cond_router=False),
          **{k: VARIANTS[k] for k in ("shared", "identity_cross",
                                      "plain_paths")}}


@pytest.mark.parametrize("opts", list(ROUTED.values()), ids=list(ROUTED))
def test_routed_fast_path_matches_jax(opts):
    """forward_precomputed over the per-sigma tables (which JAX computes
    from the sigma token alone, whatever the router's input) against the
    JAX fast path, at two steps; and the inline forward at the same sigma
    against JAX's inline forward, which routes on its own input. Every
    served variant's routed path: the shared expert after the routed sum,
    the identity expert's rows (it is picked at a tested step) and the
    cross-attention context broadcast over the batch."""
    params = _dit_params(opts, seed=4)
    d = _inputs(5)
    jm, v = JDiT(JDCfg(**DIMS, **opts)), {"params": params}
    port = TDiT(TDCfg(**DIMS, **opts), device="cpu")
    load_dit_(port, params)
    states = {"state_images": jnp.asarray(d["states"])}
    jrout = jm.apply(v, jnp.asarray(SCHED), method=JDiT.precompute_routing)
    jstatic, jgoal = jm.apply(v, states, jnp.asarray(d["goals"]),
                              method=JDiT.embed_static_tokens)
    jemb = jm.apply(v, jnp.asarray(SCHED),
                    method=JDiT.process_sigma_embeddings)
    with torch.no_grad():
        trout = port.precompute_routing(torch.from_numpy(SCHED))
        tstatic, tgoal = port.embed_static_tokens(
            {"state_images": torch.from_numpy(d["states"])},
            torch.from_numpy(d["goals"]))
        temb = port.process_sigma_embeddings(torch.from_numpy(SCHED))
    for (ji, _), (ti, _) in zip(jrout, trout):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    steps = (0, 3)
    if opts.get("identity_expert"):
        identity = port.cfg.num_routed_experts - 1
        assert any((ti[s] == identity).any() for ti, _ in trout
                   for s in steps)
    for step in steps:
        want = jm.apply(v, jstatic, jgoal, jemb[step][None],
                        jnp.asarray(d["actions"]),
                        moe_overrides=[(i, p, jnp.int32(step))
                                       for i, p in jrout],
                        method=JDiT.forward_precomputed)
        with torch.no_grad():
            got = port.forward_precomputed(
                tstatic, tgoal, temb[step][None],
                torch.from_numpy(d["actions"]),
                moe_overrides=[(i, p, step) for i, p in trout])
        _close(got.numpy(), want)
        inline = dict(d, sigma=np.full(B, SCHED[step], np.float32))
        _close(_port_apply(port, inline).numpy(),
               _jax_apply(opts, params, inline))


# ---- the agent -------------------------------------------------------------

AGENT_DIMS = dict(latent_dim=64, n_layers=2, n_heads=4, cond_dim=32,
                  resnet_type="18", num_sampling_steps=5)
IMG = 32


def _agent_variables(jagent, seed=0):
    shapes = jax.eval_shape(
        lambda k: jagent.init_variables(k, image_hw=(IMG, IMG)),
        jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, r),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})


def _agent_data(seed=1, cond=32):
    r = np.random.default_rng(seed)
    return dict(rgb=r.uniform(-1, 1, (2, 1, IMG, IMG, 3)).astype(np.float32),
                lang=r.standard_normal((2, 1, cond)).astype(np.float32),
                noise=r.standard_normal((2, 10, 7)).astype(np.float32))


def _jax_chunk(jagent, v, d, mode, precompute=True):
    agent, v = jserving.apply_serving_mode(jagent, v, mode)
    v = agent.precast_for_serving(v)
    rgb, lang = jnp.asarray(d["rgb"]), jnp.asarray(d["lang"])
    emb, _ = agent.embed_visual_obs(v, rgb, rgb, lang)
    routing = (agent.precompute_routing(v, agent.sigmas[:-1]) if precompute
               else None)
    den = agent.make_denoiser(v, emb, lang, routing, sigmas=agent.sigmas)
    x0 = jnp.asarray(d["noise"]) * agent.cfg.sigma_max
    out = jsamplers.sample_loop("ddim", den, x0, agent.sigmas,
                                jax.random.PRNGKey(0))
    return np.asarray(out), agent.cfg


def _port_chunk(v, cfg, d, mode, precompute=True):
    agent = from_jax_params(jax.tree.map(np.asarray, v), cfg, device="cpu")
    policy = RolloutPolicy.with_serving_mode(
        agent, mode=mode, use_routing_precompute=precompute)
    obs = {k: torch.from_numpy(d["rgb"]) for k in ("rgb_static",
                                                  "rgb_gripper")}
    chunk = policy.predict_chunk(obs, {"lang_emb": torch.from_numpy(
        d["lang"])}, torch.from_numpy(d["noise"]))
    return chunk.numpy(), policy.agent


@pytest.mark.parametrize("opts", [dict(use_goal_in_routing=True),
                                  dict(cond_router=False)],
                         ids=["goal_routing", "cond_router_off"])
def test_routing_tables_and_inline_chunks_differ_like_jax(opts):
    """JAX's fast path routes every step on tables made from the sigma
    token alone; its inline path (no precompute) routes on the cond token
    with the goal embedding, or on the tokens. The two JAX chunks differ
    (an open question of the reference, ROADMAP.md); the port reproduces
    each chunk within the f32 gate."""
    jagent = JAgent(JACfg(**AGENT_DIMS, **opts))
    v = _agent_variables(jagent)
    d = _agent_data()
    cfg = TACfg(**AGENT_DIMS, **opts)
    chunks = {}
    for pre in (True, False):
        want, _ = _jax_chunk(jagent, v, d, "reference", pre)
        got, _ = _port_chunk(v, cfg, d, "reference", pre)
        _close(got, want)
        chunks[pre] = want
    diff = float(np.abs(chunks[True] - chunks[False]).max())
    print(f"JAX tables-vs-inline chunk max abs diff {diff:.4e}")
    assert diff > 1e-3


def _flags(cfg):
    return {k: getattr(cfg, k) for k in (
        "use_int8_moe", "use_pallas_moe", "use_pallas_attn",
        "use_fused_layer", "use_int8_attn", "use_megakernel")}


FLAG_CONFIGS = {
    "flagship": {},
    "head_dim_16": dict(latent_dim=64, n_heads=4),
    "top3": dict(num_experts=5, top_k=3),
    **{k: {kk: vv for kk, vv in o.items() if kk != "router_temperature"}
       for k, o in VARIANTS.items()},
}


@pytest.mark.parametrize("mode", ["parity", "max-throughput", "b1-latency",
                                  "b1-latency-max"])
@pytest.mark.parametrize("config", sorted(FLAG_CONFIGS))
def test_serving_flags_match_jax(config, mode, monkeypatch):
    """preset_flags gives the flags of JAX apply_serving_mode for every
    variant and preset (JAX's derived weights are not built: flags only)."""
    for m in ("fold_encoders_for_inference", "quantize_for_inference",
              "quantize_encoders_for_inference"):
        monkeypatch.setattr(jagent_mod.MoDEAgent, m,
                            lambda self, v, **kw: v)
    opts = FLAG_CONFIGS[config]
    jcfg = jserving.apply_serving_mode(JAgent(JACfg(**opts)), {}, mode)[0].cfg
    want = _flags(jcfg)
    got = preset_flags(TACfg(**opts), mode)
    if mode == "parity" or mode == "max-throughput":
        # JAX leaves use_megakernel as the config had it (off)
        assert want["use_megakernel"] is False
    assert got == want


def test_parity_serves_a_small_head_dim_like_jax():
    """Head dim 16 under ``parity``: the port used to raise; now, as JAX,
    it keeps attention on the plain path and the MoE on the int8 kernel's
    function, with JAX's flags and JAX's chunk within the f32 gate."""
    jagent = JAgent(JACfg(**AGENT_DIMS))
    v = _agent_variables(jagent, seed=2)
    d = _agent_data(3)
    want, jcfg = _jax_chunk(jagent, v, d, "parity")
    got, agent = _port_chunk(v, TACfg(**AGENT_DIMS), d, "parity")
    assert _flags(agent.cfg) == {**_flags(jcfg), "use_megakernel": False}
    assert not agent.inner_model.cfg.fused_attn
    # the int8 MoE: the chunk's action MAE (tests/test_torch_slice.py's
    # measure) within the f32 gate
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.abs(got - want).mean() <= TOL


def test_goal_routing_parity_chunk_matches_jax():
    """``use_goal_in_routing`` under ``parity`` at the kernels' shape (D=256,
    2 heads of 128): each layer runs the whole-layer function with one cond
    row per sample, JAX its Pallas kernel in interpret mode."""
    dims = dict(AGENT_DIMS, latent_dim=256, n_heads=2,
                use_goal_in_routing=True)
    jagent = JAgent(JACfg(**dims))
    v = _agent_variables(jagent, seed=4)
    d = _agent_data(5)
    want, jcfg = _jax_chunk(jagent, v, d, "parity")
    got, agent = _port_chunk(v, TACfg(**dims), d, "parity")
    assert jcfg.use_fused_layer and agent.inner_model.cfg.fused_layer
    # the chunk's action MAE within the f32 gate
    assert np.isfinite(got).all() and got.shape == want.shape
    mae = float(np.abs(got - want).mean())
    print(f"goal-routing parity chunk vs JAX: action MAE {mae:.4e}, max "
          f"abs {float(np.abs(got - want).max()):.4e}")
    assert mae <= TOL


def test_megakernel_ignores_causal_like_jax():
    """JAX's megakernel eligibility does not check ``causal``: under
    ``b1-latency`` a ``causal=False`` model reaches the megakernel's layer
    stack, whose ``return_weights`` asserts ``causal`` (JAX modedit.py:220),
    so JAX cannot serve it there; and the megakernel itself attends
    causally. Shown at one denoise step: JAX's per-layer path (both ways)
    against the JAX megakernel on the same stack built by hand, their
    distance (ROADMAP.md, open questions); the port's per-layer path
    equals JAX's, and its stack refuses the config as JAX's does."""
    dims = dict(obs_dim=64, goal_dim=32, embed_dim=256, n_layers=2,
                n_heads=2)
    flags = dict(use_int8_moe=True, use_pallas_moe=True,
                 use_pallas_attn=True, use_fused_layer=True,
                 use_megakernel=True)
    r = np.random.default_rng(6)
    params = _dit_params_at(dims, flags, r)
    jquant = JAgent(JACfg(latent_dim=256, n_layers=2, n_heads=2, **flags)
                    ).quantize_for_inference(
        {"params": {"inner_model": params}})["quant"]["inner_model"]
    jv = {"params": params, "quant": jquant}
    d = _inputs(9)
    step, acts = 1, jnp.asarray(d["actions"])
    out = {}
    for causal in (True, False):
        jm = JDiT(JDCfg(**dims, **flags, causal=causal))
        rout = jm.apply(jv, jnp.asarray(SCHED),
                        method=JDiT.precompute_routing)
        sx, ge = jm.apply(jv, {"state_images": jnp.asarray(d["states"])},
                          jnp.asarray(d["goals"]),
                          method=JDiT.embed_static_tokens)
        emb = jm.apply(jv, jnp.asarray(SCHED),
                       method=JDiT.process_sigma_embeddings)
        args = (sx, ge, emb[step][None], acts)
        if causal:
            # the causal model's stack is the same weights
            stacked = jm.apply(jv, method=JDiT.stack_layers)
            out["mega"] = jm.apply(
                jv, *args, stacked, jnp.stack([i for i, _ in rout]),
                jnp.stack([p for _, p in rout]), jnp.int32(step),
                method=JDiT.forward_precomputed_mega)
        else:
            with pytest.raises(AssertionError):
                jm.apply(jv, method=JDiT.stack_layers)
            out["layer"] = jm.apply(
                jv, *args, moe_overrides=[(i, p, jnp.int32(step))
                                          for i, p in rout],
                method=JDiT.forward_precomputed)
    gap = float(np.abs(np.asarray(out["mega"])
                       - np.asarray(out["layer"])).max())
    print(f"JAX megakernel vs per-layer path, causal=False: max abs diff "
          f"{gap:.4e}")
    assert gap > 1e-2
    cfg = TDCfg(**dims, **flags, causal=False)
    assert cfg.megakernel and not cfg.fused_layer and not cfg.fused_attn
    port = TDiT(cfg, device="cpu")
    load_dit_(port, params)
    port.quantize_experts_()
    with pytest.raises(ValueError, match="causal"):
        port.stack_layers_()
    with torch.no_grad():
        trout = port.precompute_routing(torch.from_numpy(SCHED))
        tsx, tge = port.embed_static_tokens(
            {"state_images": torch.from_numpy(d["states"])},
            torch.from_numpy(d["goals"]))
        temb = port.process_sigma_embeddings(torch.from_numpy(SCHED))
        got = port.forward_precomputed(
            tsx, tge, temb[step][None], torch.from_numpy(d["actions"]),
            moe_overrides=[(i, p, step) for i, p in trout])
    dd = np.abs(got.numpy() - np.asarray(out["layer"]))
    # int8 rounding flips aside (tests/test_torch_dit_kernel.py's gate)
    assert dd.mean() <= 1e-4 and dd.max() <= 5e-3, (dd.mean(), dd.max())


def _dit_params_at(dims, flags, r):
    cfg = JDCfg(**dims, **flags)
    shapes = jax.eval_shape(
        lambda k: JDiT(cfg).init(
            k, {"state_images": jnp.zeros((1, 2, 64))}, jnp.zeros((1, 10, 7)),
            jnp.zeros((1, 1, 32)), jnp.ones((1,))), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s, r),
                                            shapes["params"])


# ---- training, config, converter, init ------------------------------------

TRAIN_VARIANTS = {
    "goal_routing_r34": dict(use_goal_in_routing=True, resnet_type="34"),
    "shared_r18": dict(use_shared_expert=True, num_experts=5, top_k=3,
                       resnet_type="18"),
    "identity_cross": dict(identity_expert=True, use_cross_attention=True,
                           noise_in_cross_attention=True, resnet_type="18",
                           use_grouped_moe=True),
    "plain_paths": dict(causal=False, cond_router=False,
                        router_normalize=False, goal_conditioned=False,
                        use_noise_token_as_input=False, use_proprio=True,
                        init_style="normal", resnet_type="18"),
}


@pytest.mark.parametrize("name", sorted(TRAIN_VARIANTS))
def test_train_step_runs_for_every_variant(name):
    """Two steps of the plain-path train step (``make_train_step``,
    ``FusedAdamWEma``) for every variant: finite losses with both aux
    terms, and the variant's own weights move."""
    from mode_diffusion_policy_tpu_torch.training.loop import make_train_step
    from mode_diffusion_policy_tpu_torch.training.optim import make_optimizer
    from mode_diffusion_policy_tpu_torch.training.state import TrainState
    cfg = TACfg(latent_dim=64, n_layers=1, n_heads=4, cond_dim=16,
                entropy_gamma=0.01, encoder_remat=False,
                **TRAIN_VARIANTS[name])
    agent = MoDEAgent(cfg, device="cpu")
    opt, _ = make_optimizer(dict(agent.named_parameters()))
    gen = torch.Generator().manual_seed(0)
    state = TrainState.create(agent, opt, gen)
    step = make_train_step(agent, opt, device="cpu")
    before = {n: p.detach().clone() for n, p in agent.named_parameters()}
    r = torch.Generator().manual_seed(1)
    batch = {"rgb_static": torch.rand(2, 1, 16, 16, 3, generator=r),
             "rgb_gripper": torch.rand(2, 1, 16, 16, 3, generator=r),
             "actions": torch.randn(2, 10, 7, generator=r),
             "lang_emb": torch.randn(2, 1, 16, generator=r)}
    for _ in range(2):
        state, metrics = step(state, batch)
        for k in ("train/total_loss", "train/load_balancing_loss",
                  "train/router_z_delta"):
            assert np.isfinite(float(metrics[k])), k
    moved = {n for n, p in agent.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    own = {"shared_r18": "blocks.0.shared_w1",
           "identity_cross": "blocks.0.cross_att.wkv.kernel",
           "goal_routing_r34": "blocks.0.router.mlp.fc1.kernel",
           "plain_paths": "blocks.0.attn.wqkv.kernel"}[name]
    assert f"inner_model.{own}" in moved


def test_build_agent_config_passes_every_option_like_jax():
    """Every inner_model option at a non-default value, and each
    resnet_type, gives the JAX builder's config field by field."""
    inner = {"n_layers": 1, "n_heads": 2, "num_experts": 5, "top_k": 3,
             "use_shared_expert": "true", "identity_expert": True,
             "goal_conditioned": False, "causal": "False",
             "cond_router": False, "router_normalize": False,
             "use_goal_in_routing": True, "use_noise_token_as_input": False,
             "init_style": "'switch_t'", "use_cross_attention": True,
             "noise_in_cross_attention": "true"}
    for resnet in ("18", "34", "50"):
        cfg = {"latent_dim": 32, "resnet_type": resnet, "use_proprio": True,
               "model": {"inner_model": inner}}
        got = tbuilders.build_agent_config(cfg)
        want = jbuilders.build_agent(cfg)[0].cfg
        for f in dataclasses.fields(got):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.dit_config().num_mlp_experts == 3
        assert got.obs_dim == want.obs_dim


def _ref_block(r, b, D=16, H=64, E=3, shared=True, cross=True):
    sd = {}

    def t(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32))

    sd[b + "ln_1.g"], sd[b + "ln_2.g"] = t(D), t(D)
    for n in ("query", "key", "value"):
        sd[b + f"attn.{n}.weight"], sd[b + f"attn.{n}.bias"] = t(D, D), t(D)
        if cross:
            sd[b + f"cross_att.{n}.weight"] = t(D, D)
            sd[b + f"cross_att.{n}.bias"] = t(D)
    sd[b + "attn.c_proj.weight"] = t(D, D)
    for k in ("q_norm.g", "k_norm.g"):
        sd[b + f"attn.{k}"] = t(D // 2)
        if cross:
            sd[b + f"cross_att.{k}"] = t(D // 2)
    if cross:
        sd[b + "cross_att.c_proj.weight"] = t(D, D)
        sd[b + "ln_3.g"] = t(D)
    sd[b + "router.router.mlp.0.weight"] = t(2 * D, D)
    sd[b + "router.router.mlp.0.bias"] = t(2 * D)
    sd[b + "router.router.mlp.3.weight"] = t(E, 2 * D)
    sd[b + "router.router.mlp.3.bias"] = t(E)
    mlps = [f"experts.expert_{e}" for e in range(E)]
    if shared:
        mlps.append("shared_mlp")
    for m in mlps:
        sd[b + f"{m}.mlp.0.project.weight"] = t(2 * H, D)
        sd[b + f"{m}.mlp.0.project.bias"] = t(2 * H)
        sd[b + f"{m}.mlp.2.weight"] = t(D, H)
    return sd


def test_checkpoint_converter_variants_match_jax():
    """Synthetic reference state dicts with a shared expert, cross-attention
    and ln_3, the proprio embedding, and a scratch ResNet-18: the port's
    conversion equals the JAX package's, leaf by leaf."""
    r = np.random.default_rng(11)
    p = "model.inner_model."
    sd = {}
    for i in range(2):
        sd.update(_ref_block(r, f"{p}blocks.{i}."))
    for k, shape in (("sigma_emb.weight", (16, 1)), ("sigma_emb.bias", (16,)),
                     ("sigma_linear.weight", (16, 16)),
                     ("tok_emb.weight", (16, 8)), ("goal_emb.weight", (16, 4)),
                     ("action_emb.weight", (16, 7)),
                     ("state_embed.weight", (16, 5)),
                     ("pos_emb", (1, 11, 16)), ("ln.g", (16,)),
                     ("out.weight", (7, 16)), ("out.bias", (7,))):
        sd[p + k] = torch.from_numpy(
            r.standard_normal(shape).astype(np.float32))
    assert tconv.detect_layout(sd) == (2, 3, p)
    want = dit_state_dict(jconv.convert_modedit(
        {k: v.numpy() for k, v in sd.items()}, 2, 3, p))
    got = tconv.convert_modedit(sd, 2, 3, p)
    assert set(got) == set(want)
    assert {"state_embed.kernel", "blocks.1.shared_w2",
            "blocks.0.cross_att.wkv.kernel", "blocks.0.ln_3.g"} <= set(got)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # the scratch ResNet-18: a random reference state dict in its layout
    enc = MoDEAgent(TACfg(latent_dim=32, n_layers=1, n_heads=1, cond_dim=8,
                          resnet_type="18"), device="cpu").static_resnet
    ref = {}
    for name, t in enc.state_dict().items():
        a = torch.from_numpy(r.standard_normal(t.shape).astype(np.float32))
        name = name.replace("resnet.", "").replace("_", ".", 1) \
            if name.startswith("resnet.layer") else name.replace("resnet.",
                                                                 "")
        ref[name] = a
    ref = {_ref_encoder_key(k): (v.T if v.ndim == 2 else v)
           for k, v in ref.items()}
    jout = jconv.convert_film_resnet({k: v.numpy() for k, v in ref.items()},
                                     18, style="scratch")
    want = port_tree({"params": jout["params"],
                      "stats": jout["batch_stats"]})
    want = {k.split(".", 1)[1]: v for k, v in want.items()}
    got = tconv.convert_film_resnet(ref, **tconv.encoder_kwargs("18"))
    assert set(got) == set(want) == set(enc.state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    enc.load_state_dict(got)


def _ref_encoder_key(k):
    """A port scratch-encoder key as the reference's ResNetEncoderWithFiLM
    names it (torchvision BatchNorm and downsample names, FiLM Linears)."""
    for a, b in (("downsample_conv", "downsample.0"),
                 ("downsample_bn", "downsample.1"), (".scale", ".weight"),
                 (".mean", ".running_mean"), (".var", ".running_var"),
                 (".kernel", ".weight")):
        k = k.replace(a, b)
    return k.replace(".fc.", ".modulation.1.") if k.startswith(
        "film_module") else k


@pytest.mark.parametrize("style", ["olmoe", "switch_t", "normal"])
def test_init_style_distributions_match_jax(style):
    """The seeded initializer draws each kernel from the distribution of
    JAX ``kernel_init_for`` (its draws are not JAX's): the std of the
    expert kernels within 3% of a JAX draw's, and within the clip."""
    dit = TDiT(TDCfg(**DIMS, init_style=style, num_experts=8), device="cpu")
    dit.init_weights_(torch.Generator().manual_seed(0))
    for name, fan in (("experts_w1", 64), ("experts_w2", 256)):
        got = getattr(dit.blocks[0], name).detach().numpy()
        want = np.asarray(jmodedit.kernel_init_for(style, fan)(
            jax.random.PRNGKey(1), got.shape))
        std, clip = kernel_init(style, fan)
        assert abs(got.std() / want.std() - 1) < 0.03, (name, got.std(),
                                                         want.std())
        if clip is not None:
            assert np.abs(got).max() <= clip + 1e-7
            assert np.abs(want).max() <= clip + 1e-7
    if style == "olmoe":
        # the positional embedding: truncated within +-0.04 under olmoe
        assert np.abs(dit.pos_emb.detach().numpy()).max() <= 0.04 + 1e-7
