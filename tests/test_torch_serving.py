"""Serving presets on the port's agent, in bf16 on the CPU (2 layers, D=256,
2 heads of 128).

The serving precast (``RolloutPolicy``) casts the DiT weights to bf16 in
the policy's own copy of the agent, as the JAX package's ``RolloutPolicy``
precasts a copy it owns: the caller's parameters stay f32 and untouched.
The copy keeps the f32 values as masters, so that quantizing it again
(``quantize_for_inference``) starts from the f32 weights and gives exactly
the int8 tensors and scales of the JAX package's quantizers on those
weights; so does quantizing the caller's agent (another preset applied to
it), whose parameters the policy never cast.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.ops.quant import quantize_attn as jax_qattn
from mode_diffusion_policy_tpu.ops.quant import (
    quantize_experts as jax_qexp)
from mode_diffusion_policy_tpu_torch.models.agent import (MoDEAgent,
                                                          MoDEAgentConfig,
                                                          RolloutPolicy)
from mode_diffusion_policy_tpu_torch.models.modedit import (MoDeDiT,
                                                            MoDeDiTConfig)
from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
    fused_attn_block)
from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
    fused_top2_mlp)
from mode_diffusion_policy_tpu_torch.serving import (PRESET_FLAGS,
                                                     apply_serving_mode)
from torch_threads import two_torch_threads  # noqa: F401

DIMS = dict(latent_dim=256, n_layers=2, n_heads=2, cond_dim=32,
            num_experts=4, top_k=2, dtype=torch.bfloat16)
EXPERTS = ("experts_w1", "experts_b1", "experts_w2")
ATTN = ("attn.wqkv.kernel", "attn.wqkv.bias", "attn.c_proj.kernel")


@pytest.fixture(scope="module")
def agent_and_weights():
    agent = MoDEAgent(MoDEAgentConfig(**DIMS), device="cpu")
    f32 = {n: p.detach().numpy().copy()
           for n, p in agent.inner_model.named_parameters()}
    assert all(v.dtype == np.float32 for v in f32.values())
    return agent, f32


def _assert_int8_like_jax(agent, f32, attn):
    for i, blk in enumerate(agent.inner_model.blocks):
        want = jax_qexp(*(jnp.asarray(f32[f"blocks.{i}.{k}"])
                          for k in EXPERTS))
        for name, g, w in zip(blk.experts_q._fields, blk.experts_q, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"block {i} {name}")
        if attn:
            want = jax_qattn(*(jnp.asarray(f32[f"blocks.{i}.{k}"])
                               for k in ATTN))
            for name, g, w in zip(blk.attn.attn_q._fields, blk.attn.attn_q,
                                  want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"block {i} {name}")
        else:
            assert blk.attn.attn_q is None


@pytest.mark.parametrize("mode", ["parity", "b1-latency-max",
                                  "max-throughput"])
def test_requantize_after_policy_matches_jax_f32_quantization(
        agent_and_weights, mode):
    """Build a policy (which precasts its copy of the agent to bf16),
    quantize the policy's agent and the caller's again, and get the JAX
    package's int8 weights of the original f32 weights on both."""
    agent, f32 = agent_and_weights
    policy = RolloutPolicy.with_serving_mode(agent, mode=mode)
    blk = policy.agent.inner_model.blocks[0]
    assert blk.experts_w1.dtype == torch.bfloat16      # precast happened
    assert blk.attn.wqkv.kernel.dtype == torch.bfloat16
    assert agent.inner_model.blocks[0].experts_w1.dtype == torch.float32
    for a in (policy.agent, agent):
        a.quantize_for_inference()
        _assert_int8_like_jax(a, f32, attn=PRESET_FLAGS[mode]["use_int8_attn"])


def test_presets_applied_in_turn_to_one_agent(agent_and_weights):
    """parity -> b1-latency-max -> max-throughput -> b1-latency -> parity ->
    reference on the same agent: each sets its flags, quantizes from the f32
    weights and (re)builds or drops the megakernel's layer stack and the
    int8 encoders; reference goes back to the plain graph (no int8
    weights, no folded encoders). Each policy serves its own copy."""
    agent, f32 = agent_and_weights
    dit = agent.inner_model
    for mode in ("parity", "b1-latency-max", "max-throughput", "b1-latency",
                 "parity", "reference"):
        policy = RolloutPolicy.with_serving_mode(agent, mode=mode)
        assert policy.agent is not agent
        for flag, value in PRESET_FLAGS[mode].items():
            assert getattr(agent.cfg, flag) == value, (mode, flag)
            assert getattr(dit.cfg, flag) == value, (mode, flag)
            assert getattr(policy.agent.inner_model.cfg, flag) == value
        int8_attn = PRESET_FLAGS[mode]["use_int8_attn"]
        assert (agent.q8 is not None) == (mode == "max-throughput")
        assert (policy.agent.q8 is not None) == (mode == "max-throughput")
        if mode == "reference":
            assert agent.folded is None and dit.stacked is None
            assert all(b.experts_q is None and b.attn.attn_q is None
                       for b in dit.blocks)
            continue
        assert agent.folded is not None
        _assert_int8_like_jax(agent, f32, attn=int8_attn)
        if PRESET_FLAGS[mode]["use_megakernel"]:
            assert dit.stacked["wqkv"].dtype == (
                torch.int8 if int8_attn else torch.bfloat16)
            assert ("sqkv" in dit.stacked) == int8_attn
            assert dit.blocks[1].experts_q.w1_q.data_ptr() == \
                dit.stacked["w1_q"][1].data_ptr()
        else:
            assert dit.stacked is None


def test_megakernel_preset_needs_its_stack(agent_and_weights):
    agent, _ = agent_and_weights
    apply_serving_mode(agent, "b1-latency")
    agent.inner_model.stacked = None
    emb = {"state_images": torch.zeros(1, 2, 2048)}
    lang = torch.zeros(1, 1, DIMS["cond_dim"])
    with pytest.raises(RuntimeError, match="quantize_for_inference"):
        agent.make_denoiser(emb, lang, agent.precompute_routing())
    agent.quantize_for_inference()
    assert agent.inner_model.stacked is not None


def test_int8_moe_with_bf16_attention_names_its_kernel():
    """int8 experts outside the whole-layer kernel with bf16 attention
    projections run the bf16 attention kernel, fused_attn_block, under
    use_pallas_attn (the JAX flag); int8 projections need that flag, as in
    the JAX config. int8 projections without int8 experts, and the
    megakernel without use_fused_layer, build and run as in the JAX
    package (the megakernel wherever the JAX agent runs it)."""
    cfg = MoDeDiTConfig(use_int8_moe=True, use_pallas_attn=True)
    assert cfg.fused_attn and not cfg.use_fused_layer
    dit = MoDeDiT(MoDeDiTConfig(embed_dim=256, n_layers=1, n_heads=2), "meta")
    assert dit.attn_impl_bf16 is fused_attn_block
    assert dit.moe_impl_bf16 is fused_top2_mlp
    MoDeDiTConfig(use_int8_moe=True, use_pallas_attn=True,
                  use_int8_attn=True)                      # max-throughput
    with pytest.raises(ValueError, match="use_pallas_attn"):
        MoDeDiTConfig(use_int8_moe=True, use_int8_attn=True)
    cfg = MoDeDiTConfig(use_int8_attn=True, use_pallas_attn=True)
    assert cfg.fused_attn and not cfg.fused_layer and not cfg.megakernel
    cfg = MoDeDiTConfig(use_int8_moe=True, use_pallas_attn=True,
                        use_int8_attn=True, use_megakernel=True)
    assert cfg.megakernel and not cfg.fused_layer


@pytest.mark.parametrize("mode", ["parity", "b1-latency", "max-throughput"])
def test_policy_leaves_the_callers_agent_untouched(mode):
    """Building a policy, plainly or with a preset, leaves every parameter
    of the caller's agent f32 and bit-identical (the JAX policy: "training
    state is untouched"), and the policy serves the chunk of an agent that
    was precast in place."""
    agent = MoDEAgent(MoDEAgentConfig(**DIMS), device="cpu")
    before = {n: p.detach().clone() for n, p in agent.named_parameters()}

    def untouched():
        for n, p in before.items():
            q = agent.get_parameter(n)
            assert q.dtype == torch.float32, n
            torch.testing.assert_close(q.detach(), p, rtol=0, atol=0)

    RolloutPolicy(agent)
    untouched()
    policy = RolloutPolicy.with_serving_mode(agent, mode=mode)
    untouched()
    obs = {k: torch.rand(1, 1, 32, 32, 3, generator=torch.Generator()
                         .manual_seed(i))
           for i, k in enumerate(("rgb_static", "rgb_gripper"))}
    goal = {"lang_emb": torch.ones(1, 1, DIMS["cond_dim"])}
    noise = torch.randn(1, 10, 7, generator=torch.Generator().manual_seed(2))
    got = policy.predict_chunk(obs, goal, noise)
    untouched()
    inplace = copy.deepcopy(agent).precast_for_serving()
    want = RolloutPolicy(inplace).predict_chunk(obs, goal, noise)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["parity", "b1-latency-max"])
def test_int8_biases_stay_f32_through_the_precast(mode):
    """The quantizers copy the biases they pass through: the precast that
    follows (RolloutPolicy) recasts the parameters in place and must not
    reach the int8 experts' b1 or the projections' bqkv."""
    agent = MoDEAgent(MoDEAgentConfig(**DIMS), device="cpu")
    dit = agent.inner_model
    with torch.no_grad():      # biases that bf16 cannot hold exactly
        for blk in dit.blocks:
            blk.experts_b1.add_(0.01)
            blk.attn.wqkv.bias.add_(0.01)
    b1 = dit.blocks[0].experts_b1.detach().clone()
    bqkv = dit.blocks[0].attn.wqkv.bias.detach().clone()
    dit = RolloutPolicy.with_serving_mode(agent, mode=mode).agent.inner_model
    assert dit.blocks[0].experts_b1.dtype == torch.bfloat16   # precast
    q = dit.blocks[0].experts_q
    assert q.b1.dtype == torch.float32 and not q.b1.requires_grad
    torch.testing.assert_close(q.b1, b1, rtol=0, atol=0)
    if mode == "b1-latency-max":
        qa = dit.blocks[0].attn.attn_q
        assert qa.bqkv.dtype == torch.float32
        torch.testing.assert_close(qa.bqkv, bqkv, rtol=0, atol=0)
