"""Serving presets on the port's agent, in bf16 on the CPU (2 layers, D=256,
2 heads of 128).

The serving precast (``RolloutPolicy``) casts the DiT weights to bf16 in
place; it keeps their f32 values, so that quantizing again afterwards
(``quantize_for_inference``, or another preset applied to the same agent)
starts from the f32 weights and gives exactly the int8 tensors and scales
of the JAX package's quantizers on those weights. The JAX package's
``RolloutPolicy`` precasts a copy it owns, and its
``quantize_for_inference`` always reads the f32 parameters.
"""
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
from mode_diffusion_policy_tpu_torch.serving import (PRESET_FLAGS,
                                                     apply_serving_mode)

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


@pytest.mark.parametrize("mode", ["parity", "b1-latency-max"])
def test_requantize_after_policy_matches_jax_f32_quantization(
        agent_and_weights, mode):
    """Build a policy (which precasts the agent to bf16), quantize again,
    and get the JAX package's int8 weights of the original f32 weights."""
    agent, f32 = agent_and_weights
    RolloutPolicy.with_serving_mode(agent, mode=mode)
    blk = agent.inner_model.blocks[0]
    assert blk.experts_w1.dtype == torch.bfloat16      # precast happened
    assert blk.attn.wqkv.kernel.dtype == torch.bfloat16
    agent.quantize_for_inference()
    _assert_int8_like_jax(agent, f32, attn=(mode == "b1-latency-max"))


def test_presets_applied_in_turn_to_one_agent(agent_and_weights):
    """parity -> b1-latency-max -> b1-latency -> parity -> reference on the
    same agent: each sets its flags, quantizes from the f32 weights and
    (re)builds or drops the megakernel's layer stack; reference goes back
    to the plain graph (no int8 weights, no folded encoders)."""
    agent, f32 = agent_and_weights
    dit = agent.inner_model
    for mode in ("parity", "b1-latency-max", "b1-latency", "parity",
                 "reference"):
        policy = RolloutPolicy.with_serving_mode(agent, mode=mode)
        assert policy.agent is agent
        for flag, value in PRESET_FLAGS[mode].items():
            assert getattr(agent.cfg, flag) == value, (mode, flag)
            assert getattr(dit.cfg, flag) == value, (mode, flag)
        int8_attn = PRESET_FLAGS[mode]["use_int8_attn"]
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


def test_max_throughput_still_names_its_kernels(agent_and_weights):
    agent, _ = agent_and_weights
    with pytest.raises(NotImplementedError,
                       match="fused_attn_block_q8.*fused_top2_mlp_q8c"):
        apply_serving_mode(agent, "max-throughput")


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
    RolloutPolicy.with_serving_mode(agent, mode=mode)
    assert dit.blocks[0].experts_b1.dtype == torch.bfloat16   # precast
    q = dit.blocks[0].experts_q
    assert q.b1.dtype == torch.float32 and not q.b1.requires_grad
    torch.testing.assert_close(q.b1, b1, rtol=0, atol=0)
    if mode == "b1-latency-max":
        qa = dit.blocks[0].attn.attn_q
        assert qa.bqkv.dtype == torch.float32
        torch.testing.assert_close(qa.bqkv, bqkv, rtol=0, atol=0)
