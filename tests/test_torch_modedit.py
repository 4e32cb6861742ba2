"""The port's MoDeDiT against the JAX MoDeDiT on the same weights (a
2-layer, D=256, 2-head model in f32 on the CPU): routing tables, the plain
eval forward, the hoisted ``forward_precomputed`` with sigma-table
overrides, and the same with int8 experts through the whole-layer function
(the JAX side runs its Pallas kernel in interpret mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models.modedit import MoDeDiT as JDiT
from mode_diffusion_policy_tpu.models.modedit import MoDeDiTConfig as JCfg
from mode_diffusion_policy_tpu.ops.quant import quantize_experts as jquant
from mode_diffusion_policy_tpu_torch.models.modedit import MoDeDiT as TDiT
from mode_diffusion_policy_tpu_torch.models.modedit import \
    MoDeDiTConfig as TCfg
from mode_diffusion_policy_tpu_torch.utils.weights import dit_state_dict

DIMS = dict(obs_dim=64, goal_dim=32, embed_dim=256, n_layers=2, n_heads=2,
            num_experts=4, top_k=2)
B = 3
SIGMAS = np.array([80.0, 12.0, 1.5, 0.2, 0.01], np.float32)


def _random_params(seed=0):
    """Parameter tree of the JAX model's shapes, filled from numpy."""
    shapes = jax.eval_shape(
        lambda k: JDiT(JCfg(**DIMS)).init(
            k, {"state_images": jnp.zeros((1, 2, 64))}, jnp.zeros((1, 10, 7)),
            jnp.zeros((1, 1, 32)), jnp.ones((1,))), jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1].key)
        v = r.standard_normal(s.shape).astype(np.float32)
        if name == "g":
            return 1.0 + 0.1 * v
        if "router" in jax.tree_util.keystr(path):
            return 0.5 * v           # spread the router logits
        return 0.05 * v

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


@pytest.fixture(scope="module")
def setup():
    params = _random_params()
    r = np.random.default_rng(1)
    inputs = dict(
        states=r.standard_normal((B, 2, 64)).astype(np.float32),
        goals=r.standard_normal((B, 1, 32)).astype(np.float32),
        actions=r.standard_normal((B, 10, 7)).astype(np.float32),
        sigma=np.array([3.0, 0.5, 40.0], np.float32))
    return params, inputs


def _port(params, **flags):
    m = TDiT(TCfg(**DIMS, **flags), device="cpu")
    m.load_state_dict(dit_state_dict(params))
    return m.eval()


def _jax_quant(params):
    return {name: {"experts_q": tuple(jquant(
        blk["experts_w1"], blk["experts_b1"], blk["experts_w2"]))}
        for name, blk in params.items() if name.startswith("blocks_")}


def test_precompute_routing_matches(setup):
    params, _ = setup
    want = JDiT(JCfg(**DIMS)).apply({"params": params}, jnp.asarray(SIGMAS),
                                    method=JDiT.precompute_routing)
    got = _port(params).precompute_routing(torch.from_numpy(SIGMAS))
    for (ji, jp), (ti, tp) in zip(want, got):
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   atol=1e-6)


def test_eval_forward_matches(setup):
    params, a = setup
    want = JDiT(JCfg(**DIMS)).apply(
        {"params": params}, {"state_images": jnp.asarray(a["states"])},
        jnp.asarray(a["actions"]), jnp.asarray(a["goals"]),
        jnp.asarray(a["sigma"]))
    with torch.no_grad():
        got = _port(params)(
            {"state_images": torch.from_numpy(a["states"])},
            torch.from_numpy(a["actions"]), torch.from_numpy(a["goals"]),
            torch.from_numpy(a["sigma"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def _precomputed(model_apply, port, a, step, fused):
    """forward_precomputed at one scheduled step with sigma-table routing,
    on both sides."""
    jcfg = JCfg(**DIMS, **(dict(use_int8_moe=True, use_pallas_moe=True,
                                use_pallas_attn=True, use_fused_layer=True)
                           if fused else {}))
    jdit = JDiT(jcfg)
    jv = {"params": model_apply}
    if fused:
        jv["quant"] = _jax_quant(model_apply)
    states = {"state_images": jnp.asarray(a["states"])}
    goals = jnp.asarray(a["goals"])
    static_x, goal_embed = jdit.apply(jv, states, goals,
                                      method=JDiT.embed_static_tokens)
    emb = jdit.apply(jv, jnp.asarray(SIGMAS),
                     method=JDiT.process_sigma_embeddings)
    routing = jdit.apply(jv, jnp.asarray(SIGMAS),
                         method=JDiT.precompute_routing)
    want = jdit.apply(jv, static_x, goal_embed, emb[step][None],
                      jnp.asarray(a["actions"]),
                      moe_overrides=[(i, p, jnp.int32(step))
                                     for i, p in routing],
                      method=JDiT.forward_precomputed)
    with torch.no_grad():
        sx, ge = port.embed_static_tokens(
            {"state_images": torch.from_numpy(a["states"])},
            torch.from_numpy(a["goals"]))
        temb = port.process_sigma_embeddings(torch.from_numpy(SIGMAS))
        trout = port.precompute_routing(torch.from_numpy(SIGMAS))
        got = port.forward_precomputed(
            sx, ge, temb[step][None], torch.from_numpy(a["actions"]),
            moe_overrides=[(i, p, step) for i, p in trout])
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("step", [0, 3])
def test_forward_precomputed_plain_matches(setup, step):
    params, a = setup
    got, want = _precomputed(params, _port(params), a, step, fused=False)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("step", [1, 4])
def test_forward_precomputed_fused_layer_matches(setup, step):
    """int8 experts through the whole-layer function (the plain version on
    the CPU) against the JAX whole-layer Pallas kernel. Tolerance as in
    test_torch_layer_kernel.py: exact int8 products, rare one-step int8
    rounding flips from f32 sum order."""
    params, a = setup
    port = _port(params, use_int8_moe=True, use_fused_layer=True)
    port.quantize_experts_()
    got, want = _precomputed(params, port, a, step, fused=True)
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert d.mean() <= 1e-4, d.mean()
    assert d.max() <= 5e-3, d.max()


def test_fused_layer_needs_quantized_experts(setup):
    params, a = setup
    port = _port(params, use_int8_moe=True, use_fused_layer=True)
    x = torch.zeros(1, 14, 256)
    idx = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="quantize_for_inference"):
        port.blocks[0](x, torch.zeros(1, 1, 256),
                       moe_override=(idx, torch.ones(1, 2), 0))


def test_config_rejects_unported_combinations():
    with pytest.raises(NotImplementedError, match="fused_top2_mlp_q8c"):
        TCfg(**DIMS, use_int8_moe=True)
    with pytest.raises(ValueError, match="use_fused_layer"):
        TCfg(**DIMS, use_fused_layer=True)


def test_precast_is_bit_identical(setup):
    """Casting the matmul leaves once (serving precast) gives the same bf16
    forward as casting them per use."""
    params, a = setup
    m = _port(params)
    m_bf = TDiT(TCfg(**DIMS, dtype=torch.bfloat16), device="cpu")
    m_bf.load_state_dict(m.state_dict())
    args = ({"state_images": torch.from_numpy(a["states"])},
            torch.from_numpy(a["actions"]), torch.from_numpy(a["goals"]),
            torch.from_numpy(a["sigma"]))
    with torch.no_grad():
        before = m_bf(*args)
        m_bf.precast_(torch.bfloat16)
        after = m_bf(*args)
    assert m_bf.blocks[0].attn.wqkv.kernel.dtype == torch.bfloat16
    assert m_bf.blocks[0].ln_1.g.dtype == torch.float32
    torch.testing.assert_close(after, before, rtol=0, atol=0)
