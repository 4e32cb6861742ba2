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


def _precomputed(model_apply, port, a, step, fused, jflags=None):
    """forward_precomputed at one scheduled step with sigma-table routing,
    on both sides; ``jflags`` replaces the JAX kernel flags of ``fused``
    (int8 experts and the whole-layer kernel)."""
    if jflags is None:
        jflags = (dict(use_int8_moe=True, use_pallas_moe=True,
                       use_pallas_attn=True, use_fused_layer=True)
                  if fused else {})
    jcfg = JCfg(**DIMS, **jflags)
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
    port = _port(params, use_int8_moe=True, use_pallas_attn=True,
                 use_fused_layer=True)
    port.quantize_experts_()
    counts = dict.fromkeys(("layer_impl", "attn_impl_bf16", "moe_impl"), 0)
    _counting(port, counts)
    got, want = _precomputed(params, port, a, step, fused=True)
    assert counts == {"layer_impl": DIMS["n_layers"], "attn_impl_bf16": 0,
                      "moe_impl": 0}, counts
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert d.mean() <= 1e-4, d.mean()
    assert d.max() <= 5e-3, d.max()


def _counting(port, counts):
    for key in counts:
        fn = getattr(port, key)

        def wrapped(*args, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*args, **kw)
        setattr(port, key, wrapped)


@pytest.mark.parametrize("step", [1, 4])
def test_two_kernel_layer_with_bf16_attention_matches(setup, step):
    """int8 experts with bf16 attention projections outside the whole-layer
    kernel (use_pallas_attn, no use_fused_layer): per layer the attention
    function (fused_attn_block's plain version on the CPU), then ln_2 and
    the int8 MoE function, against the JAX block's fused_attn_block then
    fused_top2_mlp_q8c (interpret mode). This configuration raised
    NotImplementedError before the bf16 attention kernel was ported.
    Tolerance as in test_forward_precomputed_fused_layer_matches."""
    params, a = setup
    port = _port(params, use_int8_moe=True, use_pallas_attn=True)
    port.quantize_experts_()
    counts = dict.fromkeys(("attn_impl_bf16", "attn_impl", "moe_impl",
                            "layer_impl"), 0)
    _counting(port, counts)
    got, want = _precomputed(params, port, a, step, fused=True, jflags=dict(
        use_int8_moe=True, use_pallas_moe=True, use_pallas_attn=True))
    L = DIMS["n_layers"]
    assert counts == {"attn_impl_bf16": L, "attn_impl": 0, "moe_impl": L,
                      "layer_impl": 0}, counts
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert d.mean() <= 1e-4, d.mean()
    assert d.max() <= 5e-3, d.max()


def test_bf16_kernel_configuration_matches_over_the_schedule(setup):
    """The bf16 kernel configuration (use_pallas_moe and use_pallas_attn,
    no int8; use_fused_layer set too, inert there as in JAX), through the
    hoisted path at every step of the 10-step exponential schedule: per
    layer the attention function (fused_attn_block's plain version on the
    CPU), then ln_2 and the bf16 MoE function (fused_top2_mlp's plain
    version, the normed input as the residual seed), against the JAX
    block's fused_attn_block then fused_top2_mlp (interpret mode), in f32
    within 2e-5. The port refused use_fused_layer without int8 experts
    before this configuration was ported."""
    from mode_diffusion_policy_tpu.models.edm.schedules import \
        get_noise_schedule
    params, a = setup
    flags = dict(use_pallas_moe=True, use_pallas_attn=True,
                 use_fused_layer=True)
    port = _port(params, **flags)
    counts = dict.fromkeys(("attn_impl_bf16", "moe_impl_bf16", "moe_impl",
                            "layer_impl", "attn_impl"), 0)
    _counting(port, counts)
    sig = np.asarray(get_noise_schedule(10, "exponential"), np.float32)[:-1]
    jdit = JDiT(JCfg(**DIMS, **flags))
    jv = {"params": params}
    static_x, goal_embed = jdit.apply(
        jv, {"state_images": jnp.asarray(a["states"])},
        jnp.asarray(a["goals"]), method=JDiT.embed_static_tokens)
    emb = jdit.apply(jv, jnp.asarray(sig),
                     method=JDiT.process_sigma_embeddings)
    routing = jdit.apply(jv, jnp.asarray(sig),
                         method=JDiT.precompute_routing)
    with torch.no_grad():
        sx, ge = port.embed_static_tokens(
            {"state_images": torch.from_numpy(a["states"])},
            torch.from_numpy(a["goals"]))
        temb = port.process_sigma_embeddings(torch.from_numpy(sig))
        trout = port.precompute_routing(torch.from_numpy(sig))
    for step in range(len(sig)):
        want = jdit.apply(jv, static_x, goal_embed, emb[step][None],
                          jnp.asarray(a["actions"]),
                          moe_overrides=[(i, p, jnp.int32(step))
                                         for i, p in routing],
                          method=JDiT.forward_precomputed)
        with torch.no_grad():
            got = port.forward_precomputed(
                sx, ge, temb[step][None], torch.from_numpy(a["actions"]),
                moe_overrides=[(i, p, step) for i, p in trout])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-5, err_msg=f"step {step}")
    L = DIMS["n_layers"] * len(sig)
    assert counts == {"attn_impl_bf16": L, "moe_impl_bf16": L,
                      "moe_impl": 0, "layer_impl": 0, "attn_impl": 0}, counts


@pytest.mark.parametrize("int8_attn", [False, True],
                         ids=["bf16-attn", "int8-attn"])
def test_inline_forward_runs_the_attention_kernels(setup, int8_attn):
    """An inline forward (no routing tables: a sampler's off-schedule
    evaluation) under the kernel flags of parity (bf16 projections) and
    max-throughput (int8): each block's attention sub-block is one call of
    the attention function with one cond row per sample ([B,1,D]), then
    ln_2, the router and the dense experts, against the JAX forward with the
    same flags (Pallas interpret mode). bf16 projections: within the f32
    forward gate (2e-5); int8 projections: the flip-aware gate of
    test_forward_precomputed_fused_layer_matches. Before the port ran the
    attention kernels here, this call ran f32 projections where the JAX
    package runs int8 ones."""
    from mode_diffusion_policy_tpu.ops.quant import quantize_attn as jqattn
    params, a = setup
    flags = dict(use_int8_moe=True, use_pallas_attn=True,
                 use_int8_attn=int8_attn,
                 use_fused_layer=not int8_attn)
    quant = _jax_quant(params)
    if int8_attn:
        for name, entry in quant.items():
            at = params[name]["attn"]
            entry["attn"] = {"attn_q": tuple(jqattn(
                at["wqkv"]["kernel"], at["wqkv"]["bias"],
                at["c_proj"]["kernel"]))}
    want = np.asarray(JDiT(JCfg(**DIMS, use_pallas_moe=True, **flags)).apply(
        {"params": params, "quant": quant},
        {"state_images": jnp.asarray(a["states"])},
        jnp.asarray(a["actions"]), jnp.asarray(a["goals"]),
        jnp.asarray(a["sigma"])))
    port = _port(params, **flags)
    port.quantize_experts_()
    if int8_attn:
        port.quantize_attn_()
    counts = dict.fromkeys(("attn_impl_bf16", "attn_impl", "moe_impl",
                            "layer_impl"), 0)
    _counting(port, counts)
    conds = []
    impl = "attn_impl" if int8_attn else "attn_impl_bf16"
    fn = getattr(port, impl)
    setattr(port, impl, lambda x, c, *r, **k: conds.append(c.shape)
            or fn(x, c, *r, **k))
    with torch.no_grad():
        got = port({"state_images": torch.from_numpy(a["states"])},
                   torch.from_numpy(a["actions"]),
                   torch.from_numpy(a["goals"]),
                   torch.from_numpy(a["sigma"])).numpy()
    L = DIMS["n_layers"]
    assert counts == {"attn_impl_bf16": 0 if int8_attn else L,
                      "attn_impl": L if int8_attn else 0, "moe_impl": 0,
                      "layer_impl": 0}, counts
    assert conds == [(B, 1, DIMS["embed_dim"])] * L
    if int8_attn:
        d = np.abs(got - want)
        assert np.isfinite(got).all()
        assert d.mean() <= 1e-4, d.mean()
        assert d.max() <= 5e-3, d.max()
    else:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_fused_layer_needs_quantized_experts(setup):
    params, a = setup
    port = _port(params, use_int8_moe=True, use_fused_layer=True)
    x = torch.zeros(1, 14, 256)
    idx = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="quantize_for_inference"):
        port.blocks[0](x, torch.zeros(1, 1, 256),
                       moe_override=(idx, torch.ones(1, 2), 0))


def test_config_rejects_unported_combinations():
    """The port's config raises where the JAX config raises (int8
    projections without the attention kernel, or with a head dim that is
    not a multiple of 128) and nowhere else: a flag whose path needs
    another is inert without it, as in the JAX package (the whole-layer
    kernel without int8 experts or without the attention kernel)."""
    assert not TCfg(**DIMS, use_int8_moe=True).fused_attn
    assert TCfg(**DIMS, use_int8_moe=True, use_pallas_attn=True).fused_attn
    for flags in (dict(use_fused_layer=True),
                  dict(use_fused_layer=True, use_pallas_attn=True,
                       use_pallas_moe=True),
                  dict(use_fused_layer=True, use_int8_moe=True)):
        assert not TCfg(**DIMS, **flags).fused_layer, flags
    assert TCfg(**DIMS, use_fused_layer=True, use_int8_moe=True,
                use_pallas_attn=True).fused_layer
    with pytest.raises(ValueError, match="use_pallas_attn"):
        TCfg(**DIMS, use_int8_moe=True, use_int8_attn=True)
    with pytest.raises(ValueError, match="head_dim"):
        TCfg(**{**DIMS, "n_heads": 4}, use_pallas_attn=True,
             use_int8_attn=True)


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


def _mega_pair(params, int8_attn):
    """The JAX DiT with its megakernel flags and quant collection, and the
    port's DiT with its layer stack, on the same weights."""
    from mode_diffusion_policy_tpu.ops.quant import quantize_attn as jqattn
    jcfg = JCfg(**DIMS, use_int8_moe=True, use_pallas_moe=True,
                use_pallas_attn=True, use_fused_layer=True,
                use_int8_attn=int8_attn, use_megakernel=True)
    quant = _jax_quant(params)
    if int8_attn:
        for name, entry in quant.items():
            a = params[name]["attn"]
            entry["attn"] = {"attn_q": tuple(jqattn(
                a["wqkv"]["kernel"], a["wqkv"]["bias"],
                a["c_proj"]["kernel"]))}
    port = _port(params, use_int8_moe=True, use_pallas_attn=True,
                 use_fused_layer=True, use_int8_attn=int8_attn,
                 use_megakernel=True)
    port.quantize_experts_()
    if int8_attn:
        port.quantize_attn_()
    port.stack_layers_()
    return JDiT(jcfg), {"params": params, "quant": quant}, port


@pytest.mark.parametrize("int8_attn", [False, True],
                         ids=["bf16-attn", "int8-attn"])
def test_stack_layers_matches_jax(setup, int8_attn):
    """The port's cached layer stack against the JAX stack_layers, leaf by
    leaf: the JAX keys, the same int8 tensors, the same f32 values; and
    beside them the K-major int8 copies that the CUDA megakernel reads,
    each the transpose of its JAX tensor's matrices."""
    params, _ = setup
    jdit, jv, port = _mega_pair(params, int8_attn)
    want = jdit.apply(jv, method=JDiT.stack_layers)
    got = port.stacked
    kmajor = {"w1_t": "w1_q", "w2_t": "w2_q"}
    if int8_attn:
        kmajor.update(wqkv_t="wqkv", wout_t="wout")
    assert set(got) == set(want) | set(kmajor)
    assert ("sqkv" in got) == int8_attn
    for k, src in kmajor.items():
        np.testing.assert_array_equal(
            got[k].numpy(), np.swapaxes(np.asarray(want[src]), -1, -2),
            err_msg=k)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        if w.dtype == np.int8:
            assert got[k].dtype == torch.int8
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          w.astype(np.float32), err_msg=k)


def test_stacked_int8_weights_are_not_held_twice(setup):
    """After stack_layers_ every block's int8 experts and projections are
    slices of the stack (the per-block copies are gone)."""
    params, _ = setup
    _, _, port = _mega_pair(params, True)
    st = port.stacked
    for l, blk in enumerate(port.blocks):
        for k, t in zip(("w1_q", "w2_q"), (blk.experts_q.w1_q,
                                           blk.experts_q.w2_q)):
            assert t.untyped_storage().data_ptr() == \
                st[k].untyped_storage().data_ptr()
            assert t.data_ptr() == st[k][l].data_ptr()
        assert blk.attn.attn_q.wqkv_q.data_ptr() == st["wqkv"][l].data_ptr()


@pytest.mark.parametrize("int8_attn", [False, True],
                         ids=["bf16-attn", "int8-attn"])
@pytest.mark.parametrize("step", [1, 4])
def test_forward_precomputed_mega_matches(setup, int8_attn, step):
    """One denoise step through the whole-stack function (the plain version
    on the CPU) against the JAX megakernel (interpret mode), at the steps
    and with the tolerance of test_forward_precomputed_fused_layer_matches.
    At step 3 the two packages' token embeddings differ by ~1e-7 and move
    one int8 rounding of the sigma-token row, which every sample shares
    and attends to: ~3e-3 at the output, on the per-layer path as well
    (test_forward_precomputed_mega_is_the_layer_path pins the two paths
    together on each side)."""
    params, a = setup
    jdit, jv, port = _mega_pair(params, int8_attn)
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
                      jdit.apply(jv, method=JDiT.stack_layers),
                      jnp.stack([i for i, _ in routing]),
                      jnp.stack([p for _, p in routing]), jnp.int32(step),
                      method=JDiT.forward_precomputed_mega)
    with torch.no_grad():
        sx, ge = port.embed_static_tokens(
            {"state_images": torch.from_numpy(a["states"])},
            torch.from_numpy(a["goals"]))
        temb = port.process_sigma_embeddings(torch.from_numpy(SIGMAS))
        trout = port.precompute_routing(torch.from_numpy(SIGMAS))
        got = port.forward_precomputed_mega(
            sx, ge, temb[step][None], torch.from_numpy(a["actions"]),
            port.stacked, torch.stack([i for i, _ in trout]),
            torch.stack([p for _, p in trout]), step).numpy()
    d = np.abs(got - np.asarray(want))
    assert np.isfinite(got).all()
    assert d.mean() <= 1e-4, d.mean()
    assert d.max() <= 5e-3, d.max()


@pytest.mark.parametrize("flags,mega", [
    (dict(use_megakernel=True), False),
    (dict(use_megakernel=True, use_int8_moe=True), False),
    (dict(use_megakernel=True, use_int8_moe=True, use_pallas_attn=True),
     True),
    (dict(use_megakernel=True, use_int8_moe=True, use_pallas_attn=True,
          use_int8_attn=True), True),
    (dict(use_megakernel=True, use_int8_moe=True, use_pallas_attn=True,
          n_heads=4), False),
    (dict(use_int8_attn=True, use_pallas_attn=True), False),
], ids=["mega", "mega-int8", "mega-int8-attn-kernel",
        "mega-int8-attn-kernel-int8-proj", "mega-head-dim-64",
        "int8-proj-bf16-experts"])
def test_config_rejects_megakernel_and_int8_attn_without_fused_layer(flags,
                                                                     mega):
    """The megakernel and int8 projections without the whole-layer kernel
    or int8 experts build, as in the JAX package: the megakernel runs
    where the JAX agent runs it (int8 top-2 experts, the attention kernel,
    head_dim % 128 == 0; JAX agent.py:585-598) and is inert elsewhere;
    int8 projections need only the attention kernel. The JAX config's two
    raises hold (test_config_rejects_unported_combinations)."""
    cfg = TCfg(**{**DIMS, **flags})
    assert cfg.megakernel == mega
    assert not cfg.fused_layer


def test_precast_keeps_f32_masters_and_load_restores_them(setup):
    """precast_ casts in place but keeps the f32 values for the quantizers;
    loading a state dict afterwards loads into f32 leaves again."""
    params, _ = setup
    m = _port(params)
    m.cfg = TCfg(**DIMS, dtype=torch.bfloat16)
    name = "blocks.0.experts_w1"
    f32 = m.get_parameter(name).detach().clone()
    m.precast_(torch.bfloat16)
    assert m.get_parameter(name).dtype == torch.bfloat16
    torch.testing.assert_close(m.f32_param(name), f32, rtol=0, atol=0)
    m.load_state_dict(dit_state_dict(_random_params(seed=3)))
    assert m.get_parameter(name).dtype == torch.float32
    assert not m._f32_masters
    assert not torch.equal(m.f32_param(name), f32)


@pytest.mark.parametrize("int8_attn", [False, True],
                         ids=["bf16-attn", "int8-attn"])
def test_forward_precomputed_mega_is_the_layer_path(setup, int8_attn):
    """On each side, the whole-stack path equals the per-layer fused path
    exactly, at every scheduled step."""
    params, a = setup
    jdit, jv, port = _mega_pair(params, int8_attn)
    acts = jnp.asarray(a["actions"])
    sx_j, ge_j = jdit.apply(jv, {"state_images": jnp.asarray(a["states"])},
                            jnp.asarray(a["goals"]),
                            method=JDiT.embed_static_tokens)
    emb_j = jdit.apply(jv, jnp.asarray(SIGMAS),
                       method=JDiT.process_sigma_embeddings)
    rout_j = jdit.apply(jv, jnp.asarray(SIGMAS),
                        method=JDiT.precompute_routing)
    st_j = jdit.apply(jv, method=JDiT.stack_layers)
    with torch.no_grad():
        sx, ge = port.embed_static_tokens(
            {"state_images": torch.from_numpy(a["states"])},
            torch.from_numpy(a["goals"]))
        temb = port.process_sigma_embeddings(torch.from_numpy(SIGMAS))
        rout = port.precompute_routing(torch.from_numpy(SIGMAS))
    tabs = (torch.stack([i for i, _ in rout]),
            torch.stack([p for _, p in rout]))
    for step in range(len(SIGMAS)):
        with torch.no_grad():
            mega = port.forward_precomputed_mega(
                sx, ge, temb[step][None], torch.from_numpy(a["actions"]),
                port.stacked, *tabs, step)
            layer = port.forward_precomputed(
                sx, ge, temb[step][None], torch.from_numpy(a["actions"]),
                moe_overrides=[(i, p, step) for i, p in rout])
        torch.testing.assert_close(mega, layer, rtol=0, atol=0)
        jm = jdit.apply(jv, sx_j, ge_j, emb_j[step][None], acts, st_j,
                        jnp.stack([i for i, _ in rout_j]),
                        jnp.stack([p for _, p in rout_j]), jnp.int32(step),
                        method=JDiT.forward_precomputed_mega)
        jl = jdit.apply(jv, sx_j, ge_j, emb_j[step][None], acts,
                        moe_overrides=[(i, p, jnp.int32(step))
                                       for i, p in rout_j],
                        method=JDiT.forward_precomputed)
        np.testing.assert_array_equal(np.asarray(jm), np.asarray(jl))
