"""The port's optimizer and schedules (``training/optim.py``) against the
JAX package's: the tri-stage LR and EMA decay schedules step for step, the
decay mask leaf for leaf, ``FusedAdamWEma`` on the same gradients (f32 and
bf16 first moment, with and without the global-norm clip, and the bf16
training state with stochastic rounding on JAX's noise) within one ulp,
the unfused chain equal to the fused optimizer, ``stochastic_round_bf16``
bit for bit on the same noise bits, its unbiasedness and sub-ulp
accumulation for every noise source, and ADOPT."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JCfg
from mode_diffusion_policy_tpu.training import optim as jopt
from mode_diffusion_policy_tpu_torch.models.agent import MoDEAgent as TAgent
from mode_diffusion_policy_tpu_torch.models.agent import \
    MoDEAgentConfig as TCfg
from mode_diffusion_policy_tpu_torch.training import optim as topt
from mode_diffusion_policy_tpu_torch.utils.weights import port_name
from torch_threads import two_torch_threads  # noqa: F401

TOTAL = 45000
STEPS = sorted({0, 1, 2, 450, 899, 900, 901, 4499, 4500, 4501, 4502, 9000,
                22000, 30000, 44000, 44999, 45000, 45001, 50000}
               | set(range(0, TOTAL + 2000, 997)))


def _rel(a, b):
    a, b = np.float64(a), np.float64(b)
    return abs(a - b) / max(abs(b), 1e-30)


def test_tri_stage_schedule_matches_jax():
    """The shipped schedule (lr 1e-4, 45000 steps, phases 0.02/0.08/0.9)
    step for step at sampled steps, to 1e-7 relative, and equal bit for bit
    at most of them. Between samples the same holds within 1e-7 of the
    peak LR: in the decay's last tenth the lr is peak * (1 + cos) / 2 with
    1 + cos cancelling, so the last bit of an f32 cos moves it by more
    than 1e-7 of itself; there JAX's own eager and jitted schedules differ
    (printed)."""
    j = jopt.tri_stage_schedule(1e-4, TOTAL, (0.02, 0.08, 0.9))
    t = topt.tri_stage_schedule(1e-4, TOTAL, (0.02, 0.08, 0.9))
    got = np.array([t(s) for s in STEPS], np.float64)
    want = np.array([np.asarray(j(s)) for s in STEPS], np.float64)
    jj = jax.jit(j)
    jitted = np.array([np.asarray(jj(s)) for s in STEPS], np.float64)
    print(f"tri-stage LR: worst port-vs-JAX "
          f"{np.max(np.abs(got - want) / want):.2e} relative, JAX eager-vs-"
          f"jit {np.max(np.abs(jitted - want) / want):.2e}, equal at "
          f"{np.mean(got == want):.3f} of the steps")
    assert np.max(np.abs(got - want) / want) <= 1e-7
    assert np.max(np.abs(got - want)) <= 1e-7 * 1e-4
    assert np.mean(got == want) >= 0.98
    assert isinstance(t(5), np.float32)


def test_ema_decay_schedule_matches_jax():
    kw = dict(inv_gamma=1.0, power=2 / 3, min_value=0.0, max_value=0.9999)
    worst = max(_rel(topt.ema_decay_schedule(s, **kw),
                     np.asarray(jopt.ema_decay_schedule(jnp.asarray(s), **kw)))
                for s in STEPS)
    assert worst <= 1e-7, worst


def test_decay_mask_matches_jax_on_every_leaf():
    """The port's flags by name equal JAX ``_decay_mask`` on the agent's
    parameter tree, leaf for leaf (DiT biases off, everything else on)."""
    dims = dict(latent_dim=64, n_layers=2, n_heads=2, cond_dim=16)
    jagent = JAgent(JCfg(resnet_type="50", **dims))
    shapes = jax.eval_shape(lambda k: jagent.init_variables(
        k, image_hw=(32, 32)), jax.random.PRNGKey(0))["params"]
    jmask = jopt._decay_mask(shapes)
    nd = {".".join(str(p.key) for p in path): len(s.shape)
          for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = {}
    for path, flag in jax.tree_util.tree_flatten_with_path(jmask)[0]:
        key = ".".join(str(p.key) for p in path)
        want[port_name(key, nd[key])] = flag
    agent = TAgent(TCfg(**dims), device="cpu")
    got = topt.decay_mask(dict(agent.named_parameters()))
    assert got == want
    assert not got["inner_model.blocks.0.attn.wqkv.bias"]
    assert got["inner_model.ln.g"] and got["inner_model.pos_emb"]
    assert got["inner_model.blocks.0.experts_b1"]
    assert got["static_resnet.resnet.bn1.bias"]


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((8, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    c = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    jtree = {"inner_model": {"blocks_0": {"wqkv": {"kernel": k, "bias": b}}},
             "static_resnet": {"conv": {"kernel": c}}}
    ttree = {"inner_model.blocks.0.wqkv.kernel": k,
             "inner_model.blocks.0.wqkv.bias": b,
             "static_resnet.conv.weight": c.transpose(3, 2, 0, 1)}
    return jtree, ttree


def _to_port(jtree):
    return {port_name(".".join(str(p.key) for p in path), np.ndim(v)):
            np.asarray(v, np.float32).transpose(3, 2, 0, 1)
            if np.ndim(v) == 4 else np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _max_ulps(got, want, dtype):
    """Largest |got - want| in units of ``dtype``'s spacing at want."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    if dtype == "bf16":
        spacing = np.abs(want) * 2.0 ** -7
        spacing = np.where(spacing == 0, 2.0 ** -133, spacing)
        # the bf16 step at |want| is 2^(floor(log2|want|) - 7)
        spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-38))) - 7)
    else:
        spacing = np.spacing(np.abs(want))
    return float(np.max(np.abs(got - want) / spacing))


KW = dict(learning_rate=3e-3, betas=(0.9, 0.95), transformer_weight_decay=0.05,
          use_lr_scheduler=True, total_steps=100)


@pytest.mark.parametrize("max_grad_norm", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("mu_dtype", ["f32", "bf16"])
def test_fused_adamw_matches_jax(mu_dtype, max_grad_norm):
    """Three steps of FusedAdamWEma.update_with_ema on the same gradients
    (small and large, so the clip triggers on some steps), EMA in bf16:
    params, mu, nu and EMA within one ulp of JAX's at every step."""
    jtree, ttree = _trees()
    jmu = jnp.bfloat16 if mu_dtype == "bf16" else None
    tmu = torch.bfloat16 if mu_dtype == "bf16" else None
    jo, _ = jopt.make_optimizer(jtree, fused=True, mu_dtype=jmu,
                                max_grad_norm=max_grad_norm, **KW)
    params = {n: torch.tensor(v) for n, v in ttree.items()}
    to, _ = topt.make_optimizer(params, fused=True, mu_dtype=tmu,
                                max_grad_norm=max_grad_norm, **KW)
    jp = jax.tree.map(jnp.asarray, jtree)
    je = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    js = jo.init(jp)
    ts = to.init(params)
    te = {n: p.to(torch.bfloat16) for n, p in params.items()}
    rng = np.random.default_rng(1)
    for step in range(3):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                    * (3.0 if step % 2 else 0.01)
                                    ).astype(np.float32), jtree)
        decay = jopt.ema_decay_schedule(jnp.asarray(step))
        jp, js, je = jo.update_with_ema(jax.tree.map(jnp.asarray, g), js, jp,
                                        je, decay)
        tg = {n: torch.tensor(v) for n, v in _to_port(g).items()}
        _, ts, _ = to.update_with_ema(tg, ts, params, te,
                                      topt.ema_decay_schedule(step))
        for name, jt, tt, dt in (("params", jp, params, "f32"),
                                 ("mu", js.mu, ts.mu, mu_dtype),
                                 ("nu", js.nu, ts.nu, "f32"),
                                 ("ema", je, te, "bf16")):
            want = _to_port(jax.tree.map(lambda x: np.asarray(
                x, np.float32), jt))
            for n, w in want.items():
                u = _max_ulps(tt[n].float().numpy(), w, dt)
                assert u <= 1.0, (step, name, n, u)
    assert ts.count == 3


def test_fused_adamw_bf16_full_state_matches_jax():
    """The update that ``bf16_full_state`` ships: bf16 parameters, mu, nu,
    gradients and EMA, the update math in f32 and the parameter write-back
    stochastically rounded. Three steps of ``update_with_ema`` against JAX
    ``FusedAdamWEma(stochastic_round=True)`` with the same noise (JAX's
    per-leaf threefry bits, passed in as ``bits``), the clip on: the
    stochastically rounded params bit for bit, mu, nu and EMA within one
    bf16 ulp of JAX's at every step."""
    jtree, ttree = _trees(6)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), jtree)
    jo, _ = jopt.make_optimizer(jp, fused=True, max_grad_norm=1.0,
                                stochastic_round=True, sr_noise="threefry",
                                **KW)
    params = {n: torch.tensor(v).to(torch.bfloat16)
              for n, v in ttree.items()}
    to, _ = topt.make_optimizer(params, fused=True, max_grad_norm=1.0,
                                stochastic_round=True, **KW)
    je = jax.tree.map(lambda x: x, jp)
    js = jo.init(jp)
    ts = to.init(params)
    assert all(v.dtype == torch.bfloat16 for v in ts.mu.values())
    te = {n: p.clone() for n, p in params.items()}
    rng = np.random.default_rng(7)
    flips = 0
    for step in range(3):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                    * (3.0 if step % 2 else 0.01)
                                    ).astype(np.float32), jtree)
        jg = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g)
        key = jax.random.PRNGKey(100 + step)
        flat, treedef = jax.tree.flatten(jp)
        keys = jax.random.split(key, len(flat))
        jbits = jax.tree.unflatten(treedef, [
            _jax_bits(k, x.shape, "threefry") for k, x in zip(keys, flat)])
        decay = jopt.ema_decay_schedule(jnp.asarray(step))
        jp, js, je = jo.update_with_ema(jg, js, jp, je, decay, key=key)
        tg = {n: torch.tensor(v).to(torch.bfloat16)
              for n, v in _to_port(jg).items()}
        tbits = {n: torch.tensor(v.astype(np.int32))
                 for n, v in _to_port(jbits).items()}
        _, ts, _ = to.update_with_ema(tg, ts, params, te,
                                      topt.ema_decay_schedule(step),
                                      bits=tbits)
        for name, jt, tt in (("params", jp, params), ("mu", js.mu, ts.mu),
                             ("nu", js.nu, ts.nu), ("ema", je, te)):
            want = _to_port(jax.tree.map(lambda x: np.asarray(
                x, np.float32), jt))
            for n, w in want.items():
                got = tt[n].float().numpy()
                assert tt[n].dtype == torch.bfloat16, (name, n)
                u = _max_ulps(got, w, "bf16")
                assert u <= 1.0, (step, name, n, u)
                flips += int(np.sum(got != w))
                if name == "params":
                    # the same noise rounds the same way: bit for bit
                    np.testing.assert_array_equal(got, w)
    print(f"bf16_full_state: {flips} elements one bf16 ulp from JAX over "
          f"3 steps, the rest equal")
    assert ts.count == 3


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_unfused_chain_equals_fused(mu_dtype):
    """``make_optimizer(fused=False)`` (scale_by_adam -> decayed weights ->
    LR, then apply_updates and ema_update) gives the fused optimizer's
    parameters, moments and EMA bit for bit."""
    _, ttree = _trees(3)
    pf = {n: torch.tensor(v) for n, v in ttree.items()}
    pu = {n: torch.tensor(v) for n, v in ttree.items()}
    fo, _ = topt.make_optimizer(pf, fused=True, mu_dtype=mu_dtype,
                                max_grad_norm=1.0, **KW)
    uo, _ = topt.make_optimizer(pu, fused=False, mu_dtype=mu_dtype,
                                max_grad_norm=1.0, **KW)
    fs, us = fo.init(pf), uo.init(pu)
    ef = {n: p.clone() for n, p in pf.items()}
    eu = {n: p.clone() for n, p in pu.items()}
    rng = np.random.default_rng(4)
    for step in range(4):
        scale = 2.0 if step % 2 else 0.02
        g = {n: torch.tensor((rng.standard_normal(v.shape) * scale
                              ).astype(np.float32))
             for n, v in ttree.items()}
        decay = topt.ema_decay_schedule(step + 5)
        _, fs, _ = fo.update_with_ema(g, fs, pf, ef, decay)
        upd, us = uo.update(g, us, pu)
        topt.apply_updates(pu, upd)
        topt.ema_update(eu, pu, decay)
        for n in pf:
            assert torch.equal(pf[n], pu[n]), (step, n)
            assert torch.equal(ef[n], eu[n]), (step, n)
    adam = us[1][0]
    for n in pf:
        assert torch.equal(fs.mu[n], adam.mu[n])
        assert torch.equal(fs.nu[n], adam.nu[n])


def _jax_bits(key, shape, noise):
    """The 16-bit noise JAX's stochastic_round_bf16 adds, per source."""
    if noise == "threefry8":
        return np.asarray(jax.random.bits(key, shape, jnp.uint8)).astype(
            np.int64) * 257
    if noise == "threefry":
        return np.asarray(jax.random.bits(key, shape, jnp.uint32)
                          & jnp.uint32(0xFFFF)).astype(np.int64)
    kd = jax.random.key_data(key).reshape(-1).astype(jnp.uint32)
    seed = jnp.tile(kd, 2)[:4]
    _, rnd = jax.lax.rng_bit_generator(seed, shape, dtype=jnp.uint32)
    return np.asarray(rnd & jnp.uint32(0xFFFF)).astype(np.int64)


@pytest.mark.parametrize("noise", ["hw", "threefry", "threefry8"])
def test_stochastic_round_bf16_bit_exact_on_jax_bits(noise):
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * 10.0 ** rng.integers(
            -8, 8, 4000),
        np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 3.3895314e38,
                  -3.3895314e38, 1e-40, 1.0, -2.5], np.float32)])
    key = jax.random.PRNGKey(11)
    want = np.asarray(jopt.stochastic_round_bf16(jnp.asarray(x), key,
                                                 noise=noise), np.float32)
    bits = torch.tensor(_jax_bits(key, x.shape, noise).astype(np.int32))
    got = topt.stochastic_round_bf16(torch.tensor(x), bits=bits).float()
    # bit for bit, NaN payloads aside (each framework canonicalizes its
    # own NaN in the f32 -> bf16 cast)
    num = ~np.isnan(want)
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[num],
                                  want.view(np.uint32)[num])
    np.testing.assert_array_equal(np.isnan(got.numpy()), ~num)
    assert np.isposinf(got[4000]) and np.isneginf(got[4001]) \
        and np.isnan(got[4002])


@pytest.mark.parametrize("noise", ["hw", "threefry", "threefry8"])
def test_stochastic_round_bf16_properties(noise):
    """Representable values round exactly, a value a quarter of the way
    between two bf16 neighbors rounds up a quarter of the time, inf and NaN
    pass through (tests/test_training.py's checks, on the port's bits)."""
    gen = torch.Generator().manual_seed(7)
    exact = torch.tensor([0.0, 1.0, -2.5, 3.140625])
    for _ in range(3):
        assert torch.equal(topt.stochastic_round_bf16(exact, gen, noise)
                           .float(), exact)
    hi = float(torch.nextafter(torch.tensor(1.0, dtype=torch.bfloat16),
                               torch.tensor(2.0, dtype=torch.bfloat16)))
    x = torch.full((4096,), 1.0 + 0.25 * (hi - 1.0))
    out = topt.stochastic_round_bf16(x, gen, noise).float()
    frac_hi = float((out == hi).float().mean())
    assert abs(frac_hi - 0.25) < 0.05, frac_hi
    spec = topt.stochastic_round_bf16(
        torch.tensor([np.inf, -np.inf, np.nan]), gen, noise).float()
    assert torch.isposinf(spec[0]) and torch.isneginf(spec[1]) \
        and torch.isnan(spec[2])


@pytest.mark.parametrize("noise", ["hw", "threefry"])
def test_stochastic_round_accumulates_sub_ulp_updates(noise):
    """2000 additions of 1e-4 (600x below half a bf16 ulp at 8.0) move the
    mean by about 0.2; round-to-nearest never moves it. For the 16-bit
    sources, as the JAX test holds its default one: "threefry8"'s 257-step
    lattice resolves a carry probability only to 1/256, too coarse for an
    update of 105 / 65536 of an ulp."""
    u, n = 1e-4, 2000
    gen = torch.Generator().manual_seed(3)
    x = torch.full((256,), 8.0, dtype=torch.bfloat16)
    for _ in range(n):
        x = topt.stochastic_round_bf16(x.float() + u, gen, noise)
    out = float(x.float().mean())
    assert abs(out - (8.0 + n * u)) < 0.02, out
    rtn = (torch.full((256,), 8.0, dtype=torch.bfloat16).float() + u).to(
        torch.bfloat16).float().mean()
    assert float(rtn) == 8.0


def test_adopt_matches_jax_and_runs():
    """ADOPT chained with a fixed scale for 3 steps equals the JAX
    transform's updates, and the parameters stay finite."""
    import optax
    jo = optax.chain(jopt.adopt(), optax.scale(-0.01))
    jp = {"w": jnp.ones(4)}
    js = jo.init(jp)
    tp = {"w": torch.ones(4)}
    to = topt.adopt()
    ts = to.init(tp)
    for i in range(3):
        g = np.full(4, 0.5 + 0.25 * i, np.float32)
        ju, js = jo.update({"w": jnp.asarray(g)}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = to.update({"w": torch.tensor(g)}, ts, tp)
        topt.apply_updates(tp, {"w": tu["w"] * -0.01})
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6)
    assert torch.isfinite(tp["w"]).all()


def test_fused_update_method_matches_update_with_ema():
    """FusedAdamWEma.update (optax-style: updates and state, no write, no
    EMA) applies the same math as update_with_ema; stochastic rounding
    needs the fused write-back and its generator."""
    w = torch.tensor(np.random.default_rng(1).standard_normal(16),
                     dtype=torch.float32)
    p1, p2 = {"w": w.clone()}, {"w": w.clone()}
    o1, _ = topt.make_optimizer(p1, use_lr_scheduler=False)
    o2, _ = topt.make_optimizer(p2, use_lr_scheduler=False)
    s1, s2 = o1.init(p1), o2.init(p2)
    g = {"w": torch.full((16,), 0.3)}
    _, s1, _ = o1.update_with_ema(g, s1, p1, {"w": w.clone()}, 0.99)
    upd, s2 = o2.update(g, s2, p2)
    topt.apply_updates(p2, upd)
    assert torch.equal(p1["w"], p2["w"]) and torch.equal(s1.nu["w"],
                                                         s2.nu["w"])
    sr, _ = topt.make_optimizer(p2, stochastic_round=True)
    st = sr.init(p2)
    with pytest.raises(ValueError, match="fused write-back"):
        sr.update(g, st, p2)
    with pytest.raises(ValueError, match="generator"):
        sr.update_with_ema(g, st, p2, None, 0.9)
    with pytest.raises(ValueError, match="requires the fused"):
        topt.make_optimizer(p2, fused=False, stochastic_round=True)
