"""The port's training path against the JAX package's, on the CPU: the sigma
densities and the camera augmentations on JAX's own draws, the FiLM-ResNet-50
encoders in train mode (BatchNorm on batch statistics and its
running-statistics update, remat, GroupNorm), ``training_loss`` with its
router aux losses and every gradient leaf, one and three steps of
``make_train_step`` from the same carried-over state against JAX's float64
step, the bf16 compute dtype's loss and gradient, and the rates of the
dropouts, the goal drop and the Gumbel routing.

Both packages start from the same numpy-made weights (``from_jax_params``,
``from_jax_train_state``); sigma, noise and the Gumbel noise are passed in
(the JAX draws are patched to the same constants) and the dropout rates are
0 where outputs are compared.

Tolerances. Where the encoders run in train mode, f32 results of either
package are only as good as the BatchNorm statistics let them be: flax
takes the variance as E[x^2] - E[x]^2, which cancels in channels whose mean
is large beside their spread, and at these sizes (a few images of 64 px)
the gradients through 53 such layers are ill-conditioned: JAX's own f32
gradients of some encoder leaves are tens of percent away from its float64
ones. So each comparison is made twice: in float64 (JAX under
``jax.enable_x64``, the port with ``dtype=torch.float64``), where the two
must agree to 1e-9 (encoders) or 1e-5 (whole loss and gradients: JAX keeps
a few f32 casts in the DiT even in x64), and in f32, where a result passes
the stated tolerance or, failing it, lies no further from the float64
result than twice JAX's own f32 result does (the floor rule of
``chip_smoke.py`` and ``tests/test_torch_slice.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mode_diffusion_policy_tpu.models.modedit as jmodedit
from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JCfg
from mode_diffusion_policy_tpu.models.edm import densities as jdens
from mode_diffusion_policy_tpu.models.encoders import resnet as jres
from mode_diffusion_policy_tpu.ops import image as jimg
from mode_diffusion_policy_tpu.training import optim as jopt
from mode_diffusion_policy_tpu.training.loop import \
    make_train_step as jmake_step
from mode_diffusion_policy_tpu.training.state import TrainState as JState
from mode_diffusion_policy_tpu_torch.models import modedit as tmodedit
from mode_diffusion_policy_tpu_torch.models.agent import MoDEAgent as TAgent
from mode_diffusion_policy_tpu_torch.models.agent import \
    MoDEAgentConfig as TCfg
from mode_diffusion_policy_tpu_torch.models.edm import densities as tdens
from mode_diffusion_policy_tpu_torch.models.encoders import resnet as tres
from mode_diffusion_policy_tpu_torch.ops import image as timg
from mode_diffusion_policy_tpu_torch.ops.primitives import (dropout,
                                                            gumbel_topk_sample)
from mode_diffusion_policy_tpu_torch.training import optim as topt
from mode_diffusion_policy_tpu_torch.training.loop import make_train_step
from mode_diffusion_policy_tpu_torch.training.state import TrainState
from mode_diffusion_policy_tpu_torch.utils.weights import (
    from_jax_params, from_jax_train_state, port_tree, resnet_state_dict)
from torch_threads import two_torch_threads  # noqa: F401

DIMS = dict(latent_dim=256, n_layers=2, n_heads=2, cond_dim=32,
            num_experts=4, top_k=2)
NO_DROP = dict(attn_pdrop=0.0, mlp_pdrop=0.0, goal_drop=0.0, embed_pdrob=0.0)
# the router aux losses on; the encoders' remat off in the comparisons with
# JAX (it changes no number; it costs a third more compile time), and
# held to the no-remat step bit for bit in test_remat_updates_batch_stats_once
LOSS_KW = dict(entropy_gamma=0.01, router_z_delta=0.001, encoder_remat=False)
B, IMG, T_TOK = 2, 64, 14


def _random_variables(agent, seed=0):
    """f32 numpy weights and statistics for a JAX agent (as
    tests/test_torch_slice.py makes them)."""
    shapes = jax.eval_shape(
        lambda k: agent.init_variables(k, image_hw=(IMG, IMG)),
        jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1].key)
        key = jax.tree_util.keystr(path)
        v = r.standard_normal(s.shape).astype(np.float32)
        if name == "var":
            out = r.uniform(0.5, 1.5, s.shape)
        elif name in ("g", "scale"):
            out = 1.0 + 0.1 * v
        elif name in ("mean", "bias"):
            out = 0.05 * v
        elif name == "kernel" and len(s.shape) == 4:
            out = v / np.sqrt(np.prod(s.shape[:3]))
        elif "router" in key:
            out = 0.5 * v
        else:
            out = 0.05 * v
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, {"params": shapes["params"],
               "batch_stats": shapes["batch_stats"]})


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# ---------------------------------------------------------------------------
# sigma densities
# ---------------------------------------------------------------------------

DENSITY_KW = {"split-lognormal": dict(loc=-0.5, scale_1=1.0, scale_2=0.5)}


def _jax_density_draws(kind, key, shape, n_values=None):
    if kind == "lognormal":
        return {"n": jax.random.normal(key, shape)}
    if kind == "split-lognormal":
        kn, ku = jax.random.split(key)
        return {"n": jax.random.normal(kn, shape),
                "u": jax.random.uniform(ku, shape)}
    if kind == "discrete":
        return {"idx": jax.random.randint(key, shape, 0, n_values)}
    return {"u": jax.random.uniform(key, shape, jnp.float32)}


@pytest.mark.parametrize("kind", jdens.SIGMA_DENSITIES)
def test_density_transform_matches_jax(kind):
    """Each density's transform of JAX's own draws equals the JAX density,
    and the port's draw-and-transform gives finite sigmas in range."""
    kw = dict(sigma_data=0.5, sigma_min=1e-3, sigma_max=80.0,
              num_sampling_steps=10, **DENSITY_KW.get(kind, {}))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jdens.make_sample_density(kind, **kw)(key, (257,)))
    tden = tdens.make_sample_density(kind, **kw)
    n_values = 10 * 100000 + 1 if kind == "discrete" else None
    draws = {k: torch.tensor(np.asarray(v)) for k, v in
             _jax_density_draws(kind, key, (257,), n_values).items()}
    got = tden.transform(draws).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    s = tden(torch.Generator().manual_seed(0), (512,))
    assert s.shape == (512,) and torch.isfinite(s).all() and (s > 0).all()


def test_gumbel_topk_and_denoiser_loss_match_jax():
    """gumbel_topk_sample on JAX's own Gumbel draw picks JAX's experts;
    denoiser_loss equals JAX's on the same model, actions, noise, sigma."""
    from mode_diffusion_policy_tpu.models.edm import precond as jprecond
    from mode_diffusion_policy_tpu.ops.primitives import \
        gumbel_topk_sample as jgumbel
    from mode_diffusion_policy_tpu_torch.models.edm import \
        precond as tprecond
    r = np.random.default_rng(13)
    logp = np.log(r.dirichlet(np.ones(4), size=(3, 14))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jgumbel(key, jnp.asarray(logp), 2))
    g = np.asarray(jax.random.gumbel(key, logp.shape, jnp.float32))
    got = gumbel_topk_sample(torch.tensor(logp), 2, gumbel=torch.tensor(g))
    np.testing.assert_array_equal(got.numpy(), want)
    w = r.standard_normal((7, 7)).astype(np.float32)
    act = r.standard_normal((3, 10, 7)).astype(np.float32)
    noise = r.standard_normal((3, 10, 7)).astype(np.float32)
    sigma = np.array([0.01, 1.0, 40.0], np.float32)
    jl, _ = jprecond.denoiser_loss(
        lambda s, a, g_, sg: a @ jnp.asarray(w) + s, 0.5, jnp.asarray(act),
        None, jnp.asarray(noise), jnp.asarray(sigma))
    tl, _ = tprecond.denoiser_loss(
        lambda s, a, g_, sg: a @ torch.tensor(w) + s, 0.5, torch.tensor(act),
        None, torch.tensor(noise), torch.tensor(sigma))
    assert _rel(float(tl), float(jl)) <= 1e-6


def test_grouped_moe_matches_jax_and_dense():
    """moe_ffn_topk_grouped (use_grouped_moe; sorted pairs, one product per
    expert) equals JAX's ragged_dot version and the dense MoE, values and
    gradients, with an expert no pair selects."""
    from mode_diffusion_policy_tpu.ops.moe import \
        moe_ffn_topk_grouped as jgrouped
    from mode_diffusion_policy_tpu_torch.ops.moe import (
        moe_ffn_dense, moe_ffn_topk_grouped)
    r = np.random.default_rng(14)
    B_, T_, D, H, E = 3, 5, 16, 32, 4
    x = r.standard_normal((B_, T_, D)).astype(np.float32)
    idx = np.stack([r.choice(3, 2, replace=False) for _ in range(B_ * T_)]
                   ).reshape(B_, T_, 2).astype(np.int32)    # expert 3 unused
    p = r.dirichlet(np.ones(2), size=(B_, T_)).astype(np.float32)
    w1 = (r.standard_normal((E, D, 2 * H)) * 0.2).astype(np.float32)
    b1 = (r.standard_normal((E, 2 * H)) * 0.1).astype(np.float32)
    w2 = (r.standard_normal((E, H, D)) * 0.2).astype(np.float32)
    want = np.asarray(jgrouped(*map(jnp.asarray, (x, p, idx, w1, b1, w2))))
    tw = [torch.tensor(a, requires_grad=True) for a in (w1, b1, w2)]
    got = moe_ffn_topk_grouped(torch.tensor(x), torch.tensor(p),
                               torch.tensor(idx), *tw)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-6,
                               rtol=1e-5)
    dense_p = torch.zeros(B_, T_, E).scatter(-1, torch.tensor(idx).long(),
                                             torch.tensor(p))
    tw2 = [torch.tensor(a, requires_grad=True) for a in (w1, b1, w2)]
    dense = moe_ffn_dense(torch.tensor(x), dense_p, *tw2)
    np.testing.assert_allclose(got.detach().numpy(), dense.detach().numpy(),
                               atol=2e-6, rtol=1e-5)
    got.square().sum().backward()
    dense.square().sum().backward()
    for a, b in zip(tw, tw2):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=1e-5, rtol=1e-4)
    assert float(tw[0].grad[3].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# augmentations
# ---------------------------------------------------------------------------

def _jitter_draws(key, B_, brightness=0.3, contrast=0.3, saturation=0.3,
                  hue=0.1):
    k_b, k_c, k_s, k_h, k_o = jax.random.split(key, 5)
    shp = (B_, 1, 1, 1)
    u = jax.random.uniform
    d = {"fb": u(k_b, shp, minval=max(0.0, 1 - brightness),
                 maxval=1 + brightness),
         "fc": u(k_c, shp, minval=max(0.0, 1 - contrast), maxval=1 + contrast),
         "fs": u(k_s, shp, minval=max(0.0, 1 - saturation),
                 maxval=1 + saturation),
         "fh": u(k_h, (B_, 1, 1), minval=-hue, maxval=hue),
         "perm": jax.random.permutation(k_o, 4)}
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _erasing_draws(key, B_, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                   attempts=10):
    k_apply, k_cand = jax.random.split(key)
    ks = jax.random.split(k_cand, 4)
    u = jax.random.uniform
    d = {"area": u(ks[0], (B_, attempts), minval=scale[0], maxval=scale[1]),
         "log_r": u(ks[1], (B_, attempts), minval=math.log(ratio[0]),
                    maxval=math.log(ratio[1])),
         "u_i": u(ks[2], (B_,)), "u_j": u(ks[3], (B_,)),
         "apply": u(k_apply, (B_,))}
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _imgs(seed, shape=(6, 24, 24, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_random_shift_matches_jax():
    x = _imgs(0) * 255
    key = jax.random.PRNGKey(1)
    want = np.asarray(jimg.random_shift_aug(key, jnp.asarray(x), 4))
    shifts = torch.tensor(np.asarray(jax.random.randint(key, (6, 2), 0, 9)))
    got = timg.random_shift_aug(torch.tensor(x), 4, shifts).numpy()
    np.testing.assert_array_equal(got, want)


def test_noise_augmentations_match_jax():
    x = _imgs(1)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jimg.add_gaussian_noise(key, jnp.asarray(x), 0.1, 0.5))
    n = torch.tensor(np.asarray(jax.random.normal(key, x.shape)))
    got = timg.add_gaussian_noise(torch.tensor(x), n, 0.1, 0.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    want = np.asarray(jimg.add_depth_noise(key, jnp.asarray(x), 1000.0,
                                           1000.0))
    g = torch.tensor(np.asarray(jax.random.gamma(key, 1000.0)))
    got = timg.add_depth_noise(torch.tensor(x), g, 1000.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert 0.8 < float(timg.draw_depth_gamma(torch.Generator().manual_seed(0))
                       ) / 1000.0 < 1.2


def test_hsv_round_trip_matches_jax():
    x = _imgs(3)
    hsv = np.asarray(jimg.rgb_to_hsv(jnp.asarray(x)))
    np.testing.assert_allclose(timg.rgb_to_hsv(torch.tensor(x)).numpy(), hsv,
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        timg.hsv_to_rgb(torch.tensor(hsv)).numpy(),
        np.asarray(jimg.hsv_to_rgb(jnp.asarray(hsv))), atol=1e-6, rtol=1e-6)
    gray = np.asarray(jimg.rgb_to_grayscale(jnp.asarray(x)))
    np.testing.assert_allclose(timg.rgb_to_grayscale(torch.tensor(x)).numpy(),
                               gray, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter_matches_jax(seed):
    """Factors per image, one op order per call: each seed draws another
    order."""
    x = _imgs(10 + seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jimg.color_jitter(key, jnp.asarray(x)))
    got = timg.color_jitter(torch.tensor(x), _jitter_draws(key, 6)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_random_erasing_matches_jax():
    x = _imgs(4, (16, 24, 24, 3))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jimg.random_erasing(key, jnp.asarray(x), p=0.7))
    got = timg.random_erasing(torch.tensor(x), _erasing_draws(key, 16),
                              p=0.7).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any()


def test_word_dropout_and_action_transforms_match_jax():
    r = np.random.default_rng(6)
    lang = r.standard_normal((4, 1, 32)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jimg.random_word_dropout(key, jnp.asarray(lang), 0.3))
    u = torch.tensor(np.asarray(jax.random.uniform(key, lang.shape)))
    np.testing.assert_array_equal(
        timg.random_word_dropout(torch.tensor(lang), u, 0.3).numpy(), want)
    act = r.standard_normal((3, 10, 7)).astype(np.float32)
    obs = r.standard_normal((3, 10, 15)).astype(np.float32) * 0.02
    np.testing.assert_allclose(
        timg.relative_actions(torch.tensor(act), torch.tensor(obs)).numpy(),
        np.asarray(jimg.relative_actions(jnp.asarray(act), jnp.asarray(obs))),
        atol=1e-6, rtol=1e-6)
    std = np.array([1.0, 0.0, 2.0], np.float32)
    np.testing.assert_allclose(
        timg.normalize_vector(torch.tensor(act[..., :3]), 0.5, std).numpy(),
        np.asarray(jimg.normalize_vector(jnp.asarray(act[..., :3]), 0.5,
                                         std)), atol=1e-6, rtol=1e-6)


def test_preprocess_camera_train_matches_jax():
    """The whole train pipeline on uint8 frames [B, T, H, W, 3] (shift,
    colour jitter, erasing, normalize; the resize is the identity here)."""
    u8 = np.random.default_rng(7).integers(0, 256, (3, 2, 24, 24, 3),
                                           dtype=np.uint8)
    key = jax.random.PRNGKey(8)
    jit_kw = dict(brightness=0.3, contrast=0.3, saturation=0.3, hue=0.1)
    er_kw = dict(p=0.7, scale=(0.02, 0.33), ratio=(0.3, 3.3), value=0.0)
    want = np.asarray(jimg.preprocess_camera(
        key, jnp.asarray(u8), size=24, shift_pad=4, train=True,
        jitter=jit_kw, erasing=er_kw))
    k_shift, k_jit, k_erase = jax.random.split(key, 3)
    draws = {"shifts": torch.tensor(np.asarray(
        jax.random.randint(k_shift, (6, 2), 0, 9))),
        "jitter": _jitter_draws(k_jit, 6, **jit_kw),
        "erasing": _erasing_draws(k_erase, 6)}
    got = timg.preprocess_camera(torch.tensor(u8), size=24, shift_pad=4,
                                 train=True, jitter=jit_kw, erasing=er_kw,
                                 draws=draws).numpy()
    # to 1e-6 on the [0, 1] pixel scale the augmentations work on (the
    # normalization divides by the CLIP std, about 0.27)
    std = np.asarray(timg.CLIP_STD, np.float32)
    np.testing.assert_allclose(got * std, want * std, atol=1e-6, rtol=1e-6)
    drawn = timg.preprocess_camera(torch.tensor(u8), size=24, shift_pad=4,
                                   train=True, jitter=jit_kw, erasing=er_kw,
                                   generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 2, 24, 24, 3) and torch.isfinite(drawn).all()


# ---------------------------------------------------------------------------
# encoders in train mode
# ---------------------------------------------------------------------------

COND = 32


def _encoder_case(norm):
    mod = jres.FiLMResNetPolicy(COND, depth=50, norm=norm)
    shapes = jax.eval_shape(lambda k: mod.init(
        k, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, COND))),
        jax.random.PRNGKey(0))
    r = np.random.default_rng(11)

    def fill(path, s):
        name = str(path[-1].key)
        v = r.standard_normal(s.shape)
        out = (r.uniform(0.5, 1.5, s.shape) if name == "var" else
               1.0 + 0.1 * v if name == "scale" else
               0.05 * v if name in ("mean", "bias") else
               v / np.sqrt(np.prod(s.shape[:3])) if len(s.shape) == 4 else
               0.05 * v)
        return np.asarray(out, np.float32)

    v = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    x = r.standard_normal((4, IMG, IMG, 3)).astype(np.float32)
    c = r.standard_normal((4, COND)).astype(np.float32)
    return mod, v, x, c


def _jax_encoder(norm, v, x, c, dtype):
    mod = jres.FiLMResNetPolicy(COND, depth=50, norm=norm, dtype=dtype)
    vv = jax.tree.map(lambda a: jnp.asarray(a, dtype), v)
    out, upd = jax.jit(lambda vv, x, c: mod.apply(
        vv, x, c, train=True, mutable=["batch_stats"]))(
            vv, jnp.asarray(x, dtype), jnp.asarray(c, dtype))
    stats = port_tree(jax.tree.map(np.asarray, upd.get("batch_stats", {})))
    return np.asarray(out, np.float64), {k: t.double().numpy()
                                         for k, t in stats.items()}


def _port_encoder(norm, v, x, c, dtype):
    mod = tres.FiLMResNetPolicy(COND, 50, dtype, device="cpu", norm=norm)
    mod.load_state_dict(resnet_state_dict(v["params"],
                                          v.get("batch_stats", {})))
    mod = mod.to(dtype)
    with tres.batch_stats_updates(mod) as sink:
        out = mod(torch.tensor(x).to(dtype), torch.tensor(c).to(dtype), True)
    return out.detach().double().numpy(), {k: t.double().numpy()
                                           for k, t in sink.items()}


def _maxrel(a, b, scale):
    return float(np.abs(a - b).max() / scale)


@pytest.fixture(scope="module", params=["batch", "group"])
def encoder_runs(request):
    norm = request.param
    _, v, x, c = _encoder_case(norm)
    j32 = _jax_encoder(norm, v, x, c, jnp.float32)
    with jax.enable_x64():
        j64 = _jax_encoder(norm, v, x, c, jnp.float64)
    p32 = _port_encoder(norm, v, x, c, torch.float32)
    p64 = _port_encoder(norm, v, x, c, torch.float64)
    return norm, j32, j64, p32, p64


def test_encoder_train_mode_f64_is_jax_x64(encoder_runs):
    """In float64 the port's train-mode encoder is JAX's: the features to
    1e-9, and for BatchNorm the updated running statistics of all 53
    layers to f32 rounding (flax keeps them in f32 even under x64)."""
    norm, _, (jf, js), _, (pf, ps) = encoder_runs
    assert _maxrel(pf, jf, np.abs(jf).max()) <= 1e-9
    assert set(ps) == set(js) and (norm == "group") == (not js)
    for k in js:
        np.testing.assert_allclose(ps[k], js[k], rtol=2 ** -23, atol=0,
                                   err_msg=k)


def test_encoder_train_mode_f32_matches_jax(encoder_runs):
    """f32 features and updated statistics within 2e-5 of JAX's, or within
    twice JAX's own f32-vs-f64 distance (module docstring)."""
    norm, (jf, js), (jf64, js64), (pf, ps), _ = encoder_runs
    sc = np.abs(jf64).max()
    print(f"{norm} encoder features, max error / max |f64|: port-vs-JAX "
          f"{_maxrel(pf, jf, sc):.2e}, JAX f32-vs-f64 "
          f"{_maxrel(jf, jf64, sc):.2e}, port f32-vs-f64 "
          f"{_maxrel(pf, jf64, sc):.2e}")
    assert _maxrel(pf, jf, sc) <= max(2e-5, 2 * _maxrel(jf, jf64, sc))
    for k in js:
        sc = np.abs(js64[k]).max()
        assert _maxrel(ps[k], js[k], sc) <= max(
            2e-5, 2 * _maxrel(js[k], js64[k], sc)), k


def test_remat_updates_batch_stats_once():
    """With encoder_remat the encoders run twice per step (forward, and
    again in the backward pass), but the running statistics move once:
    they equal the no-remat step's, bit for bit, and 0.9 * old + 0.1 *
    batch, not that applied twice."""
    cfg = dict(latent_dim=64, n_layers=1, n_heads=2, cond_dim=16, **NO_DROP)
    r = np.random.default_rng(12)
    batch = {"rgb_static": torch.tensor(r.standard_normal((2, 1, 32, 32, 3)),
                                        dtype=torch.float32),
             "rgb_gripper": torch.tensor(r.standard_normal((2, 1, 32, 32, 3)),
                                         dtype=torch.float32),
             "actions": torch.tensor(r.standard_normal((2, 10, 7)),
                                     dtype=torch.float32),
             "lang_emb": torch.tensor(r.standard_normal((2, 1, 16)),
                                      dtype=torch.float32)}
    stats = {}
    for remat in (True, False):
        agent = TAgent(TCfg(encoder_remat=remat, **cfg), device="cpu")
        before = {n: b.clone() for n, b in agent.named_buffers()
                  if n.endswith((".mean", ".var"))}
        x = batch["rgb_static"].reshape(2, 32, 32, 3)
        with tres.batch_stats_updates(agent.static_resnet, "static_resnet."
                                      ) as once:
            agent.static_resnet(x, batch["lang_emb"][:, 0], True)
        opt, _ = topt.make_optimizer(dict(agent.named_parameters()),
                                     use_lr_scheduler=False)
        state = TrainState.create(agent, opt,
                                  torch.Generator().manual_seed(0))
        step = make_train_step(agent, opt, device="cpu")
        step(state, batch)
        stats[remat] = {n: t.clone() for n, t in state.batch_stats.items()}
        for n, t in once.items():
            assert torch.equal(stats[remat][n], t), n
            assert not torch.equal(t, before[n]), n
    for n in stats[True]:
        assert torch.equal(stats[True][n], stats[False][n]), n


# ---------------------------------------------------------------------------
# training_loss, its gradients, the train step
# ---------------------------------------------------------------------------

def _batch(seed=3):
    r = np.random.default_rng(seed)
    return dict(
        rgb_static=r.standard_normal((B, 1, IMG, IMG, 3)).astype(np.float32),
        rgb_gripper=r.standard_normal((B, 1, IMG, IMG, 3)).astype(np.float32),
        actions=(r.standard_normal((B, 10, 7)) * 0.3).astype(np.float32),
        lang_emb=r.standard_normal((B, 1, COND)).astype(np.float32))


@pytest.fixture(scope="module")
def patched_draws():
    """The JAX loss's draws made constants: its sample density returns
    ``sigma``, its normal draw of the actions' shape returns ``noise``, and
    its Gumbel top-k adds layer i's ``gumbel[i]`` (the same every step)."""
    r = np.random.default_rng(21)
    d = {"sigma": np.array([0.05, 3.0], np.float32),
         "noise": r.standard_normal((B, 10, 7)).astype(np.float32),
         "gumbel": [r.gumbel(size=(B, T_TOK, 4)).astype(np.float32)
                    for _ in range(DIMS["n_layers"])]}
    mp = pytest.MonkeyPatch()
    calls = []

    def gumbel_topk(key, log_probs, k):
        g = d["gumbel"][len(calls) % DIMS["n_layers"]]
        calls.append(1)
        return jax.lax.top_k(log_probs + jnp.asarray(g, log_probs.dtype), k)[1]

    normal = jax.random.normal

    def fake_normal(key, shape=(), dtype=None):
        if tuple(shape) == (B, 10, 7):
            return jnp.asarray(d["noise"], dtype or jnp.float32)
        return normal(key, shape, dtype or jnp.float32)

    mp.setattr(jmodedit, "gumbel_topk_sample", gumbel_topk)
    mp.setattr(jax.random, "normal", fake_normal)
    yield d
    mp.undo()


def _port_draws(d, dtype=torch.float32):
    return {"sigma": torch.tensor(d["sigma"]).to(dtype),
            "noise": torch.tensor(d["noise"]).to(dtype),
            "gumbel": [torch.tensor(g).to(dtype) for g in d["gumbel"]]}


def _jax_agent(dtype, **extra):
    agent = JAgent(JCfg(resnet_type="50", dtype=dtype, **DIMS, **extra))
    return agent


def _jax_loss_and_grads(v, batch, d, dtype, **extra):
    agent = _jax_agent(dtype, **NO_DROP, **LOSS_KW, **extra)
    agent.sample_density = lambda k, s: jnp.asarray(d["sigma"], dtype)
    vv = jax.tree.map(lambda a: jnp.asarray(a, dtype), v)

    def lf(params):
        return agent.training_loss(
            {"params": params, "batch_stats": vv["batch_stats"]},
            jax.tree.map(lambda a: jnp.asarray(a, dtype), batch),
            jax.random.PRNGKey(5))

    (loss, (m, bs)), g = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        vv["params"])
    host = lambda t: {k: np.asarray(x, np.float64)  # noqa: E731
                      for k, x in t.items()}
    return (float(loss), host(m), _np(bs), _np(g))


def _np(tree):
    """A JAX tree -> {port name: float64 numpy array}."""
    return {k: t.double().numpy()
            for k, t in port_tree(jax.tree.map(np.asarray, tree)).items()}


def _port_loss_and_grads(v, batch, d, dtype):
    agent = from_jax_params(v, TCfg(dtype=dtype, **DIMS, **NO_DROP, **LOSS_KW),
                            device="cpu")
    agent = agent.to(dtype)
    tb = {k: torch.tensor(x).to(dtype) for k, x in batch.items()}
    loss, (m, bs) = agent.training_loss(tb, None, **_port_draws(d, dtype))
    loss.backward()
    return (float(loss.detach()), {k: x.detach().double().numpy() for k, x in
                                   m.items()},
            {k: t.double().numpy() for k, t in bs.items()},
            {n: p.grad.double().numpy() for n, p in agent.named_parameters()})


@pytest.fixture(scope="module")
def loss_runs(patched_draws):
    jagent = _jax_agent(jnp.float32)
    v = _random_variables(jagent)
    batch = _batch()
    d = patched_draws
    j32 = _jax_loss_and_grads(v, batch, d, jnp.float32)
    with jax.enable_x64():
        j64 = _jax_loss_and_grads(v, batch, d, jnp.float64)
    p32 = _port_loss_and_grads(v, batch, d, torch.float32)
    p64 = _port_loss_and_grads(v, batch, d, torch.float64)
    return v, batch, j32, j64, p32, p64


def test_training_loss_matches_jax(loss_runs):
    """f32: the total loss within 2e-5 relative (or the floor rule), the
    action loss likewise, load_balancing_loss and router_z_loss within
    2e-5, expert_counts equal."""
    _, _, (jl, jm, _, _), (jl64, jm64, _, _), (pl, pm, _, _), _ = loss_runs
    assert _rel(pl, jl) <= max(2e-5, 2 * _rel(jl, jl64)), (pl, jl, jl64)
    for k in ("train/load_balancing_loss", "train/router_z_delta"):
        assert _rel(pm[k], jm[k]) <= 2e-5, k
    np.testing.assert_array_equal(pm["expert_counts"], jm["expert_counts"])
    assert pm["expert_counts"].sum() == B * T_TOK * 2 * DIMS["n_layers"]


def test_training_loss_f64_is_jax_x64(loss_runs):
    """In float64 the loss is JAX's within 1e-6 and every gradient leaf
    within 1e-5 relative L2 (leaves whose gradient is zero to rounding,
    the zero-init FiLM layers' beta biases, within 1e-12 absolute)."""
    _, _, _, (jl, _, jbs, jg), _, (pl, _, pbs, pg) = loss_runs
    assert _rel(pl, jl) <= 1e-6
    assert set(pg) == set(jg)
    top = max(np.linalg.norm(g) for g in jg.values())
    for n, g in jg.items():
        nrm = np.linalg.norm(g)
        if nrm < 1e-9 * top:
            assert np.abs(pg[n] - g).max() <= 1e-12, n
        else:
            assert np.linalg.norm(pg[n] - g) / nrm <= 1e-5, n
    for n, s in jbs.items():
        # flax keeps the running statistics in f32 even under x64
        np.testing.assert_allclose(pbs[n], s, rtol=2 ** -23, atol=0,
                                   err_msg=n)


def test_training_loss_grads_match_jax(loss_runs):
    """f32, every gradient leaf: within atol 1e-5 / rtol 1e-4 of JAX's, or
    with an f32 error (the L2 distance from the float64 gradient) of JAX's
    own order: at most 4x JAX's on each such leaf, and at most 2x over all
    of them together (sums of squares). JAX's f32 gradients are 1.5-2e-4
    (relative L2) from its float64 ones on the DiT's leaves and up to tens
    of percent on the encoders' (module docstring), more than the stated
    rtol; the float64 comparison above holds every leaf to 1e-5."""
    _, _, (_, _, jbs, jg), (_, _, jbs64, jg64), (_, _, pbs, pg), _ = \
        loss_runs
    port_err = jax_err = 0.0
    ratios = {}
    for n, j in jg.items():
        p, j64 = pg[n], jg64[n]
        if np.all(np.abs(p - j) <= 1e-5 + 1e-4 * np.abs(j)):
            continue
        pe, je = np.linalg.norm(p - j64), np.linalg.norm(j - j64)
        ratios[n] = pe / je
        port_err, jax_err = port_err + pe ** 2, jax_err + je ** 2
    dit = [float(np.linalg.norm(jg[n] - jg64[n]) / np.linalg.norm(jg64[n]))
           for n in jg if n.startswith("inner_model.")
           and np.linalg.norm(jg64[n]) > 0]
    print(f"gradient leaves on the floor rule: {len(ratios)} of {len(jg)}, "
          f"worst f32-error ratio port/JAX {max(ratios.values()):.2f}, over "
          f"all {(port_err / jax_err) ** 0.5:.2f}; JAX's own f32 DiT leaves "
          f"{min(dit):.1e}-{max(dit):.1e} from float64 (relative L2)")
    assert all(r <= 4.0 for r in ratios.values()), ratios
    assert port_err <= 4 * jax_err, (port_err, jax_err)
    for n, s in jbs.items():
        s64 = jbs64[n]
        sc = np.abs(s64).max()
        assert _maxrel(pbs[n], s, sc) <= max(
            2e-5, 2 * _maxrel(s, s64, sc)), n


def _jax_train(v, batch, d, dtype, steps):
    """``steps`` JAX train steps (jitted, params in ``dtype``, FusedAdamWEma
    with the shipped settings but a short schedule) from ``v``; the state
    after step 1 and after the last, as numpy trees."""
    agent = _jax_agent(dtype, **NO_DROP, **LOSS_KW)
    agent.sample_density = lambda k, s: jnp.asarray(d["sigma"], dtype)
    vv = jax.tree.map(lambda a: jnp.asarray(a, dtype), v)
    opt, _ = jopt.make_optimizer(vv["params"], **OPT_KW)
    state = JState.create(vv, opt, jax.random.PRNGKey(1))
    step = jax.jit(jmake_step(agent, opt, log_grad_norms=False))
    jb = jax.tree.map(lambda a: jnp.asarray(a, dtype), batch)
    out = {}
    for i in range(steps):
        state, _ = step(state, jb)
        if i + 1 in (1, steps):
            out[i + 1] = jax.tree.map(np.asarray, state)
    return out


OPT_KW = dict(learning_rate=3e-3, total_steps=100)


def _port_train(v, batch, d, dtype):
    """Three port train steps from the JAX state of ``v``, carried over by
    ``from_jax_train_state``; the state after step 1 and after step 3 as
    float64 numpy dicts."""
    agent, state = from_jax_train_state(
        _initial_jax_state(v), TCfg(dtype=dtype, **DIMS, **NO_DROP, **LOSS_KW),
        device="cpu")
    if dtype == torch.float64:
        agent.double()
        state = TrainState.create(agent, topt.make_optimizer(
            dict(agent.named_parameters()), **OPT_KW)[0],
            torch.Generator().manual_seed(0))
    opt, _ = topt.make_optimizer(dict(agent.named_parameters()), **OPT_KW)
    step = make_train_step(agent, opt, log_grad_norms=False, device="cpu")
    tb = {k: torch.tensor(x).to(dtype) for k, x in batch.items()}
    out = {}
    for i in range(3):
        step(state, tb, draws=_port_draws(d, dtype))
        if i + 1 in (1, 3):
            out[i + 1] = {
                "params": {n: t.detach().double().numpy().copy()
                           for n, t in state.params.items()},
                "mu": {n: t.double().numpy().copy() for n, t in
                       state.opt_state.mu.items()},
                "nu": {n: t.double().numpy().copy() for n, t in
                       state.opt_state.nu.items()},
                "ema": {n: t.double().numpy().copy() for n, t in
                        state.ema_params.items()},
                "count": state.opt_state.count, "step": state.step}
    return out


@pytest.fixture(scope="module")
def train_runs(loss_runs, patched_draws):
    """JAX's train steps in f32 and in float64 (``jax.enable_x64``, the
    reference), and the port's in f32 and in float64, all from the same
    carried-over state."""
    v, batch, *_ = loss_runs
    d = patched_draws
    j32 = _jax_train(v, batch, d, jnp.float32, 3)
    with jax.enable_x64():
        j64 = _jax_train(v, batch, d, jnp.float64, 3)
    return (v, j32, j64, _port_train(v, batch, d, torch.float64),
            _port_train(v, batch, d, torch.float32))


def _initial_jax_state(v):
    """A fresh JAX TrainState of ``v`` (f32, FusedAdamWEma's zero moments),
    as numpy leaves."""
    opt, _ = jopt.make_optimizer(v["params"], **OPT_KW)
    st = JState.create(jax.tree.map(jnp.asarray, v), opt,
                       jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, st)


def _tree(js, what):
    t = {"params": js.params, "ema": js.ema_params, "mu": js.opt_state.mu,
         "nu": js.opt_state.nu}[what]
    return {n: x.double().numpy() for n, x in port_tree(t).items()}


def _off_fraction(got, want, atol=1e-6):
    off = total = 0
    for n, w in want.items():
        d = np.abs(got[n] - w)
        off += int((d > atol).sum())
        total += d.size
    return off / total


def _part_rel(got, want, dit):
    """Relative L2 distance of ``got`` from ``want`` over the DiT's leaves
    (``dit``) or the encoders'."""
    names = [n for n in want if n.startswith("inner_model.") == dit]
    num = sum(np.linalg.norm(got[n] - want[n]) ** 2 for n in names)
    return (num / sum(np.linalg.norm(want[n]) ** 2 for n in names)) ** 0.5


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_jax(train_runs, steps):
    """After one and after three steps from the same carried-over state,
    against JAX's float64 train step: the summed update of the params and
    of the EMA (the state minus the initial params), mu and nu, each as a
    relative L2 distance over the DiT's leaves and over the encoders'.
    - The port's float64 step lies at most half as far from it as JAX's
      own f32 step does (measured: at most 0.13 of JAX's distance).
    - The port's f32 step lies at most twice as far (the floor rule;
      measured 0.3 to 1.1 times).
    JAX's f32 distances are 2e-4 to 0.85 (the three steps part where the
    encoders' ill-conditioned gradients change sign), so a zero or a
    negated gradient, at a distance of 1 or 2, fails the float64 rule.
    The params also stay everywhere within 2 * lr * steps of JAX's f32
    ones, Adam's per-step bound (printed: the share off by more than
    1e-6, JAX's own f32 share beside it)."""
    v, j32, j64, p64, port = train_runs
    js, ps = j32[steps], port[steps]
    assert ps["count"] == int(js.opt_state.count) == steps == ps["step"]
    assert p64[steps]["count"] == int(j64[steps].opt_state.count) == steps
    p0 = _np(v["params"])
    for what in ("params", "ema", "mu", "nu"):
        want64 = _tree(j64[steps], what)
        runs = {"jax_f32": _tree(js, what), "port_f64": p64[steps][what],
                "port_f32": ps[what], "ref": want64}
        if what in ("params", "ema"):
            runs = {k: {n: x[n] - p0[n] for n in p0}
                    for k, x in runs.items()}
        for dit in (True, False):
            d = {k: _part_rel(runs[k], runs["ref"], dit)
                 for k in ("jax_f32", "port_f64", "port_f32")}
            print(f"{what} after {steps} step(s), "
                  f"{'DiT' if dit else 'encoders'}: distance from JAX "
                  f"float64 " + ", ".join(f"{k} {x:.2e}"
                                          for k, x in d.items()))
            assert d["port_f64"] <= 0.5 * d["jax_f32"], (what, dit, d)
            assert d["port_f32"] <= 2 * d["jax_f32"], (what, dit, d)
    want = _tree(js, "params")
    for n, w in want.items():
        assert np.abs(ps["params"][n] - w).max() <= \
            2 * OPT_KW["learning_rate"] * steps, n
    print(f"params after {steps} step(s), share off by > 1e-6: port-vs-JAX "
          f"{_off_fraction(ps['params'], want):.4f}, JAX f32-vs-float64 "
          f"{_off_fraction(want, _tree(j64[steps], 'params')):.4f}")


@pytest.fixture(scope="module")
def bf16_runs(loss_runs, patched_draws):
    """The bf16 compute dtype (f32 parameters cast where they are used), on
    the loss test's weights, batch and draws: JAX's loss and gradient and
    the port's, the gradients as float64 numpy by port name."""
    v, batch, *_ = loss_runs
    d = patched_draws
    agent = _jax_agent(jnp.bfloat16, **NO_DROP, **LOSS_KW)
    agent.sample_density = lambda k, s: jnp.asarray(d["sigma"])
    vv = jax.tree.map(jnp.asarray, v)

    def lf(params):
        return agent.training_loss(
            {"params": params, "batch_stats": vv["batch_stats"]},
            jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(5))[0]

    jl16, jg16 = jax.jit(jax.value_and_grad(lf))(vv["params"])
    tagent = from_jax_params(v, TCfg(dtype=torch.bfloat16, **DIMS, **NO_DROP,
                                     **LOSS_KW), device="cpu")
    tl, _ = tagent.training_loss(
        {k: torch.tensor(x) for k, x in batch.items()}, None,
        **_port_draws(d))
    tl.backward()
    return (float(jl16), _np(jg16), float(tl.detach()),
            {n: p.grad.double().numpy() for n, p in tagent.named_parameters()})


def test_bf16_compute_loss_matches_jax(loss_runs, bf16_runs):
    """The bf16 compute dtype (f32 parameters cast where they are used):
    the loss within max(1e-3, 2 x |JAX bf16 - JAX f32|) relative of JAX's
    bf16 loss (JAX's f32 loss: the loss test's run, same weights, batch
    and draws)."""
    jl32 = loss_runs[2][0]
    jl16, _, tl, _ = bf16_runs
    gate = max(1e-3, 2 * _rel(jl16, jl32))
    assert _rel(tl, jl16) <= gate, (tl, jl16, jl32)


def test_bf16_compute_grads_match_jax(loss_runs, bf16_runs):
    """The bf16 compute dtype's gradient, leaf by leaf, against JAX's bf16
    gradient by the f32 gradient test's floor rule: within atol 1e-5 /
    rtol 1e-4 of JAX's, or with an error (the L2 distance from JAX's
    float64 gradient) at most 4x JAX's own bf16 error on each such leaf,
    and at most 2x over all of them, the DiT's leaves and the encoders'
    each on their own. At this size JAX's own bf16 gradient lies 0.22
    (DiT) and 1.40 (encoders) from float64 (relative L2; measured 1.18x
    and 1.05x that for the port): the DiT's total rule fails a zero or a
    negated gradient, the encoders' cannot (their bf16 gradients at a
    random init are rounding noise in both packages, as at 224 px:
    ``scripts/train_grad_precision.py``); the f32 and float64 tests hold
    the encoders' gradient."""
    jg64 = loss_runs[3][3]
    _, jg16, _, pg16 = bf16_runs
    assert set(pg16) == set(jg16) == set(jg64)
    for dit in (True, False):
        port_err = jax_err = ref = 0.0
        ratios = {}
        for n, j in jg16.items():
            if n.startswith("inner_model.") != dit:
                continue
            p, j64 = pg16[n], jg64[n]
            ref += np.linalg.norm(j64) ** 2
            if np.all(np.abs(p - j) <= 1e-5 + 1e-4 * np.abs(j)):
                continue
            pe, je = np.linalg.norm(p - j64), np.linalg.norm(j - j64)
            ratios[n] = pe / je
            port_err, jax_err = port_err + pe ** 2, jax_err + je ** 2
        print(f"bf16 gradient, {'DiT' if dit else 'encoders'}: "
              f"{len(ratios)} leaves on the floor rule, worst ratio port/JAX "
              f"{max(ratios.values()):.2f}, over all "
              f"{(port_err / jax_err) ** 0.5:.2f}; distance from float64 "
              f"port {(port_err / ref) ** 0.5:.3f}, JAX "
              f"{(jax_err / ref) ** 0.5:.3f}")
        assert all(r <= 4.0 for r in ratios.values()), ratios
        assert port_err <= 4 * jax_err, (dit, port_err, jax_err)
    # the DiT's rule is one that a zero gradient fails
    dit_names = [n for n in jg64 if n.startswith("inner_model.")]
    jax_dit = (sum(np.linalg.norm(jg16[n] - jg64[n]) ** 2 for n in dit_names)
               / sum(np.linalg.norm(jg64[n]) ** 2 for n in dit_names)) ** 0.5
    assert 2 * jax_dit < 1.0, jax_dit


def test_validation_denoise_matches_jax(loss_runs, patched_draws):
    """validation_denoise (the raw encoders on their running statistics,
    the 10-step schedule, MSE against the batch's actions) equals JAX's on
    the same initial noise."""
    v, batch, *_ = loss_runs
    d = patched_draws
    agent = _jax_agent(jnp.float32, **NO_DROP, **LOSS_KW)
    jpred, jm = jax.jit(agent.validation_denoise)(
        jax.tree.map(jnp.asarray, v), jax.tree.map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    tagent = from_jax_params(v, TCfg(**DIMS, **NO_DROP, **LOSS_KW),
                             device="cpu")
    tpred, tm = tagent.validation_denoise(
        {k: torch.tensor(x) for k, x in batch.items()},
        noise=torch.tensor(d["noise"]))
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=1e-4,
                               rtol=1e-4)
    assert _rel(float(tm["val_act/lang_act_loss_pp"]),
                float(jm["val_act/lang_act_loss_pp"])) <= 1e-4


# ---------------------------------------------------------------------------
# rates of the random parts
# ---------------------------------------------------------------------------

def _within_5_sigma(k, n, p):
    return abs(k - n * p) <= 5 * math.sqrt(n * p * (1 - p))


def test_dropout_and_goal_drop_rates(monkeypatch):
    """One train forward of the DiT with the shipped rates: the attention
    dropout (0.3, on the [B,H,T,T] probabilities) and the expert dropout
    (0.1, on the [E,B,T,2H/2] activations) zero their rate of elements and
    scale the rest by 1 / (1 - rate); the goal drop (0.1) zeros its rate
    of goal elements."""
    seen = []

    def recording(x, rate, generator):
        out = dropout(x, rate, generator)
        if rate > 0:
            seen.append((rate, tuple(x.shape), out.detach(), x.detach()))
        return out

    monkeypatch.setattr(tmodedit, "dropout", recording)
    cfg = TCfg(latent_dim=64, n_layers=2, n_heads=2, cond_dim=16)
    agent = TAgent(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    Bn = 64
    states = {"state_images": torch.randn(Bn, 2, 2048, generator=gen)}
    agent.inner_model(states, torch.randn(Bn, 10, 7, generator=gen),
                      torch.randn(Bn, 1, 16, generator=gen),
                      torch.rand(Bn, generator=gen) + 0.1, train=True,
                      generator=gen)
    rates = sorted({(r, s) for r, s, _, _ in seen})
    assert rates == sorted({(0.3, (Bn, 2, T_TOK, T_TOK)),
                            (0.1, (4, Bn, T_TOK, 4 * 64))})
    for rate, _, out, x in seen:
        nz = x != 0
        dropped = int(((out == 0) & nz).sum())
        assert _within_5_sigma(dropped, int(nz.sum()), rate), (rate, dropped)
        kept = (out != 0) & nz
        scale = torch.tensor(1.0 - rate, dtype=x.dtype)
        assert torch.equal(out[kept], x[kept] / scale)
    goals = torch.ones(4096, 1, 16)
    dropped = agent.inner_model.preprocess_goals(goals, True, gen)
    assert _within_5_sigma(int((dropped == 0).sum()), goals.numel(), 0.1)
    assert torch.equal(agent.inner_model.preprocess_goals(goals), goals)


def test_gumbel_routing_rates():
    """Gumbel top-k samples without replacement from the router's
    probabilities: the first pick is expert e with probability p_e, the two
    picks differ, and the router in train mode uses it (argmax in eval)."""
    p = torch.tensor([0.5, 0.25, 0.15, 0.10])
    n = 20000
    idx = gumbel_topk_sample(torch.log(p).expand(n, 4), 2,
                             generator=torch.Generator().manual_seed(1))
    assert (idx[:, 0] != idx[:, 1]).all()
    for e in range(4):
        assert _within_5_sigma(int((idx[:, 0] == e).sum()), n, float(p[e])), e
    cfg = TCfg(latent_dim=64, n_layers=1, n_heads=2, cond_dim=16)
    router = TAgent(cfg, device="cpu").inner_model.blocks[0].router
    x = torch.zeros(1, 4096, 64)
    c = torch.randn(1, 1, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _, idx_eval, _, probs, _ = router(x, c)
        _, idx_train, _, _, _ = router(x, c, True,
                                       torch.Generator().manual_seed(3))
    assert (idx_eval == idx_eval[0, 0]).all()
    first = idx_train[0, :, 0]
    for e in range(4):
        assert _within_5_sigma(int((first == e).sum()), 4096,
                               float(probs[0, 0, e])), e
