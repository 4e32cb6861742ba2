"""The port's FiLM-ResNet-50 against the JAX encoder on the same weights
(random parameters and BatchNorm statistics from numpy, 32 px images, f32
on the CPU): the unfolded eval forward, the BatchNorm fold with the
space-to-depth stem, and the two exact rewrites on their own. Then the
agent's other encoders the same way: the FiLM-ResNet-34 policy encoder,
the scratch ResNet-18 with per-block FiLM and its head, and its token
variant with a 128-wide head, unfolded, folded and with int8 convs (whose
int32 sums are exact on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models.encoders import resnet as jres
from mode_diffusion_policy_tpu_torch.models.encoders import resnet as tres
from mode_diffusion_policy_tpu_torch.utils.weights import resnet_state_dict
from torch_threads import two_torch_threads  # noqa: F401

COND = 16


def _random_variables(seed=0):
    mod = jres.FiLMResNetPolicy(COND, depth=50)
    shapes = jax.eval_shape(
        lambda k: mod.init(k, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, COND))),
        jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1].key)
        v = r.standard_normal(s.shape).astype(np.float32)
        if name == "var":
            return r.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * v
        if name in ("mean", "bias"):
            return 0.05 * v
        if name == "kernel" and len(s.shape) == 4:       # HWIO: lecun normal
            return v / np.sqrt(np.prod(s.shape[:3]))
        return 0.05 * v                                   # FiLM denses

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module")
def setup():
    v = _random_variables()
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 32, 32, 3)).astype(np.float32)
    cond = r.standard_normal((2, COND)).astype(np.float32)
    port = tres.FiLMResNetPolicy(COND, 50, device="cpu")
    port.load_state_dict(resnet_state_dict(v["params"], v["batch_stats"]))
    return v, x, cond, port.eval()


def _scale(a):
    return float(np.abs(a).max())


def test_unfolded_forward_matches(setup):
    v, x, cond, port = setup
    want = np.asarray(jres.FiLMResNetPolicy(COND, depth=50).apply(
        v, jnp.asarray(x), jnp.asarray(cond), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    assert got.shape == (2, 2048)
    # 53 f32 conv layers summed in different orders
    np.testing.assert_allclose(got, want, atol=2e-5 * _scale(want), rtol=1e-4)


def test_folded_forward_matches(setup):
    v, x, cond, port = setup
    jfold = jres.fold_resnet_params(v["params"], v["batch_stats"])
    want = np.asarray(jres.FiLMResNetPolicy(COND, depth=50, folded=True).apply(
        {"params": jfold}, jnp.asarray(x), jnp.asarray(cond), train=False))
    folded = tres.FiLMResNetPolicy(COND, 50, folded=True, device="cpu")
    folded.load_state_dict(tres.fold_resnet_params(port.state_dict()))
    with torch.no_grad():
        got = folded(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
        unfolded = port(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * _scale(want), rtol=1e-4)
    # the fold is an exact rewrite up to f32 rounding
    np.testing.assert_allclose(got, unfolded, atol=2e-5 * _scale(want),
                               rtol=1e-4)


def test_space_to_depth_and_stem_fold_match_jax():
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tres.space_to_depth_2x2(torch.from_numpy(x)).numpy(),
        np.asarray(jres.space_to_depth_2x2(jnp.asarray(x))))
    w7 = r.standard_normal((7, 7, 3, 5)).astype(np.float32)      # HWIO
    want = np.asarray(jres.fold_stem_kernel(jnp.asarray(w7)))   # [4,4,12,5]
    got = tres.fold_stem_kernel(torch.from_numpy(w7.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))


def test_folded_bf16_runs_finite(setup):
    _, x, cond, port = setup
    folded = tres.FiLMResNetPolicy(COND, 50, dtype=torch.bfloat16,
                                   folded=True, device="cpu")
    folded.load_state_dict(tres.fold_resnet_params(port.state_dict()))
    with torch.no_grad():
        out = folded(torch.from_numpy(x), torch.from_numpy(cond))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


def test_only_resnet50_is_ported():
    """Every depth of the JAX encoders builds (18 and 34 with basic blocks,
    512 features; 50 with bottlenecks, 2048); another depth raises."""
    for depth, feats in ((18, 512), (34, 512), (50, 2048)):
        assert tres.out_dim(depth) == feats
        trunk = tres.ResNetBackbone(depth=depth, device="meta")
        assert len(trunk.stages[2]) == tres.STAGE_SIZES[depth][2]
    with pytest.raises(ValueError, match="ResNet-101"):
        tres.ResNetBackbone(depth=101)


# ---- the other encoders: ResNet-34 policy, scratch ResNet-18 --------------

def _jax_encoder(kind, **kw):
    if kind == "scratch18":
        return jres.ResNetEncoderWithFiLM(COND, latent_dim=512, **kw)
    if kind == "token18":
        return jres.ResNetTokenEncoderWithFiLM(COND, **kw)
    return jres.FiLMResNetPolicy(COND, depth=34, **kw)


def _port_encoder(kind, **kw):
    if kind == "token18":
        return tres.ResNetTokenEncoderWithFiLM(COND, device="cpu", **kw)
    return tres.make_encoder("18" if kind == "scratch18" else "34", COND,
                             device="cpu", **kw)


OUT_DIM = {"scratch18": 512, "policy34": 512, "token18": 128}


@pytest.fixture(scope="module", params=["scratch18", "policy34", "token18"])
def other(request):
    kind = request.param
    shapes = jax.eval_shape(
        lambda k: _jax_encoder(kind).init(k, jnp.zeros((1, 32, 32, 3)),
                                          jnp.zeros((1, COND))),
        jax.random.PRNGKey(0))
    r = np.random.default_rng(2)

    def fill(path, s):
        name = str(path[-1].key)
        v = r.standard_normal(s.shape).astype(np.float32)
        if name == "var":
            return r.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * v
        if name in ("mean", "bias"):
            return 0.05 * v
        if name == "kernel" and len(s.shape) == 4:
            return v / np.sqrt(np.prod(s.shape[:3]))
        return v / np.sqrt(s.shape[0])                # FiLM and head denses

    v = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    x = r.standard_normal((2, 32, 32, 3)).astype(np.float32)
    cond = r.standard_normal((2, COND)).astype(np.float32)
    port = _port_encoder(kind)
    port.load_state_dict(resnet_state_dict(v["params"], v["batch_stats"]))
    return kind, v, x, cond, port.eval()


@pytest.mark.parametrize("form", ["unfolded", "folded", "int8"])
def test_other_encoders_match_jax(other, form):
    """ResNet-34, the scratch ResNet-18 and its token variant (the
    default 128-wide head) against the JAX encoders: unfolded and folded
    (f32 gate of the ResNet-50 tests), and with the
    JAX package's int8 params of the folded trunk (dynamic activation
    scales; the int8 sums are exact, so 1e-5 as the ResNet-50 int8
    encoder's test)."""
    from mode_diffusion_policy_tpu_torch.utils.weights import \
        q8_resnet_state_dict
    kind, v, x, cond, port = other
    xs, cs = jnp.asarray(x), jnp.asarray(cond)
    if form == "unfolded":
        want = _jax_encoder(kind).apply(v, xs, cs, train=False)
        mod = port
    else:
        jfold = jres.fold_resnet_params(v["params"], v["batch_stats"])
        q8 = form == "int8"
        params = jres.quantize_resnet_params(jfold) if q8 else jfold
        want = _jax_encoder(kind, folded=True, q8=q8).apply(
            {"params": params}, xs, cs, train=False)
        mod = _port_encoder(kind, folded=True, q8=q8)
        mod.load_state_dict(
            q8_resnet_state_dict(jax.tree.map(np.asarray, params)) if q8
            else tres.fold_resnet_params(port.state_dict()))
    want = np.asarray(want)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    assert got.shape == (2, OUT_DIM[kind])
    if form == "int8":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2e-5 * _scale(want),
                                   rtol=1e-4)
