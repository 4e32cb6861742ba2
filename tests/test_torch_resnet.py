"""The port's FiLM-ResNet-50 against the JAX encoder on the same weights
(random parameters and BatchNorm statistics from numpy, 32 px images, f32
on the CPU): the unfolded eval forward, the BatchNorm fold with the
space-to-depth stem, and the two exact rewrites on their own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models.encoders import resnet as jres
from mode_diffusion_policy_tpu_torch.models.encoders import resnet as tres
from mode_diffusion_policy_tpu_torch.utils.weights import resnet_state_dict

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tres.ResNetBackbone(depth=18)
