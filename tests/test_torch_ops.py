"""Port ops against the JAX package on the same numpy inputs: the int8
helpers (exact), the primitives, the MoE ops and the eval camera
preprocessing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.ops import image as jimage
from mode_diffusion_policy_tpu.ops import moe as jmoe
from mode_diffusion_policy_tpu.ops import primitives as jprim
from mode_diffusion_policy_tpu.ops import quant as jquant
from mode_diffusion_policy_tpu.ops.pallas import quant_math as jqm
from mode_diffusion_policy_tpu_torch.ops import image as timage
from mode_diffusion_policy_tpu_torch.ops import moe as tmoe
from mode_diffusion_policy_tpu_torch.ops import primitives as tprim
from mode_diffusion_policy_tpu_torch.ops import quant as tquant
from mode_diffusion_policy_tpu_torch.ops.kernels import quant_math as tqm
from torch_threads import two_torch_threads  # noqa: F401


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("scale", [1e-8, 0.05, 3.0])
def test_quant_rows_exact(scale):
    x = (_rng().standard_normal((37, 300)) * scale).astype(np.float32)
    x[3] = 0.0                                  # all-zero row: 1e-6 floor
    jq, js = jqm.quant_rows(jnp.asarray(x))
    tq, ts = tqm.quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_rows_rounds_half_to_even():
    # amax 127 makes s == 1, so x * (1/s) lands exactly on the halves
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]], np.float32)
    tq, _ = tqm.quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy()[0, 1:], [0, 2, 2, 0, -2, -2])
    jq, _ = jqm.quant_rows(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_dot_i8_exact():
    r = _rng(1)
    a = r.integers(-127, 128, (19, 4096), dtype=np.int8)
    b = r.integers(-127, 128, (4096, 33), dtype=np.int8)
    a[0] = 127
    b[:, 0] = 127                               # the largest possible sum
    want = np.asarray(jqm.dot_i8(jnp.asarray(a), jnp.asarray(b)))
    got = tqm.dot_i8(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] == 127 * 127 * 4096
    with pytest.raises(TypeError):
        tqm.dot_i8(torch.from_numpy(a).float(), torch.from_numpy(b))


def test_quantize_experts_exact():
    r = _rng(2)
    w1 = (r.standard_normal((4, 64, 256)) * 0.05).astype(np.float32)
    b1 = (r.standard_normal((4, 256)) * 0.02).astype(np.float32)
    w2 = (r.standard_normal((4, 128, 64)) * 0.05).astype(np.float32)
    w1[1, :, 5] = 0.0                           # all-zero channel: 1e-12 floor
    jq = jquant.quantize_experts(*map(jnp.asarray, (w1, b1, w2)))
    tq = tquant.quantize_experts(*map(torch.from_numpy, (w1, b1, w2)))
    for name, j, t in zip(jq._fields, jq, tq):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
    for j, t in zip(jquant.dequantize_experts(jq),
                    tquant.dequantize_experts(tq)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_rmsnorm_swish_glu_append_dims_densep():
    r = _rng(3)
    x = (r.standard_normal((2, 5, 48)) * 0.3).astype(np.float32)
    x[0, 0] = 1e-12                            # the eps clamp
    g = (1 + 0.1 * r.standard_normal(48)).astype(np.float32)
    jn = jprim.RMSNorm(48, eps=1e-6)
    want = jn.apply({"params": {"g": jnp.asarray(g)}}, jnp.asarray(x))
    tn = tprim.RMSNorm(48, eps=1e-6)
    tn.g.data = torch.from_numpy(g)
    np.testing.assert_allclose(tn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), atol=1e-6, rtol=1e-6)

    h = (r.standard_normal((3, 40)) * 2).astype(np.float32)
    np.testing.assert_allclose(
        tprim.swish_glu(torch.from_numpy(h)).numpy(),
        np.asarray(jprim.swish_glu(jnp.asarray(h))), atol=1e-6, rtol=1e-6)

    assert tprim.append_dims(torch.zeros(3), 3).shape == (3, 1, 1)
    with pytest.raises(ValueError):
        tprim.append_dims(torch.zeros(3, 2), 1)

    k = (r.standard_normal((48, 16)) * 0.1).astype(np.float32)
    b = (r.standard_normal(16) * 0.1).astype(np.float32)
    jd = jprim.DenseP(48, 16, dtype=jnp.bfloat16)
    want = jd.apply({"params": {"kernel": jnp.asarray(k),
                                "bias": jnp.asarray(b)}}, jnp.asarray(x))
    td = tprim.DenseP(48, 16, dtype=torch.bfloat16)
    td.kernel.data, td.bias.data = torch.from_numpy(k), torch.from_numpy(b)
    got = td(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    # bf16 products summed in another order: within a couple of bf16 steps
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_moe_ops():
    r = _rng(4)
    x = (r.standard_normal((2, 6, 32)) * 0.5).astype(np.float32)
    w1 = (r.standard_normal((4, 32, 128)) * 0.1).astype(np.float32)
    b1 = (r.standard_normal((4, 128)) * 0.1).astype(np.float32)
    w2 = (r.standard_normal((4, 64, 32)) * 0.1).astype(np.float32)
    probs = r.dirichlet(np.ones(4), (2, 6)).astype(np.float32)
    j = jmoe.moe_ffn_dense(*map(jnp.asarray, (x, probs, w1, b1, w2)))
    t = tmoe.moe_ffn_dense(*map(torch.from_numpy, (x, probs, w1, b1, w2)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)
    idx = np.array([3, 1], np.int32)
    p = np.array([0.6, 0.4], np.float32)
    j = jmoe.moe_ffn_top2_gather(*map(jnp.asarray, (x, idx, p, w1, b1, w2)))
    t = tmoe.moe_ffn_top2_gather(*map(torch.from_numpy,
                                      (x, idx, p, w1, b1, w2)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


def test_preprocess_camera_eval_identity_size():
    u8 = _rng(5).integers(0, 256, (2, 1, 16, 16, 3), dtype=np.uint8)
    want = jimage.preprocess_camera(None, jnp.asarray(u8), size=16)
    got = timage.preprocess_camera(torch.from_numpy(u8), size=16)
    assert got.dtype == torch.float32 and got.shape == (2, 1, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_resize_downsample_matches_jax():
    """Antialiased bilinear shrink (torch F.interpolate vs
    jax.image.resize): both are triangle filters scaled by the shrink
    factor; they agree to float rounding on an integer shrink."""
    x = _rng(6).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jimage.resize_images(jnp.asarray(x), 16))
    got = timage.resize_images(torch.from_numpy(x), 16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)
