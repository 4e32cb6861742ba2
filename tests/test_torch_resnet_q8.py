"""The int8 encoder convs of the ``max-throughput`` preset against the JAX
package, on the CPU at 32 px with random weights from numpy:

- ``QuantConv`` in dynamic and static activation modes (the stem's 4x4
  conv with its asymmetric padding, a 3x3, a strided 3x3 and a strided 1x1
  downsample): the int8 activations and the int32 conv sums equal, the
  float outputs within 1e-6 relative, the calibration statistics equal;
- ``quantize_resnet_params`` on the JAX package's own folded tree: the int8
  kernels equal, the scales within one ulp; ``infer_q8_skip`` and
  ``_clip_candidates`` like the JAX ones;
- the whole int8 encoder with the JAX package's int8 parameters loaded
  through ``utils/weights``: features within 1e-5 of the JAX features;
- ``quantize_encoders_for_inference(calib_batch=...)`` picks the JAX
  package's clip labels.

The int8 products are exact on both sides, so the float outputs differ only
by the f32 rounding of what surrounds them (FiLM denses, sums of the
residual adds and the pool).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models import agent as jagent_mod
from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JCfg
from mode_diffusion_policy_tpu.models.encoders import resnet as jres
from mode_diffusion_policy_tpu_torch.models import agent as tagent_mod
from mode_diffusion_policy_tpu_torch.models.agent import \
    MoDEAgentConfig as TCfg
from mode_diffusion_policy_tpu_torch.models.encoders import resnet as tres
from mode_diffusion_policy_tpu_torch.utils import weights as tweights
from torch_threads import two_torch_threads  # noqa: F401

COND = 16
IMG = 32


def _fill(path, s, r):
    name = str(path[-1].key)
    v = r.standard_normal(s.shape).astype(np.float32)
    if name == "var":
        return r.uniform(0.5, 1.5, s.shape).astype(np.float32)
    if name == "scale":
        return 1.0 + 0.1 * v
    if name in ("mean", "bias"):
        return 0.05 * v
    if name == "kernel" and len(s.shape) == 4:            # HWIO
        return v / np.sqrt(np.prod(s.shape[:3]))
    return 0.05 * v


@pytest.fixture(scope="module")
def enc():
    """A JAX FiLM-ResNet-50's folded params, its input batch, and its
    dynamic-mode calibration statistics."""
    mod = jres.FiLMResNetPolicy(COND, depth=50)
    shapes = jax.eval_shape(
        lambda k: mod.init(k, jnp.zeros((1, IMG, IMG, 3)),
                           jnp.zeros((1, COND))), jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    v = jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s, r),
                                         dict(shapes))
    folded = jres.fold_resnet_params(v["params"], v["batch_stats"])
    x = r.standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    cond = r.standard_normal((2, COND)).astype(np.float32)
    q = jres.quantize_resnet_params(folded)
    _, calib = jres.FiLMResNetPolicy(COND, depth=50, folded=True, q8=True
                                     ).apply({"params": q}, jnp.asarray(x),
                                             jnp.asarray(cond),
                                             mutable=["calib"])
    return folded, x, cond, calib["calib"]


def _port_sd(tree):
    """A JAX folded tree as the port's folded state dict."""
    return tweights.resnet_state_dict(jax.tree.map(np.asarray, tree), {})


def _flat_clips(tree, prefix=""):
    """A JAX {conv: {act_amax[, act_msq]}} tree as the port's flat dict."""
    out = {}
    for k, v in tree.items():
        if "act_amax" in v:
            out[prefix + k] = {n: torch.from_numpy(np.array(a))
                               for n, a in v.items()}
        else:
            out.update(_flat_clips(v, prefix + k + "."))
    return out


CONVS = {  # name: (C, O, kernel, stride, padding, spatial)
    "stem": (12, 64, 4, 1, ((2, 1), (2, 1)), 16),
    "3x3": (64, 64, 3, 1, None, 8),
    "3x3-stride2": (128, 128, 3, 2, None, 8),
    "downsample": (256, 512, 1, 2, None, 8),
}


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("conv", sorted(CONVS))
def test_quant_conv_matches_jax(conv, static):
    C, O, k, s, pad, hw = CONVS[conv]
    r = np.random.default_rng(len(conv) + 10 * static)
    x = (r.standard_normal((2, hw, hw, C)) * 0.7).astype(np.float32)
    kf = (r.standard_normal((k, k, C, O)) / np.sqrt(k * k * C)).astype(
        np.float32)
    amax = np.abs(x).max(axis=(0, 1, 2)) * 0.8 if static else None
    qp = jres.quantize_resnet_params(
        {"c": {"kernel": jnp.asarray(kf),
               "bias": jnp.asarray(0.05 * r.standard_normal(O), jnp.float32)}},
        act_amax=None if amax is None else {"c": {"act_amax": amax}})["c"]
    jmod = jres.QuantConv(O, k, s, padding=pad, static_act=static)
    want, sown = jmod.apply({"params": qp}, jnp.asarray(x), mutable=["calib"])
    tmod = tres.QuantConv(C, O, k, s, pad=pad, static_act=static,
                          device="cpu")
    sd = tweights.q8_resnet_state_dict({"m": jax.tree.map(np.asarray, qp)})
    tmod.load_state_dict({k_[len("m."):]: v_ for k_, v_ in sd.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    # int8 activations: the JAX module's formula
    x32 = jnp.asarray(x)
    if static:
        sx = qp["act_scale"] / 127.0
    else:
        sx = jnp.maximum(jnp.max(jnp.abs(x32)), 1e-6) / 127.0
    xq_j = jnp.clip(jnp.round(x32 * (1.0 / sx)), -127, 127).astype(jnp.int8)
    tmod.collect = True
    xq_t, _ = tmod.quantize_input(xt)
    np.testing.assert_array_equal(xq_t.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(xq_j))
    # int32 conv sums
    p = pad if pad is not None else [(k // 2, k // 2)] * 2
    y_j = jax.lax.conv_general_dilated(
        xq_j, qp["kernel_q"], (s, s), p,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    y_t = tres.conv2d_i8(xq_t, tmod.kernel_q, s, tmod.pad)
    assert y_t.dtype == torch.int32
    np.testing.assert_array_equal(y_t.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(y_j))
    # float outputs and the calibration statistics
    with torch.no_grad():
        got = tmod(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    if not static:
        np.testing.assert_array_equal(tmod.calib["act_amax"].numpy(),
                                      np.asarray(sown["calib"]["act_amax"]))
        np.testing.assert_allclose(tmod.calib["act_msq"].numpy(),
                                   np.asarray(sown["calib"]["act_msq"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("with_clips", [False, True],
                         ids=["no-clips", "clips"])
def test_quantize_resnet_params_matches_jax(enc, with_clips):
    folded, _, _, calib = enc
    jclips = dict(jagent_mod._clip_candidates(calib))["3.5*sigma"] \
        if with_clips else None
    want = jres.quantize_resnet_params(folded, act_amax=jclips)
    got = tres.quantize_resnet_params(
        _port_sd(folded),
        act_amax=_flat_clips(jclips) if with_clips else None)
    want_sd = tweights.q8_resnet_state_dict(jax.tree.map(np.asarray, want))
    assert set(got) == set(want_sd)
    n_q = 0
    for k, w in want_sd.items():
        if k.endswith("kernel_q"):
            assert got[k].dtype == torch.int8
            np.testing.assert_array_equal(got[k].numpy(), w.numpy(),
                                          err_msg=k)
            n_q += 1
        elif k.endswith((".scale", ".act_scale")) and "resnet" in k:
            np.testing.assert_array_max_ulp(got[k].numpy(), w.numpy(),
                                            maxulp=1)
        else:
            np.testing.assert_array_equal(got[k].numpy(), w.numpy(),
                                          err_msg=k)
    assert n_q == 53          # every conv of the trunk
    assert any(k.endswith("act_scale") for k in got) == with_clips


@pytest.mark.parametrize("skip", [(), ("stem", "layer2"), ("layer4",)])
def test_skip_and_infer_q8_skip_match_jax(enc, skip):
    folded = enc[0]
    want = jres.quantize_resnet_params(folded, skip=skip)
    got = tres.quantize_resnet_params(_port_sd(folded), skip=skip)
    want_sd = tweights.q8_resnet_state_dict(jax.tree.map(np.asarray, want))
    assert set(got) == set(want_sd)
    assert tres.infer_q8_skip(got) == jres.infer_q8_skip(want) == tuple(skip)


def test_clip_candidates_match_jax(enc):
    """The port's calibration statistics (dynamic int8 modules on the same
    batch) and the seven clip candidates built from them, against the JAX
    ones."""
    folded, x, cond, calib = enc
    mod = tres.FiLMResNetPolicy(COND, 50, folded=True, q8=True, device="cpu")
    mod.load_state_dict(tres.quantize_resnet_params(_port_sd(folded)))
    with torch.no_grad():
        stats = tres.calibration_stats(mod, lambda: mod(
            torch.from_numpy(x), torch.from_numpy(cond)))
    want = _flat_clips(calib)
    assert set(stats) == set(want) and len(stats) == 53
    for name in want:
        for k in ("act_amax", "act_msq"):
            np.testing.assert_allclose(stats[name][k].numpy(),
                                       want[name][k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {k}")
    jc = jagent_mod._clip_candidates(calib, headroom=1.1)
    tc = tagent_mod._clip_candidates(stats, headroom=1.1)
    assert [lab for lab, _ in tc] == [lab for lab, _ in jc] == [
        "amax", "amax*0.9", "amax*0.8", "amax*0.7", "3.0*sigma",
        "3.5*sigma", "4.0*sigma"]
    for (label, t), (_, j) in zip(tc, jc):
        jf = _flat_clips(j)
        assert set(t) == set(jf)
        for name in jf:
            np.testing.assert_allclose(
                t[name]["act_amax"].numpy(), jf[name]["act_amax"].numpy(),
                rtol=1e-5, err_msg=f"{label} {name}")


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_q8_encoder_features_match_jax(enc, mode):
    """The JAX package's int8 parameters, loaded through utils/weights, give
    the JAX int8 encoder's features within 1e-5."""
    folded, x, cond, calib = enc
    clips = dict(jagent_mod._clip_candidates(calib))["amax*0.9"] \
        if mode == "static" else None
    q = jres.quantize_resnet_params(folded, act_amax=clips)
    q8 = "static" if mode == "static" else True
    want = np.asarray(jres.FiLMResNetPolicy(COND, depth=50, folded=True,
                                            q8=q8).apply(
        {"params": q}, jnp.asarray(x), jnp.asarray(cond)))
    mod = tres.FiLMResNetPolicy(COND, 50, folded=True, q8=q8, device="cpu")
    mod.load_state_dict(tweights.q8_resnet_state_dict(
        jax.tree.map(np.asarray, q)))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- the agent's calibration ----------------------------------------------

DIMS = dict(latent_dim=64, n_layers=1, n_heads=1, cond_dim=COND,
            num_experts=4, top_k=2)


@pytest.fixture(scope="module")
def agents():
    jagent = JAgent(JCfg(resnet_type="50", **DIMS))
    shapes = jax.eval_shape(
        lambda k: jagent.init_variables(k, image_hw=(IMG, IMG)),
        jax.random.PRNGKey(0))
    r = np.random.default_rng(3)
    v = jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, r),
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    batch = {k: r.uniform(-1, 1, (3, 1, IMG, IMG, 3)).astype(np.float32)
             for k in ("rgb_static", "rgb_gripper")}
    batch["lang_emb"] = r.standard_normal((3, 1, COND)).astype(np.float32)
    return jagent, v, batch


class _Records(logging.Handler):
    """Keeps every record it is handed."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture(scope="module")
def calibrated(agents):
    """The JAX agent's variables after ``quantize_encoders_for_inference(
    calib_batch=...)`` (its int8 calibration, run once for the module), and
    the clip label that its ``int8 calibration`` log records name for each
    encoder."""
    jagent, v, batch = agents
    log, records = logging.getLogger(jagent_mod.__name__), _Records()
    level = log.level
    log.addHandler(records)
    log.setLevel(logging.INFO)
    try:
        jv = jagent.quantize_encoders_for_inference(
            v, calib_batch={k: jnp.asarray(a) for k, a in batch.items()})
    finally:
        log.removeHandler(records)
        log.setLevel(level)
    labels = {}
    for rec in records.records:
        msg = rec.getMessage()
        if msg.startswith("int8 calibration"):
            name, clip = msg.split()[2].rstrip(":"), msg.split("clip=")[1]
            labels[name] = clip.split(",")[0]
    return jv, labels


def test_calibration_picks_the_jax_clips(agents, calibrated):
    _, _, batch = agents
    jv, want = calibrated
    assert set(want) == {"static_resnet", "gripper_resnet"}
    agent = tweights.from_jax_params(jax.tree.map(np.asarray, jv),
                                     TCfg(**DIMS), device="cpu")
    agent.quantize_encoders_for_inference(
        calib_batch={k: torch.from_numpy(a) for k, a in batch.items()})
    for name, label in want.items():
        mses = agent.q8_clip_mse[name]
        ranked = sorted(mses, key=mses.get)
        gap = (mses[ranked[1]] - mses[ranked[0]]) / mses[ranked[0]]
        # a near tie would make the label a coin toss: say so
        assert gap > 1e-4, (name, "candidates tie", mses)
        assert agent.q8_clips[name] == label, (name, mses)
    # the chosen clips end in static int8 modules that embed_visual_obs runs
    assert all(hasattr(m.resnet.conv1, "act_scale")
               for m in agent.q8.values())


def test_loaded_q8_encoders_embed_like_jax(agents, calibrated):
    """The JAX agent's q8_encoder_params (calibrated), loaded into the port
    agent, give JAX's embed_visual_obs features within 1e-5."""
    jagent, v, batch = agents
    jv, _ = calibrated
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    want, _ = jagent.embed_visual_obs(jv, jb["rgb_static"], jb["rgb_gripper"],
                                      jb["lang_emb"])
    agent = tweights.from_jax_params(jax.tree.map(np.asarray, v),
                                     TCfg(**DIMS), device="cpu")
    tweights.load_q8_encoders(agent, jax.tree.map(
        np.asarray, jv["q8_encoder_params"]))
    got = agent.embed_visual_obs(torch.from_numpy(batch["rgb_static"]),
                                 torch.from_numpy(batch["rgb_gripper"]),
                                 torch.from_numpy(batch["lang_emb"]))
    np.testing.assert_allclose(got["state_images"].numpy(),
                               np.asarray(want["state_images"]), rtol=0,
                               atol=1e-5)
