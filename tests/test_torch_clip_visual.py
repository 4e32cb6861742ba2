"""The CLIP visual towers of the port against the JAX package's: one random
OpenAI-layout state dict (``clip_visual.random_visual_state_dict``, numpy
seeded) goes through both packages' ``convert_clip_visual``; the inferred
configs are equal and ``encode_image`` agrees within 2e-5 (max abs) in f32
on the same NHWC images. The ViT at 32 px, patch 8, width 64, 2 layers
(one head); the ModifiedResNet at 64 px, width 16, layers 1-1-1-1 and
2-1-1-2 (a second block per stage exercises the block without
downsample)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models.encoders import clip_visual as J
from mode_diffusion_policy_tpu_torch.models.encoders import clip_visual as P
from torch_threads import two_torch_threads  # noqa: F401

CASES = {
    "vit": ("vit", P.CLIPViTConfig(input_resolution=32, patch_size=8,
                                   width=64, layers=2, heads=1,
                                   output_dim=32)),
    "rn_1111": ("resnet", P.ModifiedResNetConfig(
        layers=(1, 1, 1, 1), width=16, output_dim=32, heads=8,
        input_resolution=64)),
    "rn_2112": ("resnet", P.ModifiedResNetConfig(
        layers=(2, 1, 1, 2), width=16, output_dim=32, heads=8,
        input_resolution=64)),
}


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


@pytest.fixture(scope="module", params=sorted(CASES))
def towers(request):
    kind, cfg = CASES[request.param]
    sd = P.random_visual_state_dict(kind, cfg, seed=0)
    res = cfg.input_resolution
    img = np.random.default_rng(1).standard_normal(
        (2, res, res, 3)).astype(np.float32)
    return sd, img, kind, cfg


def test_infer_visual_config_matches_jax(towers):
    sd, _, kind, cfg = towers
    jk, jcfg = J.infer_visual_config(sd)
    tk, tcfg = P.infer_visual_config(sd)
    assert jk == tk == kind
    assert _fields(jcfg) == _fields(tcfg) == _fields(cfg)


def test_encode_image_matches_jax(towers):
    sd, img, kind, _ = towers
    jk, jcfg, jvars = J.convert_clip_visual(sd)
    want = np.asarray(J.encode_image(jvars, jnp.asarray(img), jk, jcfg))
    tk, tcfg, tsd = P.convert_clip_visual(sd)
    model = P.build_visual(tk, tcfg, tsd, device="cpu")
    got = P.encode_image(model, torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_state_dict_layout(towers):
    """The port's modules hold every tensor of the OpenAI layout (the
    BatchNorm counters aside), and frozen BatchNorms use their running
    statistics in train mode too."""
    sd, img, kind, cfg = towers
    tk, tcfg, tsd = P.convert_clip_visual(sd)
    model = P.build_visual(tk, tcfg, tsd, device="cpu")
    n_open = sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    assert len(model.state_dict()) == len(tsd) == n_open
    x = torch.from_numpy(img)
    eval_out = P.encode_image(model, x)
    with torch.no_grad():
        train_out = model.train()(x)
    assert torch.equal(eval_out, train_out)
