"""The port's config system against the JAX package's: hydra-style
composition, interpolation and overrides over the root ``conf/``, the
``_target_`` registry, and the builders (``build_agent``'s config fields,
its validation, the CALVIN and LIBERO datamodules)."""
import dataclasses
import pathlib

import jax.numpy as jnp
import pytest
import torch

from mode_diffusion_policy_tpu.config import builders as jb
from mode_diffusion_policy_tpu.config import loader as jl
from mode_diffusion_policy_tpu.config import registry as jr
from mode_diffusion_policy_tpu_torch.config import builders as tb
from mode_diffusion_policy_tpu_torch.config import loader as tl
from mode_diffusion_policy_tpu_torch.config import registry as tr
from mode_diffusion_policy_tpu_torch.models.agent import MoDEAgent
from torch_threads import two_torch_threads  # noqa: F401

CONF = pathlib.Path(__file__).resolve().parents[1] / "conf"


OVERRIDES = [
    [],
    ["batch_size=16", "model.latent_dim=64", "trainer.max_epochs=2"],
    ["model.model.inner_model.n_layers=2", "seed=7", "+extra.key=[1, 2]"],
    ["datamodule=libero", "model.sampler_type=euler"],
]


@pytest.mark.parametrize("name", ["config_calvin", "config_libero",
                                  "mode_evaluate", "agent_proxy",
                                  "sweep", "lang_ann"])
def test_load_config_matches_jax(name):
    for ov in (OVERRIDES if name == "config_calvin" else [[]]):
        assert tl.load_config(CONF, name, ov) == jl.load_config(CONF, name, ov)


def test_interpolation_matches_jax():
    cfg = {"a": 5, "b": "${a}", "c": {"d": "${b}"}, "e": "x${a}y",
           "f": "${missing.key}", "g": ["${a}", {"h": "${c.d}"}]}
    assert tl.resolve_interpolations(cfg) == jl.resolve_interpolations(cfg)
    with pytest.raises(ValueError, match="key=value"):
        tl.load_config(CONF, "config_calvin", ["no_equals_sign"])


def test_registry_maps_onto_the_port():
    from mode_diffusion_policy_tpu_torch.rollout.env import CalvinEnvWrapper
    from mode_diffusion_policy_tpu_torch.rollout.rollout_long_horizon import \
        LongHorizonEvaluator
    assert tr.resolve_target(
        "mode.models.mode_agent.MoDEAgent") is tb.build_agent
    assert tr.resolve_target(
        "mode.wrappers.hulc_wrapper.HulcWrapper") is CalvinEnvWrapper
    assert tr.resolve_target("mode.rollout.rollout_long_horizon."
                             "RolloutLongHorizon") is LongHorizonEvaluator
    # every alias of the JAX table resolves here too
    for target, dest in jr._ALIASES.items():
        got = tr.resolve_target(target)
        if dest.startswith("__"):
            assert got == dest
        else:
            assert got.__module__.startswith("mode_diffusion_policy_tpu_torch")
            assert got.__name__ == dest.rsplit(".", 1)[1]
    obj = tr.instantiate({"_target_": "mode_diffusion_policy_tpu_torch."
                          "models.agent.MoDEAgentConfig", "latent_dim": 32})
    assert obj.latent_dim == 32
    assert tr.instantiate({"_target_": "torch.optim.AdamW", "lr": 1}) == {
        "__sentinel__": "__optimizer__:adamw", "lr": 1}
    from mode_diffusion_policy_tpu_torch.data.datamodule import \
        CalvinDataModule
    dm = tb.build_calvin_datamodule({"root_data_dir": "/data/calvin"})
    assert isinstance(dm, CalvinDataModule) and dm.train_dataset is None
    from mode_diffusion_policy_tpu_torch.data.libero import LiberoDataModule
    cfg = tl.load_config(CONF, "config_libero", [])
    dm = tb.build_libero_datamodule(cfg["datamodule"])
    jdm = jb.build_libero_datamodule(cfg["datamodule"])
    assert isinstance(dm, LiberoDataModule) and dm.train_dataset is None
    assert (dm.benchmark_name, dm.root_data_dir, dm.batch_size, dm.seq_len,
            dm.obs_seq_len) == ("libero_10", "/data/libero", 128, 10, 1)
    for k in ("benchmark_name", "root_data_dir", "batch_size", "seq_len",
              "obs_seq_len", "cache_all", "train_fraction", "seed"):
        assert getattr(dm, k) == getattr(jdm, k), k
    assert tr.resolve_target("mode.datasets.libero_data_module."
                             "LiberoDataModule") is tb.build_libero_datamodule


def _common_fields(tcfg, jcfg):
    out = {}
    for f in dataclasses.fields(tcfg):
        if f.name == "dtype":
            continue
        out[f.name] = (getattr(tcfg, f.name), getattr(jcfg, f.name))
    return out


@pytest.mark.parametrize("overrides", [
    ["model.latent_dim=256", "model.model.inner_model.n_layers=2",
     "model.model.inner_model.n_heads=2"],
    ["model.latent_dim=128", "model.model.inner_model.n_layers=1",
     "model.model.inner_model.num_experts=3", "model.sampler_type=euler",
     "model.num_sampling_steps=4", "model.entropy_gamma=0.01",
     "+model.model.inner_model.use_argmax=true",
     "+model.encoder_norm=group", "+model.encoder_remat=false",
     "model.optimizer.mu_dtype=bfloat16", "model.optimizer.nu_dtype=bf16"],
    ["model.latent_dim=256", "model.model.inner_model.n_layers=1",
     "model.model.inner_model.n_heads=2",
     "+model.model.inner_model.use_int8_moe=true",
     "+model.model.inner_model.use_pallas_attn=true",
     "+model.model.inner_model.use_fused_layer=true"],
])
def test_build_agent_matches_jax(overrides):
    cfg = tl.load_config(CONF, "config_calvin", overrides)
    assert cfg == jl.load_config(CONF, "config_calvin", overrides)
    for dtype, jdtype in ((None, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        agent, opt, lang = tb.build_agent(cfg["model"], dtype=dtype,
                                          device="cpu")
        jagent, jopt, jlang = jb.build_agent(cfg["model"], dtype=jdtype)
        assert isinstance(agent, MoDEAgent)
        assert agent.cfg.dtype == (dtype or torch.float32)
        for name, (t, j) in _common_fields(agent.cfg, jagent.cfg).items():
            assert t == j, name
        assert tb.build_agent_config(cfg["model"], dtype=dtype) == agent.cfg
        assert lang == jlang
        jopt = {k: ({jnp.bfloat16: torch.bfloat16}[v] if k.endswith("_dtype")
                    else v) for k, v in jopt.items()}
        assert opt == jopt


def test_build_agent_validation_matches_jax():
    base = {"latent_dim": 32, "model": {"inner_model": {
        "n_layers": 1, "n_heads": 2, "num_experts": 4, "top_k": 2}}}
    bad = [{"made_up_option": 1}, {"use_custom_attn_mask": True},
           {"linear_output": False}]
    for extra in bad:
        cfg = {**base, "model": {"inner_model": {
            **base["model"]["inner_model"], **extra}}}
        with pytest.raises(ValueError):
            jb.build_agent(cfg)
        with pytest.raises(ValueError):
            tb.build_agent(cfg, device="cpu")
    with pytest.raises(ValueError, match="encoder_norm"):
        tb.build_agent_config({**base, "encoder_norm": "gn"})
    with pytest.raises(ValueError, match="mu_dtype"):
        tb.build_agent({**base, "optimizer": {"mu_dtype": "fp8"}},
                       device="cpu")
    # every JAX option builds, each alone, with the JAX builder's config
    # field by field (the port used to raise for these)
    for key, value in (("use_shared_expert", True), ("identity_expert", True),
                       ("use_cross_attention", "true"),
                       ("use_goal_in_routing", True), ("causal", False),
                       ("init_style", "'normal'"), ("cond_router", "False"),
                       ("router_normalize", False),
                       ("goal_conditioned", False),
                       ("use_noise_token_as_input", "false"),
                       ("noise_in_cross_attention", True)):
        cfg = {**base, "model": {"inner_model": {
            **base["model"]["inner_model"], key: value}}}
        _same_config(tb.build_agent_config(cfg), jb.build_agent(cfg)[0].cfg)
    for cfg in ({**base, "use_proprio": True},
                {**base, "resnet_type": "18"}, {**base, "resnet_type": "34"}):
        _same_config(tb.build_agent_config(cfg), jb.build_agent(cfg)[0].cfg)
    agent = tb.build_agent({**base, "resnet_type": "18"}, device="cpu")[0]
    assert agent.cfg.obs_dim == 512
    assert type(agent.static_resnet).__name__ == "ResNetEncoderWithFiLM"
    shipped = tl.load_config(CONF, "config_calvin")["model"]
    assert tb.build_agent_config(shipped).n_layers == 12


def _same_config(got, want):
    """The port's MoDEAgentConfig equals the JAX one on every field they
    share (the dtype aside: torch's and JAX's)."""
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_ema_and_checkpoint_builders_match():
    kw = {"decay": 0.999, "power": 0.5, "inv_gamma": 2.0, "max_value": 0.99,
          "monitor": "val/loss", "mode": "min", "save_top_k": 3}
    assert tb.build_ema_cfg(**kw) == jb.build_ema_cfg(**kw)
    assert tb.build_checkpoint_cfg(**kw) == jb.build_checkpoint_cfg(**kw)
    assert tb.build_dit_cfg(a=1) == jb.build_dit_cfg(a=1)
    assert tb.build_denoiser_cfg(b=2) == jb.build_denoiser_cfg(b=2)


def test_loader_needs_yaml_only_to_read(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert tl.resolve_interpolations({"a": 1, "b": "${a}"})["b"] == 1
    with pytest.raises(ImportError, match="PyYAML"):
        tl.load_config(CONF, "config_calvin")
