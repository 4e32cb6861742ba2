"""Builders: reference-shaped config dicts -> the port's objects
(counterpart of ``mode_diffusion_policy_tpu/config/builders.py``).

These are the functions the registry maps the reference ``_target_``
strings onto, translating the hydra config surface
(``conf/model/mode_agent.yaml`` etc.) into ``MoDEAgentConfig``, optimizer
and EMA arguments, and the CALVIN and LIBERO datamodules.
"""
from __future__ import annotations

import ast
import logging
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)


def build_dit_cfg(**kwargs) -> Dict[str, Any]:
    return kwargs


def build_denoiser_cfg(**kwargs) -> Dict[str, Any]:
    return kwargs


def build_ema_cfg(**kwargs) -> Dict[str, Any]:
    """EMA hyperparameters (``conf/callbacks/calvin.yaml``) -> the
    ``ema_kwargs`` of ``training.optim.ema_decay_schedule``."""
    return {
        "inv_gamma": kwargs.get("inv_gamma", 1.0),
        "power": kwargs.get("power", 2 / 3),
        "min_value": kwargs.get("min_value", 0.0),
        "max_value": kwargs.get("max_value", 0.9999),
        "start_step": kwargs.get("start_step", 0),
    }


def build_checkpoint_cfg(**kwargs) -> Dict[str, Any]:
    return {
        "monitor": kwargs.get("monitor", "eval_lh/avg_seq_len"),
        "mode": kwargs.get("mode", "max"),
        "save_top_k": kwargs.get("save_top_k", 1),
    }


def build_lang_clip(model_name: str = "ViT-B/32",
                    freeze_backbone: bool = True,
                    clip_checkpoint: Optional[str] = None, *,
                    device="cuda", seed: int = 0, **_):
    """The frozen CLIP text tower (``LangClip``) on ``device``: the
    converted OpenAI CLIP weights of ``clip_checkpoint`` when given, else a
    random-init tower drawn from ``seed`` (as the JAX package runs offline,
    without the published weights)."""
    from ..models.encoders.clip_text import (LangClip, convert_clip_text,
                                             infer_text_config)
    if clip_checkpoint:
        from ..utils.checkpoint_convert import load_torch_checkpoint
        sd = load_torch_checkpoint(clip_checkpoint)
        return LangClip.from_state_dict(convert_clip_text(sd),
                                        infer_text_config(sd),
                                        model_name=model_name, device=device)
    logger.warning("no CLIP checkpoint provided; using random-init text tower")
    return LangClip.initialize_random(seed, device=device)


# every inner_model key the reference config surface can carry
# (conf/model/mode_agent.yaml); a key outside this set would be silently
# ignored, which is worse than erroring
_KNOWN_INNER_KEYS = {
    "_target_", "_recursive_", "device",
    "action_dim", "goal_dim", "obs_dim", "state_dim", "embed_dim",
    "n_layers", "n_heads", "goal_seq_len", "obs_seq_len", "action_seq_len",
    "goal_conditioned", "causal", "use_custom_attn_mask", "use_proprio",
    "embed_pdrob", "goal_drop", "attn_pdrop", "mlp_pdrop", "linear_output",
    "cond_router", "num_experts", "top_k", "router_normalize",
    "use_goal_in_routing", "use_argmax", "use_shared_expert",
    "identity_expert", "use_noise_token_as_input", "init_style",
    "use_cross_attention", "noise_in_cross_attention",
    # execution-strategy flags (no reference counterpart): the kernel
    # paths, settable from configs; serving.apply_serving_mode packages
    # them as presets
    "use_pallas_moe", "use_int8_moe", "use_grouped_moe", "use_pallas_attn",
    "use_int8_attn", "use_fused_layer", "use_megakernel",
}

def _validate_inner_model(inner: Dict[str, Any]):
    """Raise on inner_model options that would otherwise be silently
    mis-instantiated."""
    unknown = set(inner) - _KNOWN_INNER_KEYS
    if unknown:
        raise ValueError(
            f"unsupported inner_model config keys: {sorted(unknown)}; they "
            "would be silently ignored: remove or implement them")
    if inner.get("use_custom_attn_mask") in (True, "True", "true"):
        raise ValueError(
            "inner_model.use_custom_attn_mask=True is not implemented "
            "(the reference default is False)")
    if inner.get("linear_output") in (False, "False", "false"):
        raise ValueError(
            "inner_model.linear_output=False is not implemented (the "
            "reference Mlp head maps D->D, not D->action_dim)")


def _num(v, default):
    try:
        return type(default)(v)
    except (TypeError, ValueError):
        return default


def _bool(v, default):
    if isinstance(v, str):
        return v.strip().lower() == "true"
    return default if v is None else bool(v)


def _validated_norm(v):
    # a typo'd encoder_norm ("gn", "Group") would otherwise silently train
    # with BatchNorm
    v = str(v).strip().lower()
    if v not in ("batch", "group"):
        raise ValueError(f"encoder_norm must be 'batch' or 'group', got {v!r}")
    return v


def build_agent_config(model_cfg: Dict[str, Any], *, dtype=None):
    """``conf/model/mode_agent.yaml`` -> ``MoDEAgentConfig``, with the JAX
    builder's parsing and defaults: every model option and
    ``resnet_type`` pass through."""
    from ..models.agent import MoDEAgentConfig

    inner = model_cfg.get("model", {}).get("inner_model", {})
    _validate_inner_model(inner)
    return MoDEAgentConfig(
        latent_dim=_num(model_cfg.get("latent_dim", 1024), 1024),
        multistep=_num(model_cfg.get("multistep", 10), 10),
        sampler_type=model_cfg.get("sampler_type", "ddim"),
        num_sampling_steps=_num(model_cfg.get("num_sampling_steps", 10), 10),
        sigma_data=_num(model_cfg.get("sigma_data", 0.5), 0.5),
        sigma_min=_num(model_cfg.get("sigma_min", 0.001), 0.001),
        sigma_max=_num(model_cfg.get("sigma_max", 80), 80.0),
        noise_scheduler=model_cfg.get("noise_scheduler", "exponential"),
        sigma_sample_density_type=model_cfg.get("sigma_sample_density_type",
                                                "loglogistic"),
        cond_dim=_num(model_cfg.get("cond_dim", 512), 512),
        resnet_type=str(model_cfg.get("resnet_type", "50")),
        act_window_size=_num(model_cfg.get("act_window_size", 10), 10),
        action_dim=_num(inner.get("action_dim", 7), 7),
        obs_seq_len=_num(inner.get("obs_seq_len", 1), 1),
        goal_seq_len=_num(inner.get("goal_seq_len", 1), 1),
        entropy_gamma=_num(model_cfg.get("entropy_gamma", 0.0), 0.0),
        router_z_delta=_num(model_cfg.get("router_z_delta", 0.0), 0.0),
        # read as the JAX builder reads it (bool() of the raw value)
        use_proprio=bool(model_cfg.get("use_proprio", False)),
        n_layers=_num(inner.get("n_layers", 12), 12),
        n_heads=_num(inner.get("n_heads", 8), 8),
        num_experts=_num(inner.get("num_experts", 4), 4),
        top_k=_num(inner.get("top_k", 2), 2),
        use_shared_expert=_bool(inner.get("use_shared_expert"), False),
        identity_expert=_bool(inner.get("identity_expert"), False),
        goal_conditioned=_bool(inner.get("goal_conditioned"), True),
        causal=_bool(inner.get("causal"), True),
        embed_pdrob=_num(inner.get("embed_pdrob", 0.0), 0.0),
        goal_drop=_num(inner.get("goal_drop", 0.1), 0.1),
        attn_pdrop=_num(inner.get("attn_pdrop", 0.3), 0.3),
        mlp_pdrop=_num(inner.get("mlp_pdrop", 0.1), 0.1),
        cond_router=_bool(inner.get("cond_router"), True),
        router_normalize=_bool(inner.get("router_normalize"), True),
        use_goal_in_routing=_bool(inner.get("use_goal_in_routing"), False),
        use_argmax=_bool(inner.get("use_argmax"), False),
        use_noise_token_as_input=_bool(
            inner.get("use_noise_token_as_input"), True),
        init_style=str(inner.get("init_style", "olmoe")).strip("'\""),
        use_cross_attention=_bool(inner.get("use_cross_attention"), False),
        noise_in_cross_attention=_bool(
            inner.get("noise_in_cross_attention"), False),
        seed=_num(model_cfg.get("seed", 42), 42),
        dtype=dtype if dtype is not None else torch.float32,
        use_pallas_moe=_bool(inner.get("use_pallas_moe"), False),
        use_int8_moe=_bool(inner.get("use_int8_moe"), False),
        use_grouped_moe=_bool(inner.get("use_grouped_moe"), False),
        use_pallas_attn=_bool(inner.get("use_pallas_attn"), False),
        use_int8_attn=_bool(inner.get("use_int8_attn"), False),
        use_fused_layer=_bool(inner.get("use_fused_layer"), False),
        use_megakernel=_bool(inner.get("use_megakernel"), False),
        encoder_remat=_bool(model_cfg.get("encoder_remat"), True),
        encoder_norm=_validated_norm(model_cfg.get("encoder_norm", "batch")),
    )


def build_optimizer_kwargs(model_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``conf/model/mode_agent.yaml``'s optimizer and LR schedule -> the
    keyword arguments of ``training.optim.make_optimizer``."""
    opt = model_cfg.get("optimizer", {})
    lrs = model_cfg.get("lr_scheduler", {}).get("lr_scheduler", {})
    phase_ratio = lrs.get("phase_ratio", "(0.02, 0.08, 0.9)")
    if isinstance(phase_ratio, str):
        phase_ratio = ast.literal_eval(phase_ratio)
    optimizer_kwargs = {
        "learning_rate": _num(opt.get("learning_rate", 1e-4), 1e-4),
        "betas": tuple(opt.get("betas", (0.9, 0.95))),
        "transformer_weight_decay": _num(
            opt.get("transformer_weight_decay", 0.05), 0.05),
        "use_lr_scheduler": bool(model_cfg.get("use_lr_scheduler", True)),
        "total_steps": _num(lrs.get("total_steps", 45000), 45000),
        "phase_ratio": tuple(phase_ratio),
        "init_lr_scale": _num(lrs.get("init_lr_scale", 0.1), 0.1),
        "final_lr_scale": _num(lrs.get("final_lr_scale", 1e-6), 1e-6),
    }
    for key in ("mu_dtype", "nu_dtype"):
        # optimizer.mu_dtype / nu_dtype = "bfloat16" store the Adam moments
        # in bf16 (training.optim.make_optimizer)
        v = opt.get(key)
        if v in (None, "", "float32", "fp32"):
            continue
        if str(v) not in ("bfloat16", "bf16"):
            raise ValueError(f"optimizer.{key} must be float32 or bfloat16, "
                             f"got {v!r}")
        optimizer_kwargs[key] = torch.bfloat16
    return optimizer_kwargs


def build_agent(model_cfg: Dict[str, Any], *, dtype=None, device="cuda"):
    """``conf/model/mode_agent.yaml`` -> (MoDEAgent on ``device``,
    optimizer_kwargs, lang_cfg)."""
    from ..models.agent import MoDEAgent

    agent = MoDEAgent(build_agent_config(model_cfg, dtype=dtype),
                      device=device)
    return (agent, build_optimizer_kwargs(model_cfg),
            model_cfg.get("language_goal", {}))


def build_calvin_datamodule(dm_cfg: Dict[str, Any], lang_embed=None,
                            **kwargs):
    """``conf/datamodule/calvin.yaml`` -> ``CalvinDataModule``, read as the
    JAX builder reads it; ``kwargs`` (``shm_tag``) go to the datamodule
    as they are."""
    from ..data.datamodule import CalvinDataModule

    lang_ds = dm_cfg.get("datasets", {}).get("lang_dataset", {})
    return CalvinDataModule(
        root_data_dir=dm_cfg["root_data_dir"],
        batch_size=int(lang_ds.get("batch_size",
                                   dm_cfg.get("batch_size", 32))),
        act_seq_len=int(lang_ds.get("action_seq_len", 10)),
        obs_seq_len=int(lang_ds.get("obs_seq_len", 1)),
        lang_folder=lang_ds.get("lang_folder", "lang_annotations"),
        use_extracted_rel_actions=bool(
            lang_ds.get("use_extracted_rel_actions", False)),
        use_shm_cache=bool(dm_cfg.get("use_shm_cache", False)),
        num_workers=int(lang_ds.get("num_workers",
                                    dm_cfg.get("num_workers", 0))),
        lang_embed=lang_embed,
        shuffle_val=bool(dm_cfg.get("shuffle_val", False)),
        transforms=dm_cfg.get("transforms"),
        dataset_kwargs={
            "obs_space": dm_cfg.get("observation_space"),
            "proprio_state": dm_cfg.get("proprioception_dims"),
        },
        **kwargs)


def build_libero_datamodule(dm_cfg: Dict[str, Any], lang_embed=None,
                            **kwargs):
    """``conf/datamodule/libero.yaml`` -> ``LiberoDataModule``, read as the
    JAX builder reads it; ``kwargs`` (``cache_all``, ``task_arrays``) go
    to the datamodule as they are."""
    from ..data.libero import LiberoDataModule
    return LiberoDataModule(
        benchmark_name=dm_cfg.get("benchmark_name", "libero_10"),
        root_data_dir=dm_cfg.get("root_data_dir"),
        batch_size=int(dm_cfg.get("batch_size", 32)),
        seq_len=int(dm_cfg.get("action_seq_len", dm_cfg.get("seq_len", 10))),
        obs_seq_len=int(dm_cfg.get("obs_seq_len", 1)),
        lang_embed=lang_embed,
        **kwargs)
