"""``_target_`` registry (counterpart of
``mode_diffusion_policy_tpu/config/registry.py``): hydra-style
instantiate() with an alias table that maps the reference's target strings
(``mode.models.mode_agent.MoDEAgent``, ...) onto the port's constructors,
so the reference YAML configs work verbatim.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

_ALIASES: Dict[str, str] = {
    # model stack
    "mode.models.mode_agent.MoDEAgent":
        "mode_diffusion_policy_tpu_torch.config.builders.build_agent",
    "mode.models.edm_diffusion.score_wrappers.GCDenoiser":
        "mode_diffusion_policy_tpu_torch.config.builders.build_denoiser_cfg",
    "mode.models.networks.modedit.MoDeDiT":
        "mode_diffusion_policy_tpu_torch.config.builders.build_dit_cfg",
    "mode.models.networks.clip_lang_encoder.LangClip":
        "mode_diffusion_policy_tpu_torch.config.builders.build_lang_clip",
    # data
    "mode.datasets.hulc_data_module.HulcDataModule":
        "mode_diffusion_policy_tpu_torch.config.builders.build_calvin_datamodule",
    "mode.datasets.libero_data_module.LiberoDataModule":
        "mode_diffusion_policy_tpu_torch.config.builders.build_libero_datamodule",
    "mode.datasets.disk_dataset.ExtendedDiskDataset":
        "mode_diffusion_policy_tpu_torch.data.calvin_dataset.ExtendedDiskDataset",
    "mode.datasets.disk_dataset.DiskDataset":
        "mode_diffusion_policy_tpu_torch.data.calvin_dataset.DiskDataset",
    # rollout / wrappers
    "mode.rollout.rollout_long_horizon.RolloutLongHorizon":
        "mode_diffusion_policy_tpu_torch.rollout.rollout_long_horizon.LongHorizonEvaluator",
    "mode.wrappers.hulc_wrapper.HulcWrapper":
        "mode_diffusion_policy_tpu_torch.rollout.env.CalvinEnvWrapper",
    "mode.callbacks.ema.EMA":
        "mode_diffusion_policy_tpu_torch.config.builders.build_ema_cfg",
    "pytorch_lightning.callbacks.ModelCheckpoint":
        "mode_diffusion_policy_tpu_torch.config.builders.build_checkpoint_cfg",
    # transforms (resolved by the on-device pipeline builder)
    "torchvision.transforms.Resize": "__transform__:resize",
    "torchvision.transforms.Normalize": "__transform__:normalize",
    "mode.utils.transforms.RandomShiftsAug": "__transform__:random_shift",
    "mode.utils.transforms.ScaleImageTensor": "__transform__:scale",
    "mode.utils.transforms.NormalizeVector": "__transform__:normalize_vector",
    "mode.utils.transforms.AddGaussianNoise": "__transform__:gaussian_noise",
    "mode.utils.transforms.AddDepthNoise": "__transform__:depth_noise",
    "mode.utils.transforms.RobustColorJitter": "__transform__:color_jitter",
    "mode.utils.transforms.RobustRandomErasing": "__transform__:random_erasing",
    "mode.utils.transforms.RandomWordDropout": "__transform__:word_dropout",
    "torch.optim.AdamW": "__optimizer__:adamw",
}


def resolve_target(target: str) -> Any:
    target = _ALIASES.get(target, target)
    if target.startswith("__"):
        return target  # sentinel handled by pipeline builders
    module, _, name = target.rpartition(".")
    return getattr(importlib.import_module(module), name)


def instantiate(cfg: Dict, *args, _recursive_: bool | None = None, **kwargs):
    """hydra.utils.instantiate subset: resolve _target_, pass remaining keys
    as kwargs; nested dicts with _target_ are instantiated recursively unless
    _recursive_: false."""
    if not isinstance(cfg, dict) or "_target_" not in cfg:
        raise ValueError("instantiate() requires a dict with _target_")
    cfg = dict(cfg)
    target = cfg.pop("_target_")
    recursive = cfg.pop("_recursive_", True) if _recursive_ is None \
        else _recursive_
    cfg.pop("_partial_", None)
    obj = resolve_target(target)
    if isinstance(obj, str):
        return {"__sentinel__": obj, **cfg}
    call_kwargs = {}
    for k, v in cfg.items():
        if recursive and isinstance(v, dict) and "_target_" in v:
            call_kwargs[k] = instantiate(v)
        else:
            call_kwargs[k] = v
    call_kwargs.update(kwargs)
    return obj(*args, **call_kwargs)
