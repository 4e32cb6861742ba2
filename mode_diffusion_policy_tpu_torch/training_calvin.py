"""CALVIN training entry point (counterpart of
``mode_diffusion_policy_tpu/training_calvin.py``), for one card.

The reference's training_calvin.py:59-175 without Lightning or Hydra: the
same config surface (the unchanged ``conf/config_calvin.yaml`` read by
``config/loader.py``, plus dotted overrides), the episode store on disk
through ``data/datamodule.py`` (worker processes, the shared-memory cache),
the language goals through the CLIP tower's cache on the card, auto-resume
from the newest checkpoint, pretrained weights for a fresh run, the EMA
and the rollout hook, and crash forensics. Camera augmentation runs on the
card inside the train step (``training_common.make_train_preprocess``):
raw uint8 frames go to the card once.

``train_with`` is the run itself, which ``training_libero.py`` shares
with its own datamodule and rollout hook.

The run directory is ``<log_dir>/<logger.name>``: ``saved_models/`` (the
``Trainer``'s checkpoints), ``metrics.jsonl`` and ``.hydra/config.yaml``
(the resolved config), which ``evaluate_calvin --checkpoint`` restores.

The shipped config says ``device: tpu`` and a global batch of 128: here
``device`` ``tpu``, ``cuda`` or ``gpu`` trains on the first CUDA card
(raising without one) and ``cpu`` on the CPU; any other value raises. With
more than one card visible it trains on one and says so (data parallelism
across cards is not ported). ``trainer.auto_layout`` is accepted and
changes nothing (``training/loop.py``).

Usage (extract the packed actions first, as
``use_extracted_rel_actions: true`` asks):
    python -m mode_diffusion_policy_tpu_torch.data.preprocess \\
        --in-root /data/calvin/task_D_D/training
    python -m mode_diffusion_policy_tpu_torch.data.preprocess \\
        --in-root /data/calvin/task_D_D/validation
    python -m mode_diffusion_policy_tpu_torch.training_calvin \\
        root_data_dir=/data/calvin/task_D_D batch_size=32 \\
        [trainer.max_epochs=20] [datamodule.use_shm_cache=true] ...
"""
from __future__ import annotations

import dataclasses
import logging
import sys
import traceback
from pathlib import Path
from typing import Any, Callable, Dict

import torch

logger = logging.getLogger(__name__)

CONF_DIR = Path(__file__).resolve().parents[1] / "conf"


@dataclasses.dataclass
class TrainingRun:
    """What one ``train`` call left: the final state, its trainer, the run
    directory, and the step it started from (0, or the resumed one)."""

    state: Any
    trainer: Any
    run_dir: Path
    start_step: int


def train_device(cfg: Dict) -> torch.device:
    """The config's ``device`` as a torch device: ``cpu``, or the first
    CUDA card for ``tpu`` (the shipped value), ``cuda`` or ``gpu``."""
    from .utils.device import resolve_device
    name = str(cfg.get("device", "cuda")).strip().lower()
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("tpu", "cuda", "gpu"):
        raise ValueError(f"device={name!r}: train on 'cuda' (also read from "
                         "'tpu' and 'gpu') or 'cpu'")
    dev = resolve_device("cuda:0")
    n = torch.cuda.device_count()
    if n > 1:
        logger.warning("%d CUDA devices visible: training on cuda:0 only "
                       "(data parallelism across cards is not ported)", n)
    return dev


def _flag(v) -> bool:
    return str(v).strip().lower() == "true"


def train(cfg: Dict) -> TrainingRun:
    from .config.builders import build_calvin_datamodule
    from .training_common import build_calvin_rollout_callback

    def rollout(rollout_cfg, lang_cache, pipelines):
        rollout_cfg.setdefault("dataset_path", cfg.get("root_data_dir"))
        return build_calvin_rollout_callback(rollout_cfg, lang_cache,
                                             pipelines)

    return train_with(cfg, build_datamodule=build_calvin_datamodule,
                      build_rollout=rollout, default_name="mode_calvin")


def train_with(cfg: Dict, *, build_datamodule: Callable,
               build_rollout: Callable, default_name: str) -> TrainingRun:
    """One training run of the resolved config ``cfg`` on its ``device``:
    ``build_datamodule(cfg["datamodule"], lang_embed=)`` makes the
    datamodule (set up here, closed at the end), ``build_rollout(
    rollout_cfg, lang_cache, pipelines)`` the rollout hook or None, and the
    run directory is ``<log_dir>/<logger.name or default_name>``."""
    from .config.builders import (build_agent, build_checkpoint_cfg,
                                  build_ema_cfg, build_lang_clip)
    from .models.encoders.lang_cache import LangEmbeddingCache
    from .training.loop import Trainer
    from .training_common import (load_pretrained_into_state,
                                  make_data_iters, make_train_preprocess,
                                  parse_camera_pipelines,
                                  persist_resolved_config)
    from .utils.utils import log_environment_info

    dev = train_device(cfg)
    log_environment_info(logger, dev)
    seed = int(cfg.get("seed", 42))
    trainer_cfg = cfg.get("trainer", {})
    callbacks_cfg = cfg.get("callbacks", {})
    dtype = torch.bfloat16 if str(trainer_cfg.get(
        "precision", "bf16")).startswith("bf16") else torch.float32
    agent, optimizer_kwargs, lang_cfg = build_agent(cfg["model"],
                                                    dtype=dtype, device=dev)

    lang = build_lang_clip(**{k: v for k, v in lang_cfg.items()
                              if not k.startswith("_")},
                           clip_checkpoint=cfg.get("clip_checkpoint"),
                           device=dev)
    lang_cache = LangEmbeddingCache(lang)
    datamodule = build_datamodule(cfg["datamodule"],
                                  lang_embed=lang_cache).setup()
    try:
        pipelines = parse_camera_pipelines(
            cfg["datamodule"].get("transforms"))
        # the in-training rollout: the real simulator when installed, the
        # fake env when callbacks.rollout_lh.fake_env=true, else none
        rollout_cfg = dict(callbacks_cfg.get("rollout_lh", {}))
        rollout_callback = build_rollout(rollout_cfg, lang_cache, pipelines)

        trainer = Trainer(
            agent,
            log_dir=str(Path(cfg.get("log_dir", "runs"))
                        / cfg.get("logger", {}).get("name", default_name)),
            max_epochs=int(trainer_cfg.get("max_epochs", 20)),
            limit_train_batches=int(trainer_cfg.get("limit_train_batches",
                                                    1000)),
            limit_val_batches=int(trainer_cfg.get("limit_val_batches", 4)),
            rollout_freq=int(rollout_cfg.get("rollout_freq", 5)),
            optimizer_kwargs=optimizer_kwargs,
            ema_kwargs=build_ema_cfg(**callbacks_cfg.get("ema", {})),
            checkpoint_kwargs=build_checkpoint_cfg(
                **callbacks_cfg.get("checkpoint", {})),
            use_wandb=bool(cfg.get("logger", {}).get("use_wandb", False)),
            rollout_callback=rollout_callback,
            preprocess_fn=make_train_preprocess(pipelines),
            auto_layout=_flag(trainer_cfg.get("auto_layout", False)),
            bf16_full_state=_flag(trainer_cfg.get("bf16_full_state",
                                                  False)),
            device=dev)
        # the resolved config in the run dir (the reference's .hydra
        # layout): the evaluation CLIs rebuild the model from it
        run_dir = Path(trainer.logger.log_dir)
        persist_resolved_config(cfg, run_dir)

        state = trainer.setup(seed=seed)
        start_step = state.step
        if trainer.resumed:
            logger.info("resumed: continuing from step %d, epoch %d",
                        state.step, state.epoch)
        # start_from_pretrained applies only to a fresh run: a restored
        # checkpoint keeps its weights (a crash restart must not reset the
        # weights while keeping the optimizer and LR state)
        model_cfg = cfg.get("model", {})
        if (model_cfg.get("start_from_pretrained")
                and model_cfg.get("ckpt_path") and not trainer.resumed):
            state = load_pretrained_into_state(state, cfg, logger)

        train_iter, val_iter = make_data_iters(datamodule, pipelines,
                                               device=dev)
        try:
            state = trainer.fit(state, train_iter, val_iter)
        except Exception:
            # crash forensics (the reference's training_calvin.py:116-132)
            exc_type, exc_value, tb = sys.exc_info()
            logger.error("training crashed:\n%s", "".join(
                traceback.format_exception(exc_type, exc_value, tb)))
            frames = traceback.extract_tb(tb)
            if frames:
                logger.error("crash frame: %s:%d in %s", frames[-1].filename,
                             frames[-1].lineno, frames[-1].name)
            raise
        finally:
            trainer.logger.close()
    finally:
        datamodule.close()
    return TrainingRun(state, trainer, run_dir, start_step)


def main(argv=None) -> TrainingRun:
    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    from .config.loader import load_config
    cfg = load_config(CONF_DIR, "config_calvin", overrides=argv)
    return train(cfg)


if __name__ == "__main__":
    from .data.datamodule import stop_helper_processes
    try:
        main()
    finally:
        stop_helper_processes()
