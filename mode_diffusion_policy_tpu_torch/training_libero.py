"""LIBERO training entry point (counterpart of
``mode_diffusion_policy_tpu/training_libero.py``), for one card.

The run of ``training_calvin.py`` (``train_with``: the device rule, the
CLIP tower's cache on the card, auto-resume, pretrained weights for a
fresh run, the EMA, crash forensics, ``.hydra/config.yaml``) on the
shipped ``conf/config_libero.yaml`` with dotted overrides: the LIBERO
datamodule (``data/libero.py``: robomimic hdf5 task files, read inline)
and the LIBERO rollout hook. The shipped transforms train the static
camera at 224 px and the gripper camera at 112 px.

The rollout hook's benchmark is ``libero_benchmark`` when the config sets
it (the key the JAX entry point reads), else ``benchmark_name`` (the key
``conf/config_libero.yaml`` sets).

Usage:
    python -m mode_diffusion_policy_tpu_torch.training_libero \\
        root_data_dir=/data/libero benchmark_name=libero_10 \\
        [batch_size=128] [trainer.max_epochs=20] ...
"""
from __future__ import annotations

import logging
import sys
from typing import Dict

from .training_calvin import CONF_DIR, TrainingRun, train_with

logger = logging.getLogger(__name__)


def train(cfg: Dict) -> TrainingRun:
    from .config.builders import build_libero_datamodule
    from .training_common import build_libero_rollout_callback

    def rollout(rollout_cfg, lang_cache, pipelines):
        rollout_cfg.setdefault("benchmark_name", cfg.get(
            "libero_benchmark", cfg.get("benchmark_name")))
        return build_libero_rollout_callback(rollout_cfg, lang_cache,
                                             pipelines)

    return train_with(cfg, build_datamodule=build_libero_datamodule,
                      build_rollout=rollout, default_name="mode_libero")


def main(argv=None) -> TrainingRun:
    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    from .config.loader import load_config
    cfg = load_config(CONF_DIR, "config_libero", overrides=argv)
    return train(cfg)


if __name__ == "__main__":
    from .data.datamodule import stop_helper_processes
    try:
        main()
    finally:
        stop_helper_processes()
