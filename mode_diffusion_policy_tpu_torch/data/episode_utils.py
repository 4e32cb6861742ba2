"""Host-side episode processing, numpy only (counterpart of
``mode_diffusion_policy_tpu/data/episode_utils.py``; copied).

Mirrors the reference's ``datasets/utils/episode_utils.py``. Image arrays
stay uint8 NHWC on the host: the camera transforms run on the card inside
the train step (``ops/image.py``), where the reference runs torchvision
transforms in every loader worker.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def process_state(episode: Dict[str, np.ndarray], observation_space,
                  proprio_state) -> Dict[str, np.ndarray]:
    """Concatenate + slice proprioceptive state
    (episode_utils.py:14-59; keep_indices default [[0,7],[14,15]],
    conf/datamodule/calvin.yaml:21-25)."""
    state_obs_keys = observation_space["state_obs"]
    parts = []
    for key in state_obs_keys:
        arr = np.asarray(episode[key], np.float32)
        if arr.ndim != 2:
            arr = arr[None]
        parts.append(arr)
    seq = np.concatenate(parts, axis=1)
    sliced = [seq[:, slice(*ids)] for ids in proprio_state["keep_indices"]]
    return {"robot_obs": np.concatenate(sliced, axis=1)}


def process_rgb(episode: Dict[str, np.ndarray],
                observation_space) -> Dict[str, Dict[str, np.ndarray]]:
    """uint8 NHWC camera streams (episode_utils.py:62-91 keeps NCHW byte
    tensors; NHWC is the layout ``ops/image.preprocess_camera`` reads)."""
    out = {}
    for key in observation_space["rgb_obs"]:
        if key not in episode:
            continue
        arr = np.asarray(episode[key])
        if arr.ndim != 4:
            arr = arr[None]
        out[key] = arr.astype(np.uint8)
    return {"rgb_obs": out}


def process_depth(episode, observation_space):
    out = {}
    for key in observation_space.get("depth_obs", []):
        if key not in episode:
            continue
        arr = np.asarray(episode[key], np.float32)
        if arr.ndim != 3:
            arr = arr[None]
        out[key] = arr
    return {"depth_obs": out}


def process_actions(episode, observation_space) -> Dict[str, np.ndarray]:
    """episode_utils.py:126-153: single action key -> 'actions'."""
    action_keys = observation_space["actions"]
    if len(action_keys) != 1:
        raise NotImplementedError("multiple action keys not supported")
    actions = np.asarray(episode[action_keys[0]], np.float32)
    if actions.ndim != 2:
        actions = actions[None]
    return {"actions": actions}


def process_language(episode, with_lang: bool) -> Dict[str, Any]:
    out = {}
    if with_lang:
        out["lang"] = np.asarray(episode["language"], np.float32)
        if "language_text" in episode:
            out["lang_text"] = episode["language_text"]
    return out


def get_state_info_dict(episode) -> Dict[str, Dict[str, np.ndarray]]:
    """Raw robot/scene state passed through for env resets
    (episode_utils.py:156-173)."""
    return {"state_info": {
        "robot_obs": np.asarray(episode["robot_obs"], np.float32),
        "scene_obs": np.asarray(episode["scene_obs"], np.float32),
    }}


def load_dataset_statistics(train_dir, val_dir, transforms: Dict) -> Dict:
    """Merge per-dataset statistics.yaml transform overrides
    (episode_utils.py:176-213). transforms: {'train': {mod: [specs]},
    'val': ...} with spec dicts carrying '_target_'. PyYAML is imported
    only when a statistics.yaml exists."""
    from ..config.loader import require_yaml
    paths = {"train": train_dir, "val": val_dir}
    for dataset_type in ("train", "val"):
        stats_path = Path(paths[dataset_type]) / "statistics.yaml"
        if not stats_path.exists():
            continue
        with open(stats_path) as f:
            statistics = require_yaml().safe_load(
                f.read().replace("calvin_agent", "mode"))
        for modality in list(transforms.get(dataset_type, {})):
            if modality not in statistics:
                continue
            conf_transforms = transforms[dataset_type][modality]
            for dataset_trans in statistics[modality]:
                for i, conf_trans in enumerate(conf_transforms):
                    if dataset_trans["_target_"] == conf_trans["_target_"]:
                        conf_transforms[i] = dataset_trans
                        break
                else:
                    conf_transforms.append(dataset_trans)
    return transforms


def lookup_naming_pattern(dataset_dir, save_format: str
                          ) -> Tuple[Tuple[Path, str], int]:
    """Detect 'episode_0000001.npz' -> (('<dir>/episode_', '.npz'), 7)
    (episode_utils.py:216-238)."""
    it = os.scandir(dataset_dir)
    while True:
        filename = Path(next(it))
        if save_format in filename.suffix:
            break
    aux = re.split(r"\d+", filename.stem)
    naming_pattern = (filename.parent / aux[0], filename.suffix)
    n_digits = len(re.findall(r"\d+", filename.stem)[0])
    assert n_digits > 0
    return naming_pattern, n_digits
