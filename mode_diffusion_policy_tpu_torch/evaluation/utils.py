"""Evaluation utilities: deterministic seeding, scene resets and result
accounting (counterpart of ``mode_diffusion_policy_tpu/evaluation/utils.py``;
numpy only, copied).

The FNV-hash-seeded scene reset (``get_env_state_for_initial_condition``)
is reproduced bit for bit, including its blue-block placement branch that
keys on the *red* block, because published CALVIN results depend on every
evaluation run placing the blocks identically.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
from collections import Counter
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils.hashing import fnv1_32

logger = logging.getLogger(__name__)

_hasher = fnv1_32()


@contextlib.contextmanager
def temp_seed(seed):
    """Temporarily seed np.random (utils.py:296-303)."""
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)


# neutral-position robot state (utils.py:307-326)
NEUTRAL_ROBOT_OBS = np.array([
    0.02586889, -0.2313129, 0.5712808, 3.09045411, -0.02908596, 1.50013585,
    0.07999963, -1.21779124, 1.03987629, 2.11978254, -2.34205014, -0.87015899,
    1.64119093, 0.55344928, 1.0,
])


def get_env_state_for_initial_condition(initial_condition: Dict
                                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(robot_obs, scene_obs) for a symbolic initial condition, seeded by
    fnv1_32(str(values)) so every run places blocks identically
    (utils.py:306-373)."""
    robot_obs = NEUTRAL_ROBOT_OBS.copy()
    block_rot_z_range = (np.pi / 2 - np.pi / 8, np.pi / 2 + np.pi / 8)
    block_slider_left = np.array([-2.40851662e-01, 9.24044687e-02, 4.60990009e-01])
    block_slider_right = np.array([7.03416330e-02, 9.24044687e-02, 4.60990009e-01])
    block_table = [
        np.array([5.00000896e-02, -1.20000177e-01, 4.59990009e-01]),
        np.array([2.29995412e-01, -1.19995140e-01, 4.59990010e-01]),
    ]
    seed = _hasher(str(initial_condition.values()))
    with temp_seed(seed):
        np.random.shuffle(block_table)
        scene_obs = np.zeros(24)
        if initial_condition["slider"] == "left":
            scene_obs[0] = 0.28
        if initial_condition["drawer"] == "open":
            scene_obs[1] = 0.22
        if initial_condition["lightbulb"] == 1:
            scene_obs[3] = 0.088
        scene_obs[4] = initial_condition["lightbulb"]
        scene_obs[5] = initial_condition["led"]
        # red block
        if initial_condition["red_block"] == "slider_right":
            scene_obs[6:9] = block_slider_right
        elif initial_condition["red_block"] == "slider_left":
            scene_obs[6:9] = block_slider_left
        else:
            scene_obs[6:9] = block_table[0]
        scene_obs[11] = np.random.uniform(*block_rot_z_range)
        # blue block (note: the reference branches on red_block here —
        # preserved verbatim for placement parity, utils.py:355-360)
        if initial_condition["blue_block"] == "slider_right":
            scene_obs[12:15] = block_slider_right
        elif initial_condition["blue_block"] == "slider_left":
            scene_obs[12:15] = block_slider_left
        elif initial_condition["red_block"] == "table":
            scene_obs[12:15] = block_table[1]
        else:
            scene_obs[12:15] = block_table[0]
        scene_obs[17] = np.random.uniform(*block_rot_z_range)
        # pink block
        if initial_condition["pink_block"] == "slider_right":
            scene_obs[18:21] = block_slider_right
        elif initial_condition["pink_block"] == "slider_left":
            scene_obs[18:21] = block_slider_left
        else:
            scene_obs[18:21] = block_table[1]
        scene_obs[23] = np.random.uniform(*block_rot_z_range)
    return robot_obs, scene_obs


def count_success(results: Sequence[int]) -> List[float]:
    """Per-chain-length success rates SR_1..SR_5
    (mode_evaluate.py:49-56): results[i] = number of consecutive subtasks
    solved in chain i."""
    count = Counter(results)
    step_success = []
    for i in range(1, 6):
        n_success = sum(count[j] for j in reversed(range(i, 6)))
        sr = n_success / len(results) if results else 0.0
        step_success.append(sr)
    return step_success


def print_and_save(results: Sequence[int], sequences, log_dir,
                   epoch: str = "0") -> Dict:
    """Aggregate + persist evaluation results (mode_evaluate.py:59-108)."""
    current_data = {}
    ranking = {}
    chain_sr = {i + 1: sr for i, sr in enumerate(count_success(list(results)))}
    avg_seq_len = float(np.mean(list(results))) if len(results) else 0.0
    ranking["avg_seq_len"] = avg_seq_len
    ranking["chain_sr"] = chain_sr

    task_info = {}
    for result, (_, seq) in zip(results, sequences):
        for task in seq[:result]:
            task_info.setdefault(task, {"success": 0, "total": 0})
            task_info[task]["success"] += 1
        for task in seq:
            task_info.setdefault(task, {"success": 0, "total": 0})
            task_info[task]["total"] += 1
    ranking["task_info"] = task_info
    current_data[epoch] = ranking
    os.makedirs(log_dir, exist_ok=True)
    out_path = Path(log_dir) / "results.json"
    previous = {}
    if out_path.exists():
        with open(out_path) as f:
            previous = json.load(f)
    previous.update(current_data)
    with open(out_path, "w") as f:
        json.dump(previous, f, indent=2)
    logger.info("avg_seq_len=%.3f chain_sr=%s", avg_seq_len, chain_sr)
    return ranking


def get_all_checkpoints(experiment_folder: Path) -> List[Path]:
    """The step directories of a run, oldest first: ``<run>/saved_models/
    <step>/``, as ``training.loop.Trainer`` writes them (the best-by-metric
    copy under ``saved_models/best/`` is not a step directory)."""
    ckpt_dir = Path(experiment_folder) / "saved_models"
    if not ckpt_dir.is_dir():
        return []
    steps = sorted(int(p.name) for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.isdigit())
    return [ckpt_dir / str(s) for s in steps]


def get_last_checkpoint(experiment_folder: Path):
    ckpts = get_all_checkpoints(experiment_folder)
    return ckpts[-1] if ckpts else None


class LangEmbeddings:
    """Lookup of precomputed language-goal embeddings from the dataset's
    ``<lang_folder>/embeddings.npy`` (reference evaluation/utils.py:248-256):
    maps an annotation string to its stored embedding for rollout goals
    (numpy, f32, squeezed)."""

    def __init__(self, val_dataset_path,
                 lang_folder: str = "lang_annotations"):
        path = Path(val_dataset_path) / lang_folder / "embeddings.npy"
        self.lang_embeddings = np.load(path, allow_pickle=True).reshape(-1)[0]

    def get_lang_goal(self, task: str):
        return {"lang": np.asarray(self.lang_embeddings[task]["emb"],
                                   np.float32).squeeze()}
