"""CALVIN episode datasets: npz-per-frame episodes read in windows, numpy
on the host (counterpart of
``mode_diffusion_policy_tpu/data/calvin_dataset.py``; copied).

Mirrors the reference's datasets:
- BaseDataset windowing and padding (base_dataset.py:60-296): validation
  window sizes from FNV-1 32 of the index, random or geometric training
  windows from a numpy generator, repeat-last padding with zero-padded
  relative actions.
- DiskDataset / ExtendedDiskDataset (disk_dataset.py:29-290): npz frames
  found through the detected naming pattern, the ``auto_lang_ann.npy``
  language index, ``ep_start_end_ids.npy`` boundaries, obs_seq_len /
  action_seq_len splits, and the packed ``extracted/ep_rel_actions.npy``
  actions (``data/preprocess.py``), which spare a disk read per action
  frame (README.md:73-76).

Items are dicts of numpy arrays; the frames stay uint8 until the train step
preprocesses them on the card. ``DEFAULT_OBS_SPACE`` and
``DEFAULT_PROPRIO`` are also what the evaluation env wrapper reads.
"""
from __future__ import annotations

import logging
import os
import pickle
from itertools import chain
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..utils.hashing import fnv1_32, get_validation_window_size
from .episode_utils import (get_state_info_dict, lookup_naming_pattern,
                            process_actions, process_depth, process_language,
                            process_rgb, process_state)

logger = logging.getLogger(__name__)

DEFAULT_OBS_SPACE = {
    "rgb_obs": ["rgb_static", "rgb_gripper"],
    "depth_obs": [],
    "state_obs": ["robot_obs"],
    "actions": ["rel_actions"],
    "language": ["language"],
}

DEFAULT_PROPRIO = {
    "n_state_obs": 8,
    "keep_indices": [[0, 7], [14, 15]],
    "robot_orientation_idx": [3, 6],
    "normalize": True,
    "normalize_robot_orientation": True,
}


class BaseCalvinDataset:
    """Window-sampling dataset over frame-indexed episodes
    (base_dataset.py:40-296)."""

    def __init__(self, datasets_dir, *, obs_space=None, proprio_state=None,
                 key: str = "lang", lang_folder: str = "lang_annotations",
                 batch_size: int = 32, min_window_size: int = 16,
                 max_window_size: int = 32, pad: bool = True,
                 aux_lang_loss_window: int = 1,
                 window_sampling_strategy: str = "random",
                 geometric_p_value: float = 0.1,
                 seed: int = 0):
        self.observation_space = obs_space or DEFAULT_OBS_SPACE
        self.proprio_state = proprio_state or DEFAULT_PROPRIO
        self.with_lang = key == "lang"
        self.relative_actions = "rel_actions" in self.observation_space["actions"]
        assert window_sampling_strategy in ("random", "geometric")
        self.window_sampling_strategy = window_sampling_strategy
        self.geometric_p_value = geometric_p_value
        self.pad = pad
        self.batch_size = batch_size
        self.min_window_size = min_window_size
        self.max_window_size = max_window_size
        self.abs_datasets_dir = Path(datasets_dir)
        self.lang_folder = lang_folder
        self.aux_lang_loss_window = aux_lang_loss_window
        assert ("validation" in self.abs_datasets_dir.as_posix()
                or "training" in self.abs_datasets_dir.as_posix())
        self.validation = "validation" in self.abs_datasets_dir.as_posix()
        assert self.abs_datasets_dir.is_dir()
        self._rng = np.random.default_rng(seed)
        self._hasher = fnv1_32()

    # -- indexing ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self.episode_lookup)

    def __getitem__(self, idx: Union[int, Tuple[int, int]]) -> Dict:
        if isinstance(idx, int):
            if self.min_window_size == self.max_window_size:
                window_size = self.max_window_size
            elif self.min_window_size < self.max_window_size:
                window_size = self._get_window_size(idx)
            else:
                raise ValueError(
                    f"min_window_size {self.min_window_size} > "
                    f"max_window_size {self.max_window_size}")
        else:
            idx, window_size = idx
        sequence = self._get_sequences(idx, window_size)
        if self.pad:
            pad_size = self.max_window_size - len(sequence["actions"])
            sequence = self._pad_sequence(sequence, pad_size)
        return sequence

    def _get_sequences(self, idx: int, window_size: int) -> Dict:
        episode = self._load_episode(idx, window_size)
        seq = {}
        seq.update(process_state(episode, self.observation_space,
                                 self.proprio_state))
        seq.update(process_rgb(episode, self.observation_space))
        seq.update(process_depth(episode, self.observation_space))
        seq.update(process_actions(episode, self.observation_space))
        seq.update(get_state_info_dict(episode))
        seq.update(process_language(episode, self.with_lang))
        seq = self._add_language_info(seq, idx)
        seq["idx"] = idx
        return seq

    def _load_episode(self, idx: int, window_size: int):
        raise NotImplementedError

    def _get_window_size(self, idx: int) -> int:
        """base_dataset.py:155-192: cap window at episode boundary; hash in
        validation, random/geometric in training."""
        window_diff = self.max_window_size - self.min_window_size
        if len(self.episode_lookup) <= idx + window_diff:
            max_window = self.min_window_size + len(self.episode_lookup) - idx - 1
        elif (self.episode_lookup[idx + window_diff]
              != self.episode_lookup[idx] + window_diff):
            steps_to_next_episode = int(np.nonzero(
                self.episode_lookup[idx: idx + window_diff + 1]
                - (self.episode_lookup[idx] + np.arange(window_diff + 1)))[0][0])
            max_window = min(self.max_window_size,
                             self.min_window_size + steps_to_next_episode - 1)
        else:
            max_window = self.max_window_size

        if self.validation:
            return get_validation_window_size(idx, self.min_window_size,
                                              max_window, self._hasher)
        if self.window_sampling_strategy == "geometric":
            while True:
                w = 1 + self._rng.geometric(self.geometric_p_value)
                if self.min_window_size <= w <= max_window:
                    return int(w)
        return int(self._rng.integers(self.min_window_size, max_window + 1))

    # -- padding (base_dataset.py:213-276) --------------------------------
    def _pad_sequence(self, seq: Dict, pad_size: int) -> Dict:
        seq["robot_obs"] = self._pad_rep(seq["robot_obs"], pad_size)
        seq["rgb_obs"] = {k: self._pad_rep(v, pad_size)
                          for k, v in seq["rgb_obs"].items()}
        seq["depth_obs"] = {k: self._pad_rep(v, pad_size)
                            for k, v in seq["depth_obs"].items()}
        if not self.relative_actions:
            seq["actions"] = self._pad_rep(seq["actions"], pad_size)
        else:
            # zero-pad xyz/rot dims, repeat gripper dim (base_dataset.py:246-256)
            seq["actions"] = np.concatenate([
                self._pad_zeros(seq["actions"][..., :-1], pad_size),
                self._pad_rep(seq["actions"][..., -1:], pad_size)], axis=-1)
        seq["state_info"] = {k: self._pad_rep(v, pad_size)
                             for k, v in seq["state_info"].items()}
        return seq

    @staticmethod
    def _pad_rep(arr: np.ndarray, pad_size: int) -> np.ndarray:
        if pad_size <= 0:
            return arr
        last = np.repeat(arr[-1:], pad_size, axis=0)
        return np.concatenate([arr, last], axis=0)

    @staticmethod
    def _pad_zeros(arr: np.ndarray, pad_size: int) -> np.ndarray:
        if pad_size <= 0:
            return arr
        zeros = np.zeros((pad_size,) + arr.shape[1:], arr.dtype)
        return np.concatenate([arr, zeros], axis=0)

    def _add_language_info(self, info: Dict, idx: int) -> Dict:
        if not self.with_lang:
            return info
        use = (idx + self.aux_lang_loss_window >= len(self.lang_lookup)
               or self.lang_lookup[idx] <
               self.lang_lookup[idx + self.aux_lang_loss_window])
        info["use_for_aux_lang_loss"] = use
        return info


def _load_pkl(p):
    with open(p, "rb") as f:
        return pickle.load(f)


def _load_npz(p):
    return np.load(p, allow_pickle=True)


class DiskDataset(BaseCalvinDataset):
    """npz/pkl-per-frame loader (disk_dataset.py:29-160). Pass ``shm_cache``
    (a data.shm_cache.SharedEpisodeCache) to serve frames zero-copy from
    shared memory instead of per-frame npz reads (the reference's
    SharedMemoryLoader fast path)."""

    def __init__(self, *args, skip_frames: int = 1, save_format: str = "npz",
                 pretrain: bool = False, shm_cache=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.save_format = save_format
        self.shm_cache = shm_cache
        if save_format == "pkl":
            self.load_file = _load_pkl
        elif save_format == "npz":
            self.load_file = _load_npz
        else:
            raise NotImplementedError(save_format)
        self.pretrain = pretrain
        self.skip_frames = skip_frames
        if self.with_lang:
            (self.episode_lookup, self.lang_lookup, self.lang_ann,
             self.lang_text) = self._build_file_indices_lang(
                 self.abs_datasets_dir)
        else:
            self.episode_lookup = self._build_file_indices(
                self.abs_datasets_dir)
        self.naming_pattern, self.n_digits = lookup_naming_pattern(
            self.abs_datasets_dir, self.save_format)

    def _get_episode_name(self, file_idx: int) -> Path:
        return Path(f"{self.naming_pattern[0]}"
                    f"{file_idx:0{self.n_digits}d}{self.naming_pattern[1]}")

    def _read_stacked(self, start_idx: int, end_idx: int, keys) -> Dict:
        """Stacked [T, ...] frame data, preferring the shared-memory cache."""
        if self.shm_cache is not None and all(k in self.shm_cache
                                              for k in keys):
            return {k: np.stack([self.shm_cache.episode(i, k)
                                 for i in range(start_idx, end_idx)])
                    for k in keys}
        eps = [self.load_file(self._get_episode_name(i))
               for i in range(start_idx, end_idx)]
        return {k: np.stack([ep[k] for ep in eps]) for k in keys}

    def _load_episode(self, idx: int, window_size: int):
        start_idx = self.episode_lookup[idx]
        keys = list(chain(*self.observation_space.values()))
        keys.remove("language")
        keys.append("scene_obs")
        episode = self._read_stacked(start_idx, start_idx + window_size, keys)
        if self.with_lang:
            episode["language"] = self.lang_ann[self.lang_lookup[idx]][0]
            episode["language_text"] = self.lang_text[self.lang_lookup[idx]]
        return episode

    def _build_file_indices_lang(self, d: Path):
        """disk_dataset.py:99-138."""
        for cand in (d / self.lang_folder / "auto_lang_ann.npy",
                     d / "auto_lang_ann.npy"):
            if cand.exists():
                lang_data = np.load(cand, allow_pickle=True).item()
                break
        else:
            raise FileNotFoundError(f"auto_lang_ann.npy not found under {d}")
        ep_start_end_ids = lang_data["info"]["indx"]
        lang_ann = lang_data["language"]["emb"]
        lang_text = lang_data["language"]["ann"]
        episode_lookup, lang_lookup = [], []
        for i, (start_idx, end_idx) in enumerate(ep_start_end_ids):
            if self.pretrain:
                start_idx = max(start_idx, end_idx + 1 - self.min_window_size
                                - self.aux_lang_loss_window)
            assert end_idx >= self.max_window_size
            cnt = 0
            for idx in range(start_idx, end_idx + 1 - self.min_window_size):
                if cnt % self.skip_frames == 0:
                    lang_lookup.append(i)
                    episode_lookup.append(idx)
                cnt += 1
        return np.array(episode_lookup), lang_lookup, lang_ann, lang_text

    def _build_file_indices(self, d: Path) -> np.ndarray:
        ep_start_end_ids = np.load(d / "ep_start_end_ids.npy")
        episode_lookup = []
        for start_idx, end_idx in ep_start_end_ids:
            assert end_idx > self.max_window_size
            episode_lookup.extend(
                range(start_idx, end_idx + 1 - self.min_window_size))
        return np.array(episode_lookup)


class ExtendedDiskDataset(DiskDataset):
    """obs_seq_len frames + action_seq_len actions per item, with the packed
    rel-actions fast path (disk_dataset.py:163-290)."""

    def __init__(self, *args, obs_seq_len: int = 1, action_seq_len: int = 10,
                 future_range: int = 1, use_extracted_rel_actions: bool = False,
                 extracted_dir: str = "extracted/", **kwargs):
        super().__init__(*args, **kwargs)
        self.obs_seq_len = obs_seq_len
        self.action_seq_len = action_seq_len
        self.future_range = future_range
        self.ep_start_end_ids = np.load(
            self.abs_datasets_dir / "ep_start_end_ids.npy")
        self.use_extracted_rel_actions = use_extracted_rel_actions
        if use_extracted_rel_actions:
            self.extracted_dir = extracted_dir
            if not os.path.exists(extracted_dir):
                self.extracted_dir = os.path.join(self.abs_datasets_dir,
                                                  "extracted")
                assert os.path.exists(self.extracted_dir), (
                    f"extracted dir not found at {self.extracted_dir} — run "
                    "python -m mode_diffusion_policy_tpu_torch.data."
                    "preprocess --in-root <split dir> first, or set "
                    "use_extracted_rel_actions=false")
            with open(os.path.join(self.extracted_dir,
                                   "ep_npz_names.list")) as f:
                names = [int(x.strip()) for x in f.readlines()]
            self._ex_name_to_idx = {n: i for i, n in enumerate(names)}
            self.extracted_ep_rel_actions = np.load(
                os.path.join(self.extracted_dir, "ep_rel_actions.npy"))

    def _load_episode(self, idx: int, window_size: int):
        start_idx = self.episode_lookup[idx]
        end_idx = start_idx + self.action_seq_len + self.obs_seq_len - 1
        keys = list(chain(*self.observation_space.values()))
        keys.remove("language")
        keys.append("scene_obs")

        if not self.use_extracted_rel_actions:
            data = self._read_stacked(start_idx, end_idx, keys)
        else:
            data = self._read_stacked(start_idx, start_idx + self.obs_seq_len,
                                      keys)
            ex_indices = [self._ex_name_to_idx[i]
                          for i in range(start_idx, end_idx)]
            ex_actions = self.extracted_ep_rel_actions[ex_indices, :]

        o = self.obs_seq_len
        episode = {}
        for key in keys:
            stacked = data[key]
            if key in ("rel_actions", "actions"):
                if self.use_extracted_rel_actions:
                    episode[key] = ex_actions[(o - 1):(o - 1) + self.action_seq_len, :]
                else:
                    episode[key] = stacked[(o - 1):(o - 1) + self.action_seq_len, :]
            else:
                episode[key] = stacked[:o]
        if self.with_lang:
            episode["language"] = self.lang_ann[self.lang_lookup[idx]][0]
            episode["language_text"] = self.lang_text[self.lang_lookup[idx]]
        return episode


class SubsetDiskDataset(ExtendedDiskDataset):
    """Random percentage subset (disk_dataset.py:290-330)."""

    def __init__(self, *args, subset_percentage: float = 0.1,
                 subset_seed: Optional[int] = 42, **kwargs):
        super().__init__(*args, **kwargs)
        rng = np.random.default_rng(subset_seed)
        n = len(self.episode_lookup)
        keep = max(1, int(n * subset_percentage))
        self._subset_indices = np.sort(rng.choice(n, keep, replace=False))

    def __len__(self):
        return len(self._subset_indices)

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            i, w = idx
            return super().__getitem__((int(self._subset_indices[i]), w))
        return super().__getitem__(int(self._subset_indices[idx]))


class LabeledSubsetDiskDataset(ExtendedDiskDataset):
    """Random subset restricted to language-labeled frames
    (disk_dataset.py:329-365). Uses index indirection instead of mutating
    episode_lookup, so lang_lookup stays aligned."""

    def __init__(self, *args, subset_percentage: float = 0.1,
                 subset_seed: Optional[int] = 42, **kwargs):
        super().__init__(*args, **kwargs)
        rng = np.random.default_rng(subset_seed)
        lang_data = np.load(self.abs_datasets_dir / self.lang_folder
                            / "auto_lang_ann.npy", allow_pickle=True).item()
        labeled = []
        for start_idx, end_idx in lang_data["info"]["indx"]:
            labeled.extend(range(start_idx, end_idx + 1))
        mask = np.isin(self.episode_lookup, np.asarray(labeled))
        labeled_idx = np.where(mask)[0]
        keep = max(1, int(len(labeled_idx) * subset_percentage))
        self._subset_indices = np.sort(
            rng.choice(labeled_idx, keep, replace=False))
        logger.info("labeled subset: %d/%d frames", keep, len(labeled_idx))

    def __len__(self):
        return len(self._subset_indices)

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            i, w = idx
            return super().__getitem__((int(self._subset_indices[i]), w))
        return super().__getitem__(int(self._subset_indices[idx]))


class BalancedLabeledSubsetDataset(ExtendedDiskDataset):
    """Task-balanced labeled subset (disk_dataset.py:369-418): sample at
    least ``min_samples_per_task`` frames per task, proportional above."""

    def __init__(self, *args, subset_percentage: float = 0.1,
                 subset_seed: Optional[int] = 42,
                 min_samples_per_task: int = 10, **kwargs):
        super().__init__(*args, **kwargs)
        from collections import defaultdict
        rng = np.random.default_rng(subset_seed)
        lang_data = np.load(self.abs_datasets_dir / self.lang_folder
                            / "auto_lang_ann.npy", allow_pickle=True).item()
        tasks = lang_data["language"].get("task",
                                          lang_data["language"]["ann"])
        task_to_frames = defaultdict(list)
        for i, (start_idx, end_idx) in enumerate(lang_data["info"]["indx"]):
            task_to_frames[tasks[i]].extend(range(start_idx, end_idx + 1))
        selected = []
        for task, frames in task_to_frames.items():
            n = max(min_samples_per_task,
                    int(len(frames) * subset_percentage))
            if n >= len(frames):
                selected.extend(frames)
            else:
                selected.extend(rng.choice(frames, n, replace=False))
        mask = np.isin(self.episode_lookup, np.asarray(selected))
        self._subset_indices = np.where(mask)[0]
        logger.info("balanced subset: %d frames across %d tasks",
                    len(self._subset_indices), len(task_to_frames))

    def __len__(self):
        return len(self._subset_indices)

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            i, w = idx
            return super().__getitem__((int(self._subset_indices[i]), w))
        return super().__getitem__(int(self._subset_indices[idx]))
