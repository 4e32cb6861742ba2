"""LIBERO data: robomimic-layout hdf5 sequence datasets and the data module
(counterpart of ``mode_diffusion_policy_tpu/data/libero.py``; numpy only).

- ``LiberoSequenceDataset``: one task file (``data/demo_N/{obs/...,
  actions}``), one index per frame, fixed-length windows repeat-padded at
  the demo's ends (robomimic's ``pad_frame_stack``/``pad_seq_length``),
  frame stacking, ``goal_mode="last"``, ``next_obs``, and the full
  in-memory cache (``cache_all``, robomimic's hdf5_cache_mode 'all').
  ``demo_arrays=`` hands it the demos in the layout that ``cache_all``
  holds ({demo: {"actions", obs key: array}}, arrays or memory maps)
  instead of the file: the same items without ``h5py``.
- The item is translated to the CALVIN-style interface: agentview_rgb ->
  rgb_static, eye_in_hand_rgb -> rgb_gripper, robot_obs = [joint_states ‖
  gripper_states[0]].
- ``LiberoDataModule``: the tasks of a benchmark concatenated, with one
  language embedding per task; a seeded 95/5 split and a ``seed + epoch``
  shuffle of this process's share, batches assembled inline (synchronous,
  as the JAX package's). Uses the LIBERO benchmark package when installed,
  else scans a directory of ``*_demo.hdf5`` files and takes each task's
  instruction from its file name (the LIBERO convention).

``h5py`` is imported only where a file is opened.
"""
from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

import numpy as np

from ..parallel.mesh import process_local_slice
from .datamodule import collate_episodes, embed_texts

logger = logging.getLogger(__name__)


def task_description_from_filename(path: str) -> str:
    """LIBERO convention: SCENE10_put_the_butter_in_the_basket_demo.hdf5 ->
    'put the butter in the basket'."""
    stem = Path(path).stem
    stem = re.sub(r"_demo$", "", stem)
    stem = re.sub(r"^[A-Z0-9_]*SCENE\d*_", "", stem)
    return stem.replace("_", " ").strip()


def _demo_order(demos) -> List[str]:
    return sorted(demos, key=lambda d: int(d.split("_")[1]))


class LiberoSequenceDataset:
    """robomimic SequenceDataset semantics: per-demo index maps with
    pad_frame_stack/pad_seq_length offsets, repeat-padded windows, optional
    frame stacking, goal_mode ("last" -> the demo's final observation as
    goal_obs) and next_obs."""

    OBS_KEYS = ("agentview_rgb", "eye_in_hand_rgb", "joint_states",
                "gripper_states")

    def __init__(self, hdf5_path: str, *, seq_len: int = 10,
                 obs_seq_len: int = 1, obs_keys=None,
                 cache_all: bool = False,
                 task_description: Optional[str] = None,
                 task_emb=None,
                 frame_stack: int = 1,
                 pad_frame_stack: bool = True,
                 pad_seq_length: bool = True,
                 goal_mode: Optional[str] = None,
                 load_next_obs: bool = False,
                 demo_arrays: Optional[Mapping[str, Mapping]] = None):
        if goal_mode not in (None, "last"):
            raise ValueError(f"unsupported goal_mode {goal_mode!r} "
                             "(robomimic allows 'last')")
        self.hdf5_path = str(hdf5_path)
        self.seq_len = seq_len
        self.obs_seq_len = obs_seq_len
        self.obs_keys = tuple(obs_keys or self.OBS_KEYS)
        self.task_description = (task_description or
                                 task_description_from_filename(hdf5_path))
        self.task_emb = task_emb
        self.frame_stack = int(frame_stack)
        self.pad_frame_stack = pad_frame_stack
        self.pad_seq_length = pad_seq_length
        self.goal_mode = goal_mode
        self.load_next_obs = load_next_obs
        self._h5 = None
        self._cache = None
        self._arrays = demo_arrays

        if demo_arrays is None:
            import h5py
            with h5py.File(self.hdf5_path, "r") as f:
                self.demos = _demo_order(f["data"].keys())
                self._demo_lengths = [f[f"data/{d}/actions"].shape[0]
                                      for d in self.demos]
        else:
            self.demos = _demo_order(demo_arrays.keys())
            self._demo_lengths = [len(demo_arrays[d]["actions"])
                                  for d in self.demos]
        self.n_demos = len(self.demos)
        # sequences per demo shrink when padding is disabled on either end
        self._index_to_demo = []
        self._index_in_demo = []
        start_off = 0 if pad_frame_stack else self.frame_stack - 1
        end_off = 0 if pad_seq_length else seq_len - 1
        for di, L in enumerate(self._demo_lengths):
            for t in range(start_off, L - end_off):
                self._index_to_demo.append(di)
                self._index_in_demo.append(t)
        self.total_num_sequences = len(self._index_to_demo)
        if cache_all:
            self._load_cache()

    def _file(self):
        if self._h5 is None:
            import h5py
            self._h5 = h5py.File(self.hdf5_path, "r")
        return self._h5

    def _source(self, demo: str) -> Dict[str, Any]:
        """The demo's arrays, unread: the file's datasets or the given
        ones."""
        keys = ("actions",) + self.obs_keys
        if self._arrays is not None:
            return {k: self._arrays[demo][k] for k in keys}
        f = self._file()
        return {"actions": f[f"data/{demo}/actions"],
                **{k: f[f"data/{demo}/obs/{k}"] for k in self.obs_keys}}

    def _load_cache(self):
        self._cache = {d: {k: np.array(v) for k, v in self._source(d).items()}
                       for d in self.demos}
        self.close()

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    def __len__(self):
        return self.total_num_sequences

    def _demo_arrays(self, demo: str) -> Dict[str, Any]:
        if self._cache is not None:
            return self._cache[demo]
        return self._source(demo)

    @staticmethod
    def _window(arr, t: int, length: int) -> np.ndarray:
        """[t : t+length] repeat-padded on BOTH sides of the demo (robomimic
        get_sequence_from_demo: frame-stack pads repeat the first frame,
        sequence pads repeat the last)."""
        L = arr.shape[0]
        begin = max(0, min(t, L - 1))
        end = min(max(t + length, begin + 1), L)
        out = np.asarray(arr[begin:end])
        if begin > t:   # frame-stack padding before the demo start
            out = np.concatenate(
                [np.repeat(out[:1], begin - t, axis=0), out], axis=0)
        if out.shape[0] < length:
            # sequence padding past the demo end repeats the last frame;
            # clamping begin above keeps this non-empty even when the whole
            # window starts at/after L (next_obs of the final frame)
            out = np.concatenate(
                [out, np.repeat(out[-1:], length - out.shape[0], axis=0)],
                axis=0)
        return out

    def _obs_window(self, arrs, t: int, length: int, shift: int = 0):
        """Observation window with frame stacking: [t-(fs-1)+shift,
        t+length+shift). shift=1 emulates the robomimic next_obs group
        (next_obs[t] == obs[t+1] by the robomimic data convention)."""
        fs = self.frame_stack - 1
        return {k: self._window(arrs[k], t - fs + shift, fs + length)
                for k in self.obs_keys}

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        demo = self.demos[self._index_to_demo[idx]]
        t = self._index_in_demo[idx]
        L = self._demo_lengths[self._index_to_demo[idx]]
        arrs = self._demo_arrays(demo)
        o = self.obs_seq_len
        obs = self._obs_window(arrs, t, o)
        agent = obs["agentview_rgb"].astype(np.uint8)
        eye = obs["eye_in_hand_rgb"].astype(np.uint8)
        joints = obs["joint_states"].astype(np.float32)
        grip = obs["gripper_states"].astype(np.float32)
        actions = self._window(arrs["actions"], t, self.seq_len
                               ).astype(np.float32)
        T = agent.shape[0]      # obs_seq_len + frame_stack - 1
        item = {
            "rgb_obs": {"rgb_static": agent, "rgb_gripper": eye},
            "depth_obs": {},
            "actions": actions,
            "robot_obs": np.concatenate(
                [joints, np.repeat(grip[:1], T, axis=0)], axis=-1),
            "lang_text": self.task_description,
            "idx": idx,
        }
        if self.load_next_obs:
            nobs = self._obs_window(arrs, t, o, shift=1)
            item["next_obs"] = {
                "rgb_static": nobs["agentview_rgb"].astype(np.uint8),
                "rgb_gripper": nobs["eye_in_hand_rgb"].astype(np.uint8),
            }
        if self.goal_mode == "last":
            # goal_index = end_index_in_demo - 1: the final observation of
            # the demo, no sequence dim
            end_index = L - (0 if self.pad_seq_length else self.seq_len - 1)
            goal = {k: np.asarray(arrs[k][end_index - 1])
                    for k in self.obs_keys}
            item["goal_obs"] = {
                "rgb_static": goal["agentview_rgb"].astype(np.uint8),
                "rgb_gripper": goal["eye_in_hand_rgb"].astype(np.uint8),
            }
        if self.task_emb is not None:
            item["lang"] = self.task_emb
        return item


class LiberoMultitaskDataset:
    """Concatenation over a benchmark's task datasets."""

    def __init__(self, datasets: List[LiberoSequenceDataset]):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        di = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[di][idx - int(self._offsets[di])]


def discover_benchmark_tasks(benchmark_name: str,
                             root_data_dir: Optional[str]) -> List[str]:
    """Task hdf5 paths for a benchmark: via the LIBERO package when present,
    else by scanning <root>/<benchmark_name>/*.hdf5 (or <root>/*.hdf5)."""
    try:
        from libero.libero import get_libero_path
        from libero.libero.benchmark import get_benchmark
        bench = get_benchmark(benchmark_name)()
        base = get_libero_path("datasets")
        return [str(Path(base) / bench.get_task_demonstration(i))
                for i in range(bench.n_tasks)]
    except ImportError:
        if root_data_dir is None:
            raise FileNotFoundError(
                "LIBERO package not installed and no root_data_dir given")
        d = Path(root_data_dir) / benchmark_name
        if not d.is_dir():
            d = Path(root_data_dir)
        files = sorted(str(p) for p in d.glob("*.hdf5"))
        if not files:
            raise FileNotFoundError(f"no hdf5 task files under {d}")
        return files


class LiberoDataModule:
    """Multitask LIBERO data (the reference's LiberoDataModule).

    ``lang_embed`` (a callable: list of str -> [N, 1, D]) embeds the task
    instructions once at ``setup`` and every batch's texts as it is
    assembled; a tensor it returns stays where it is (the card, for the
    CLIP tower's ``LangEmbeddingCache``). ``task_arrays`` ({task path:
    ``demo_arrays``}) stands in for the files: ``setup`` then takes its
    paths, sorted, as the tasks and reads no file."""

    def __init__(self, benchmark_name: str = "libero_10",
                 root_data_dir: Optional[str] = None, *,
                 batch_size: int = 32, seq_len: int = 10,
                 obs_seq_len: int = 1,
                 lang_embed: Optional[Callable] = None,
                 cache_all: bool = False, train_fraction: float = 0.95,
                 seed: int = 42,
                 task_arrays: Optional[Mapping[str, Mapping]] = None):
        self.benchmark_name = benchmark_name
        self.root_data_dir = root_data_dir
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.obs_seq_len = obs_seq_len
        self.lang_embed = lang_embed
        self.cache_all = cache_all
        self.train_fraction = train_fraction
        self.seed = seed
        self.task_arrays = task_arrays
        self.train_dataset = None
        self.val_dataset = None
        self.task_descriptions: List[str] = []

    def setup(self):
        if self.task_arrays is not None:
            paths = sorted(self.task_arrays)    # the directory scan's order
        else:
            paths = discover_benchmark_tasks(self.benchmark_name,
                                             self.root_data_dir)
        self.task_descriptions = [task_description_from_filename(p)
                                  for p in paths]
        task_embs = [None] * len(paths)
        if self.lang_embed is not None:
            # a tensor on the card stays there (np.asarray would raise)
            embs = embed_texts(self.lang_embed, self.task_descriptions)
            task_embs = [embs[i, 0] for i in range(len(paths))]
        datasets = [LiberoSequenceDataset(
            p, seq_len=self.seq_len, obs_seq_len=self.obs_seq_len,
            cache_all=self.cache_all, task_emb=task_embs[i],
            demo_arrays=(None if self.task_arrays is None
                         else self.task_arrays[p]))
            for i, p in enumerate(paths)]
        full = LiberoMultitaskDataset(datasets)
        n = len(full)
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        n_train = int(n * self.train_fraction)
        self._train_idx = perm[:n_train]
        self._val_idx = perm[n_train:] if n_train < n else perm[-1:]
        self.full = full
        self.train_dataset = full
        self.val_dataset = full
        logger.info("LIBERO %s: %d tasks, %d sequences (%d train)",
                    self.benchmark_name, len(datasets), n, n_train)
        return self

    def close(self):
        """Close every task file the datasets hold open."""
        for ds in getattr(getattr(self, "full", None), "datasets", ()):
            ds.close()

    def _iter(self, indices, shuffle: bool, epoch: int) -> Iterator[Dict]:
        start, end = process_local_slice(len(indices))
        idx = np.array(indices[start:end])
        if shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        bs = self.batch_size
        for i in range(0, len(idx) - bs + 1, bs):
            items = [self.full[int(j)] for j in idx[i:i + bs]]
            yield collate_episodes(items, self.lang_embed)

    def train_batches(self, epoch: int = 0) -> Iterator[Dict]:
        return self._iter(self._train_idx, True, epoch)

    def val_batches(self, epoch: int = 0) -> Iterator[Dict]:
        return self._iter(self._val_idx, False, epoch)
