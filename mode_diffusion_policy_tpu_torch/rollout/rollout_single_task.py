"""Single-task CALVIN rollout evaluation (counterpart of
``mode_diffusion_policy_tpu/rollout/rollout_single_task.py``; numpy only).

The reference's Rollout callback: on the first evaluation, find which
task each validation sequence solves by replaying its ground-truth start
and end states through the task oracle, and build a task -> sequence-ids
dict (kept with the checkpoints in the reference; here returned and
savable as JSON); then roll the policy out from those start states and
report each task's success rate (``tasks/<task>``, ``tasks/average_sr``).
"""
from __future__ import annotations

import json
import logging
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class SingleTaskEvaluator:
    def __init__(self, env, task_oracle, val_annotations: Dict[str, List[str]],
                 *, ep_len: int = 120, tasks_per_sequence: int = 1):
        self.env = env
        self.task_oracle = task_oracle
        self.val_annotations = val_annotations
        self.ep_len = ep_len
        self.task_to_sequences: Optional[Dict[str, List[int]]] = None
        self.groundtruth_counter: Counter = Counter()

    # ------------------------------------------------------------------
    def build_task_dict(self, sequences: Sequence[Dict]
                        ) -> Dict[str, List[int]]:
        """sequences: list of {'state_info': {'robot_obs': [T, ...],
        'scene_obs': [T, ...]}} validation windows. Determine the tasks each
        sequence demonstrates by diffing env info between its start and end
        states (rollout.py:370-414)."""
        task_to_sequences: Dict[str, List[int]] = defaultdict(list)
        for i, seq in enumerate(sequences):
            info_start = self._reset_info(seq, 0)
            info_end = self._reset_info(seq, -1)
            tasks = self.task_oracle.get_task_info_for_set(
                info_start, info_end, set(self.val_annotations.keys()))
            for task in tasks:
                task_to_sequences[task].append(i)
        self.task_to_sequences = dict(task_to_sequences)
        self.groundtruth_counter = Counter(
            {t: len(ids) for t, ids in self.task_to_sequences.items()})
        logger.info("task dict: %s", self.groundtruth_counter)
        return self.task_to_sequences

    def _reset_info(self, seq: Dict, t: int) -> Dict:
        state_info = seq["state_info"]
        self.env.reset(robot_obs=np.asarray(state_info["robot_obs"][t]),
                       scene_obs=np.asarray(state_info["scene_obs"][t]))
        return self.env.get_info()

    # ------------------------------------------------------------------
    def evaluate(self, policy, sequences: Sequence[Dict]) -> Dict[str, float]:
        """Roll out from each demonstrated start state; success if the
        sequence's task is achieved within ep_len steps."""
        if self.task_to_sequences is None:
            self.build_task_dict(sequences)
        success_counter: Counter = Counter()
        for task, ids in self.task_to_sequences.items():
            lang = self.val_annotations[task][0]
            for i in ids:
                seq = sequences[i]
                state_info = seq["state_info"]
                obs = self.env.reset(
                    robot_obs=np.asarray(state_info["robot_obs"][0]),
                    scene_obs=np.asarray(state_info["scene_obs"][0]))
                policy.reset()
                start_info = self.env.get_info()
                goal = {"lang_text": lang}
                for _ in range(self.ep_len):
                    action = policy.step(obs, goal)
                    obs, _, _, info = self.env.step(action)
                    if self.task_oracle.get_task_info_for_set(
                            start_info, info, {task}):
                        success_counter[task] += 1
                        break
        metrics = {}
        total_success = sum(success_counter.values())
        total_gt = sum(self.groundtruth_counter.values())
        for task, n_gt in self.groundtruth_counter.items():
            metrics[f"tasks/{task}"] = success_counter[task] / n_gt
        metrics["tasks/average_sr"] = (total_success / total_gt
                                       if total_gt else 0.0)
        return metrics

    # -- persistence (reference keeps the dict in checkpoint state) -------
    def save_task_dict(self, path: str):
        with open(path, "w") as f:
            json.dump(self.task_to_sequences, f)

    def load_task_dict(self, path: str):
        with open(path) as f:
            self.task_to_sequences = json.load(f)
        self.groundtruth_counter = Counter(
            {t: len(ids) for t, ids in self.task_to_sequences.items()})
