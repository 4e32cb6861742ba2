"""Long-horizon CALVIN evaluation: N five-task chains with deterministic
scene resets, split across processes (counterpart of
``mode_diffusion_policy_tpu/rollout/rollout_long_horizon.py``).

The evaluator is a plain object, used both as the Trainer's in-training
rollout hook (``make_rollout_callback``) and by the standalone CLI
(``evaluation/evaluate_calvin.py``). Each process evaluates its share of
the chains (``parallel.mesh.process_local_slice``: the
``torch.distributed`` rank's share when a process group is up) and
``gather_results`` collects every share with
``torch.distributed.all_gather_object``, as the reference callback does.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Sequence

import numpy as np

from ..evaluation.utils import (count_success,
                                get_env_state_for_initial_condition)
from ..parallel.mesh import process_local_slice
from .multistep_sequences import get_sequences

logger = logging.getLogger(__name__)


class LongHorizonEvaluator:
    """Evaluate a chunked policy on num_sequences 5-task chains
    (conf/callbacks/rollout_lh/calvin.yaml: 1000 sequences, ep_len 360)."""

    def __init__(self, env, task_oracle, val_annotations: Dict[str, List[str]],
                 *, num_sequences: int = 1000, ep_len: int = 360,
                 num_videos: int = 0, rollout_video=None, debug: bool = False):
        self.env = env
        self.task_oracle = task_oracle
        self.val_annotations = val_annotations
        self.num_sequences = num_sequences
        self.ep_len = ep_len
        self.num_videos = num_videos
        self.rollout_video = rollout_video
        self.debug = debug
        self.eval_sequences = get_sequences(num_sequences)

    # ------------------------------------------------------------------
    def evaluate_policy(self, policy, *, shard_across_hosts: bool = True
                        ) -> List[int]:
        """policy: object with reset() and step(obs, goal) -> action.
        Returns per-chain consecutive-success counts (local shard)."""
        seqs = self.eval_sequences
        if shard_across_hosts:
            start, end = process_local_slice(len(seqs))
            seqs = seqs[start:end]
        results = []
        for i, (initial_state, eval_sequence) in enumerate(seqs):
            record = i < self.num_videos and self.rollout_video is not None
            results.append(self.evaluate_sequence(
                policy, initial_state, eval_sequence, record, i))
        return results

    def evaluate_sequence(self, policy, initial_state, eval_sequence,
                          record: bool = False, i: int = 0) -> int:
        """One 5-task chain (rollout_long_horizon.py:270-292)."""
        robot_obs, scene_obs = get_env_state_for_initial_condition(
            initial_state)
        self.env.reset(robot_obs=robot_obs, scene_obs=scene_obs)
        if record:
            self.rollout_video.new_video(tag=f"lh_seq_{i}",
                                         caption=" | ".join(eval_sequence))
        success_counter = 0
        for subtask in eval_sequence:
            if record:
                self.rollout_video.new_subtask()
            success = self.rollout(policy, subtask, record)
            if record:
                self.rollout_video.draw_outcome(success)
            if not success:
                return success_counter
            success_counter += 1
        return success_counter

    def rollout(self, policy, subtask: str, record: bool = False) -> bool:
        """One subtask episode (rollout_long_horizon.py:294-328)."""
        obs = self.env.get_obs()
        lang_annotation = self.val_annotations[subtask][0]
        goal = {"lang_text": lang_annotation}
        policy.reset()
        start_info = self.env.get_info()
        for _ in range(self.ep_len):
            action = policy.step(obs, goal)
            obs, _, _, current_info = self.env.step(action)
            if record:
                self.rollout_video.update(obs["rgb_obs"]["rgb_static"])
            solved = self.task_oracle.get_task_info_for_set(
                start_info, current_info, {subtask})
            if len(solved) > 0:
                if record:
                    self.rollout_video.add_language_instruction(
                        lang_annotation)
                return True
        if record:
            self.rollout_video.add_language_instruction(lang_annotation)
        return False

    # ------------------------------------------------------------------
    @staticmethod
    def gather_results(local_results: List[int]) -> List[int]:
        """Every process's results in rank order (each rank's share is a
        contiguous slice, ``process_local_slice``); the local list when no
        process group is up."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return list(local_results)
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, list(local_results))
        return [r for part in gathered for r in part]

    def metrics(self, results: Sequence[int]) -> Dict[str, float]:
        """eval_lh/* metrics (rollout_long_horizon.py:222-232)."""
        out = {f"eval_lh/sr_chain_{i + 1}": sr
               for i, sr in enumerate(count_success(list(results)))}
        out["eval_lh/avg_seq_len"] = float(np.mean(list(results))) \
            if len(results) else 0.0
        return out


def make_rollout_callback(env, task_oracle, val_annotations,
                          make_policy: Callable, **eval_kwargs):
    """The Trainer's ``rollout_callback(agent, variables, epoch) ->
    metrics``: ``make_policy(agent, variables)`` builds the policy (the
    variables are ``TrainState.eval_variables()``, the EMA weights by
    default), which runs every chain of this process's share."""
    evaluator = LongHorizonEvaluator(env, task_oracle, val_annotations,
                                     **eval_kwargs)

    def callback(agent, variables, epoch: int) -> Dict[str, float]:
        policy = make_policy(agent, variables)
        local = evaluator.evaluate_policy(policy)
        results = evaluator.gather_results(local)
        return evaluator.metrics(results)

    return callback
