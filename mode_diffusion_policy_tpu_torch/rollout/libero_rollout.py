"""LIBERO evaluation: per-task fixed-init-state rollouts with a done-flag
success criterion (counterpart of
``mode_diffusion_policy_tpu/rollout/libero_rollout.py``; numpy on the host,
the policy moves its frames to the card itself).

Per task: reset to the benchmark's fixed init states, warm the physics up
with 5 zero-action steps, run the chunked policy up to ``max_steps`` (520
in ``conf/callbacks/libero.yaml``), success = the env's done flag. The
rollouts are split across processes (``parallel.mesh.process_local_slice``)
and ``gather_success_rates`` averages each task's rate over them with
``torch.distributed.all_gather_object``. Real MuJoCo envs come from the
LIBERO package (a gated import, five attempts); ``FakeLiberoEnv`` keeps
the loop testable without it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..parallel.mesh import process_local_slice


def translate_obs(env_obs: Dict) -> Dict:
    """LIBERO obs keys -> the CALVIN-style interface, batched to
    [1, 1, H, W, 3]. LIBERO renders upside down: the env flips the images
    upstream, this only remaps the keys."""
    out = {"rgb_obs": {}, "depth_obs": {}}
    out["rgb_obs"]["rgb_static"] = np.asarray(
        env_obs["agentview_image"], np.uint8)[None, None]
    out["rgb_obs"]["rgb_gripper"] = np.asarray(
        env_obs["robot0_eye_in_hand_image"], np.uint8)[None, None]
    robot = np.concatenate([np.asarray(env_obs["robot0_joint_pos"]),
                            np.asarray(env_obs["robot0_gripper_qpos"])])
    out["robot_obs"] = robot[None, None].astype(np.float32)
    return out


class FakeLiberoEnv:
    """OffScreenRenderEnv-surface stand-in: reset/set_init_state/step/close.
    Succeeds (done=True) after ``steps_to_success`` steps when scripted.
    Its frames are draws of ``np.random.default_rng(seed)``, the JAX
    package's stream."""

    def __init__(self, hw: int = 24, steps_to_success: Optional[int] = 4,
                 seed: int = 0):
        self.hw = hw
        self.steps_to_success = steps_to_success
        self._rng = np.random.default_rng(seed)
        self._steps = 0

    def _obs(self):
        img = self._rng.integers(0, 255, (self.hw, self.hw, 3), np.uint8)
        return {"agentview_image": img, "robot0_eye_in_hand_image": img,
                "robot0_joint_pos": np.zeros(7),
                "robot0_gripper_qpos": np.zeros(2)}

    def reset(self):
        self._steps = 0
        return self._obs()

    def set_init_state(self, init_state):
        self._steps = 0
        return self._obs()

    def step(self, action):
        self._steps += 1
        done = (self.steps_to_success is not None
                and self._steps >= self.steps_to_success)
        return self._obs(), 0.0, done, {}

    def get_sim_state(self):
        return np.zeros(8)

    def close(self):
        pass


def make_libero_env(bddl_file: str, img_h: int, img_w: int, retries: int = 5):
    """A real OffScreenRenderEnv, created with up to ``retries`` attempts
    5 s apart (env creation is flaky under load)."""
    from libero.libero.envs import OffScreenRenderEnv
    last_err = None
    for _ in range(retries):
        try:
            return OffScreenRenderEnv(bddl_file_name=bddl_file,
                                      camera_heights=img_h,
                                      camera_widths=img_w)
        except Exception as e:  # env creation is flaky under load
            last_err = e
            time.sleep(5)
    raise RuntimeError(f"Failed to create environment: {last_err}")


class LiberoEvaluator:
    """Evaluate a chunked policy over a benchmark's tasks
    (conf/callbacks/libero.yaml: n_eval 20, 520-step cap)."""

    def __init__(self, *, n_eval: int = 20, max_steps: int = 520,
                 warmup_steps: int = 5, rollout_video=None,
                 num_videos: int = 0):
        self.n_eval = n_eval
        self.max_steps = max_steps
        self.warmup_steps = warmup_steps
        self.rollout_video = rollout_video
        self.num_videos = num_videos

    def evaluate_task(self, policy, env, task_description: str,
                      init_states: Optional[np.ndarray] = None,
                      shard_across_hosts: bool = True) -> float:
        """Success rate over this process's share of the n_eval rollouts."""
        if shard_across_hosts:
            start, end = process_local_slice(self.n_eval)
        else:
            start, end = 0, self.n_eval
        if end <= start:
            return 0.0
        n_success = 0
        for i in range(start, end):
            record = (i - start) < self.num_videos and \
                self.rollout_video is not None
            if record:
                name = task_description[:40].replace(" ", "_")
                self.rollout_video.new_video(tag=f"libero_{name}_{i}",
                                             caption=task_description)
            env.reset()
            if init_states is not None:
                obs = env.set_init_state(
                    init_states[i % len(init_states)])
            else:
                obs = env.reset()
            policy.reset()
            dummy = np.zeros(7)
            for _ in range(self.warmup_steps):
                obs, _, _, _ = env.step(dummy)
            done = False
            goal = {"lang_text": task_description}
            for _ in range(self.max_steps):
                data = translate_obs(obs)
                action = policy.step(data, goal)
                obs, _, d, _ = env.step(np.asarray(action).squeeze())
                if record:
                    self.rollout_video.update(obs["agentview_image"])
                if d:
                    done = True
                    break
            if record:
                self.rollout_video.draw_outcome(done)
            n_success += int(done)
        return n_success / (end - start)

    @staticmethod
    def gather_success_rates(local_rates: List[float]) -> List[float]:
        """Each task's success rate averaged over the processes (each one's
        share of the rollouts); the local list when no process group is
        up."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return list(local_rates)
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, list(local_rates))
        return np.mean(np.asarray(gathered, np.float32), axis=0).tolist()

    def metrics(self, success_rates: Sequence[float],
                task_names: Sequence[str]) -> Dict[str, float]:
        out = {f"eval/sr_{name[:48].replace(' ', '_')}": sr
               for name, sr in zip(task_names, success_rates)}
        out["eval/avg_success_rate"] = float(np.mean(list(success_rates))) \
            if len(success_rates) else 0.0
        return out
