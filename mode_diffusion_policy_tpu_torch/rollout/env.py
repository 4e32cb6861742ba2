"""Environment adapters: the calvin_env wrapper surface and a fake env
(counterpart of ``mode_diffusion_policy_tpu/rollout/env.py``; numpy only,
copied).

``CalvinEnvWrapper`` adapts a raw calvin_env PlayTable env (PyBullet, CPU)
to the policy interface of the reference HulcWrapper: NHWC uint8 camera obs
batched [1, 1, H, W, 3], proprio slicing, relative actions and gripper
binarization. It stays numpy in, numpy out: the simulator runs on the host,
and the policy moves the frames to the card itself.

``FakeCalvinEnv`` implements the same surface without PyBullet so rollout /
evaluation logic is testable hermetically (SURVEY.md §4(c)); its oracle
deems a subtask solved when a registered script says so.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Set, Tuple

import numpy as np


class CalvinEnvWrapper:
    """Adapter over a raw calvin_env-style env exposing
    reset/step/get_obs/get_info with policy-ready observations."""

    def __init__(self, env, observation_space: Dict, proprio_state: Dict,
                 relative_actions: bool = True):
        self.env = env
        self.observation_space_keys = observation_space
        self.proprio_state = proprio_state
        self.relative_actions = relative_actions

    # -- observation adaptation (hulc_wrapper.py:47-62) -------------------
    def transform_observation(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"rgb_obs": {}, "depth_obs": {}}
        for key in self.observation_space_keys["rgb_obs"]:
            img = np.asarray(obs["rgb_obs"][key], np.uint8)
            out["rgb_obs"][key] = img[None, None]  # [1, 1, H, W, 3]
        for key in self.observation_space_keys.get("depth_obs", []):
            out["depth_obs"][key] = np.asarray(
                obs["depth_obs"][key], np.float32)[None, None]
        robot_obs = np.asarray(obs["robot_obs"], np.float32)
        sliced = [robot_obs[slice(*ids)]
                  for ids in self.proprio_state["keep_indices"]]
        out["robot_obs"] = np.concatenate(sliced)[None, None]
        out["robot_obs_raw"] = robot_obs
        return out

    # -- action adaptation (hulc_wrapper.py:64-83) ------------------------
    def step(self, action) -> Tuple[Dict, Any, bool, Dict]:
        action = np.asarray(action).squeeze()
        if self.relative_actions:
            assert action.shape[-1] == 7
            action = np.array(action, dtype=np.float64)
        else:
            if action.shape[-1] == 7:
                action = np.split(action, [3, 6])
            elif action.shape[-1] == 8:
                action = np.split(action, [3, 7])
            else:
                raise NotImplementedError(action.shape)
        # gripper binarization
        if self.relative_actions:
            action[-1] = 1 if action[-1] > 0 else -1
        else:
            action[-1] = np.array([1 if action[-1] > 0 else -1])
        o, r, d, i = self.env.step(action)
        return self.transform_observation(o), r, d, i

    def reset(self, robot_obs=None, scene_obs=None, reset_info=None,
              batch_idx: int = 0, seq_idx: int = 0) -> Dict:
        if reset_info is not None:
            obs = self.env.reset(
                robot_obs=reset_info["robot_obs"][batch_idx, seq_idx],
                scene_obs=reset_info["scene_obs"][batch_idx, seq_idx])
        elif robot_obs is not None or scene_obs is not None:
            obs = self.env.reset(robot_obs=robot_obs, scene_obs=scene_obs)
        else:
            obs = self.env.reset()
        return self.transform_observation(obs)

    def get_obs(self) -> Dict:
        return self.transform_observation(self.env.get_obs())

    def get_info(self) -> Dict:
        return self.env.get_info()


class FakeTaskOracle:
    """Stands in for calvin_env's Tasks oracle
    (get_task_info_for_set, rollout_long_horizon.py:317)."""

    def __init__(self, success_fn: Callable[[Dict, Dict, str], bool]):
        self.success_fn = success_fn

    def get_task_info_for_set(self, start_info: Dict, current_info: Dict,
                              task_set: Set[str]) -> Set[str]:
        return {t for t in task_set
                if self.success_fn(start_info, current_info, t)}


class FakeCalvinEnv:
    """Raw-env stand-in with the calvin_env surface
    (reset/step/get_obs/get_info). Scripted success: tasks in
    ``solvable_tasks`` succeed after ``steps_to_success`` env steps."""

    def __init__(self, hw: int = 24, solvable_tasks: Optional[Set[str]] = None,
                 steps_to_success: int = 3, seed: int = 0):
        self.hw = hw
        self.solvable = solvable_tasks if solvable_tasks is not None else set()
        self.steps_to_success = steps_to_success
        self._rng = np.random.default_rng(seed)
        self._steps = 0
        self.robot_obs = np.zeros(15)
        self.scene_obs = np.zeros(24)
        self.actions_log = []

    def _obs(self):
        img = self._rng.integers(0, 255, (self.hw, self.hw, 3), np.uint8)
        return {
            "rgb_obs": {"rgb_static": img, "rgb_gripper": img},
            "depth_obs": {},
            "robot_obs": self.robot_obs,
            "scene_obs": self.scene_obs,
        }

    def reset(self, robot_obs=None, scene_obs=None):
        if robot_obs is not None:
            self.robot_obs = np.asarray(robot_obs, np.float64)
        if scene_obs is not None:
            self.scene_obs = np.asarray(scene_obs, np.float64)
        self._steps = 0
        return self._obs()

    def step(self, action):
        self.actions_log.append(np.asarray(action))
        self._steps += 1
        return self._obs(), 0, False, self.get_info()

    def get_obs(self):
        return self._obs()

    def get_info(self):
        return {"steps": self._steps, "scene_obs": self.scene_obs.copy(),
                "robot_obs": self.robot_obs.copy()}

    def make_oracle(self) -> FakeTaskOracle:
        def success(start_info, current_info, task):
            return (task in self.solvable
                    and current_info["steps"] - start_info["steps"]
                    >= self.steps_to_success)
        return FakeTaskOracle(success)
