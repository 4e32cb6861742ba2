"""CALVIN dataset settings (counterpart of
``mode_diffusion_policy_tpu/data/calvin_dataset.py``).

Only the default observation space and proprioception slicing are here,
which the evaluation path's env wrapper reads; the episode datasets come
with the data slice (ROADMAP.md Queue 1).
"""
from __future__ import annotations

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
