"""Determinism smoke check (counterpart of
``mode_diffusion_policy_tpu/evaluation/determinism_check.py``; numpy only):
reset a deterministic scene and print FNV-1 64 hashes of the observation
and info trees, so runs and machines can be diffed. The hashes are the JAX
package's (``utils/hashing.fnv1_64``, pyhash's semantics).

The reference's repo-root ``test_env.py``, its de-facto regression check.
Works against the real calvin_env or the built-in fake env (--fake-env).

Usage:
    python -m mode_diffusion_policy_tpu_torch.evaluation.determinism_check --fake-env
"""
from __future__ import annotations

import argparse
import logging

import numpy as np

from ..utils.hashing import fnv1_64


def hash_tree(tree, hasher=None) -> int:
    """Stable FNV-1 64 hash over a nested dict/array tree (sorted keys,
    raw array bytes; mirrors test_env.py's optree hashing intent)."""
    h = hasher or fnv1_64()

    def visit(node, value):
        if isinstance(node, dict):
            for k in sorted(node.keys()):
                value = h(str(k), seed=value)
                value = visit(node[k], value)
            return value
        if isinstance(node, (list, tuple)):
            for item in node:
                value = visit(item, value)
            return value
        return h(np.ascontiguousarray(np.asarray(node)).tobytes(), seed=value)

    return visit(tree, 0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fake-env", action="store_true")
    p.add_argument("--dataset-path", default=None)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..data.calvin_dataset import DEFAULT_OBS_SPACE, DEFAULT_PROPRIO
    from ..evaluation.utils import get_env_state_for_initial_condition
    from ..rollout.env import CalvinEnvWrapper, FakeCalvinEnv
    from ..rollout.multistep_sequences import get_sequences

    initial_state, chain = get_sequences(1)[0]
    robot_obs, scene_obs = get_env_state_for_initial_condition(initial_state)

    if args.fake_env:
        raw = FakeCalvinEnv(hw=24, seed=0)
    else:
        from calvin_env.envs.play_table_env import get_env
        from pathlib import Path
        raw = get_env(Path(args.dataset_path) / "validation", show_gui=False)
    env = CalvinEnvWrapper(raw, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)

    obs = env.reset(robot_obs=robot_obs, scene_obs=scene_obs)
    info = env.get_info()
    print(f"initial_state: {initial_state}")
    print(f"chain: {chain}")
    print(f"hash(scene_reset robot_obs): {fnv1_64()(robot_obs.tobytes()):x}")
    print(f"hash(scene_reset scene_obs): {fnv1_64()(scene_obs.tobytes()):x}")
    print(f"hash(obs): {hash_tree(obs):x}")
    print(f"hash(info): {hash_tree(info):x}")
    for i in range(args.steps):
        obs, _, _, info = env.step(np.zeros(7))
        print(f"step {i}: hash(obs)={hash_tree(obs):x} "
              f"hash(info)={hash_tree(info):x}")


if __name__ == "__main__":
    main()
