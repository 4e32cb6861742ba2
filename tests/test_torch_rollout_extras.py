"""The port's single-task CALVIN evaluator and determinism check against the
JAX package's: ``SingleTaskEvaluator``'s task dict (from oracle-diffed
start and end states), its rollouts and metrics, and its JSON dict on a
scripted env and oracle; ``hash_tree`` on nested trees and the printed
hashes of ``determinism_check --fake-env``."""
import numpy as np
import pytest

from mode_diffusion_policy_tpu.evaluation import determinism_check as jdc
from mode_diffusion_policy_tpu.rollout import env as jenv
from mode_diffusion_policy_tpu.rollout import rollout_single_task as jst
from mode_diffusion_policy_tpu_torch.data.calvin_dataset import (
    DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
from mode_diffusion_policy_tpu_torch.evaluation import determinism_check as tdc
from mode_diffusion_policy_tpu_torch.rollout import env as tenv
from mode_diffusion_policy_tpu_torch.rollout import rollout_single_task as tst
from torch_threads import two_torch_threads  # noqa: F401

# task -> (scene coordinate that a demonstration moves, env steps a rollout
# needs to solve it; None: never solved)
TASKS = {"open_drawer": (0, 2), "turn_on_led": (1, 13),
         "push_block": (2, None), "move_slider_left": (3, 5)}
ANNOTATIONS = {t: [t.replace("_", " ")] for t in TASKS}


class ScriptedOracle:
    """A task is solved between two infos when its scene coordinate rose by
    more than 0.5 (what a demonstration does), or after its number of env
    steps (what a rollout does)."""

    def get_task_info_for_set(self, start, end, task_set):
        out = set()
        for task in task_set:
            k, need = TASKS[task]
            moved = end["scene_obs"][k] - start["scene_obs"][k] > 0.5
            steps = end["steps"] - start["steps"]
            if moved or (need is not None and steps >= need):
                out.add(task)
        return out


def sequences(n=6, T=8, seed=0):
    """Validation windows whose last scene state moves one task's
    coordinate, every third one two tasks'."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        robot = r.standard_normal((T, 15))
        scene = r.standard_normal((T, 24)) * 0.1
        for k in {i % 4, (i + 1) % 4 if i % 3 == 0 else i % 4}:
            scene[-1, k] += 1.0
        out.append({"state_info": {"robot_obs": robot, "scene_obs": scene}})
    return out


class StubPolicy:
    def __init__(self):
        self.resets = 0
        self.seen = []

    def reset(self):
        self.resets += 1

    def step(self, obs, goal):
        self.seen.append(goal["lang_text"])
        return np.full(7, 0.5, np.float32)


def _run(env_mod, st_mod, seqs, tmp_path, tag):
    raw = env_mod.FakeCalvinEnv(hw=16, seed=1)
    env = env_mod.CalvinEnvWrapper(raw, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
    ev = st_mod.SingleTaskEvaluator(env, ScriptedOracle(), ANNOTATIONS,
                                    ep_len=10)
    task_dict = ev.build_task_dict(seqs)
    policy = StubPolicy()
    metrics = ev.evaluate(policy, seqs)
    path = tmp_path / f"{tag}.json"
    ev.save_task_dict(str(path))
    again = st_mod.SingleTaskEvaluator(env, ScriptedOracle(), ANNOTATIONS,
                                       ep_len=10)
    again.load_task_dict(str(path))
    loaded = (again.task_to_sequences, dict(again.groundtruth_counter))
    return (task_dict, dict(ev.groundtruth_counter), metrics, policy.resets,
            policy.seen, len(raw.actions_log), path.read_text(), loaded)


def test_single_task_evaluator_matches_jax(tmp_path):
    seqs = sequences()
    got = _run(tenv, tst, seqs, tmp_path, "port")
    want = _run(jenv, jst, seqs, tmp_path, "jax")
    assert got == want
    task_dict, counts, metrics = got[:3]
    assert sum(counts.values()) == 8 and len(task_dict) == 4
    assert set(metrics) == {f"tasks/{t}" for t in task_dict} | {
        "tasks/average_sr"}
    assert metrics["tasks/push_block"] == 0.0      # never solved
    assert metrics["tasks/turn_on_led"] == 0.0     # not within 10 steps
    assert metrics["tasks/open_drawer"] == 1.0
    assert metrics["tasks/average_sr"] == 4 / 8
    # a fresh evaluator builds the dict on its first evaluation
    raw = tenv.FakeCalvinEnv(hw=16, seed=1)
    ev = tst.SingleTaskEvaluator(
        tenv.CalvinEnvWrapper(raw, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO),
        ScriptedOracle(), ANNOTATIONS, ep_len=10)
    assert ev.evaluate(StubPolicy(), seqs) == metrics


def _tree(r):
    return {"b": r.integers(0, 255, (3, 4, 3), dtype=np.uint8),
            "a": {"z": r.standard_normal(5), "y": [np.float32(1.5), 3,
                                                   (r.standard_normal(2),)]},
            "c": np.arange(6, dtype=np.int64).reshape(2, 3)[:, ::2],
            "d": 7.25}


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_tree_matches_jax(seed):
    tree = _tree(np.random.default_rng(seed))
    assert tdc.hash_tree(tree) == jdc.hash_tree(tree)
    assert tdc.hash_tree(tree["a"]) == jdc.hash_tree(tree["a"])
    assert tdc.hash_tree([]) == jdc.hash_tree([]) == 0


def test_determinism_check_output_matches_jax(capsys):
    """The printed hashes (scene reset, obs and info, 5 zero-action steps)
    equal JAX's, run after run."""
    outs = []
    for mod in (jdc, tdc, tdc):
        mod.main(["--fake-env", "--steps", "5"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == outs[2]
    assert outs[1].count("hash(") == 4 + 2 * 5
