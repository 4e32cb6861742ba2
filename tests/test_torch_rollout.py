"""The port's rollout pieces against the JAX package's: the task tables
(the 1000-chain generator is in ``test_torch_rollout_sequences.py``), the
FNV hashers, the seeded scene resets, the result
accounting, the env wrapper and the fake env, the long-horizon evaluator
and its Trainer hook with a numpy stub policy (bit for bit: all numpy on
both sides), the video buffer, and the result gathering across two
``torch.distributed`` processes."""
import json
import multiprocessing
import socket

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mode_diffusion_policy_tpu.data.calvin_dataset import (
    DEFAULT_OBS_SPACE as J_OBS, DEFAULT_PROPRIO as J_PROPRIO)
from mode_diffusion_policy_tpu.evaluation import utils as jutils
from mode_diffusion_policy_tpu.rollout import env as jenv
from mode_diffusion_policy_tpu.rollout import multistep_sequences as jms
from mode_diffusion_policy_tpu.rollout import rollout_long_horizon as jlh
from mode_diffusion_policy_tpu.rollout import video as jvideo
from mode_diffusion_policy_tpu.utils import hashing as jhash
from mode_diffusion_policy_tpu_torch.data.calvin_dataset import (
    DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
from mode_diffusion_policy_tpu_torch.evaluation import utils as tutils
from mode_diffusion_policy_tpu_torch.rollout import env as tenv
from mode_diffusion_policy_tpu_torch.rollout import multistep_sequences as tms
from mode_diffusion_policy_tpu_torch.rollout import rollout_long_horizon as tlh
from mode_diffusion_policy_tpu_torch.rollout import video as tvideo
from mode_diffusion_policy_tpu_torch.utils import hashing as thash
from torch_threads import two_torch_threads  # noqa: F401

ANNOTATIONS = {t: [f"do {t.replace('_', ' ')}"] for t in jms.tasks}


def test_defaults_match():
    assert DEFAULT_OBS_SPACE == J_OBS and DEFAULT_PROPRIO == J_PROPRIO


def test_task_tables_match():
    assert list(tms.tasks) == list(jms.tasks)
    assert tms.tasks == jms.tasks
    assert tms.task_categories == jms.task_categories
    assert tms.initial_states() == jms.initial_states()


@pytest.mark.parametrize("name", ["fnv1_32", "fnv1a_32", "fnv1_64",
                                  "fnv1a_64"])
@settings(max_examples=60, deadline=None)
@given(args=st.lists(st.one_of(st.text(max_size=40),
                               st.binary(max_size=40)), max_size=3),
       seed=st.one_of(st.none(), st.integers(0, 2 ** 32 - 1)))
def test_fnv_hashers_match(name, args, seed):
    """pyhash semantics, bit for bit against the JAX package's native and
    pure-Python hashers: strings as UTF-16LE, bytes raw, chained args."""
    kw = {} if seed is None else {"seed": seed}
    port = getattr(thash, name)()
    for ref in (getattr(jhash, name)(), getattr(jhash, f"py_{name}")()):
        assert port(*args, **kw) == ref(*args, **kw)
    if seed is not None:
        assert getattr(thash, name)(seed)(*args) == port(*args, seed=seed)


def test_env_state_for_every_initial_condition_matches():
    for state in jms.initial_states():
        for d in (state, dict(state, led=1 - state["led"])):
            tr, ts = tutils.get_env_state_for_initial_condition(d)
            jr, js = jutils.get_env_state_for_initial_condition(d)
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("results", [[5, 3, 0, 1, 5], [], [0, 0], [2]])
def test_count_success_and_print_and_save_match(tmp_path, results):
    assert tutils.count_success(results) == jutils.count_success(results)
    seqs = tms.get_sequences(max(len(results), 1))
    for epoch in ("0", "3"):
        want = jutils.print_and_save(results, seqs, str(tmp_path / "j"),
                                     epoch=epoch)
        got = tutils.print_and_save(results, seqs, str(tmp_path / "t"),
                                    epoch=epoch)
        assert got == want
    assert (json.loads((tmp_path / "t" / "results.json").read_text())
            == json.loads((tmp_path / "j" / "results.json").read_text()))


def test_checkpoint_listing_matches(tmp_path):
    run = tmp_path / "run"
    assert tutils.get_all_checkpoints(run) == jutils.get_all_checkpoints(run)
    for d in ("12", "3", "best", "7"):
        (run / "saved_models" / d).mkdir(parents=True)
    assert tutils.get_all_checkpoints(run) == jutils.get_all_checkpoints(run)
    assert tutils.get_last_checkpoint(run) == jutils.get_last_checkpoint(run)
    assert tutils.get_last_checkpoint(run).name == "12"


def _pair(hw=16, solvable=("open_drawer", "turn_on_led"), steps=2, seed=3):
    out = []
    for mod in (tenv, jenv):
        raw = mod.FakeCalvinEnv(hw=hw, solvable_tasks=set(solvable),
                                steps_to_success=steps, seed=seed)
        out.append((raw, mod.CalvinEnvWrapper(raw, DEFAULT_OBS_SPACE,
                                              DEFAULT_PROPRIO)))
    return out


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_env_wrapper_and_fake_env_match():
    (traw, tw), (jraw, jw) = _pair()
    robot = np.linspace(-1, 1, 15)
    scene = np.linspace(0, 2, 24)
    _assert_tree_equal(tw.reset(robot_obs=robot, scene_obs=scene),
                       jw.reset(robot_obs=robot, scene_obs=scene))
    rng = np.random.default_rng(0)
    for _ in range(5):
        a = rng.standard_normal(7)
        to, tr, td, ti = tw.step(a.copy())
        jo, jr, jd, ji = jw.step(a.copy())
        _assert_tree_equal(to, jo)
        _assert_tree_equal(ti, ji)
        assert (tr, td) == (jr, jd)
    _assert_tree_equal(tw.get_obs(), jw.get_obs())
    _assert_tree_equal(tw.get_info(), jw.get_info())
    for ta, ja in zip(traw.actions_log, jraw.actions_log):
        np.testing.assert_array_equal(ta, ja)
    start = {"steps": 0}
    for task in ("open_drawer", "close_drawer"):
        for steps in (1, 2, 5):
            cur = {"steps": steps}
            assert (traw.make_oracle().get_task_info_for_set(start, cur,
                                                              {task})
                    == jraw.make_oracle().get_task_info_for_set(start, cur,
                                                                {task}))


class StubPolicy:
    """A numpy policy whose action depends on the frames and the step, so
    that a difference in the observations changes the actions."""

    def __init__(self, log):
        self.log = log
        self.t = 0

    def reset(self):
        self.t = 0

    def step(self, obs, goal):
        img = obs["rgb_obs"]["rgb_static"].astype(np.float64)
        x = img.mean() / 255.0 - 0.5 + 0.01 * self.t + len(goal["lang_text"])
        self.t += 1
        a = np.sin(x * np.arange(1, 8))[None].astype(np.float32)
        self.log.append(a)
        return a


def test_long_horizon_evaluator_matches():
    (traw, tw), (jraw, jw) = _pair(solvable=("open_drawer", "turn_on_led",
                                             "move_slider_left",
                                             "lift_red_block_table"))
    runs = []
    for mod, raw, w in ((tlh, traw, tw), (jlh, jraw, jw)):
        log = []
        ev = mod.LongHorizonEvaluator(w, raw.make_oracle(), ANNOTATIONS,
                                      num_sequences=12, ep_len=4)
        results = ev.evaluate_policy(StubPolicy(log))
        runs.append((results, ev.metrics(ev.gather_results(results)), log,
                     raw.actions_log))
    (tres, tmet, tlog, tact), (jres, jmet, jlog, jact) = runs
    assert tres == jres and tmet == jmet
    assert len(tlog) == len(jlog) > 12 and len(tact) == len(jact)
    for a, b in zip(tlog + tact, jlog + jact):
        np.testing.assert_array_equal(a, b)
    assert 0 < tmet["eval_lh/sr_chain_1"] < 1


def test_rollout_callback_matches():
    (traw, tw), (jraw, jw) = _pair(solvable=tuple(jms.tasks), steps=3)
    metrics = []
    for mod, raw, w in ((tlh, traw, tw), (jlh, jraw, jw)):
        cb = mod.make_rollout_callback(
            w, raw.make_oracle(), ANNOTATIONS,
            lambda agent, variables: StubPolicy([]), num_sequences=3,
            ep_len=4)
        metrics.append(cb(None, None, 0))
    assert metrics[0] == metrics[1]
    assert metrics[0]["eval_lh/avg_seq_len"] == 5.0


def test_rollout_video_matches(tmp_path):
    videos = []
    for mod, sub in ((tvideo, "t"), (jvideo, "j")):
        v = mod.RolloutVideo(save_dir=str(tmp_path / sub))
        v.new_video("seq", caption="open | close")
        v.new_subtask()
        for i in range(4):
            v.update(np.full((1, 1, 16, 16, 3), i * 20, np.uint8))
        v.draw_outcome(True)
        v.new_subtask()
        for i in range(3):
            v.update(np.full((16, 16, 3), 200, np.uint8))
        v.draw_outcome(False)
        v.add_language_instruction("close the drawer")
        videos.append((dict(v._videos), dict(v._captions)))
        v.log()
        assert (tmp_path / sub / "seq.mp4").exists()
    (tv, tc), (jv, jc) = videos
    assert tc == jc
    for a, b in zip(tv["seq"], jv["seq"]):
        np.testing.assert_array_equal(a, b)


def _gather_worker(rank, world, port, q):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        start, end = tlh.process_local_slice(5)
        q.put((rank, (start, end),
               tlh.LongHorizonEvaluator.gather_results(
                   list(range(start, end)))))
    finally:
        dist.destroy_process_group()


def test_gather_results_across_processes():
    """Two gloo processes: each evaluates its contiguous share of the
    chains, and every process gets all results in rank order; without a
    process group the local list comes back."""
    assert tlh.LongHorizonEvaluator.gather_results([3, 1]) == [3, 1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_gather_worker, args=(r, 2, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    got = sorted(q.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert [g[1] for g in got] == [(0, 3), (3, 5)]
    assert all(g[2] == [0, 1, 2, 3, 4] for g in got)
