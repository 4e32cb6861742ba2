"""The port's LIBERO slice against the JAX package's: the robomimic hdf5
datasets (every item over the flag combinations of ``tests/test_libero.py``,
from the file and from the in-memory ``demo_arrays`` seam), the
datamodule's split and batches with a numpy and a torch embedder, the
builder, ``translate_obs`` and the ``FakeLiberoEnv`` stream, the
``LiberoEvaluator`` on scripted envs and with both packages' agents on
the same weights, both rollout hooks, and the ``evaluate_libero`` and
``training_libero`` CLIs on the CPU.

Sizes are the JAX tests' (24 px frames, 2 tasks of 2 demos x 15 frames);
the agents are ``tests/test_torch_evaluate.py``'s (a 2-layer DiT at D=256
and the FiLM-ResNet-50 encoders at 32 px: the port has no ResNet-18). The
sampler noise of both packages' policies comes from one numpy stream.
Gate on the actions: every action within 2e-5 of JAX's (the plain f32
graph on both sides, ``reference``), the gate of
``tests/test_torch_evaluate.py``."""
import pathlib
import shutil

import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401

h5py = pytest.importorskip("h5py")

import mode_diffusion_policy_tpu.models.agent as jagent_mod  # noqa: E402
from mode_diffusion_policy_tpu.config import builders as jb  # noqa: E402
from mode_diffusion_policy_tpu.data import libero as jl  # noqa: E402
from mode_diffusion_policy_tpu.models.encoders.lang_cache import \
    LangEmbeddingCache as JCache  # noqa: E402
from mode_diffusion_policy_tpu.rollout import \
    libero_rollout as jr  # noqa: E402
from mode_diffusion_policy_tpu.training_common import \
    build_libero_rollout_callback as jbuild_hook  # noqa: E402
from mode_diffusion_policy_tpu_torch import training_common  # noqa: E402
from mode_diffusion_policy_tpu_torch import training_libero  # noqa: E402
from mode_diffusion_policy_tpu_torch.config import builders as tb  # noqa: E402
from mode_diffusion_policy_tpu_torch.config.loader import \
    load_config  # noqa: E402
from mode_diffusion_policy_tpu_torch.data import libero as tl  # noqa: E402
from mode_diffusion_policy_tpu_torch.evaluation import \
    evaluate_calvin as ec  # noqa: E402
from mode_diffusion_policy_tpu_torch.evaluation import \
    evaluate_libero  # noqa: E402
from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import \
    LangEmbeddingCache  # noqa: E402
from mode_diffusion_policy_tpu_torch.rollout import \
    libero_rollout as tr  # noqa: E402
from test_libero import make_libero_hdf5  # noqa: E402
from test_torch_data import assert_same, fake_lang  # noqa: E402
from test_torch_evaluate import (CAMS, IMG, JaxNoisePolicy,  # noqa: E402
                                 PortNoisePolicy, _port_agent, _port_lang,
                                 weights)

CONF = pathlib.Path(__file__).resolve().parents[1] / "conf"
TASKS = ("SCENE1_open_the_top_drawer_demo.hdf5",
         "SCENE2_put_the_bowl_on_the_plate_demo.hdf5")


@pytest.fixture(scope="module")
def libero_root(tmp_path_factory):
    """JAX's fixture store: two tasks of 2 demos x 15 frames at 24 px."""
    root = tmp_path_factory.mktemp("libero_torch")
    (root / "libero_10").mkdir()
    for seed, name in enumerate(TASKS):
        make_libero_hdf5(root / "libero_10" / name, seed=seed)
    return root


def demo_arrays(path):
    """A task file read into ``demo_arrays``' layout."""
    with h5py.File(path, "r") as f:
        return {d: {"actions": np.asarray(f[f"data/{d}/actions"]),
                    **{k: np.asarray(v)
                       for k, v in f[f"data/{d}/obs"].items()}}
                for d in f["data"]}


def torch_lang(texts):
    """``fake_lang`` as a tensor (as the CLIP tower's cache returns it)."""
    return torch.from_numpy(fake_lang(texts))


def test_task_description_from_filename_matches_jax():
    for name in ("KITCHEN_SCENE10_put_the_butter_in_the_basket_demo.hdf5",
                 "LIVING_ROOM_SCENE2_pick_up_the_book_demo.hdf5",
                 *TASKS, "no_scene_prefix_demo.hdf5"):
        got = tl.task_description_from_filename(name)
        assert got == jl.task_description_from_filename(name)


FLAGS = [
    dict(seq_len=10),
    dict(seq_len=10, cache_all=True),
    dict(seq_len=10, obs_seq_len=2),
    dict(seq_len=10, frame_stack=3, goal_mode="last", load_next_obs=True),
    dict(seq_len=10, frame_stack=3, pad_frame_stack=False),
    dict(seq_len=10, pad_seq_length=False, goal_mode="last"),
    dict(seq_len=1, frame_stack=1, load_next_obs=True),
    dict(seq_len=10, task_emb=np.arange(8, dtype=np.float32)),
]


@pytest.mark.parametrize("kw", FLAGS, ids=[
    "plain", "cache-all", "obs2", "stack3-goal-next", "no-pad-stack",
    "no-pad-seq-goal", "seq1-next", "task-emb"])
def test_sequence_items_match_jax(libero_root, kw):
    """Every item of a task file, in order, equals JAX's bit for bit; so
    does every item read through ``demo_arrays`` (arrays, with and
    without ``cache_all``)."""
    path = libero_root / "libero_10" / TASKS[0]
    jd = jl.LiberoSequenceDataset(path, **kw)
    td = tl.LiberoSequenceDataset(path, **kw)
    arrays = demo_arrays(path)
    seam = [tl.LiberoSequenceDataset(path, demo_arrays=arrays,
                                     **dict(kw, cache_all=c))
            for c in (False, True)]
    assert len(jd) == len(td) == len(seam[0]) == len(seam[1]) > 0
    assert td.demos == jd.demos == seam[0].demos
    for i in range(len(td)):
        want = jd[i]
        assert_same(want, td[i], f"item {i}")
        for s in seam:
            assert_same(want, s[i], f"demo_arrays item {i}")
    td.close()
    jd.close()
    with pytest.raises(ValueError, match="goal_mode"):
        tl.LiberoSequenceDataset(path, goal_mode="nope")


def test_multitask_concat_matches_jax(libero_root):
    paths = sorted((libero_root / "libero_10").glob("*.hdf5"))
    jd = jl.LiberoMultitaskDataset([jl.LiberoSequenceDataset(p)
                                    for p in paths])
    td = tl.LiberoMultitaskDataset([tl.LiberoSequenceDataset(p)
                                    for p in paths])
    assert len(jd) == len(td) == 60
    for i in (0, 29, 30, 59):
        assert_same(jd[i], td[i], f"item {i}")
    assert tl.discover_benchmark_tasks("libero_10", str(libero_root)) == \
        jl.discover_benchmark_tasks("libero_10", str(libero_root))
    with pytest.raises(FileNotFoundError):
        tl.discover_benchmark_tasks("libero_10", None)


def _batches(dm, epochs=(0, 1)):
    out = []
    for e in epochs:
        out += list(dm.train_batches(e))
    return out + list(dm.val_batches())


@pytest.mark.parametrize("embed", ["numpy", "torch"])
def test_datamodule_matches_jax(libero_root, embed):
    """The same split, the same train batches over two epochs and the same
    validation batches as JAX's, with a numpy embedder and with one that
    returns tensors (kept as tensors, equal in value); the ``task_arrays``
    seam with ``cache_all`` gives the same batches too."""
    lang = fake_lang if embed == "numpy" else torch_lang
    kw = dict(batch_size=4, seq_len=10, train_fraction=0.9, seed=3)
    jdm = jl.LiberoDataModule("libero_10", str(libero_root),
                              lang_embed=fake_lang, **kw).setup()
    tdm = tl.LiberoDataModule("libero_10", str(libero_root),
                              lang_embed=lang, **kw).setup()
    task_arrays = {str(p): demo_arrays(p) for p in sorted(
        (libero_root / "libero_10").glob("*.hdf5"))}
    sdm = tl.LiberoDataModule("libero_10", None, lang_embed=lang,
                              cache_all=True, task_arrays=task_arrays,
                              **kw).setup()
    assert tdm.task_descriptions == jdm.task_descriptions == \
        sdm.task_descriptions
    for dm in (tdm, sdm):
        np.testing.assert_array_equal(dm._train_idx, jdm._train_idx)
        np.testing.assert_array_equal(dm._val_idx, jdm._val_idx)
    want = _batches(jdm)
    assert len(want) == 2 * 13 + 1
    for dm in (tdm, sdm):
        got = _batches(dm)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = dict(g), dict(w)
            emb = g.pop("lang_emb")
            assert isinstance(emb, torch.Tensor) == (embed == "torch")
            np.testing.assert_array_equal(np.asarray(emb), w.pop("lang_emb"))
            assert_same(w, g, f"batch {i}")
    # the per-task embeddings of the items
    for ds, jds in zip(tdm.full.datasets, jdm.full.datasets):
        np.testing.assert_array_equal(np.asarray(ds[0]["lang"]),
                                      jds[0]["lang"])
    tdm.close()


def test_builder_reads_the_shipped_config(libero_root):
    cfg = load_config(CONF, "config_libero", [
        f"root_data_dir={libero_root}", "batch_size=4"])
    t = tb.build_libero_datamodule(cfg["datamodule"], lang_embed=fake_lang)
    j = jb.build_libero_datamodule(cfg["datamodule"], lang_embed=fake_lang)
    assert isinstance(t, tl.LiberoDataModule)
    for k in ("benchmark_name", "root_data_dir", "batch_size", "seq_len",
              "obs_seq_len", "cache_all", "train_fraction", "seed"):
        assert getattr(t, k) == getattr(j, k), k
    assert (t.benchmark_name, t.batch_size, t.seq_len) == ("libero_10", 4, 10)
    t.setup()
    j.setup()
    for g, w in zip(t.train_batches(0), j.train_batches(0)):
        assert_same(w, g)


def test_translate_obs_and_fake_env_stream_match_jax():
    for seed in (0, 5):
        tenv = tr.FakeLiberoEnv(hw=16, steps_to_success=3, seed=seed)
        jenv = jr.FakeLiberoEnv(hw=16, steps_to_success=3, seed=seed)
        obs = [(tenv.reset(), jenv.reset())]
        for _ in range(4):
            t, _, td, _ = tenv.step(np.zeros(7))
            j, _, jd, _ = jenv.step(np.zeros(7))
            assert td == jd
            obs.append((t, j))
        obs.append((tenv.set_init_state(None), jenv.set_init_state(None)))
        for t, j in obs:
            assert_same(j, t)
            assert_same(jr.translate_obs(j), tr.translate_obs(t))
        np.testing.assert_array_equal(tenv.get_sim_state(),
                                      jenv.get_sim_state())


class CountingPolicy:
    def __init__(self):
        self.resets = self.steps = 0

    def reset(self):
        self.resets += 1

    def step(self, obs, goal):
        assert goal["lang_text"]
        self.steps += 1
        return np.full((1, 7), 0.1 * self.steps, np.float32)


class RecordingVideo:
    def __init__(self):
        self.calls = []

    def new_video(self, tag, caption):
        self.calls.append(("new", tag, caption))

    def update(self, img):
        self.calls.append(("update", img.shape))

    def draw_outcome(self, done):
        self.calls.append(("outcome", done))


def test_evaluator_on_scripted_envs_matches_jax(monkeypatch):
    """Success rates, policy resets and steps, init states, videos and
    metrics equal JAX's; the cross-process average is the mean of each
    task's rates (``torch.distributed`` faked with two ranks)."""
    results = []
    for mod in (jr, tr):
        video = RecordingVideo()
        ev = mod.LiberoEvaluator(n_eval=4, max_steps=20, warmup_steps=5,
                                 rollout_video=video, num_videos=2)
        policy = CountingPolicy()
        rates = [ev.evaluate_task(policy, mod.FakeLiberoEnv(
            steps_to_success=s), f"task {s}", init_states=init,
            shard_across_hosts=False)
            for s, init in ((12, None), (None, np.zeros((3, 8))),
                            (30, None))]
        rates.append(ev.evaluate_task(policy, mod.FakeLiberoEnv(), "task x"))
        results.append((rates, policy.resets, policy.steps, video.calls,
                        ev.metrics(rates, ["a", "b", "c", "d"]),
                        ev.gather_success_rates(rates)))
    assert results[0] == results[1]
    assert results[1][0] == [1.0, 0.0, 0.0, 1.0]

    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)

    def all_gather_object(out, obj):
        out[0], out[1] = list(obj), [1.0 - r for r in obj]

    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    assert tr.LiberoEvaluator.gather_success_rates([1.0, 0.25]) == [0.5, 0.5]


@pytest.fixture(scope="module")
def jax_policy(weights):
    """JAX's chunked stepper for the weights (one jitted chunk for the
    module); each test sets its noise stream and log."""
    jagent, v, jlang = weights
    return JaxNoisePolicy(jagent, v, JCache(jlang), "reference", None, None)


def _rollouts(mod, policy):
    """Two fake tasks (one solved after 17 env steps: 12 policy steps, two
    chunks; one never: 14 policy steps), two rollouts each."""
    ev = mod.LiberoEvaluator(n_eval=2, max_steps=14)
    rates, names = [], []
    for i, steps in enumerate((17, None)):
        env = mod.FakeLiberoEnv(hw=IMG, steps_to_success=steps, seed=i)
        rates.append(ev.evaluate_task(policy, env, f"fake task {i}",
                                      shard_across_hosts=False))
        names.append(f"fake task {i}")
    return ev.metrics(rates, names)


def test_evaluator_with_agents_matches_jax(weights, jax_policy):
    """``LiberoEvaluator`` + ``evaluate_calvin.PreprocPolicy`` (both
    cameras at one size, as evaluate_libero serves them) against JAX's
    stepper on the same weights, env seeds and noise: equal metrics, every
    action within 2e-5."""
    jagent, v, jlang = weights
    jlog, tlog = [], []
    jax_policy.rng, jax_policy.log = np.random.default_rng(7), jlog
    want = _rollouts(jr, jax_policy)
    cache = LangEmbeddingCache(_port_lang(jlang))
    policy = ec.PreprocPolicy(_port_agent(v), cache,
                              sizes={c: IMG for c in CAMS})
    got = _rollouts(tr, PortNoisePolicy(policy, np.random.default_rng(7),
                                        tlog))
    assert got == want == {"eval/sr_fake_task_0": 1.0,
                           "eval/sr_fake_task_1": 0.0,
                           "eval/avg_success_rate": 0.5}
    assert len(tlog) == len(jlog) == 2 * 12 + 2 * 14
    got, want = np.concatenate(tlog), np.concatenate(jlog)
    assert np.isfinite(got).all() and np.abs(want).mean() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert cache.encoder_calls == 2


def test_rollout_hooks_match_jax(weights, jax_policy, monkeypatch):
    """Both packages' hooks on the same weights, env seeds and noise:
    equal metrics, every action within 2e-5. JAX's hook serves
    ``RolloutPolicy``: here the module's jitted stepper, fed the raw frames
    (the hook's preprocessing at the frames' own size is the stepper's);
    the port's hook serves an f32 copy of the variables through
    ``PreprocPolicy`` with both cameras at the static pipeline's size.
    Without the fake env or the LIBERO package, both return None."""
    jagent, v, jlang = weights
    jlog, tlog = [], []
    jax_policy.rng, jax_policy.log = np.random.default_rng(9), jlog

    class JaxStepper:
        def __init__(self, agent, variables, lang):
            assert agent is jagent and variables is v
            self.multistep, self._counter = 10, 0

        def reset(self):
            self._counter = 0
            jax_policy.reset()

        def step(self, obs, goal):
            self._counter = (self._counter + 1) % self.multistep
            return jax_policy.step(obs, goal)

    noise = np.random.default_rng(9)
    made = []

    class PortNoise(ec.PreprocPolicy):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def step(self, obs, goal, noise_=None):
            if self._counter % self.multistep == 0:
                noise_ = torch.from_numpy(noise.standard_normal(
                    (1, 10, 7)).astype(np.float32))
            action = super().step(obs, goal, noise_)
            tlog.append(action)
            return action

    monkeypatch.setattr(jagent_mod, "RolloutPolicy", JaxStepper)
    monkeypatch.setattr(ec, "PreprocPolicy", PortNoise)
    cfg = {"fake_env": True, "fake_hw": IMG, "fake_tasks": 2,
           "fake_steps_to_success": 17, "n_eval": 2, "max_steps": 14}
    pipes = {"rgb_static": {"size": IMG, "pad": 2},
             "rgb_gripper": {"size": IMG // 2, "pad": 2}}
    want = jbuild_hook(cfg, JCache(jlang), pipes)(jagent, v, 0)
    agent = _port_agent(v)
    variables = {"params": dict(agent.named_parameters()),
                 "batch_stats": dict(agent.named_buffers())}
    got = training_common.build_libero_rollout_callback(
        cfg, LangEmbeddingCache(_port_lang(jlang)), pipes)(agent, variables,
                                                           0)
    assert got == want == {"eval/sr_fake_task_0": 1.0,
                           "eval/sr_fake_task_1": 1.0,
                           "eval/avg_success_rate": 1.0}
    assert made[0].sizes == {c: IMG for c in CAMS}
    assert made[0].agent.inner_model is not agent.inner_model
    assert len(tlog) == len(jlog) == 4 * 12
    np.testing.assert_allclose(np.concatenate(tlog), np.concatenate(jlog),
                               atol=2e-5, rtol=0)
    for build in (jbuild_hook, training_common.build_libero_rollout_callback):
        assert build({"benchmark_name": "libero_10"}, None, pipes) is None


def test_evaluate_libero_cli_on_the_cpu(tmp_path):
    argv = ["--fake-env", "--fake-tasks", "2", "--n-eval", "2",
            "--max-steps", "6", "--latent-dim", "64", "--n-layers", "1",
            "--img-size", "32", "--log-dir", str(tmp_path),
            "--fake-steps-to-success", "3", "--sampler-unroll", "4"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_libero.main(argv)      # CUDA by default, and none here
    metrics = evaluate_libero.main(argv + ["--device", "cpu"])
    assert metrics == {"eval/sr_fake_task_0": 1.0, "eval/sr_fake_task_1": 1.0,
                       "eval/avg_success_rate": 1.0}
    import json
    assert json.loads((tmp_path / "results_libero.json").read_text()) == \
        metrics


def test_benchmark_key_for_the_rollout_hook(monkeypatch):
    """The hook's benchmark: ``libero_benchmark`` when set, else the
    shipped config's ``benchmark_name``."""
    seen = []
    monkeypatch.setattr(training_common, "build_libero_rollout_callback",
                        lambda cfg, lang, pipes: seen.append(cfg))

    def train_with(cfg, *, build_datamodule, build_rollout, default_name):
        assert build_datamodule is tb.build_libero_datamodule
        assert default_name == "mode_libero"
        build_rollout({}, None, None)

    monkeypatch.setattr(training_libero, "train_with", train_with)
    cfg = load_config(CONF, "config_libero", ["benchmark_name=libero_90"])
    training_libero.train(cfg)
    training_libero.train(dict(cfg, libero_benchmark="libero_spatial"))
    assert [c["benchmark_name"] for c in seen] == ["libero_90",
                                                   "libero_spatial"]


def test_training_libero_cli_on_the_cpu(libero_root, tmp_path, monkeypatch):
    """``training_libero.main`` on the shipped config (a one-layer DiT 64
    wide in f32; the static camera at 32 px and the gripper at 16, two
    sizes as shipped): finite losses, a checkpoint, ``.hydra/config.yaml``, the
    hook's metric; its first batch equal to JAX's ``make_data_iters``
    batch (the language embedding: the CLI's tower on the batch's texts);
    then ``evaluate_libero`` restores the run directory."""
    from mode_diffusion_policy_tpu import training_common as jtc
    from mode_diffusion_policy_tpu.config.loader import \
        load_config as jload
    first = {}
    make_iters = training_common.make_data_iters

    def recording(datamodule, pipelines, device="cuda"):
        train_iter, val_iter = make_iters(datamodule, pipelines, device)

        def train(epoch=0):
            for batch in train_iter(epoch):
                first.setdefault("batch", batch)
                first.setdefault("lang", datamodule.lang_embed)
                yield batch

        return train, val_iter

    monkeypatch.setattr(training_common, "make_data_iters", recording)
    overrides = [
        f"root_data_dir={libero_root}", f"log_dir={tmp_path}", "device=cpu",
        "model.latent_dim=64", "model.model.inner_model.n_layers=1",
        "model.model.inner_model.n_heads=2", "batch_size=4",
        "trainer.precision=32", "trainer.max_epochs=1",
        "trainer.limit_train_batches=2",
        "trainer.limit_val_batches=1", "callbacks.rollout_lh.fake_env=true",
        "callbacks.rollout_lh.fake_hw=24", "callbacks.rollout_lh.n_eval=1",
        "callbacks.rollout_lh.max_steps=4",
        "callbacks.rollout_lh.rollout_freq=1"] + [
        f"datamodule.transforms.{split}.{cam}.0.size={size}"
        for split in ("train", "val")
        for cam, size in (("rgb_static", 32), ("rgb_gripper", 16))]
    try:
        run = training_libero.main(overrides)
        out = run.run_dir
        assert out == tmp_path / "mode_libero" and run.state.step == 2
        assert (out / "saved_models" / "2" / "state.pt").exists()
        assert (out / ".hydra" / "config.yaml").is_file()
        import json
        records = [json.loads(line) for line in open(out / "metrics.jsonl")]
        assert np.isfinite(records[0]["train/total_loss"])
        assert "eval/avg_success_rate" in records[-1]

        cfg = jload(CONF, "config_libero", overrides)
        jdm = jb.build_libero_datamodule(cfg["datamodule"],
                                         lang_embed=fake_lang).setup()
        pipes = jtc.parse_camera_pipelines(cfg["datamodule"]["transforms"])
        jtrain, _ = jtc.make_data_iters(jdm, pipes)
        want = next(jtrain(0))
        got = dict(first["batch"])
        assert set(got) == set(want)
        texts = next(jdm.train_batches(0))["lang_text"]
        torch.testing.assert_close(got.pop("lang_emb"), first["lang"](texts),
                                   rtol=0, atol=0)
        want.pop("lang_emb")
        assert_same(want, got)

        ev = evaluate_libero.evaluate(evaluate_libero.parse_args([
            "--checkpoint", str(out), "--fake-env", "--device", "cpu",
            "--n-eval", "1", "--max-steps", "4", "--img-size", "32",
            "--log-dir", str(tmp_path / "eval")]))
        assert ev.agent.cfg.latent_dim == 64 and ev.agent.cfg.n_layers == 1
        assert (tmp_path / "eval" / "results_libero.json").is_file()
        saved = torch.load(out / "saved_models" / "2" / "state.pt",
                           weights_only=False)
        torch.testing.assert_close(
            dict(ev.agent.named_parameters())["inner_model.out.kernel"],
            saved["ema_params"]["inner_model.out.kernel"].float(),
            rtol=0, atol=0)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
