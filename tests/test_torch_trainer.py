"""The port's Trainer on a tiny configuration on the CPU, mirroring the JAX
package's Trainer tests (tests/test_training.py): a fit with validation
and the rollout hook, best-checkpoint tracking and ``best_score.json``
across a restart, auto-resume that continues step, epoch, schedule and the
random stream (the resumed run equals the uninterrupted one bit for bit),
the SIGTERM preemption checkpoint, the bf16 training state's checkpoint
round trip, the JSONL metric log, ``auto_layout`` (the same state as
without it), and the helpers of ``training_common``."""
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu_torch.models.agent import (MoDEAgent,
                                                          MoDEAgentConfig)
from mode_diffusion_policy_tpu_torch.parallel.mesh import (
    process_local_slice, shard_batch)
from mode_diffusion_policy_tpu_torch.training.loop import (
    CheckpointManager, MetricLogger, Trainer, grad_telemetry)
from mode_diffusion_policy_tpu_torch.training.optim import (make_optimizer,
                                                            tri_stage_schedule)
from mode_diffusion_policy_tpu_torch.training.state import TrainState
from mode_diffusion_policy_tpu_torch.training_common import (
    DEFAULT_PIPELINES, make_data_iters, make_train_preprocess,
    parse_camera_pipelines)
from mode_diffusion_policy_tpu_torch.utils.utils import device_memory_stats
from torch_threads import two_torch_threads  # noqa: F401

IMG = 16
CFG = dict(latent_dim=64, n_layers=1, n_heads=2, cond_dim=16,
           entropy_gamma=0.01)
PIPES = {k: dict(v, size=IMG) for k, v in DEFAULT_PIPELINES.items()}
OPT = {"learning_rate": 1e-3, "total_steps": 40}


@pytest.fixture(autouse=True)
def _free_checkpoints(tmp_path):
    """A checkpoint of the tiny agent holds ~750 MB (two full-size
    ResNet-50 encoders, four copies): remove each test's as it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _agent():
    return MoDEAgent(MoDEAgentConfig(**CFG), device="cpu")


def _batch(seed, B=2):
    r = np.random.default_rng(seed)
    return {"rgb_static": r.integers(0, 256, (B, 1, IMG + 4, IMG + 4, 3),
                                     dtype=np.uint8),
            "rgb_gripper": r.integers(0, 256, (B, 1, IMG + 4, IMG + 4, 3),
                                      dtype=np.uint8),
            "actions": (r.standard_normal((B, 10, 7)) * 0.3).astype(
                np.float32),
            "lang_emb": r.standard_normal((B, 1, 16)).astype(np.float32)}


class TinyData:
    """Any object with train_batches(epoch) / val_batches() feeds
    make_data_iters."""

    def __init__(self, n_train=2):
        self.n_train = n_train

    def train_batches(self, epoch):
        for i in range(self.n_train):
            yield _batch(100 * epoch + i)

    def val_batches(self):
        yield _batch(999)


def _trainer(log_dir, **kw):
    kw.setdefault("optimizer_kwargs", OPT)
    return Trainer(_agent(), log_dir=str(log_dir), device="cpu",
                   preprocess_fn=make_train_preprocess(PIPES), **kw)


def _snapshot(state):
    return {n: t.detach().clone() for n, t in state.params.items()}


def test_fit_with_validation_and_rollout_hook(tmp_path):
    train_iter, val_iter = make_data_iters(TinyData(3), PIPES, device="cpu")
    t = _trainer(tmp_path / "run", max_epochs=1, limit_train_batches=2,
                 rollout_freq=1,
                 rollout_callback=lambda agent, v, epoch: {
                     "eval_lh/avg_seq_len": 1.5})
    state = t.setup()
    before = _snapshot(state)
    state = t.fit(state, train_iter, val_iter)
    assert state.step == 2 and state.epoch == 1
    assert state.opt_state.count == 2
    assert any(not torch.equal(before[n], p) for n, p in
               state.params.items())
    assert t._optimizer.last_lr == tri_stage_schedule(1e-3, 40)(1)
    recs = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
    assert recs[0]["step"] == 1 and np.isfinite(recs[0]["train/total_loss"])
    assert "debug/total_grad_norm" in recs[0] and "train/lr" in recs[0]
    ep = recs[-1]
    assert np.isfinite(ep["val_act/lang_act_loss_pp"])
    assert ep["eval_lh/avg_seq_len"] == 1.5
    assert np.asarray(ep["MoE_utils/expert_usage"]).shape == (1, 4)
    assert t.ckpt.latest_step() == 2 and t.ckpt.best_step() == 2
    # the EMA decay is 0 for the first two steps (1 - (1 + max(0, step -
    # 1))^-2/3), so the EMA is the parameters, as in the JAX package
    ema = state.ema_params
    assert all(torch.equal(ema[n], p) for n, p in state.params.items())


def _small_state():
    """A TrainState over two small tensors: what the checkpoint manager
    saves does not depend on the model."""
    params = {"inner_model.w": torch.randn(4, 3),
              "inner_model.bias": torch.randn(3)}
    opt, _ = make_optimizer(params, use_lr_scheduler=False)
    st = opt.init(params)
    return TrainState(step=0, params=params,
                      batch_stats={"static_resnet.bn.mean": torch.zeros(3)},
                      opt_state=st, ema_params={n: p.clone() for n, p in
                                                params.items()},
                      rng=torch.Generator().manual_seed(0))


def test_checkpoint_best_tracking_across_restart(tmp_path):
    state = _small_state()
    mgr = CheckpointManager(str(tmp_path / "ck"), monitor="m", mode="max",
                            save_top_k=1)
    for step, m in ((1, 0.5), (2, 0.9), (3, 0.2)):
        state.step = step
        mgr.save(step, state, {"m": m})
    assert mgr.best_step() == 2 and mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3", "best",
                                                   "best_score.json"]
    # a restart keeps the historical best: 0.7 does not beat 0.9
    mgr2 = CheckpointManager(str(tmp_path / "ck"), monitor="m", mode="max")
    state.step = 4
    mgr2.save(4, state, {"m": 0.7})
    assert mgr2.best_step() == 2
    state.step = 5
    mgr2.save(5, state, {"m": 1.1})
    assert mgr2.best_step() == 5
    assert json.load(open(tmp_path / "ck" / "best_score.json"))["best"] == 1.1
    assert mgr2.restore(state).step == 5
    assert mgr2.restore_best(state).step == 5


def test_auto_resume_continues_the_run(tmp_path):
    """One epoch, then a fresh Trainer on the same log dir resumes (step,
    epoch, optimizer count, generator state) and its second epoch ends
    where an uninterrupted two-epoch run ends, bit for bit."""
    data = TinyData(1)
    t1 = _trainer(tmp_path / "a", max_epochs=1)
    s1 = t1.fit(t1.setup(), data.train_batches)
    saved_rng = s1.rng.get_state()
    t2 = _trainer(tmp_path / "a", max_epochs=2)
    s2 = t2.setup()
    assert t2.resumed and s2.step == 1 and s2.epoch == 1
    assert s2.opt_state.count == 1
    assert torch.equal(s2.rng.get_state(), saved_rng)
    s2 = t2.fit(s2, data.train_batches)
    assert s2.step == 2 and s2.epoch == 2
    assert t2._optimizer.last_lr == tri_stage_schedule(1e-3, 40)(1)
    t3 = _trainer(tmp_path / "b", max_epochs=2)
    s3 = t3.fit(t3.setup(), data.train_batches)
    for n, p in s3.params.items():
        assert torch.equal(s2.params[n], p), n
        assert torch.equal(s2.ema_params[n], s3.ema_params[n]), n


def test_sigterm_preemption_checkpoint(tmp_path):
    batches = [_batch(s) for s in range(5)]

    def gen():
        for i, b in enumerate(batches):
            if i == 1:      # preempted while the 2nd batch is pending
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    before = signal.getsignal(signal.SIGTERM)
    t1 = _trainer(tmp_path / "run", max_epochs=3, limit_train_batches=5)
    s1 = t1.fit(t1.setup(), lambda: gen())
    assert s1.step == 2                  # stopped mid-epoch
    assert t1.ckpt.latest_step() == 2    # boundary checkpoint written
    assert signal.getsignal(signal.SIGTERM) == before
    t2 = _trainer(tmp_path / "run", max_epochs=3, limit_train_batches=5)
    s2 = t2.setup()
    assert t2.resumed and s2.step == 2 and s2.epoch == 0


def test_bf16_full_state_checkpoint_round_trip(tmp_path):
    """The bf16 state (parameters, moments, EMA in bf16, stochastic-rounded
    updates) restores with its dtypes and every tensor bit for bit."""
    batches = [_batch(0)]
    t1 = _trainer(tmp_path / "run", max_epochs=1, bf16_full_state=True)
    s1 = t1.fit(t1.setup(), lambda: iter(batches))
    t2 = _trainer(tmp_path / "run", max_epochs=1, bf16_full_state=True)
    s2 = t2.setup()
    assert t2.resumed and s1.step == s2.step == 1
    for a, b in ((s1.params, s2.params), (s1.ema_params, s2.ema_params),
                 (s1.opt_state.mu, s2.opt_state.mu),
                 (s1.opt_state.nu, s2.opt_state.nu),
                 (s1.batch_stats, s2.batch_stats)):
        for n, x in a.items():
            assert b[n].dtype == x.dtype, n
            assert torch.equal(b[n], x), n
    assert all(p.dtype == torch.bfloat16 for p in s2.params.values())
    assert all(torch.isfinite(p.float()).all() for p in s2.params.values())


def test_auto_layout_gives_the_default_state(tmp_path):
    batches = [_batch(0)]
    finals = {}
    for auto in (False, True):
        t = _trainer(tmp_path / f"run{auto}", max_epochs=1, auto_layout=auto)
        finals[auto] = t.fit(t.setup(), lambda: iter(batches))
    for n, p in finals[False].params.items():
        assert torch.equal(finals[True].params[n], p), n


def test_metric_logger_jsonl(tmp_path):
    log = MetricLogger(str(tmp_path))
    log.log({"a": torch.tensor(1.5), "b": np.float32(2.0),
             "c": np.arange(3), "d": torch.ones(2, 2)}, 7)
    log.log({"a": 3}, 8)
    log.close()
    recs = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert recs == [{"step": 7, "a": 1.5, "b": 2.0, "c": [0, 1, 2],
                     "d": [[1.0, 1.0], [1.0, 1.0]]}, {"step": 8, "a": 3.0}]


def test_grad_telemetry_names():
    g = {"inner_model.blocks.0.attn.wqkv.kernel": torch.full((2, 2), 1.0),
         "inner_model.blocks.1.ln_1.g": torch.full((4,), 1.0),
         "inner_model.out.kernel": torch.full((1,), 2.0),
         "static_resnet.resnet.conv1.weight": torch.full((3,), 5.0)}
    m = grad_telemetry(g)
    assert set(m) == {"debug/blocks_0_grad_norm", "debug/blocks_1_grad_norm",
                      "debug/total_grad_norm"}
    assert float(m["debug/blocks_0_grad_norm"]) == 2.0
    assert float(m["debug/total_grad_norm"]) == pytest.approx(12 ** 0.5)


def test_training_common_helpers(tmp_path):
    cfg = {"train": {
        "rgb_static": [{"_target_": "torchvision.transforms.Resize",
                        "size": 96},
                       {"_target_": "mode.utils.transforms.RandomShiftsAug",
                        "pad": 6},
                       {"_target_": "x.RobustColorJitter", "hue": 0.05}],
        "lang_emb": [{"_target_": "x.RandomWordDropout", "p": 0.2}]}}
    p = parse_camera_pipelines(cfg)
    assert p["rgb_static"]["size"] == 96 and p["rgb_static"]["pad"] == 6
    assert p["rgb_static"]["jitter"]["hue"] == 0.05
    assert p["rgb_gripper"] == {"size": 224, "pad": 4}
    assert p["word_dropout_p"] == 0.2
    pipes = dict(PIPES, word_dropout_p=0.5)
    pipes["rgb_static"] = dict(pipes["rgb_static"], jitter={})
    b = {k: torch.as_tensor(v) for k, v in _batch(0).items()}
    out = make_train_preprocess(pipes)(b, torch.Generator().manual_seed(0))
    assert out["rgb_static"].shape == (2, 1, IMG, IMG, 3)
    assert out["rgb_static"].dtype == torch.float32
    assert (out["lang_emb"] == 0).any() and out["actions"] is b["actions"]
    tr, va = make_data_iters(TinyData(2), PIPES, device="cpu")
    assert len(list(tr(0))) == 2
    (vb,) = list(va(0))
    assert vb["rgb_static"].shape == (2, 1, IMG, IMG, 3)
    pytest.importorskip("yaml")
    from mode_diffusion_policy_tpu_torch.training_common import \
        persist_resolved_config
    persist_resolved_config({"a": 1, "b": (2, 3)}, tmp_path)
    assert (tmp_path / ".hydra" / "config.yaml").exists()


def test_mesh_helpers_on_one_process():
    assert process_local_slice(10) == (0, 10)
    b = shard_batch({"x": np.ones((2, 3), np.float32)}, "cpu")
    assert isinstance(b["x"], torch.Tensor) and b["x"].shape == (2, 3)
    assert device_memory_stats("cpu") == {}
