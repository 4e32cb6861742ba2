"""The port's ``Trainer`` and ``training_calvin`` across ranks on the CPU: a
2-rank gloo world, spawned once (``tests/torch_dp_worker.py``), at the
small shapes of ``tests/test_torch_data_parallel.py`` (weights numpy-made
for the JAX agent's tree, entering through ``from_jax_params``; the bf16
training state; uint8 frames augmented in the step).

Checked: with uneven shards (rank 0 holds one batch more) both ranks take
the same number of steps and end bit-equal; rank 0 alone writes the
checkpoints and the metric log; a SIGTERM sent to one rank stops both at
the same step, where the checkpoint lands, and both resume from it; and
``training_calvin`` on the tiny store of ``tests/calvin_fixture.py`` runs
on both ranks, each on ``batch_size / 2`` rows.
"""
import shutil

import pytest
import torch

from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JCfg
from test_torch_data_parallel import (DIMS, LOSS_KW, NO_DROP, OPT_KW,
                                      PIPELINES, _random_variables,
                                      _raw_batches, _same)
from torch_dp_worker import World
from torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tiny store (actions extracted), then the 2-rank world's results;
    the run directory is removed at the end (checkpoints of the encoders)."""
    from calvin_fixture import make_calvin_dataset
    from mode_diffusion_policy_tpu_torch.data import preprocess
    tmp = tmp_path_factory.mktemp("dp_trainer")
    store = make_calvin_dataset(tmp / "calvin", n_episodes=3, ep_len=30,
                                hw=24)
    for split in ("training", "validation"):
        preprocess.main(["--in-root", str(store / split), "--workers", "2"])
    torch.save({
        "variables": _random_variables(JAgent(JCfg(**DIMS))),
        "cfg": dict(**DIMS, **NO_DROP, **LOSS_KW), "opt_kw": OPT_KW,
        "raw_batches": _raw_batches(), "pipelines": PIPELINES,
        "cli_argv": [
            f"root_data_dir={store}", "device=cpu", "batch_size=4",
            "model.latent_dim=64", "model.resnet_type=18",
            "model.model.inner_model.n_layers=1",
            "model.model.inner_model.n_heads=2", "num_workers=0",
            "trainer.max_epochs=1", "trainer.limit_train_batches=2",
            "trainer.limit_val_batches=1"] + [
            f"datamodule.transforms.{split}.{cam}.0.size=32"
            for split in ("train", "val")
            for cam in ("rgb_static", "rgb_gripper")]},
        tmp / "inputs.pt")
    yield World("trainer", tmp).results(timeout=240.0)
    shutil.rmtree(tmp, ignore_errors=True)


def test_trainer_fit_on_two_ranks(world):
    """Uneven shards (rank 0 holds 3 batches, rank 1 2): both ranks take 2
    steps and end with the same parameters; rank 0 alone writes the
    checkpoint and the log. A SIGTERM to rank 1 alone stops both at the
    same step, where the checkpoint lands, and both resume from it."""
    u = [r["fit"]["uneven"] for r in world]
    assert [x["batches"] for x in u] == [3, 2]
    assert [x["step"] for x in u] == [2, 2]
    assert u[0]["writes"] == [2] and u[1]["writes"] == []
    assert u[0]["logger_open"] and not u[1]["logger_open"]
    assert {"metrics.jsonl", "saved_models"} <= set(u[0]["files"])
    _same(u[0]["digest"], u[1]["digest"])
    for r in world:
        s = r["fit"]["sigterm"]
        assert s["step"] == 2 and s["latest"] == 2, s
        assert s["resumed"] and s["resumed_step"] == 2 and \
            s["resumed_equal"], s
    assert world[0]["fit"]["sigterm"]["writes"] == [2]
    assert world[1]["fit"]["sigterm"]["writes"] == []


def test_training_calvin_on_two_ranks(world):
    """``training_calvin.main`` under an initialized 2-rank gloo group:
    each rank trains on batch_size / 2 rows of the store, both end at the
    same step with the same parameters, and rank 0's run directory holds
    the checkpoint and the resolved config."""
    c = [r["cli"] for r in world]
    assert [(x["size"], x["rank"]) for x in c] == [(2, 0), (2, 1)]
    assert c[0]["step"] == c[1]["step"] == 2
    assert all(rows == 2 for x in c for rows in x["rows"]), c[0]["rows"]
    assert c[0]["ckpt"] == 2 and c[0]["run_dir"] == c[1]["run_dir"]
    assert {".hydra", "metrics.jsonl", "saved_models"} <= set(c[0]["files"])
    _same(c[0]["digest"], c[1]["digest"])
