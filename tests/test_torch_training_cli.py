"""The port's ``training_calvin`` CLI on the CPU (``device=cpu``), on the
synthetic store of ``tests/calvin_fixture.py`` (3 episodes x 30 frames,
24 px) with its actions packed by ``data.preprocess``: the shipped
``conf/config_calvin.yaml`` with a small model (a one-layer DiT 64 wide;
the FiLM-ResNet-50 encoders, the only ones the port has, at 32 px) through
dotted overrides. A fresh run with two loader workers, the shared-memory
cache and the rollout hook on the fake env; an auto-resume that continues
the run; ``start_from_pretrained`` from a synthetic reference state dict,
equal to ``utils/checkpoint_convert``'s output, and skipped on a resume;
the run directory restored by ``evaluate_calvin``; the device rule; and
``chip_smoke.py``'s phase-22 settings against what the builders read from
the shipped config."""
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from calvin_fixture import make_calvin_dataset
from mode_diffusion_policy_tpu_torch import training_calvin
from mode_diffusion_policy_tpu_torch.data import preprocess
from mode_diffusion_policy_tpu_torch.data.shm_cache import SEGMENT_PREFIX
from mode_diffusion_policy_tpu_torch.evaluation import evaluate_calvin as ec
from mode_diffusion_policy_tpu_torch.models.agent import ENCODERS
from mode_diffusion_policy_tpu_torch.utils import checkpoint_convert as conv
from test_torch_evaluate import _reference_state_dict
from torch_threads import two_torch_threads  # noqa: F401

SMALL = ["model.latent_dim=64", "model.model.inner_model.n_layers=1",
         "model.model.inner_model.n_heads=2", "batch_size=2"] + [
    f"datamodule.transforms.{split}.{cam}.0.size=32"
    for split in ("train", "val") for cam in ("rgb_static", "rgb_gripper")]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = make_calvin_dataset(tmp_path_factory.mktemp("calvin_cli"),
                            n_episodes=3, ep_len=30, hw=24)
    for split in ("training", "validation"):
        preprocess.main(["--in-root", str(r / split), "--workers", "2"])
    return r


@pytest.fixture(autouse=True)
def _free_runs(tmp_path):
    """A run directory holds two ~375 MB checkpoints (the full-size
    encoders): remove each test's as it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def argv(root, log_dir, *extra):
    return [f"root_data_dir={root}", f"log_dir={log_dir}", "device=cpu",
            *SMALL, "trainer.limit_val_batches=1", *extra]


def _port_segments():
    return [p for p in pathlib.Path("/dev/shm").glob(
        f"{SEGMENT_PREFIX}calvin{os.getpid()}_*")]


def test_fresh_run_resume_and_evaluate(root, tmp_path):
    first = training_calvin.main(argv(
        root, tmp_path, "trainer.max_epochs=1",
        "trainer.limit_train_batches=2", "num_workers=2",
        "datamodule.use_shm_cache=true", "callbacks.rollout_lh.fake_env=true",
        "callbacks.rollout_lh.num_sequences=1",
        "callbacks.rollout_lh.rollout_freq=1",
        "callbacks.rollout_lh.ep_len=4"))
    run = tmp_path / "mode_calvin"
    assert first.run_dir == run and not first.trainer.resumed
    assert first.start_step == 0 and first.state.step == 2
    assert (run / "saved_models" / "2" / "state.pt").exists()
    # the rollout hook ran (its metric picks the best checkpoint)
    assert (run / "saved_models" / "best" / "2" / "state.pt").exists()
    records = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert np.isfinite(records[0]["train/total_loss"])
    assert "eval_lh/avg_seq_len" in records[-1]
    assert "val_act/lang_act_loss_pp" in records[-1]
    assert not _port_segments()
    # the persisted config is what evaluate_calvin reads back
    saved = ec.find_train_config(run)
    assert saved["model"]["latent_dim"] == 64 and saved["device"] == "cpu"
    assert saved["datamodule"]["use_shm_cache"] is True

    second = training_calvin.main(argv(
        root, tmp_path, "trainer.max_epochs=2",
        "trainer.limit_train_batches=2", "num_workers=0"))
    assert second.trainer.resumed and second.start_step == 2
    assert second.state.step == 4 and second.state.epoch == 2
    assert (run / "saved_models" / "4" / "state.pt").exists()

    # evaluate_calvin restores the run: the shape from .hydra/config.yaml,
    # the weights of the best (epoch 1) checkpoint's EMA
    ev = ec.evaluate(ec.parse_args([
        "--checkpoint", str(run), "--fake-env", "--device", "cpu",
        "--num-sequences", "1", "--ep-len", "4", "--image-size", "32",
        "--log-dir", str(tmp_path / "eval")]))
    assert ev.agent.cfg.latent_dim == 64 and ev.agent.cfg.n_layers == 1
    assert len(ev.results) == 1
    best = torch.load(run / "saved_models" / "best" / "2" / "state.pt",
                      weights_only=False)
    got = dict(ev.agent.named_parameters())
    for n in ("inner_model.out.kernel", "static_resnet.film1_gamma.kernel"):
        torch.testing.assert_close(got[n], best["ema_params"][n].float(),
                                   rtol=0, atol=0)


def test_start_from_pretrained(root, tmp_path):
    """A fresh run loads the converted weights (in the state's dtype) and
    copies them into the EMA; a resumed run keeps its own weights."""
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig)
    shape = MoDEAgent(MoDEAgentConfig(latent_dim=64, n_layers=1, n_heads=2,
                                      cond_dim=512), device="cpu")
    paths = []
    for seed in (0, 1):
        sd = _reference_state_dict(shape, seed=seed)
        paths.append(tmp_path / f"ref{seed}.pt")
        torch.save({"state_dict": sd}, paths[-1])
    common = ("trainer.limit_train_batches=0", "num_workers=0",
              "model.start_from_pretrained=true")
    first = training_calvin.main(argv(root, tmp_path, "trainer.max_epochs=1",
                                      f"model.ckpt_path={paths[0]}", *common))
    state = first.state
    sd = conv.normalize_state_dict(conv.load_torch_checkpoint(str(paths[0])))
    want = {f"inner_model.{k}": v for k, v in conv.convert_modedit(
        sd, 1, 4, "model.inner_model.").items()}
    for enc in ENCODERS:
        want.update({f"{enc}.{k}": v for k, v in conv.convert_film_resnet(
            sd, 50, prefix=f"{enc}.").items()})
    assert state.step == 0
    n_params = 0
    for n, v in want.items():
        dst = state.params[n] if n in state.params else state.batch_stats[n]
        n_params += n in state.params
        assert torch.equal(dst, v.to(dst.dtype)), n
    assert n_params == len(state.params)    # every parameter converted
    for n, p in state.params.items():
        assert torch.equal(state.ema_params[n], p), n

    second = training_calvin.main(argv(root, tmp_path, "trainer.max_epochs=2",
                                       f"model.ckpt_path={paths[1]}", *common))
    assert second.trainer.resumed
    for n, p in second.state.params.items():
        assert torch.equal(p, state.params[n]), n


def test_device_rule(monkeypatch):
    """``tpu`` (the shipped value), ``cuda`` and ``gpu`` need a card and
    never fall back to the CPU; ``cpu`` runs there; anything else raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("tpu", "cuda", "gpu"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            training_calvin.train_device({"device": name})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training_calvin.train_device({})
    assert training_calvin.train_device({"device": "cpu"}).type == "cpu"
    with pytest.raises(ValueError, match="xla"):
        training_calvin.train_device({"device": "xla"})


def test_smoke_train_settings_follow_the_shipped_config():
    """Phase 22's TRAIN_* constants equal the builders' reading of
    ``conf/config_calvin.yaml`` but for the from-scratch router aux
    weights (0.0 in the YAML)."""
    import chip_smoke
    assert chip_smoke.check_train_settings() == {
        "entropy_gamma": (0.01, 0.0), "router_z_delta": (0.001, 0.0)}
