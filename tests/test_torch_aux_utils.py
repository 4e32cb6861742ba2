"""The port's auxiliary modules against the JAX package's, on the CPU:

- ``VLMEmbeddingCache``: padding, masks, encoding the misses only, values
  kept on the cache's device, and the pickle files each package writes read
  by the other (bit for bit);
- export: the port's ``modedit_params_to_torch_layout`` equal to JAX's for
  the same numpy weights (bit for bit), its round trip through
  ``convert_modedit`` (the flagship layout and the options: proprio
  embedding, shared expert, cross-attention), and the CLI on a tiny run
  directory made by the port's ``Trainer`` (EMA and trained weights);
- ``verify_checkpoint``: ``infer_dit_shape``, ``infer_resnet_depth``,
  ``_sub_state_dict`` and ``Report`` against JAX's on synthetic state
  dicts; the rungs that need no reference repo (``check_encoders``,
  ``check_routing``) on a small checkpoint; the CLI refusing a reference
  repo without ``mode/``;
- ``torch_oracles.TorchFiLMResNetPolicy`` bit-equal to JAX's copy (same
  seed: same weights, same features) at depths 18 and 50;
- ``manual_annotate`` and ``auto_annotate`` driven as
  ``tests/test_lang_annotators.py`` drives JAX's, over the port's
  ``DiskDataset`` and fake env, equal to JAX's results and files; and
  ``auto_annotate`` with the port's ``LangClip`` as the encoder.
"""
import io
import contextlib
import pickle

import jax
import numpy as np
import pytest
import torch

from calvin_fixture import make_calvin_dataset
from mode_diffusion_policy_tpu.data import calvin_dataset as jdata
from mode_diffusion_policy_tpu.models.encoders import lang_cache as jcache
from mode_diffusion_policy_tpu.models.modedit import MoDeDiT as JDiT
from mode_diffusion_policy_tpu.models.modedit import \
    MoDeDiTConfig as JDiTCfg
from mode_diffusion_policy_tpu.rollout import env as jenv
from mode_diffusion_policy_tpu.utils import export as jexport
from mode_diffusion_policy_tpu.utils import lang_annotators as jann
from mode_diffusion_policy_tpu.utils import torch_oracles as joracles
from mode_diffusion_policy_tpu.utils import verify_checkpoint as jvck
from mode_diffusion_policy_tpu_torch.data import calvin_dataset as tdata
from mode_diffusion_policy_tpu_torch.models.agent import (MoDEAgent,
                                                          MoDEAgentConfig)
from mode_diffusion_policy_tpu_torch.models.encoders import lang_cache as tcache
from mode_diffusion_policy_tpu_torch.models.encoders.clip_text import \
    LangClip, CLIPTextConfig
from mode_diffusion_policy_tpu_torch.rollout import env as tenv
from mode_diffusion_policy_tpu_torch.training.loop import Trainer
from mode_diffusion_policy_tpu_torch.training_common import (
    DEFAULT_PIPELINES, make_data_iters, make_train_preprocess)
from mode_diffusion_policy_tpu_torch.utils import export as texport
from mode_diffusion_policy_tpu_torch.utils import lang_annotators as tann
from mode_diffusion_policy_tpu_torch.utils import torch_oracles as toracles
from mode_diffusion_policy_tpu_torch.utils import verify_checkpoint as tvck
from mode_diffusion_policy_tpu_torch.utils.checkpoint_convert import (
    convert_modedit, detect_layout, load_torch_checkpoint)
from mode_diffusion_policy_tpu_torch.utils.weights import dit_state_dict
from torch_threads import two_torch_threads  # noqa: F401


# -- VLMEmbeddingCache ---------------------------------------------------------

def _vlm_encoder(calls, make):
    def enc(texts):
        calls.append(list(texts))
        return [make(np.arange(len(t.split()) * 4, dtype=np.float32)
                     .reshape(-1, 4) + len(t)) for t in texts]
    return enc


def test_vlm_cache_pads_masks_and_encodes_misses(tmp_path):
    tcalls, jcalls = [], []
    tc = tcache.VLMEmbeddingCache(_vlm_encoder(tcalls, torch.from_numpy),
                                  max_length=6, device="cpu")
    jc = jcache.VLMEmbeddingCache(_vlm_encoder(jcalls, np.asarray),
                                  max_length=6)
    texts = ["open the drawer", "go", "open the drawer",
             "push the red block to the left side now"]
    temb, tmask = tc(texts)
    jemb, jmask = jc(texts)
    assert temb.shape == (4, 6, 4) and tmask.shape == (4, 6)
    assert temb.device.type == "cpu" and tmask.dtype == torch.float32
    np.testing.assert_array_equal(temb.numpy(), jemb)
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    assert tmask.sum(1).tolist() == [3, 1, 3, 6]        # the long one cut
    # each distinct text encoded once; a second batch encodes its misses
    assert tcalls == jcalls == [["open the drawer", "go",
                                 "push the red block to the left side now"]]
    tc(["go", "close it"])
    assert tcalls[1:] == [["close it"]] and tc.encoder_calls == 2
    # pad_sequences on its own: the longest length without max_len
    p, m = tcache.VLMEmbeddingCache.pad_sequences(
        [torch.ones(2, 3), torch.ones(5, 3)])
    pj, mj = jcache.VLMEmbeddingCache.pad_sequences(
        [np.ones((2, 3), np.float32), np.ones((5, 3), np.float32)])
    np.testing.assert_array_equal(p.numpy(), pj)
    np.testing.assert_array_equal(m.numpy(), mj)


def test_vlm_cache_files_cross_packages(tmp_path):
    refuse = lambda texts: (_ for _ in ()).throw(  # noqa: E731
        RuntimeError("hit expected"))
    tc = tcache.VLMEmbeddingCache(_vlm_encoder([], torch.from_numpy),
                                  max_length=5, device="cpu")
    jc = jcache.VLMEmbeddingCache(_vlm_encoder([], np.asarray), max_length=5)
    texts = ["lift the block", "rotate"]
    tc(texts)
    jc(texts)
    tc.save(tmp_path / "t.pkl")
    jc.save(tmp_path / "j.pkl")
    with open(tmp_path / "t.pkl", "rb") as f:
        assert all(isinstance(v, np.ndarray) for v in pickle.load(f).values())
    t2 = tcache.VLMEmbeddingCache(refuse, max_length=5, device="cpu")
    t2.load(tmp_path / "j.pkl")
    j2 = jcache.VLMEmbeddingCache(refuse, max_length=5)
    j2.load(tmp_path / "t.pkl")
    temb, tmask = t2(texts)
    jemb, jmask = j2(texts)
    np.testing.assert_array_equal(temb.numpy(), jemb)
    np.testing.assert_array_equal(tmask.numpy(), jmask)


# -- export ----------------------------------------------------------------

DIT = dict(obs_dim=32, goal_dim=16, action_dim=7, embed_dim=64, n_layers=2,
           n_heads=4, goal_seq_len=1, obs_seq_len=1, action_seq_len=10)


@pytest.fixture(scope="module")
def jax_dit_params():
    """JAX MoDeDiT params, refilled from a seeded numpy stream."""
    model = JDiT(JDiTCfg(**DIT))
    shapes = jax.eval_shape(lambda k: model.init(
        k, {"state_images": np.zeros((1, 2, 32), np.float32)},
        np.zeros((1, 10, 7), np.float32), np.zeros((1, 1, 16), np.float32),
        np.ones((1,), np.float32)), jax.random.PRNGKey(0))["params"]
    r = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: r.standard_normal(s.shape).astype(np.float32), shapes)


def test_export_layout_matches_jax(jax_dit_params):
    want = jexport.modedit_params_to_torch_layout(jax_dit_params)
    got = texport.modedit_params_to_torch_layout(
        dit_state_dict(jax_dit_params))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _port_dit_sd(**opts):
    agent = MoDEAgent(MoDEAgentConfig(latent_dim=64, n_layers=2, n_heads=4,
                                      cond_dim=16, resnet_type="18", **opts),
                      device="cpu")
    return {k: v.detach().clone() for k, v in
            agent.inner_model.state_dict().items()}


@pytest.mark.parametrize("opts", [{}, {"use_shared_expert": True,
                                       "use_cross_attention": True}],
                         ids=["flagship", "shared_cross"])
def test_export_round_trips_through_convert_modedit(opts):
    sd = _port_dit_sd(**opts)
    flat = texport.modedit_params_to_torch_layout(sd)
    n_layers, n_experts, prefix = detect_layout(flat)
    assert (n_layers, n_experts, prefix) == (
        2, sd["blocks.0.experts_w1"].shape[0], "model.inner_model.")
    back = convert_modedit(flat, n_layers, n_experts, prefix)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


IMG = 16
PIPES = {k: dict(v, size=IMG) for k, v in DEFAULT_PIPELINES.items()}


class _TinyData:
    def train_batches(self, epoch):
        r = np.random.default_rng(epoch)
        for _ in range(3):
            yield {"rgb_static": r.integers(0, 256, (2, 1, 20, 20, 3),
                                            dtype=np.uint8),
                   "rgb_gripper": r.integers(0, 256, (2, 1, 20, 20, 3),
                                             dtype=np.uint8),
                   "actions": (r.standard_normal((2, 10, 7)) * 0.3
                               ).astype(np.float32),
                   "lang_emb": r.standard_normal((2, 1, 16)).astype(
                       np.float32)}

    def val_batches(self):
        return iter(())


def test_export_cli_on_a_trainer_run(tmp_path):
    """A three-step Trainer run (the EMA leaves the weights from the
    third step on), exported by the CLI: the safetensors DiT
    converts back to the run's EMA weights (and, with --no-use-ema, its
    trained weights) bit for bit; config.json and README.md when asked."""
    agent = MoDEAgent(MoDEAgentConfig(latent_dim=64, n_layers=1, n_heads=2,
                                      cond_dim=16, resnet_type="18"),
                      device="cpu")
    run = tmp_path / "run"
    trainer = Trainer(agent, log_dir=str(run), device="cpu", max_epochs=1,
                      preprocess_fn=make_train_preprocess(PIPES),
                      optimizer_kwargs={"learning_rate": 1e-3,
                                        "total_steps": 10})
    train_iter, val_iter = make_data_iters(_TinyData(), PIPES, device="cpu")
    state = trainer.fit(trainer.setup(), train_iter, val_iter)
    assert state.step == 3
    for flag, weights in (([], state.ema_params),
                          (["--no-use-ema"], state.params)):
        out = tmp_path / f"export{len(flag)}"
        texport.main(["--run-dir", str(run), "--out-dir", str(out), *flag])
        sd = load_torch_checkpoint(str(out))
        n_layers, n_experts, prefix = detect_layout(sd)
        back = convert_modedit(sd, n_layers, n_experts, prefix)
        dit = {k[len("inner_model."):]: v for k, v in weights.items()
               if k.startswith("inner_model.")}
        assert sorted(back) == sorted(dit)
        for k, v in dit.items():
            assert torch.equal(back[k], v.float()), k
    assert any(not torch.equal(state.ema_params[k], state.params[k])
               for k in state.params if k.startswith("inner_model."))
    path = texport.save_cleaned_checkpoint(
        {"x": torch.ones(2)}, str(tmp_path / "flat"), config={"a": 1},
        model_card="# card")
    assert torch.equal(load_torch_checkpoint(path)["x"], torch.ones(2))
    assert (tmp_path / "flat" / "config.json").read_text().strip().startswith(
        "{")
    assert (tmp_path / "flat" / "README.md").read_text() == "# card"
    with pytest.raises(FileNotFoundError, match="no port checkpoints"):
        texport.load_run_params(str(tmp_path / "nothing"))


# -- verify_checkpoint ---------------------------------------------------------

def _checkpoint(depth, seed=11):
    """A reference-layout state dict: the exported small DiT and two
    timm-layout FiLM-ResNets of ``depth`` with random statistics."""
    torch.manual_seed(seed)
    sd = dict(texport.modedit_params_to_torch_layout(_port_dit_sd()))
    g = torch.Generator().manual_seed(seed + 1)
    for enc in ("static_resnet", "gripper_resnet"):
        tenc = toracles.TorchFiLMResNetPolicy(16, depth=depth)
        with torch.no_grad():
            for m in tenc.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.5, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
        for k, v in tenc.state_dict().items():
            sd[f"{enc}.{k}"] = v
    return sd


@pytest.mark.parametrize("depth", [18, 34, 50])
def test_verify_shape_helpers_match_jax(depth):
    sd = _checkpoint(depth)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    prefix = "model.inner_model."
    assert tvck.infer_dit_shape(sd, prefix) == jvck.infer_dit_shape(
        np_sd, prefix) == {"embed_dim": 64, "obs_dim": 512, "goal_dim": 16,
                           "action_dim": 7, "n_heads": 4,
                           "action_seq_len": 10}
    assert tvck.infer_resnet_depth(sd) == jvck.infer_resnet_depth(np_sd) \
        == depth
    assert tvck.infer_resnet_depth({}) is jvck.infer_resnet_depth({}) is None
    tsub = tvck._sub_state_dict(sd, "gripper_resnet.")
    jsub = jvck._sub_state_dict(np_sd, "gripper_resnet.")
    assert sorted(tsub) == sorted(jsub)
    for k, v in jsub.items():
        assert torch.equal(tsub[k], v), k


def test_report_matches_jax():
    outs = []
    for mod in (tvck, jvck):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = mod.Report(1e-3)
            a = r.add("dit/forward", 2e-4)
            b = r.add("e2e/x", 5e-3, gate=1e-2, note="n")
            c = r.add("e2e/y", 2e-3)
        outs.append((a, b, c, r.ok, r.to_json(), buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][:4] == (True, True, False, False)


def test_verify_rungs_without_reference(tmp_path):
    """``check_encoders`` and ``check_routing`` on a small checkpoint on
    the CPU: the port's encoders equal the torch ones to f32 rounding, the
    int8 encoders are reported, the fast path equals the dense one; the
    CLI refuses a reference repo without ``mode/``."""
    sd = _checkpoint(34)
    rng = np.random.default_rng(0)
    goal = torch.from_numpy(rng.standard_normal((2, 1, 16)).astype(
        np.float32))
    images = {enc: torch.from_numpy(rng.standard_normal(
        (2, 3, 16, 16)).astype(np.float32) * 0.3)
        for enc in tvck.ENCODERS}
    shape = tvck.infer_dit_shape(sd, "model.inner_model.")
    agent = tvck.build_agent(sd, 2, 4, "model.inner_model.", shape, 34,
                             device="cpu")
    report = tvck.Report(tvck.GATE_DEFAULT)
    feats = tvck.check_encoders(report, sd, 34, goal, images, "cpu",
                                agent=agent)
    rows = {r["module"]: r for r in report.rows}
    assert rows["encoder/static_resnet"]["mae"] < 1e-6
    assert rows["encoder/gripper_resnet"]["mae"] < 1e-6
    assert rows["encoder/static_resnet (int8)"]["gate"] == float("inf")
    assert agent.q8 is not None and report.ok
    emb = {"state_images": torch.stack([feats[e] for e in tvck.ENCODERS], 1)}
    noise = torch.from_numpy(rng.standard_normal((2, 10, 7)).astype(
        np.float32))
    dense = tvck.check_routing(report, agent, emb, goal, noise)
    assert dense.shape == (2, 10, 7) and report.ok
    assert report.rows[-1]["module"] == "e2e/routing_precompute"
    path = tmp_path / "ck.pt"
    torch.save({"state_dict": sd}, path)
    with pytest.raises(FileNotFoundError, match="no mode/ package"):
        tvck.main(["--checkpoint", str(path), "--reference-repo",
                   str(tmp_path), "--device", "cpu"])


# -- torch oracles -------------------------------------------------------------

@pytest.mark.parametrize("depth", [18, 50])
def test_torch_oracle_equals_jax_copy(depth):
    torch.manual_seed(0)
    t = toracles.TorchFiLMResNetPolicy(16, depth=depth).eval()
    torch.manual_seed(0)
    j = joracles.TorchFiLMResNetPolicy(16, depth=depth).eval()
    tsd, jsd = t.state_dict(), j.state_dict()
    assert list(tsd) == list(jsd)
    assert all(torch.equal(tsd[k], jsd[k]) for k in tsd)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    c = torch.randn(2, 1, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(t(x, c), j(x, c))


# -- the language annotators -----------------------------------------------------

def test_manual_annotate_matches_jax(tmp_path):
    root = make_calvin_dataset(tmp_path / "c", n_episodes=2, ep_len=15, hw=8,
                               splits=("training",))
    kw = dict(key="lang", lang_folder="lang_annotations", min_window_size=5,
              max_window_size=5, pad=False)
    results = []
    for pkg, data in (("t", tdata), ("j", jdata)):
        out = tmp_path / pkg
        out.mkdir()
        ds = data.DiskDataset(root / "training", **kw)
        ann = jann if pkg == "j" else tann
        answers = iter(["open the drawer", "push the block", "q"])
        first = ann.manual_annotate(ds, out_dir=str(out), sample_fraction=0.2,
                                    prompt=lambda msg: next(answers))
        answers = iter(["turn on the led", "q"])
        second = ann.manual_annotate(ds, out_dir=str(out),
                                     sample_fraction=0.2,
                                     prompt=lambda msg: next(answers))
        calls = []
        enc = (lambda texts: (calls.append(list(texts)),
                              torch.ones(len(texts), 1, 4))[1]) \
            if pkg == "t" else \
            (lambda texts: (calls.append(list(texts)),
                            np.ones((len(texts), 1, 4), np.float32))[1])
        ann.manual_annotate(ds, out_dir=str(out), sample_fraction=0.2,
                            prompt=lambda msg: "q", lang_encoder=enc)
        saved = np.load(out / "lang_ann.npy", allow_pickle=True).item()
        emb = np.load(out / "lang_emb_ann.npy", allow_pickle=True).item()
        results.append((first, second, calls, saved, emb))
    t, j = results
    assert t[0] == j[0] and t[1] == j[1] and t[2] == j[2] and t[3] == j[3]
    assert t[0]["language"] == [["open the drawer"], ["push the block"]]
    assert len(t[1]["language"]) >= 3
    assert isinstance(t[4]["language"], np.ndarray)
    np.testing.assert_array_equal(t[4]["language"], j[4]["language"])
    assert t[4]["indx"] == j[4]["indx"]


class DrawerOracle:
    def get_task_info_for_set(self, start, cur, task_set):
        out = set()
        if cur["scene_obs"][1] > start["scene_obs"][1] + 0.1:
            out.add("open_drawer")
        if cur["scene_obs"][5] > start["scene_obs"][5]:
            out.add("turn_on_led")
        return out & task_set


ANNOTATIONS = {"open_drawer": ["open the drawer", "pull the drawer open"],
               "turn_on_led": ["turn on the led"]}


def _sequences():
    def seq(delta_idx, delta):
        robot = np.zeros((5, 15))
        scene = np.zeros((5, 24))
        scene[-1, delta_idx] = delta
        return {"state_info": {"robot_obs": robot, "scene_obs": scene},
                "indx": (0, 5)}
    return [seq(1, 0.22), seq(5, 1.0), seq(3, 0.01), seq(1, 0.22),
            seq(1, 0.3), seq(5, 2.0)]


def test_auto_annotate_matches_jax(tmp_path):
    outs = []
    for pkg, env_mod, ann in (("t", tenv, tann), ("j", jenv, jann)):
        env = env_mod.CalvinEnvWrapper(env_mod.FakeCalvinEnv(hw=8),
                                       (tdata if pkg == "t" else jdata)
                                       .DEFAULT_OBS_SPACE,
                                       (tdata if pkg == "t" else jdata)
                                       .DEFAULT_PROPRIO)
        enc = (lambda t: torch.arange(len(t) * 4.0).reshape(-1, 1, 4)) \
            if pkg == "t" else \
            (lambda t: np.arange(len(t) * 4.0,
                                 dtype=np.float32).reshape(-1, 1, 4))
        out = ann.auto_annotate(_sequences(), env, DrawerOracle(),
                                ANNOTATIONS, lang_encoder=enc,
                                out_dir=str(tmp_path / pkg),
                                rng=np.random.default_rng(3))
        saved = np.load(tmp_path / pkg / "auto_lang_ann.npy",
                        allow_pickle=True).item()
        outs.append((out, saved))
    (t, tsaved), (j, jsaved) = outs
    assert t["language"]["task"] == j["language"]["task"] == [
        "open_drawer", "turn_on_led", "open_drawer", "open_drawer",
        "turn_on_led"]
    assert t["language"]["ann"] == j["language"]["ann"]
    assert t["info"] == j["info"] == tsaved["info"]
    np.testing.assert_array_equal(t["language"]["emb"], j["language"]["emb"])
    np.testing.assert_array_equal(tsaved["language"]["emb"],
                                  jsaved["language"]["emb"])


def test_auto_annotate_with_langclip(tmp_path):
    """The port's (random-weight, small) LangClip as the encoder: one
    embedding per labelled window, the tower's own output on the host."""
    lang = LangClip.initialize_random(0, CLIPTextConfig(
        vocab_size=49408, context_length=77, width=64, heads=1, layers=1,
        embed_dim=32), device="cpu")
    env = tenv.CalvinEnvWrapper(tenv.FakeCalvinEnv(hw=8),
                                tdata.DEFAULT_OBS_SPACE,
                                tdata.DEFAULT_PROPRIO)
    out = tann.auto_annotate(_sequences(), env, DrawerOracle(), ANNOTATIONS,
                             lang_encoder=lang, out_dir=str(tmp_path))
    emb = out["language"]["emb"]
    assert isinstance(emb, np.ndarray) and emb.shape == (5, 1, 32)
    np.testing.assert_array_equal(emb, lang(out["language"]["ann"]).numpy())
