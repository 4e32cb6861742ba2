"""The port's evaluation slice against the JAX package's: the chunked
stepper's host actions, the reference-checkpoint converters, the
long-horizon evaluation of both packages' agents on the same weights (each
with its own CLIP tower and cache) over the fake env, the CLI end to end on
the CPU, the restore of the port's own checkpoints, the agent proxy over
localhost and the Trainer's rollout hook.

Sizes are the JAX tests' small ones (a 2-layer DiT at D=256, ResNet-50 at
32 px, a 2-layer CLIP tower 64 wide). The sampler noise of both evaluators
comes from one numpy stream, handed to each policy's chunk by a test-side
wrapper around ``step``. Gates: under ``reference`` every action within
2e-5 of JAX's and equal results; under ``parity`` the action MAE within
max(1e-3, 2 x floor), the rule ``tests/test_torch_slice.py`` holds the
int8 presets to: over a closed loop of many chunks the int8 roundings
move with the order of the f32 sums (the CPU thread count), which the
floor measures."""
import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent
from mode_diffusion_policy_tpu.models.agent import MoDEAgentConfig as JCfg
from mode_diffusion_policy_tpu.models.agent import \
    RolloutPolicy as JRolloutPolicy
from mode_diffusion_policy_tpu.models.edm import samplers as jsamplers
from mode_diffusion_policy_tpu.models.encoders import clip_text as jclip
from mode_diffusion_policy_tpu.models.encoders.lang_cache import \
    LangEmbeddingCache as JCache
from mode_diffusion_policy_tpu.ops.image import preprocess_camera as jpre
from mode_diffusion_policy_tpu.rollout import env as jenv
from mode_diffusion_policy_tpu.rollout import rollout_long_horizon as jlh
from mode_diffusion_policy_tpu.serving import apply_serving_mode as japply
from mode_diffusion_policy_tpu.utils import checkpoint_convert as jconv
from mode_diffusion_policy_tpu_torch.data.calvin_dataset import (
    DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
from mode_diffusion_policy_tpu_torch.evaluation import agent_proxy
from mode_diffusion_policy_tpu_torch.evaluation import evaluate_calvin as ec
from mode_diffusion_policy_tpu_torch.models.agent import (
    ENCODERS, MoDEAgent, MoDEAgentConfig, RolloutPolicy)
from mode_diffusion_policy_tpu_torch.models.encoders import clip_text as tclip
from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import \
    LangEmbeddingCache
from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import \
    fused_layer_q8c_ref
from mode_diffusion_policy_tpu_torch.rollout import env as tenv
from mode_diffusion_policy_tpu_torch.rollout import rollout_long_horizon as tlh
from mode_diffusion_policy_tpu_torch.serving import apply_serving_mode
from mode_diffusion_policy_tpu_torch.training.loop import CheckpointManager
from mode_diffusion_policy_tpu_torch.training.optim import make_optimizer
from mode_diffusion_policy_tpu_torch.training.state import TrainState
from mode_diffusion_policy_tpu_torch.training_common import \
    build_calvin_rollout_callback
from mode_diffusion_policy_tpu_torch.utils import checkpoint_convert as tconv
from mode_diffusion_policy_tpu_torch.utils.weights import (
    dit_state_dict, from_jax_clip_text, from_jax_params, resnet_state_dict)
from test_torch_slice import _random_variables
from torch_threads import two_torch_threads  # noqa: F401

DIMS = dict(latent_dim=256, n_layers=2, n_heads=2, cond_dim=32,
            num_experts=4, top_k=2)
IMG = 32
CLIP = dict(width=64, heads=4, layers=2, embed_dim=32)
SOLVABLE = {"open_drawer", "close_drawer", "move_slider_left",
            "move_slider_right", "turn_on_led", "turn_off_led",
            "turn_on_lightbulb", "turn_off_lightbulb"}
CAMS = ("rgb_static", "rgb_gripper")


@pytest.fixture(scope="module")
def weights():
    jagent = JAgent(JCfg(resnet_type="50", **DIMS))
    v = _random_variables(jagent)
    jlang = jclip.LangClip.initialize_random(jax.random.PRNGKey(3),
                                             jclip.CLIPTextConfig(**CLIP))
    return jagent, v, jlang


def _port_agent(v, device="cpu"):
    return from_jax_params(jax.tree.map(np.asarray, v), MoDEAgentConfig(**DIMS),
                           device=device)


def _port_lang(jlang):
    return tclip.LangClip.from_state_dict(
        from_jax_clip_text(jax.tree.map(np.asarray, jlang.params)),
        tclip.CLIPTextConfig(**CLIP), device="cpu")


# ---------------------------------------------------------------------------
# the chunked stepper
# ---------------------------------------------------------------------------

class _DeviceChunk:
    """Stands in for a chunk on the card: counts its copies to the host."""

    def __init__(self, chunk):
        self.chunk, self.copies = chunk, 0

    def cpu(self):
        self.copies += 1
        return torch.from_numpy(self.chunk.copy())


def test_step_returns_host_arrays_like_jax(weights):
    """Same chunk, same steps: the port's and JAX's ``step`` return numpy
    arrays of the same shape, dtype and values; the port copies each chunk
    to the host once, and the steps of a chunk are views of that copy."""
    jagent, v, _ = weights
    chunks = [np.random.default_rng(i).standard_normal((2, 10, 7)).astype(
        np.float32) for i in range(2)]
    jp = JRolloutPolicy(jagent, v, None)
    jchunks = iter(chunks)
    jp._policy = lambda *a: jnp.asarray(next(jchunks))
    tp = RolloutPolicy(_port_agent(v))
    made = []

    def predict_chunk(obs, goal, noise=None):
        made.append(_DeviceChunk(chunks[len(made)]))
        return made[-1]

    tp.predict_chunk = predict_chunk
    obs = {k: np.zeros((2, 1, IMG, IMG, 3), np.float32) for k in CAMS}
    goal = {"lang_emb": np.zeros((2, 1, 32), np.float32)}
    got, want = [], []
    for _ in range(20):
        got.append(tp.step(obs, goal))
        want.append(jp.step(obs, goal))
    for g, w in zip(got, want):
        assert type(g) is type(w) is np.ndarray
        assert g.shape == w.shape == (2, 7) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert [c.copies for c in made] == [1, 1]
    assert all(g.base is got[0].base for g in got[1:10])
    assert got[10].base is not got[0].base


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

def _reference_state_dict(agent, seed=0, prefix="model.inner_model."):
    """A synthetic reference-layout state dict (the keys JAX's converter
    reads) with random values, shaped for ``agent``."""
    r = np.random.default_rng(seed)
    sd = {}

    def put(key, *shape):
        sd[key] = torch.from_numpy(
            r.standard_normal(shape).astype(np.float32) * 0.1)

    dit = agent.inner_model.state_dict()
    p = prefix
    for name in ("sigma_emb", "sigma_linear", "tok_emb", "goal_emb",
                 "action_emb", "out"):
        put(f"{p}{name}.weight", *dit[f"{name}.kernel"].shape[::-1])
        if f"{name}.bias" in dit:
            put(f"{p}{name}.bias", *dit[f"{name}.bias"].shape)
    put(f"{p}pos_emb", *dit["pos_emb"].shape)
    put(f"{p}ln.g", *dit["ln.g"].shape)
    D = agent.cfg.latent_dim
    for i in range(agent.cfg.n_layers):
        b = f"{p}blocks.{i}."
        for n in ("ln_1.g", "ln_2.g", "attn.q_norm.g", "attn.k_norm.g"):
            put(b + n, *dit[f"blocks.{i}.{n}"].shape)
        for n in ("query", "key", "value"):
            put(b + f"attn.{n}.weight", D, D)
            put(b + f"attn.{n}.bias", D)
        put(b + "attn.c_proj.weight", D, D)
        fc1 = dit[f"blocks.{i}.router.mlp.fc1.kernel"].shape
        fc2 = dit[f"blocks.{i}.router.mlp.fc2.kernel"].shape
        put(b + "router.router.mlp.0.weight", *fc1[::-1])
        put(b + "router.router.mlp.0.bias", fc1[1])
        put(b + "router.router.mlp.3.weight", *fc2[::-1])
        put(b + "router.router.mlp.3.bias", fc2[1])
        _, d_in, h2 = dit[f"blocks.{i}.experts_w1"].shape
        _, h, d_out = dit[f"blocks.{i}.experts_w2"].shape
        for e in range(agent.cfg.num_experts):
            put(b + f"experts.expert_{e}.mlp.0.project.weight", h2, d_in)
            put(b + f"experts.expert_{e}.mlp.0.project.bias", h2)
            put(b + f"experts.expert_{e}.mlp.2.weight", d_out, h)
    for enc in ENCODERS:
        for k, t in getattr(agent, enc).state_dict().items():
            if k.startswith("film"):
                stage, leaf = k.split(".")
                s, part = stage[len("film"):].split("_")
                ref = f"{enc}.film{s}.{part}."
                if leaf == "kernel":
                    put(ref + "weight", *t.shape[::-1])
                else:
                    put(ref + "bias", *t.shape)
                continue
            k = k[len("resnet."):]
            for a, b in (("downsample_conv", "downsample.0"),
                         ("downsample_bn", "downsample.1")):
                k = k.replace(a, b)
            k = k.replace("_", ".", 1) if k.startswith("layer") else k
            for a, b in ((".scale", ".weight"), (".mean", ".running_mean"),
                         (".var", ".running_var")):
                if k.endswith(a):
                    k = k[: -len(a)] + b
            put(f"{enc}.resnet.{k}", *t.shape)
            if k.endswith("running_var"):
                sd[f"{enc}.resnet.{k}"] = sd[f"{enc}.resnet.{k}"].abs() + 0.5
    return sd


@pytest.fixture(scope="module")
def ref_sd(weights):
    return _reference_state_dict(_port_agent(weights[1]))


def test_converters_match_jax(ref_sd):
    """convert_modedit and convert_film_resnet on a reference-layout state
    dict give the port's modules the same tensors as JAX's converters
    followed by from_jax_params' mappings, bit for bit."""
    sd = dict(ref_sd)
    sd["clip_model.visual.proj"] = torch.zeros(2)
    got_n, want_n = tconv.normalize_state_dict(sd), jconv.normalize_state_dict(sd)
    assert set(got_n) == set(want_n) and "clip_model.visual.proj" not in got_n
    assert tconv.detect_layout(got_n) == jconv.detect_layout(want_n) == (
        DIMS["n_layers"], DIMS["num_experts"], "model.inner_model.")
    L, E, prefix = tconv.detect_layout(got_n)
    got = tconv.convert_modedit(got_n, L, E, prefix)
    want = dit_state_dict(jconv.convert_modedit(want_n, L, E, prefix))
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    for enc in ENCODERS:
        got = tconv.convert_film_resnet(got_n, 50, prefix=f"{enc}.")
        conv = jconv.convert_film_resnet(want_n, 50, prefix=f"{enc}.")
        want = resnet_state_dict(conv["params"], conv["batch_stats"])
        assert set(got) == set(want)
        for k in got:
            assert torch.equal(got[k], want[k]), k


def test_checkpoint_files_and_unported_options(ref_sd, tmp_path):
    """A Lightning ``.ckpt`` with EMA callback state, a raw ``.pt``, and a
    safetensors directory load as JAX's loaders load them; the published
    key remaps apply; the proprio embedding converts as JAX's, and an
    option's incomplete keys raise in both converters."""
    sd = {k: v for k, v in list(ref_sd.items())[:40]}
    sd["img_encoder_image_wrist.x.running_mean"] = torch.ones(3)
    ema = [v + 1 for k, v in sd.items()
           if not k.endswith(tconv._BUFFER_SUFFIXES)]
    ckpt = {"state_dict": sd, "callbacks": {"EMA": {"ema_weights": ema}}}
    torch.save(ckpt, tmp_path / "run.ckpt")
    for use_ema in (True, False):
        got = tconv.load_lightning_checkpoint(str(tmp_path / "run.ckpt"),
                                              use_ema)
        want = jconv.load_lightning_checkpoint(str(tmp_path / "run.ckpt"),
                                               use_ema)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    got = tconv.normalize_state_dict(tconv.extract_ema_state_dict(ckpt))
    want = jconv.normalize_state_dict(jconv.extract_ema_state_dict(ckpt))
    assert set(got) == set(want) and "gripper_resnet.x.running_mean" in got
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    torch.save(sd, tmp_path / "raw.pt")
    from safetensors.torch import save_file
    (tmp_path / "hf").mkdir()
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(tmp_path / "hf" / "model_cleaned.safetensors"))
    for path in (tmp_path / "raw.pt", tmp_path / "hf",
                 tmp_path / "hf" / "model_cleaned.safetensors"):
        got = tconv.load_torch_checkpoint(str(path))
        want = jconv.load_torch_checkpoint(str(path))
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(FileNotFoundError):
        tconv.load_torch_checkpoint(str(tmp_path))
    # the options the port used to refuse convert as JAX's converter does
    # (whole option sets: tests/test_torch_variants.py); an option whose
    # keys are incomplete raises KeyError in both converters
    b = "model.inner_model.blocks.0."
    for extra in (b + "cross_att.query.weight",
                  b + "shared_mlp.mlp.0.project.weight"):
        for conv in (tconv.convert_modedit, jconv.convert_modedit):
            with pytest.raises(KeyError):
                conv({**ref_sd, extra: torch.zeros(1)}, 1, 4)
    D = ref_sd["model.inner_model.sigma_linear.weight"].shape[0]
    proprio = {**ref_sd, "model.inner_model.state_embed.weight":
               torch.randn(D, 8, generator=torch.Generator().manual_seed(0))}
    got = tconv.convert_modedit(proprio, 1, 4)
    want = dit_state_dict(jconv.convert_modedit(proprio, 1, 4))
    assert torch.equal(got["state_embed.kernel"], want["state_embed.kernel"])
    for conv in (tconv.convert_film_resnet, jconv.convert_film_resnet):
        with pytest.raises(KeyError):
            conv(ref_sd, 18, style="scratch")


# ---------------------------------------------------------------------------
# the slice as a whole: both evaluators on the fake env
# ---------------------------------------------------------------------------

class JaxNoisePolicy:
    """The JAX agent's chunked stepper (``RolloutPolicy.step``'s contract:
    one host action per call, a new chunk every ``multistep`` calls) with
    the chunk's initial noise taken from ``noise_rng``: preprocessing, the
    serving preset's encoders and denoiser, DDIM, as ``_jax_chunk`` of
    tests/test_torch_slice.py runs them, jitted."""

    def __init__(self, agent, v, lang, mode, noise_rng, log):
        agent, v = japply(agent, v, mode)
        self.v = agent.precast_for_serving(v)
        self.lang, self.rng, self.log = lang, noise_rng, log
        self.multistep = agent.cfg.multistep
        self._counter, self._chunk = 0, None

        def chunk(v, u8s, u8g, lang_emb, noise):
            rgb_s = jpre(None, u8s, size=IMG)
            rgb_g = jpre(None, u8g, size=IMG)
            emb, _ = agent.embed_visual_obs(v, rgb_s, rgb_g, lang_emb)
            routing = agent.precompute_routing(v, agent.sigmas[:-1])
            den = agent.make_denoiser(v, emb, lang_emb, routing,
                                      sigmas=agent.sigmas)
            return jsamplers.sample_loop(
                "ddim", den, noise * agent.cfg.sigma_max, agent.sigmas,
                jax.random.PRNGKey(0))

        self._fn = jax.jit(chunk)

    def reset(self):
        self._counter, self._chunk = 0, None

    def step(self, obs, goal):
        if self._counter % self.multistep == 0:
            noise = self.rng.standard_normal((1, 10, 7)).astype(np.float32)
            self._chunk = np.asarray(self._fn(
                self.v, obs["rgb_obs"]["rgb_static"],
                obs["rgb_obs"]["rgb_gripper"],
                jnp.asarray(self.lang([goal["lang_text"]])), noise))
            self._counter = 0
        action = self._chunk[:, self._counter]
        self._counter = (self._counter + 1) % self.multistep
        self.log.append(action)
        return action


class PortNoisePolicy:
    """``evaluate_calvin.PreprocPolicy`` with each chunk's initial noise
    from ``noise_rng``."""

    def __init__(self, policy, noise_rng, log):
        self.policy, self.rng, self.log = policy, noise_rng, log

    def reset(self):
        self.policy.reset()

    def step(self, obs, goal):
        noise = None
        if self.policy._counter % self.policy.multistep == 0:
            noise = torch.from_numpy(self.rng.standard_normal(
                (1, 10, 7)).astype(np.float32))
        action = self.policy.step(obs, goal, noise)
        self.log.append(action)
        return action


def _evaluate(mod_env, mod_lh, policy, ann):
    raw = mod_env.FakeCalvinEnv(hw=IMG, solvable_tasks=set(SOLVABLE),
                                steps_to_success=3, seed=0)
    env = mod_env.CalvinEnvWrapper(raw, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
    ev = mod_lh.LongHorizonEvaluator(env, raw.make_oracle(), ann,
                                     num_sequences=2, ep_len=12)
    results = ev.evaluate_policy(policy)
    return results, ev.metrics(results)


@pytest.mark.parametrize("mode", ["reference", "parity"])
def test_long_horizon_evaluation_matches_jax(weights, mode):
    jagent, v, jlang = weights
    ann = ec.load_val_annotations()
    jlog, tlog = [], []
    jres = _evaluate(jenv, jlh, JaxNoisePolicy(
        jagent, v, JCache(jlang), mode, np.random.default_rng(11), jlog), ann)
    agent = apply_serving_mode(_port_agent(v), mode)
    cache = LangEmbeddingCache(_port_lang(jlang))
    policy = ec.PreprocPolicy(agent, cache, sizes={c: IMG for c in CAMS})
    tres = _evaluate(tenv, tlh, PortNoisePolicy(
        policy, np.random.default_rng(11), tlog), ann)
    assert tres == jres
    assert 0 < jres[1]["eval_lh/sr_chain_1"]
    assert len(tlog) == len(jlog) > 20
    got, want = np.concatenate(tlog), np.concatenate(jlog)
    assert np.isfinite(got).all() and np.abs(want).mean() > 1e-2
    if mode == "reference":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        # the rule tests/test_torch_slice.py applies to the int8 presets:
        # max(1e-3, 2 x the distance between the port's plain evaluation
        # and one with f64 products), here over the whole loop. The
        # closed loop's int8 roundings move with the order of the f32
        # sums (the CPU thread count), which the floor measures
        flog = []
        policy = ec.PreprocPolicy(agent, LangEmbeddingCache(_port_lang(jlang)),
                                  sizes={c: IMG for c in CAMS})
        policy.agent.inner_model.layer_impl = functools.partial(
            fused_layer_q8c_ref, acc_dtype=torch.float64)
        _evaluate(tenv, tlh, PortNoisePolicy(
            policy, np.random.default_rng(11), flog), ann)
        floor = np.abs(got - np.concatenate(flog)).mean()
        assert np.abs(got - want).mean() <= max(1e-3, 2.0 * floor)
    # one tower call per distinct instruction
    assert cache.encoder_calls == cache.encoded_texts == len(cache)


def test_cli_main_on_the_cpu(tmp_path):
    argv = ["--fake-env", "--num-sequences", "2", "--ep-len", "4",
            "--latent-dim", "256", "--n-layers", "1", "--image-size", "32",
            "--fake-steps-to-success", "2", "--sampler-unroll", "10",
            "--log-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ec.main(argv)                   # CUDA by default, and none here
    ranking = ec.main(argv + ["--device", "cpu"])
    saved = json.loads((tmp_path / "results.json").read_text())
    assert saved["0"]["avg_seq_len"] == ranking["avg_seq_len"] == 5.0
    assert sum(t["total"] for t in saved["0"]["task_info"].values()) == 10


# ---------------------------------------------------------------------------
# the port's own checkpoints
# ---------------------------------------------------------------------------

SMALL = dict(latent_dim=128, n_layers=1)


def _args(checkpoint, **over):
    ns = SimpleNamespace(checkpoint=str(checkpoint), bf16=False,
                         image_size=32, no_ema=False, serving_mode="reference",
                         clip_checkpoint=None, device="cpu")
    for k in ec.MODEL_ARG_DEFAULTS:
        setattr(ns, k, None)
    for k, val in {**SMALL, **over}.items():
        setattr(ns, k, val)
    return ns


def _saved_run(tmp_path, bf16):
    cfg = MoDEAgentConfig(**{**ec.MODEL_ARG_DEFAULTS, **SMALL})
    agent = MoDEAgent(cfg, device="cpu")
    opt, _ = make_optimizer(dict(agent.named_parameters()),
                            stochastic_round=bf16)
    kw = dict(param_dtype=torch.bfloat16, ema_dtype=torch.bfloat16) \
        if bf16 else {}
    state = TrainState.create(agent, opt, torch.Generator().manual_seed(0),
                              **kw)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for coll in (state.params, state.ema_params, state.batch_stats):
            for t in coll.values():
                t.add_(torch.randn(t.shape, generator=gen).to(t.dtype))
    run = tmp_path / ("bf16" if bf16 else "f32")
    state.step = 3
    # the newest state and the best one (a hard link to the same file)
    CheckpointManager(str(run / "saved_models")).save(
        3, state, {"eval_lh/avg_seq_len": 2.0})
    want = {}
    for use_ema in (True, False):
        w = state.ema_params if use_ema else state.params
        want[use_ema] = {n: t.float().clone() for n, t in
                         {**w, **state.batch_stats}.items()}
    return run, want


@pytest.mark.parametrize("bf16", [False, True])
def test_restore_port_checkpoints_bit_for_bit(tmp_path, bf16):
    """A run directory (the best state), a step directory and the best
    step directory, with and without EMA, in an f32 and a bf16 state: the
    agent holds exactly the saved weights and running statistics."""
    run, want = _saved_run(tmp_path, bf16)
    for ckpt, use_ema in ((run, True), (run, False),
                          (run / "saved_models" / "3", True),
                          (run / "saved_models" / "best" / "3", False)):
        agent = ec.build_agent(_args(ckpt, no_ema=not use_ema))
        sd = agent.state_dict()
        assert set(want[use_ema]) <= set(sd)
        for n, t in want[use_ema].items():
            assert torch.equal(sd[n], t), (ckpt, use_ema, n)
    with pytest.raises(FileNotFoundError):
        ec.build_agent(_args(tmp_path / "nowhere"))


def test_build_agent_converts_a_reference_checkpoint(ref_sd, tmp_path):
    """A published-layout directory (``model_cleaned.safetensors`` and the
    run's ``config.yaml``): the model's shape comes from the config, the
    weights through the converters, equal to JAX's conversion."""
    import yaml
    from safetensors.torch import save_file
    save_file({k: v.contiguous() for k, v in ref_sd.items()},
              str(tmp_path / "model_cleaned.safetensors"))
    (tmp_path / "config.yaml").write_text(yaml.safe_dump({"model": {
        "latent_dim": DIMS["latent_dim"], "cond_dim": DIMS["cond_dim"],
        "model": {"inner_model": {"n_layers": DIMS["n_layers"],
                                  "n_heads": DIMS["n_heads"]}}}}))
    agent = ec.build_agent(_args(tmp_path, latent_dim=None, n_layers=None))
    assert (agent.cfg.cond_dim, agent.cfg.n_heads) == (32, 2)
    jsd = jconv.normalize_state_dict(ref_sd)
    want = dit_state_dict(jconv.convert_modedit(jsd, 2, 4))
    for k, t in want.items():
        assert torch.equal(agent.inner_model.state_dict()[k], t), k
    conv = jconv.convert_film_resnet(jsd, 50, prefix="gripper_resnet.")
    want = resnet_state_dict(conv["params"], conv["batch_stats"])
    for k, t in want.items():
        assert torch.equal(agent.gripper_resnet.state_dict()[k], t), k


# ---------------------------------------------------------------------------
# the agent proxy
# ---------------------------------------------------------------------------

def _raw_obs(rng):
    return {"rgb_obs": {
        "rgb_static": rng.integers(0, 256, (200, 200, 3), dtype=np.uint8),
        "rgb_gripper": rng.integers(0, 256, (84, 84, 3), dtype=np.uint8)},
        "robot_obs": rng.standard_normal(15)}


def test_agent_proxy_round_trip_equals_in_process(weights):
    """__init__, 12 steps over two instructions, a request that raises on
    the server (the agent is dropped), a fresh __init__, 3 more steps,
    __shutdown__: every action equal to an in-process CalvinAgentWrapper's
    with the same seed, bit for bit."""
    _, v, jlang = weights
    agent = apply_serving_mode(_port_agent(v), "parity")
    lang = _port_lang(jlang)

    def create_agent():
        policy = ec.PreprocPolicy(agent, LangEmbeddingCache(lang),
                                  sizes={c: IMG for c in CAMS})
        return agent_proxy.CalvinAgentWrapper(policy, DEFAULT_OBS_SPACE,
                                              DEFAULT_PROPRIO, IMG)

    server = agent_proxy.start_server(create_agent, "127.0.0.1", 0,
                                      background=True)
    try:
        client = agent_proxy.AgentProxyClient(
            f"http://127.0.0.1:{server.server_address[1]}")
        with pytest.raises(RuntimeError, match="not initialized"):
            client.step(_raw_obs(np.random.default_rng(0)), "open")
        assert client.init() == "agent created"
        rng = np.random.default_rng(0)
        local = create_agent()
        texts = ("open the drawer", "push the sliding door to the left")
        for i in range(12):
            obs = _raw_obs(rng)
            got = client.step(obs, texts[i // 6])
            want = local.step(obs, texts[i // 6])
            assert got.dtype == np.float64 and got.shape == (7,)
            np.testing.assert_array_equal(got, want)
            assert got[-1] in (-1.0, 1.0)
        with pytest.raises(RuntimeError, match="AttributeError"):
            client._call("no_such_method")
        with pytest.raises(RuntimeError, match="not initialized"):
            client.reset()
        client.init()
        local = create_agent()
        for _ in range(3):
            obs = _raw_obs(rng)
            np.testing.assert_array_equal(client.step(obs, texts[0]),
                                          local.step(obs, texts[0]))
        assert client.shutdown() == "shutdown"
    finally:
        server.shutdown()
        server.server_close()


def test_proxy_wrapper_transforms_match_jax():
    """The wrapper's observation slicing and action de-normalization (the
    gripper binarized; absolute actions split 3/3/1 or 3/4/1) equal JAX's
    CalvinAgentWrapper's."""
    from mode_diffusion_policy_tpu.evaluation.agent_proxy import \
        CalvinAgentWrapper as JWrapper
    tw = agent_proxy.CalvinAgentWrapper(None, DEFAULT_OBS_SPACE,
                                        DEFAULT_PROPRIO, IMG)
    jw = JWrapper(None, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO, IMG)
    rng = np.random.default_rng(2)
    for rel in (True, False):
        tw.relative_actions = jw.relative_actions = rel
        for dim in ((7,) if rel else (7, 8)):
            for sign in (1.0, -1.0):
                a = rng.standard_normal((1, dim)).astype(np.float32)
                a[0, -1] = sign * abs(a[0, -1])
                got, want = tw._transform_action(a), jw._transform_action(a)
                for g, w in zip(np.atleast_1d(got) if rel else got,
                                np.atleast_1d(want) if rel else want):
                    np.testing.assert_array_equal(g, w)
    obs = _raw_obs(rng)
    got = tw._transform_observation(obs)
    np.testing.assert_array_equal(got["robot_obs"],
                                  jw._transform_observation(obs)["robot_obs"])
    for cam in CAMS:
        assert got["rgb_obs"][cam].shape[:2] == (1, 1)
        assert got["rgb_obs"][cam].dtype == np.uint8


# ---------------------------------------------------------------------------
# the Trainer's rollout hook
# ---------------------------------------------------------------------------

def _stub_action(obs, t):
    x = obs["rgb_obs"]["rgb_static"].mean() / 255.0 + 0.1 * t
    return np.sin(x * np.arange(1, 8))[None].astype(np.float32)


def test_rollout_callback_matches_jax(monkeypatch):
    """With the same stub policy on both sides, the port's hook returns
    JAX's eval_lh metrics; without the fake env or calvin_env, None."""
    import mode_diffusion_policy_tpu.models.agent as jagent_mod
    from mode_diffusion_policy_tpu.training_common import \
        build_calvin_rollout_callback as jbuild

    class JStub:
        def __init__(self, agent, variables, lang):
            self._counter, self.multistep, self.t = 0, 10, 0

        def reset(self):
            self.t = 0

        def step(self, obs, goal):
            self.t += 1
            return _stub_action(obs, self.t)

    class TStub:
        def __init__(self, agent, lang, *, sizes):
            assert sizes == {c: 16 for c in CAMS}
            self.t = 0

        reset = JStub.reset
        step = JStub.step

    monkeypatch.setattr(jagent_mod, "RolloutPolicy", JStub)
    monkeypatch.setattr(ec, "PreprocPolicy", TStub)
    cfg = {"fake_env": True, "fake_hw": 24, "fake_steps_to_success": 6,
           "num_sequences": 3, "ep_len": 8}
    pipes = {c: {"size": 16, "pad": 2} for c in CAMS}
    agent = MoDEAgent(MoDEAgentConfig(**SMALL, n_heads=2, cond_dim=16),
                      device="cpu")
    variables = {"params": dict(agent.named_parameters()),
                 "batch_stats": {n: b for n, b in agent.named_buffers()}}
    got = build_calvin_rollout_callback(cfg, None, pipes)(agent, variables, 0)
    want = jbuild(cfg, None, pipes)(None, None, 0)
    assert got == want
    assert set(got) == {"eval_lh/avg_seq_len"} | {
        f"eval_lh/sr_chain_{i}" for i in range(1, 6)}
    assert build_calvin_rollout_callback({"dataset_path": None}, None,
                                         pipes) is None


def test_rollout_callback_serves_the_ema_weights(monkeypatch):
    """The port's hook on a real tiny agent: the policy serves an f32 copy
    of the given EMA weights and statistics, and the training agent keeps
    its own."""
    cfg = MoDEAgentConfig(**SMALL, n_heads=2, cond_dim=16)
    agent = MoDEAgent(cfg, device="cpu")
    opt, _ = make_optimizer(dict(agent.named_parameters()))
    state = TrainState.create(agent, opt, torch.Generator().manual_seed(0),
                              ema_dtype=torch.bfloat16)
    with torch.no_grad():
        for t in state.ema_params.values():
            t.add_(0.25)
    before = {n: t.clone() for n, t in agent.state_dict().items()}
    made = []

    class Recording(ec.PreprocPolicy):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(ec, "PreprocPolicy", Recording)

    def lang(texts):
        return np.zeros((len(texts), 1, 16), np.float32)

    cb = build_calvin_rollout_callback(
        {"fake_env": True, "fake_hw": 24, "fake_steps_to_success": 1,
         "num_sequences": 2, "ep_len": 4},
        LangEmbeddingCache(lang), {c: {"size": 16, "pad": 2} for c in CAMS})
    metrics = cb(agent, state.eval_variables(), 0)
    assert metrics["eval_lh/avg_seq_len"] == 5.0
    served = made[0].agent.state_dict()
    for n, t in state.ema_params.items():
        assert torch.equal(served[n], t.float()), n
    for n, t in agent.state_dict().items():
        assert torch.equal(t, before[n]), n
