"""Standalone CALVIN long-horizon evaluation CLI (counterpart of
``mode_diffusion_policy_tpu/evaluation/evaluate_calvin.py``).

Loads a MoDE agent (a run directory of the port's ``Trainer``, one of its
step directories, or a published torch checkpoint through the converter),
applies a serving preset, builds the calvin_env wrapper (or the scripted
fake env with ``--fake-env``), runs ``--num-sequences`` five-task chains and
writes ``results.json`` (SR_1..SR_5, avg_seq_len, per-task counts). Runs on
CUDA unless ``--device cpu``.

Usage:
    python -m mode_diffusion_policy_tpu_torch.evaluation.evaluate_calvin \\
        --checkpoint runs/exp1 --dataset-path /data/calvin/task_D_D \\
        [--sampler-type ddim --num-sampling-steps 10] [--fake-env]
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..models.agent import RolloutPolicy
from ..ops.image import preprocess_camera

logger = logging.getLogger(__name__)

REPO_ROOT = Path(__file__).resolve().parents[2]
CAMERAS = ("rgb_static", "rgb_gripper")


def load_val_annotations(path=None):
    """The validation instructions per task
    (``conf/annotations/new_playtable_validation.yaml``)."""
    from ..config.loader import require_yaml
    yaml = require_yaml()
    path = path or (REPO_ROOT / "conf" / "annotations" /
                    "new_playtable_validation.yaml")
    with open(path) as f:
        return yaml.safe_load(f)


# model-shape/sampler flags the CLI can override; parser defaults are None
# so "not passed" is distinguishable from "explicitly set": when the
# checkpoint dir carries the training run's resolved config
# (<run>/.hydra/config.yaml), the model is rebuilt from THAT and CLI flags
# apply on top
MODEL_ARG_DEFAULTS = {
    "sampler_type": "ddim", "num_sampling_steps": 10,
    "noise_scheduler": "exponential", "sigma_min": 0.001, "sigma_max": 80.0,
    "latent_dim": 1024, "n_layers": 12, "resnet_type": "50",
}


def find_train_config(checkpoint):
    """The persisted training config of a checkpoint path: the run dir's
    ``.hydra/config.yaml`` (or ``config.yaml``), also searched one and two
    levels up for ``saved_models/<step>`` paths."""
    if not checkpoint:
        return None
    ckpt = Path(checkpoint)
    candidates = [ckpt]
    if ckpt.name.isdigit():               # <run>/saved_models/<step>
        candidates += [ckpt.parent, ckpt.parent.parent]
    for base in candidates:
        for rel in (".hydra/config.yaml", "config.yaml"):
            p = base / rel
            if p.is_file():
                from ..config.loader import require_yaml, \
                    resolve_interpolations
                with open(p) as f:
                    cfg = require_yaml().safe_load(f)
                if isinstance(cfg, dict) and "model" in cfg:
                    logger.info("model shape from training config %s", p)
                    return resolve_interpolations(cfg)
    return None


def _checkpoint_file(ckpt: Path) -> Optional[Path]:
    """The state file that ``restore_trained`` will read, for its dtype."""
    from ..training.loop import CheckpointManager
    if ckpt.name.isdigit():
        return ckpt / CheckpointManager.FILE
    root = ckpt / "saved_models"
    for sub in (root / "best", root):
        steps = CheckpointManager._steps(sub)
        if steps:
            return sub / str(steps[-1]) / CheckpointManager.FILE
    return None


@torch.no_grad()
def restore_trained(agent, ckpt: Path, use_ema: bool = True):
    """Load a port checkpoint into ``agent``, in f32: a run directory
    (``<run>/saved_models``: the best-by-metric state under ``best/`` when
    there is one, else the newest) or one step directory
    (``<run>/saved_models/<step>`` or ``.../best/<step>``), through
    ``training.loop.CheckpointManager``. The state is restored as the
    Trainer saved it (an f32 or a bf16 state, ``bf16_full_state``) into a
    second agent of the same config; ``agent`` then takes its EMA weights
    (or its trained weights with ``use_ema=False``) and the encoders'
    running statistics. Returns the restored step."""
    from ..models.agent import MoDEAgent
    from ..training.loop import CheckpointManager
    from ..training.optim import make_optimizer
    from ..training.state import TrainState

    path = _checkpoint_file(ckpt)
    if path is None or not path.exists():
        raise FileNotFoundError(f"no port checkpoint under {ckpt}")
    saved = torch.load(path, map_location="cpu", weights_only=False,
                       mmap=True)
    dtype = next(iter(saved["params"].values())).dtype
    del saved
    holder = MoDEAgent(agent.cfg, device=agent.device)
    bf16 = dtype == torch.bfloat16
    opt, _ = make_optimizer(dict(holder.named_parameters()),
                            stochastic_round=bf16)
    kw = dict(param_dtype=dtype, ema_dtype=dtype) if bf16 else {}
    state = TrainState.create(holder, opt, torch.Generator(
        device=agent.device), **kw)
    if ckpt.name.isdigit():
        state = CheckpointManager(str(ckpt.parent)).restore(
            state, step=int(ckpt.name))
    else:
        state = CheckpointManager(str(ckpt / "saved_models")).restore_best(
            state)
    weights = state.ema_params if use_ema else state.params
    sd = {n: t.float() for n, t in weights.items()}
    sd.update({n: t.float() for n, t in state.batch_stats.items()})
    agent.load_state_dict(sd)
    logger.info("restored %s weights of %s (step %d)",
                "EMA" if use_ema else "trained", path, state.step)
    return state.step


def load_converted(agent, ckpt: Path):
    """Load a published reference torch checkpoint (safetensors dir,
    ``.ckpt`` or ``.pt``) into ``agent`` through the converters: the DiT
    with whatever options its keys hold, the encoders as the config's
    ``resnet_type`` builds them (``checkpoint_convert.encoder_kwargs``)."""
    from ..models.agent import ENCODERS
    from ..utils.checkpoint_convert import (convert_film_resnet,
                                            convert_modedit, detect_layout,
                                            encoder_kwargs,
                                            load_torch_checkpoint,
                                            normalize_state_dict)
    from ..utils.weights import load_dit_state_
    sd = normalize_state_dict(load_torch_checkpoint(str(ckpt)))
    n_layers, n_experts, prefix = detect_layout(sd)
    load_dit_state_(agent.inner_model,
                    convert_modedit(sd, n_layers, n_experts, prefix))
    for enc in ENCODERS:
        try:
            conv = convert_film_resnet(
                sd, prefix=f"{enc}.", **encoder_kwargs(agent.cfg.resnet_type))
        except KeyError:
            logger.warning("no %s weights in checkpoint", enc)
            continue
        getattr(agent, enc).load_state_dict(conv)
    logger.info("converted torch checkpoint %s (layers=%d experts=%d)",
                ckpt, n_layers, n_experts)


def build_agent(args):
    """The agent of ``args`` on ``args.device``: its config from the
    checkpoint's training config or the flagship defaults, CLI flags on
    top; its weights from ``--checkpoint``; then the serving preset, applied
    after the weights are loaded (the folded and int8 weights derive from
    them)."""
    from ..config.builders import build_agent_config
    from ..models.agent import MoDEAgent, MoDEAgentConfig
    from ..serving import apply_serving_mode, resolve_serving_mode

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    overrides = {k: getattr(args, k) for k in MODEL_ARG_DEFAULTS
                 if getattr(args, k, None) is not None}
    train_cfg = find_train_config(args.checkpoint)
    if train_cfg is not None:
        cfg = build_agent_config(train_cfg["model"], dtype=dtype)
    else:
        cfg = MoDEAgentConfig(dtype=dtype, **MODEL_ARG_DEFAULTS)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    agent = MoDEAgent(cfg, device=getattr(args, "device", "cuda"))
    ckpt = Path(args.checkpoint) if args.checkpoint else None
    if ckpt and not ckpt.exists():
        raise FileNotFoundError(f"--checkpoint {ckpt} does not exist")
    if ckpt:
        if (ckpt / "saved_models").exists() or ckpt.name.isdigit():
            restore_trained(agent, ckpt, use_ema=not args.no_ema)
        else:
            load_converted(agent, ckpt)
    mode = resolve_serving_mode(getattr(args, "serving_mode", "auto"),
                                agent.device.type)
    logger.info("serving mode: %s", mode)
    return apply_serving_mode(agent, mode)


def build_env(args, observation_space, proprio_state):
    from ..rollout.env import CalvinEnvWrapper, FakeCalvinEnv

    if args.fake_env:
        from ..rollout.multistep_sequences import tasks as all_tasks
        raw = FakeCalvinEnv(hw=args.image_size,
                            solvable_tasks=set(all_tasks.keys()),
                            steps_to_success=args.fake_steps_to_success)
        return (CalvinEnvWrapper(raw, observation_space, proprio_state),
                raw.make_oracle())
    # the real calvin_env (PyBullet): an external dependency
    try:
        from calvin_env.envs.play_table_env import get_env
        from calvin_env.envs.tasks import Tasks
    except ImportError:
        print("calvin_env not installed; use --fake-env for a smoke run",
              file=sys.stderr)
        raise
    from ..config.loader import require_yaml
    env = get_env(Path(args.dataset_path) / "validation", show_gui=False)
    tasks_yaml = (REPO_ROOT / "conf" / "callbacks" / "rollout_lh" / "tasks"
                  / "new_playtable_tasks.yaml")
    with open(tasks_yaml) as f:
        oracle = Tasks(require_yaml().safe_load(f)["tasks"])
    return (CalvinEnvWrapper(env, observation_space, proprio_state), oracle)


class PreprocPolicy(RolloutPolicy):
    """``RolloutPolicy`` over raw env observations: on a chunk boundary the
    uint8 frames (``obs['rgb_obs'][camera]``, [1, 1, H, W, 3]) go to the
    card once and are resized and normalized there (``sizes``: {camera:
    side}); the other steps hand out the chunk's actions and touch no
    frame."""

    def __init__(self, agent, lang_encoder=None, *, sizes: Dict[str, int],
                 **kw):
        super().__init__(agent, lang_encoder, **kw)
        self.sizes = dict(sizes)

    def step(self, obs, goal, noise=None):
        if self._counter % self.multistep == 0:
            dev = self.agent.device
            obs = dict(obs)
            for cam in CAMERAS:
                obs[cam] = preprocess_camera(
                    torch.as_tensor(obs["rgb_obs"][cam], device=dev),
                    size=self.sizes[cam])
        return super().step(obs, goal, noise)


@dataclasses.dataclass
class Evaluation:
    """What one evaluation run made and measured."""

    ranking: Dict[str, Any]
    results: List[int]
    agent: Any          # the loaded agent with its serving preset applied
    policy: PreprocPolicy
    env: Any
    evaluator: Any
    lang_cache: Any


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--checkpoint", default=None,
                   help="a run directory of the port's Trainer "
                        "(<run>/saved_models: the best state under "
                        "saved_models/best/ when there is one, else the "
                        "newest), one step directory "
                        "(<run>/saved_models/<step> or "
                        "<run>/saved_models/best/<step>), or a published "
                        "reference torch checkpoint (safetensors dir, "
                        ".ckpt, .pt; converted)")
    p.add_argument("--dataset-path", default=None)
    p.add_argument("--num-sequences", type=int, default=1000)
    p.add_argument("--ep-len", type=int, default=360)
    # model/sampler flags: None = "use the training run's persisted config
    # (.hydra/config.yaml in the checkpoint dir) or the flagship defaults";
    # a passed value always wins (MODEL_ARG_DEFAULTS)
    p.add_argument("--sampler-type", default=None)
    p.add_argument("--num-sampling-steps", type=int, default=None)
    p.add_argument("--sampler-unroll", type=int, default=1,
                   help="accepted for the JAX CLI's flag set; no effect "
                        "here (a lax.scan unroll setting: the port's "
                        "samplers are Python loops)")
    p.add_argument("--noise-scheduler", default=None)
    p.add_argument("--sigma-min", type=float, default=None)
    p.add_argument("--sigma-max", type=float, default=None)
    p.add_argument("--latent-dim", type=int, default=None)
    p.add_argument("--n-layers", type=int, default=None)
    p.add_argument("--resnet-type", default=None)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--serving-mode", default="auto",
                   help="serving preset: reference | parity | "
                        "max-throughput | b1-latency | b1-latency-max | "
                        "auto (parity on CUDA, reference on the CPU); "
                        "PERF.md has the measured speed and accuracy of "
                        "each")
    p.add_argument("--clip-checkpoint", default=None,
                   help="OpenAI CLIP state dict for the language tower "
                        "(random-init tower otherwise; required for "
                        "meaningful language conditioning)")
    p.add_argument("--log-dir", default="eval_results")
    p.add_argument("--fake-env", action="store_true")
    p.add_argument("--fake-steps-to-success", type=int, default=3)
    p.add_argument("--num-videos", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu (the "
                        "kernels' plain PyTorch versions)")
    return p.parse_args(argv)


def evaluate(args) -> Evaluation:
    """One evaluation run of parsed ``args`` (``main`` without its
    printing)."""
    from ..config.builders import build_lang_clip
    from ..data.calvin_dataset import DEFAULT_OBS_SPACE, DEFAULT_PROPRIO
    from ..evaluation.utils import print_and_save
    from ..models.encoders.lang_cache import LangEmbeddingCache
    from ..rollout.rollout_long_horizon import LongHorizonEvaluator
    from ..rollout.video import RolloutVideo

    agent = build_agent(args)
    env, oracle = build_env(args, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
    val_annotations = load_val_annotations()
    lang = build_lang_clip(clip_checkpoint=args.clip_checkpoint,
                           device=agent.device)
    lang_cache = LangEmbeddingCache(lang)
    policy = PreprocPolicy(agent, lang_cache,
                           sizes={cam: args.image_size for cam in CAMERAS})
    video = RolloutVideo(save_dir=str(Path(args.log_dir) / "videos")) \
        if args.num_videos > 0 else None
    evaluator = LongHorizonEvaluator(
        env, oracle, val_annotations, num_sequences=args.num_sequences,
        ep_len=args.ep_len, num_videos=args.num_videos, rollout_video=video)
    local = evaluator.evaluate_policy(policy)
    results = evaluator.gather_results(local)
    if video is not None:
        video.log()
    ranking = print_and_save(results, evaluator.eval_sequences[:len(results)],
                             args.log_dir)
    return Evaluation(ranking, results, agent, policy, env, evaluator,
                      lang_cache)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ranking = evaluate(parse_args(argv)).ranking
    print(f"avg_seq_len: {ranking['avg_seq_len']:.3f}")
    print(f"chain_sr: {ranking['chain_sr']}")
    return ranking


if __name__ == "__main__":
    main()
