"""Shared helpers of the training entry points, CALVIN and LIBERO
(counterpart of ``mode_diffusion_policy_tpu/training_common.py``).

The camera pipelines are parsed from the datamodule's transforms config
(``conf/datamodule/transforms/*.yaml``) and run on the card inside the
train step (``make_train_step(preprocess_fn=...)``): raw uint8 frames go to
the card once. Each camera takes its own draws from the train state's
generator, as the reference's per-camera torchvision transforms are
independent.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import torch

from .ops.image import preprocess_camera, random_word_dropout
from .utils.device import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_PIPELINES = {
    "rgb_static": {"size": 224, "pad": 10},
    "rgb_gripper": {"size": 224, "pad": 4},
}
CAMERAS = ("rgb_static", "rgb_gripper")


def persist_resolved_config(cfg: Dict, log_dir) -> None:
    """Write the resolved run config to ``<log_dir>/.hydra/config.yaml``
    (the reference's hydra run-dir layout, which evaluation reads back)."""
    import yaml
    from pathlib import Path

    def plain(node):
        if isinstance(node, dict):
            return {str(k): plain(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [plain(v) for v in node]
        if isinstance(node, (str, int, float, bool)) or node is None:
            return node
        return str(node)

    d = Path(log_dir) / ".hydra"
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "config.yaml", "w") as f:
        yaml.safe_dump(plain(cfg), f, sort_keys=False)


def parse_camera_pipelines(transforms_cfg: Optional[Dict]) -> Dict[str, Dict]:
    """{'rgb_static': {'size', 'pad'[, 'jitter', 'erasing']}, ...} from the
    (train) transform specs, plus 'word_dropout_p' for a language
    RandomWordDropout entry."""
    out = {k: dict(v) for k, v in DEFAULT_PIPELINES.items()}
    train = (transforms_cfg or {}).get("train", {})
    for cam in out:
        for spec in train.get(cam, []):
            target = str(spec.get("_target_", ""))
            if target.endswith("Resize"):
                out[cam]["size"] = int(spec.get("size", out[cam]["size"]))
            elif target.endswith("RandomShiftsAug"):
                out[cam]["pad"] = int(spec.get("pad", out[cam]["pad"]))
            elif target.endswith("RobustColorJitter"):
                out[cam]["jitter"] = {
                    "brightness": float(spec.get("brightness", 0.3)),
                    "contrast": float(spec.get("contrast", 0.3)),
                    "saturation": float(spec.get("saturation", 0.3)),
                    "hue": float(spec.get("hue", 0.1))}
            elif target.endswith("RobustRandomErasing"):
                out[cam]["erasing"] = {
                    "p": float(spec.get("p", 0.2)),
                    "scale": tuple(spec.get("scale", (0.02, 0.33))),
                    "ratio": tuple(spec.get("ratio", (0.3, 3.3))),
                    "value": float(spec.get("value", 0))}
    for lang_key in ("language", "lang", "lang_emb"):
        for spec in train.get(lang_key, []):
            if str(spec.get("_target_", "")).endswith("RandomWordDropout"):
                out["word_dropout_p"] = float(spec.get("p", 0.1))
    return out


def make_train_preprocess(pipelines: Dict[str, Dict]) -> Callable:
    """``preprocess(batch, generator)``: uint8 frames -> augmented,
    normalized float32 on the batch's device (train mode), the cameras in
    order, then the optional word dropout; draws from ``generator``."""

    def preprocess(batch, generator):
        out = dict(batch)
        for cam in CAMERAS:
            p = pipelines[cam]
            out[cam] = preprocess_camera(
                batch[cam], size=p["size"], shift_pad=p["pad"], train=True,
                jitter=p.get("jitter"), erasing=p.get("erasing"),
                generator=generator)
        wd_p = pipelines.get("word_dropout_p")
        if wd_p and "lang_emb" in batch:
            lang = batch["lang_emb"]
            u = torch.rand(lang.shape, generator=generator,
                           device=lang.device)
            out["lang_emb"] = random_word_dropout(lang, u, wd_p)
        return out

    return preprocess


def make_data_iters(datamodule, pipelines: Dict[str, Dict], device="cuda"):
    """(train_iter, val_iter) over any object with ``train_batches(epoch)``
    and ``val_batches()``: train batches stay raw uint8 (preprocessed in the
    train step); validation batches are preprocessed here, eval mode, on
    ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    keep = ("rgb_static", "rgb_gripper", "actions", "lang_emb")

    def train_iter(epoch=0):
        for batch in datamodule.train_batches(epoch):
            yield {k: batch[k] for k in keep}

    def val_iter(epoch=0):
        for batch in datamodule.val_batches():
            out = {k: batch[k] for k in keep}
            for cam in CAMERAS:
                out[cam] = preprocess_camera(
                    torch.as_tensor(out[cam], device=dev),
                    size=pipelines[cam]["size"])
            yield out

    return train_iter, val_iter


@torch.no_grad()
def load_pretrained_into_state(state, cfg: Dict, logger=logger):
    """``start_from_pretrained``: the reference torch weights of
    ``cfg['model']['ckpt_path']`` (``utils/checkpoint_convert.py``)
    copied into a fresh train state, in place and in the state's dtype:
    the DiT, and each FiLM-ResNet encoder the checkpoint holds (its
    running statistics into ``batch_stats``); then the EMA weights become
    a copy of the parameters, as in the reference
    (``initialize_pretrained_weights``, utils/utils.py:31-42). Returns the
    state."""
    from .models.agent import ENCODERS
    from .utils.checkpoint_convert import (convert_film_resnet,
                                           convert_modedit, detect_layout,
                                           encoder_kwargs,
                                           load_torch_checkpoint,
                                           normalize_state_dict)
    ckpt_path = cfg.get("model", {}).get("ckpt_path")
    sd = normalize_state_dict(load_torch_checkpoint(str(ckpt_path)))
    n_layers, n_experts, prefix = detect_layout(sd)
    converted = {f"inner_model.{k}": v for k, v in
                 convert_modedit(sd, n_layers, n_experts, prefix).items()}
    for enc in ENCODERS:
        try:
            conv = convert_film_resnet(
                sd, prefix=f"{enc}.", **encoder_kwargs(
                    cfg["model"].get("resnet_type", "50")))
        except KeyError:
            logger.warning("no %s weights in pretrained checkpoint", enc)
            continue
        converted.update({f"{enc}.{k}": v for k, v in conv.items()})
    for name, value in converted.items():
        dst = state.params.get(name, state.batch_stats.get(name))
        if dst is None:
            raise KeyError(f"pretrained {name} has no place in the state")
        if dst.shape != value.shape:
            raise ValueError(f"pretrained {name} is {tuple(value.shape)}, "
                             f"the state's {tuple(dst.shape)}")
        dst.copy_(value)
    for name, ema in state.ema_params.items():
        ema.copy_(state.params[name])
    logger.info("initialized from pretrained %s (layers=%d, experts=%d)",
                ckpt_path, n_layers, n_experts)
    return state


def _serving_agent(agent, variables):
    """A new agent on ``agent``'s device holding an f32 copy of
    ``variables`` (``TrainState.eval_variables()``: the EMA weights and
    running statistics); the training agent is not touched."""
    from .models.agent import MoDEAgent
    serving = MoDEAgent(agent.cfg, device=agent.device)
    serving.load_state_dict({n: t.float() for coll in ("params",
                                                       "batch_stats")
                             for n, t in variables[coll].items()})
    return serving


def build_calvin_rollout_callback(rollout_cfg: Dict, lang_cache,
                                  pipelines: Dict[str, Dict]):
    """The Trainer's in-training long-horizon rollout hook
    (``Trainer(rollout_callback=)``; the reference's RolloutLongHorizon
    callback): the scripted fake env when ``rollout_cfg["fake_env"]`` is
    set, the real calvin_env when it is importable, else None. Each call
    serves an f32 copy of the given variables (the EMA weights and running
    statistics, ``TrainState.eval_variables()``) in a new agent on the
    training agent's device, through ``evaluate_calvin.PreprocPolicy``
    with the eval pipelines' image sizes; the training agent is not
    touched."""
    from .data.calvin_dataset import DEFAULT_OBS_SPACE, DEFAULT_PROPRIO
    from .evaluation.evaluate_calvin import PreprocPolicy
    from .rollout.env import CalvinEnvWrapper, FakeCalvinEnv
    from .rollout.rollout_long_horizon import make_rollout_callback

    val_annotations = rollout_cfg.get("val_annotations")
    if not val_annotations:
        from .evaluation.evaluate_calvin import load_val_annotations
        val_annotations = load_val_annotations()

    if rollout_cfg.get("fake_env"):
        from .rollout.multistep_sequences import tasks as all_tasks
        raw = FakeCalvinEnv(
            hw=int(rollout_cfg.get("fake_hw", 24)),
            solvable_tasks=set(all_tasks.keys()),
            steps_to_success=int(rollout_cfg.get("fake_steps_to_success", 2)))
        env = CalvinEnvWrapper(raw, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
        oracle = raw.make_oracle()
    else:
        try:
            from pathlib import Path

            from calvin_env.envs.play_table_env import get_env
            from calvin_env.envs.tasks import Tasks

            from .config.loader import require_yaml
            env_raw = get_env(
                Path(rollout_cfg["dataset_path"]) / "validation",
                show_gui=False)
            env = CalvinEnvWrapper(env_raw, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
            tasks_yaml = (Path(__file__).resolve().parents[1] / "conf"
                          / "callbacks" / "rollout_lh" / "tasks"
                          / "new_playtable_tasks.yaml")
            with open(tasks_yaml) as f:
                oracle = Tasks(require_yaml().safe_load(f)["tasks"])
        except (ImportError, KeyError, TypeError) as e:
            logger.info("in-training rollouts disabled (%s)", e)
            return None

    def make_policy(agent, variables):
        return PreprocPolicy(_serving_agent(agent, variables), lang_cache,
                             sizes={cam: pipelines[cam]["size"]
                                    for cam in CAMERAS})

    return make_rollout_callback(
        env, oracle, val_annotations, make_policy,
        num_sequences=int(rollout_cfg.get("num_sequences", 1000)),
        ep_len=int(rollout_cfg.get("ep_len", 360)))


def build_libero_rollout_callback(rollout_cfg: Dict, lang_cache,
                                  pipelines: Dict[str, Dict]):
    """The Trainer's in-training LIBERO rollout hook (the reference's
    RolloutLibero callback, ``conf/callbacks/libero.yaml`` rollout_lh):
    scripted ``FakeLiberoEnv``s when ``rollout_cfg["fake_env"]`` is set,
    the benchmark ``rollout_cfg["benchmark_name"]`` when the LIBERO package
    is importable, else None. Each call creates the envs and closes them
    after (no simulator state outlives an epoch), and serves an f32 copy
    of the given variables in a new agent on the training agent's device
    through ``evaluate_calvin.PreprocPolicy``, both cameras at
    ``pipelines["rgb_static"]["size"]`` (as the JAX hook serves them)."""
    from .evaluation.evaluate_calvin import PreprocPolicy
    from .rollout.libero_rollout import (FakeLiberoEnv, LiberoEvaluator,
                                         make_libero_env)

    fake = bool(rollout_cfg.get("fake_env"))
    if not fake:
        try:
            import libero.libero.benchmark  # noqa: F401
        except ImportError as e:
            logger.info("in-training LIBERO rollouts disabled (%s)", e)
            return None

    size = pipelines["rgb_static"]["size"]

    def make_tasks():
        if fake:
            return [(f"fake task {i}",
                     FakeLiberoEnv(
                         hw=int(rollout_cfg.get("fake_hw", 24)),
                         steps_to_success=int(
                             rollout_cfg.get("fake_steps_to_success", 4))),
                     None)
                    for i in range(int(rollout_cfg.get("fake_tasks", 2)))]
        import os
        from libero.libero import get_libero_path
        from libero.libero.benchmark import get_benchmark
        bench = get_benchmark(rollout_cfg["benchmark_name"])()
        bddl_base = get_libero_path("bddl_files")
        tasks = []
        for i in range(bench.n_tasks):
            task = bench.get_task(i)
            env = make_libero_env(
                os.path.join(bddl_base, task.problem_folder, task.bddl_file),
                size, size)
            tasks.append((task.language, env, bench.get_task_init_states(i)))
        return tasks

    def callback(agent, variables, epoch):
        policy = PreprocPolicy(_serving_agent(agent, variables), lang_cache,
                               sizes={cam: size for cam in CAMERAS})
        evaluator = LiberoEvaluator(
            n_eval=int(rollout_cfg.get("n_eval", 20)),
            max_steps=int(rollout_cfg.get("max_steps", 520)))
        names, rates = [], []
        for desc, env, init_states in make_tasks():
            try:
                rates.append(evaluator.evaluate_task(policy, env, desc,
                                                     init_states))
                names.append(desc)
            finally:
                env.close()
        return evaluator.metrics(evaluator.gather_success_rates(rates), names)

    return callback
