"""Standalone LIBERO benchmark CLI (counterpart of
``mode_diffusion_policy_tpu/evaluation/evaluate_libero.py``).

Evaluates a MoDE agent on a LIBERO benchmark (libero_10 / libero_90: 20
rollouts per task from the benchmark's fixed init states, 520-step cap),
writing each task's and the average success rate to
``<log-dir>/results_libero.json``. The agent comes from
``evaluate_calvin.build_agent``: a run directory of the port's
``Trainer`` (restored through ``CheckpointManager``), one of its step
directories, or a published torch checkpoint through the converter, then
the serving preset. ``--fake-env`` runs the whole pipeline on scripted
envs. Runs on CUDA unless ``--device cpu``.

Usage:
    python -m mode_diffusion_policy_tpu_torch.evaluation.evaluate_libero \\
        --checkpoint runs/exp1 --benchmark libero_10 [--fake-env]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, List

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class LiberoEvaluation:
    """What one evaluation run made and measured."""

    metrics: Dict[str, float]
    names: List[str]
    agent: Any          # the loaded agent with its serving preset applied
    policy: Any         # evaluate_calvin.PreprocPolicy
    evaluator: Any
    lang_cache: Any


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--checkpoint", default=None,
                   help="a run directory of the port's Trainer, one of its "
                        "step directories, or a published reference torch "
                        "checkpoint (as evaluate_calvin reads them)")
    p.add_argument("--benchmark", default="libero_10")
    p.add_argument("--root-data-dir", default=None)
    p.add_argument("--n-eval", type=int, default=20)
    p.add_argument("--max-steps", type=int, default=520)
    p.add_argument("--img-size", type=int, default=224,
                   help="the side both cameras are rendered and resized to")
    # None = use the checkpoint dir's persisted training config (or the
    # flagship defaults): evaluate_calvin.MODEL_ARG_DEFAULTS
    p.add_argument("--latent-dim", type=int, default=None)
    p.add_argument("--n-layers", type=int, default=None)
    p.add_argument("--resnet-type", default=None)
    p.add_argument("--sampler-type", default=None)
    p.add_argument("--num-sampling-steps", type=int, default=None)
    p.add_argument("--sampler-unroll", type=int, default=1,
                   help="accepted for the JAX CLI's flag set; no effect "
                        "here (the port's samplers are Python loops)")
    p.add_argument("--noise-scheduler", default=None)
    p.add_argument("--sigma-min", type=float, default=None)
    p.add_argument("--sigma-max", type=float, default=None)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--serving-mode", default="auto",
                   help="serving preset: reference | parity | "
                        "max-throughput | b1-latency | b1-latency-max | "
                        "auto (parity on CUDA, reference on the CPU)")
    p.add_argument("--clip-checkpoint", default=None)
    p.add_argument("--log-dir", default="eval_results_libero")
    p.add_argument("--fake-env", action="store_true")
    p.add_argument("--fake-tasks", type=int, default=2)
    p.add_argument("--fake-steps-to-success", type=int, default=4)
    p.add_argument("--num-videos", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu (the "
                        "kernels' plain PyTorch versions)")
    args = p.parse_args(argv)
    args.image_size = args.img_size     # evaluate_calvin.build_agent's name
    return args


def make_tasks(args):
    """[(instruction, env, init_states)]: ``--fake-tasks`` scripted envs
    with ``--fake-env``, else every task of the LIBERO benchmark."""
    from ..rollout.libero_rollout import FakeLiberoEnv, make_libero_env
    if args.fake_env:
        return [(f"fake task {i}",
                 FakeLiberoEnv(hw=args.img_size,
                               steps_to_success=args.fake_steps_to_success),
                 None)
                for i in range(args.fake_tasks)]
    from libero.libero import get_libero_path
    from libero.libero.benchmark import get_benchmark
    bench = get_benchmark(args.benchmark)()
    bddl_base = get_libero_path("bddl_files")
    tasks = []
    for i in range(bench.n_tasks):
        task = bench.get_task(i)
        env = make_libero_env(
            os.path.join(bddl_base, task.problem_folder, task.bddl_file),
            args.img_size, args.img_size)
        tasks.append((task.language, env, bench.get_task_init_states(i)))
    return tasks


def evaluate(args) -> LiberoEvaluation:
    """One evaluation run of parsed ``args`` (``main`` without its
    printing)."""
    from ..config.builders import build_lang_clip
    from ..models.encoders.lang_cache import LangEmbeddingCache
    from ..rollout.libero_rollout import LiberoEvaluator
    from ..rollout.video import RolloutVideo
    from .evaluate_calvin import CAMERAS, PreprocPolicy, build_agent

    agent = build_agent(args)
    lang = build_lang_clip(clip_checkpoint=args.clip_checkpoint,
                           device=agent.device)
    lang_cache = LangEmbeddingCache(lang)
    # both cameras at --img-size, as the JAX CLI resizes them
    policy = PreprocPolicy(agent, lang_cache,
                           sizes={cam: args.img_size for cam in CAMERAS})
    tasks = make_tasks(args)
    video = RolloutVideo(save_dir=str(Path(args.log_dir) / "videos")) \
        if args.num_videos > 0 else None
    evaluator = LiberoEvaluator(n_eval=args.n_eval, max_steps=args.max_steps,
                                rollout_video=video,
                                num_videos=args.num_videos)
    names, rates = [], []
    for desc, env, init_states in tasks:
        try:
            sr = evaluator.evaluate_task(policy, env, desc, init_states)
        finally:
            env.close()
        logger.info("task '%s': SR=%.3f", desc, sr)
        names.append(desc)
        rates.append(sr)
    rates = evaluator.gather_success_rates(rates)
    metrics = evaluator.metrics(rates, names)
    if video is not None:
        video.log()
    os.makedirs(args.log_dir, exist_ok=True)
    with open(Path(args.log_dir) / "results_libero.json", "w") as f:
        json.dump(metrics, f, indent=2)
    return LiberoEvaluation(metrics, names, agent, policy, evaluator,
                            lang_cache)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    metrics = evaluate(parse_args(argv)).metrics
    print(f"avg_success_rate: {metrics['eval/avg_success_rate']:.3f}")
    return metrics


if __name__ == "__main__":
    main()
