"""Training loop (counterpart of
``mode_diffusion_policy_tpu/training/loop.py``): the train step, EMA,
checkpoints, auto-resume, metric logging and the epoch-driven ``Trainer``,
for one card.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``: preprocess on the card (optional), the agent's training loss,
its backward pass into the state's flat gradient buffers, the fused AdamW
+ EMA update and the BatchNorm running-statistics update, all in place on
the state's tensors. The random draws of a step come from the state's
generator, in order: preprocessing, the loss's (sigma, noise, the DiT's),
the stochastic-rounding bits.

``CheckpointManager`` keeps, as the JAX one does with orbax, the
``save_top_k + 1`` newest states for auto-resume and the best state by the
monitored metric under ``best/``, with ``best_score.json`` kept across
restarts; a state is one ``torch.save`` file per step directory, with the
generator's state, written to a temporary name and renamed.

``Trainer.auto_layout`` is accepted and changes nothing: it is XLA's choice
of parameter layouts, which PyTorch has no counterpart of (the JAX
package's ``auto_layout=True`` state is numerically the default one,
``tests/test_training.py::test_jit_auto_layout_matches_default``).
"""
from __future__ import annotations

import inspect
import json
import logging
import os
import shutil
import signal
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..parallel.mesh import shard_batch
from ..utils.device import resolve_device
from .optim import (FusedAdamWEmaState, apply_updates, ema_decay_schedule,
                    ema_update, make_optimizer)
from .state import TrainState, swapped_in

logger = logging.getLogger(__name__)


def grad_telemetry(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Gradient norms of the DiT: per block (``debug/blocks_{i}_grad_norm``)
    and in total (``debug/total_grad_norm``), under the JAX package's
    metric names; device scalars."""
    names = [n for n in grads if n.startswith("inner_model.")]
    if not names:
        return {}
    norms = torch._foreach_norm([grads[n].float() for n in names])
    sq: Dict[str, torch.Tensor] = {}
    for n, v in zip(names, norms):
        parts = n.split(".")
        top = f"blocks_{parts[2]}" if parts[1] == "blocks" else parts[1]
        sq[top] = sq.get(top, 0.0) + v * v
    metrics = {f"debug/{k}_grad_norm": torch.sqrt(v) for k, v in sq.items()
               if k.startswith("blocks_")}
    metrics["debug/total_grad_norm"] = torch.sqrt(sum(sq.values()))
    return metrics


def _grad_buffers(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state's gradient buffers, zeroed, each parameter's ``.grad`` a
    view into them (the backward pass accumulates there in place): flat
    like the parameters under ``FusedAdamWEma``."""
    if state.grads is None:
        params = state.params
        layout = getattr(params, "layout", None)
        if layout is not None:
            state.grads = layout.new(
                next(iter(params.values())).device, lambda g: g.dtype)
        else:
            state.grads = {n: torch.zeros_like(p) for n, p in params.items()}
    for n, p in state.params.items():
        p.grad = state.grads[n]
    flats = getattr(state.grads, "flats", None)
    for t in (flats if flats is not None else state.grads.values()):
        t.zero_()
    return state.grads


def _check_device(agent, device):
    dev = resolve_device(device)
    if agent.device.type != dev.type:
        raise ValueError(f"the agent lives on {agent.device}, not {dev}; "
                         "build it with the same device=")
    return dev


def make_train_step(agent, optimizer, *, ema_kwargs: Optional[dict] = None,
                    log_grad_norms: bool = True,
                    preprocess_fn: Optional[Callable] = None,
                    device="cuda") -> Callable:
    """``train_step(state, batch, draws=None) -> (state, metrics)``, in place
    on ``state``. ``preprocess_fn(batch, generator) -> batch`` runs first
    (e.g. uint8 frames -> augmented, normalized floats on the card).
    ``draws`` (``sigma``, ``noise``, ``gumbel``) replace the loss's random
    draws, for tests. Runs on CUDA unless ``device="cpu"`` (the agent's
    device)."""
    ema_kwargs = ema_kwargs or {}
    _check_device(agent, device)
    agent.check_trainable()

    def train_step(state: TrainState, batch, draws: Optional[dict] = None):
        gen = state.rng
        if preprocess_fn is not None:
            batch = preprocess_fn(batch, gen)
        grads = _grad_buffers(state)
        loss, (metrics, bs_upd) = agent.training_loss(batch, gen,
                                                      **(draws or {}))
        loss.backward()
        for n, p in state.params.items():
            if p.grad is not grads[n]:
                # autograd replaced the buffer (it does so only when the
                # grad was undefined): keep the value, restore the view
                grads[n].copy_(p.grad)
                p.grad = grads[n]
        decay = ema_decay_schedule(state.step, **ema_kwargs)
        if hasattr(optimizer, "update_with_ema"):
            kw = ({"generator": gen}
                  if getattr(optimizer, "stochastic_round", False) else {})
            _, state.opt_state, _ = optimizer.update_with_ema(
                grads, state.opt_state, state.params, state.ema_params,
                decay, **kw)
        else:
            updates, state.opt_state = optimizer.update(
                grads, state.opt_state, state.params)
            apply_updates(state.params, updates)
            ema_update(state.ema_params, state.params, decay)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics["train/ema_rate"] = decay
        if log_grad_norms:
            metrics.update(grad_telemetry(grads))
        with torch.no_grad():
            for n, v in bs_upd.items():
                state.batch_stats[n].copy_(v)
        state.step += 1
        return state, metrics

    return train_step


def _scalar(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class MetricLogger:
    """JSONL (``<log_dir>/metrics.jsonl``) and, when asked and importable,
    wandb."""

    def __init__(self, log_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(**(wandb_kwargs or {}))
            except ImportError:
                logger.warning("wandb unavailable; logging to JSONL only")

    def log(self, metrics: Dict[str, Any], step: int):
        record = {"step": int(step)}
        for k, v in metrics.items():
            a = _scalar(v)
            record[k] = a.tolist() if a.ndim > 0 else float(a)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "step"},
                            step=step)

    def close(self):
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()


def state_dict_of(state: TrainState) -> Dict[str, Any]:
    """Everything a resume needs, by name (tensors detached, the
    generator's state as a byte tensor)."""
    def plain(d):
        return {n: t.detach() for n, t in d.items()}
    opt = state.opt_state
    if isinstance(opt, FusedAdamWEmaState):
        opt = {"count": opt.count, "mu": plain(opt.mu), "nu": plain(opt.nu)}
    return {"step": state.step, "epoch": state.epoch,
            "params": plain(state.params),
            "batch_stats": plain(state.batch_stats), "opt_state": opt,
            "ema_params": plain(state.ema_params),
            "rng": state.rng.get_state()}


@torch.no_grad()
def load_state_(state: TrainState, saved: Dict[str, Any]) -> TrainState:
    """Copy a ``state_dict_of`` payload into ``state``'s own tensors (their
    identity, dtype and device kept; a dtype mismatch raises)."""
    def into(dst, src, what):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint {what} names differ from the "
                             "state's")
        for n, t in dst.items():
            if t.dtype != src[n].dtype or t.shape != src[n].shape:
                raise ValueError(f"checkpoint {what}[{n}] is "
                                 f"{src[n].dtype}{tuple(src[n].shape)}, the "
                                 f"state's {t.dtype}{tuple(t.shape)}")
            t.copy_(src[n])
    into(state.params, saved["params"], "params")
    into(state.batch_stats, saved["batch_stats"], "batch_stats")
    into(state.ema_params, saved["ema_params"], "ema_params")
    opt = saved["opt_state"]
    if isinstance(state.opt_state, FusedAdamWEmaState):
        into(state.opt_state.mu, opt["mu"], "mu")
        into(state.opt_state.nu, opt["nu"], "nu")
        state.opt_state = FusedAdamWEmaState(int(opt["count"]),
                                             state.opt_state.mu,
                                             state.opt_state.nu)
    else:
        state.opt_state = opt
    state.step, state.epoch = int(saved["step"]), int(saved["epoch"])
    state.rng.set_state(saved["rng"].cpu())    # a CPU byte tensor
    return state


class CheckpointManager:
    """Save/restore with best-metric tracking and auto-resume: the newest
    ``save_top_k + 1`` states under ``<ckpt_dir>/<step>/``, the best by
    ``monitor`` (``mode`` max or min) under ``best/<step>/``, and the best
    score in ``best_score.json``, read back on restart."""

    FILE = "state.pt"

    def __init__(self, ckpt_dir: str, monitor: str = "eval_lh/avg_seq_len",
                 mode: str = "max", save_top_k: int = 1):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.best_dir = os.path.join(self.ckpt_dir, "best")
        os.makedirs(self.best_dir, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.keep = save_top_k + 1
        self._best_file = os.path.join(self.ckpt_dir, "best_score.json")
        self._best = -np.inf if mode == "max" else np.inf
        if os.path.exists(self._best_file):
            with open(self._best_file) as f:
                self._best = float(json.load(f)["best"])

    @classmethod
    def _steps(cls, root):
        out = []
        for d in os.listdir(root) if os.path.isdir(root) else ():
            if d.isdigit() and os.path.exists(os.path.join(root, d,
                                                           cls.FILE)):
                out.append(int(d))
        return sorted(out)

    def _write(self, root, step, payload, link_from=None):
        d = os.path.join(root, str(step))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, self.FILE)
        if os.path.exists(path):
            os.remove(path)
        if link_from is not None:
            try:
                os.link(link_from, path)
                return path
            except OSError:
                pass
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def _prune(self, root, keep):
        for s in self._steps(root)[:-keep]:
            shutil.rmtree(os.path.join(root, str(s)), ignore_errors=True)

    def save(self, step: int, state: TrainState,
             metrics: Optional[Dict[str, Any]] = None) -> bool:
        clean = {}
        for k, v in (metrics or {}).items():
            a = _scalar(v)
            if a.ndim == 0:
                clean[k] = float(a)
        payload = state_dict_of(state)
        path = self._write(self.ckpt_dir, step, payload)
        self._prune(self.ckpt_dir, self.keep)
        if self.monitor in clean:
            val = clean[self.monitor]
            better = val > self._best if self.mode == "max" \
                else val < self._best
            if better:
                self._best = val
                self._write(self.best_dir, step, payload, link_from=path)
                self._prune(self.best_dir, 1)
                with open(self._best_file, "w") as f:
                    json.dump({"best": val, "step": step,
                               "monitor": self.monitor}, f)
        return True

    def best_step(self) -> Optional[int]:
        steps = self._steps(self.best_dir)
        return steps[-1] if steps else None

    def latest_step(self) -> Optional[int]:
        steps = self._steps(self.ckpt_dir)
        return steps[-1] if steps else None

    def _load(self, root, step, state):
        saved = torch.load(os.path.join(root, str(step), self.FILE),
                           map_location=next(iter(state.params.values()))
                           .device, weights_only=False)
        return load_state_(state, saved)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        step = step if step is not None else self.latest_step()
        return state if step is None else self._load(self.ckpt_dir, step,
                                                     state)

    def restore_best(self, state: TrainState) -> TrainState:
        step = self.best_step()
        if step is None:
            return self.restore(state)
        return self._load(self.best_dir, step, state)


def _call_iter(fn, epoch):
    try:
        if len(inspect.signature(fn).parameters) >= 1:
            return fn(epoch)
    except (TypeError, ValueError):
        pass
    return fn()


class Trainer:
    """Epoch-driven training with validation once per epoch, the rollout
    hook every ``rollout_freq`` epochs, checkpoints and auto-resume,
    mirroring the JAX ``Trainer`` (the reference recipe,
    ``conf/config_calvin.yaml``: bf16, 1000 train and 4 validation batches
    per epoch, 20 epochs, rollouts every 5).

    ``bf16_full_state``: parameters, gradients, Adam moments and EMA in
    bf16 with stochastic-rounded parameter updates (no f32 master copy).
    ``auto_layout`` is accepted and does nothing (module docstring).
    Runs on CUDA unless ``device="cpu"`` (the agent's device)."""

    def __init__(self, agent, *, log_dir: str = "runs/default",
                 max_epochs: int = 20, limit_train_batches: int = 1000,
                 limit_val_batches: int = 4, rollout_freq: int = 5,
                 optimizer_kwargs: Optional[dict] = None,
                 ema_kwargs: Optional[dict] = None,
                 checkpoint_kwargs: Optional[dict] = None,
                 use_wandb: bool = False,
                 rollout_callback: Optional[Callable] = None,
                 preprocess_fn: Optional[Callable] = None,
                 monitor: str = "eval_lh/avg_seq_len",
                 auto_layout: bool = False,
                 bf16_full_state: bool = False, device="cuda"):
        self.agent = agent
        self.device = _check_device(agent, device)
        self.max_epochs = max_epochs
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.rollout_freq = rollout_freq
        self.logger = MetricLogger(log_dir, use_wandb=use_wandb)
        ckpt_kwargs = dict(checkpoint_kwargs or {})
        ckpt_kwargs.setdefault("monitor", monitor)
        self.ckpt = CheckpointManager(os.path.join(log_dir, "saved_models"),
                                      **ckpt_kwargs)
        self.rollout_callback = rollout_callback
        self.preprocess_fn = preprocess_fn
        self.optimizer_kwargs = optimizer_kwargs or {}
        self.ema_kwargs = ema_kwargs or {}
        self.auto_layout = auto_layout
        self.bf16_full_state = bf16_full_state
        self._optimizer = None
        self._schedule = None
        self._train_step = None
        self._preempted = False
        self.resumed = False

    def setup(self, seed: Optional[int] = None) -> TrainState:
        """The optimizer, the train state of the agent's parameters (its
        generator seeded with ``seed``, default the config's), the train
        step; then auto-resume from the newest checkpoint."""
        agent = self.agent
        opt_kwargs = dict(self.optimizer_kwargs)
        state_dtypes = {}
        if self.bf16_full_state:
            opt_kwargs.setdefault("stochastic_round", True)
            opt_kwargs.setdefault("sr_noise", "hw")
            state_dtypes = dict(param_dtype=torch.bfloat16,
                                ema_dtype=torch.bfloat16)
        self._optimizer, self._schedule = make_optimizer(
            dict(agent.named_parameters()), **opt_kwargs)
        gen = torch.Generator(device=self.device).manual_seed(
            agent.cfg.seed if seed is None else seed)
        state = TrainState.create(agent, self._optimizer, gen,
                                  **state_dtypes)
        self._train_step = make_train_step(agent, self._optimizer,
                                           ema_kwargs=self.ema_kwargs,
                                           preprocess_fn=self.preprocess_fn,
                                           device=self.device)
        latest = self.ckpt.latest_step()
        if latest is not None:
            logger.info("auto-resuming from checkpoint step %d", latest)
            state = self.ckpt.restore(state)
            self.resumed = True
        return state

    def fit(self, state: TrainState, train_iter_fn: Callable[[], Iterable],
            val_iter_fn: Optional[Callable[[], Iterable]] = None
            ) -> TrainState:
        """``train_iter_fn()`` (or ``train_iter_fn(epoch)``) -> iterable of
        host batches per epoch.

        A SIGTERM during the run (preemption) lets the batch in flight
        finish, writes a checkpoint at that boundary and returns; the next
        ``setup`` resumes from it. The handler chains to the previous one
        and is restored even if ``fit`` raises."""
        self._preempted = False
        prev = signal.getsignal(signal.SIGTERM)

        def on_sigterm(signum, frame):
            logger.warning("SIGTERM: checkpointing at the next batch "
                           "boundary, then leaving fit()")
            self._preempted = True
            if callable(prev):
                try:
                    prev(signum, frame)
                except SystemExit:
                    # a chained cleanup handler that ends in SystemExit:
                    # its cleanup ran; the exit waits for the checkpoint
                    pass

        installed = False
        try:
            signal.signal(signal.SIGTERM, on_sigterm)
            installed = True
        except ValueError:     # not the main thread
            pass
        try:
            return self._fit_inner(state, train_iter_fn, val_iter_fn)
        finally:
            if installed:
                signal.signal(signal.SIGTERM,
                              prev if prev is not None else signal.SIG_DFL)

    def _fit_inner(self, state, train_iter_fn, val_iter_fn):
        from ..utils.utils import device_memory_stats
        agent = self.agent
        for epoch in range(state.epoch, self.max_epochs):
            t0 = time.time()
            n = 0
            expert_counts = None
            for batch in _call_iter(train_iter_fn, epoch):
                if n >= self.limit_train_batches:
                    break
                batch = shard_batch(batch, self.device)
                state, metrics = self._train_step(state, batch)
                n += 1
                ec = metrics.pop("expert_counts", None)
                if ec is not None:
                    expert_counts = ec if expert_counts is None \
                        else expert_counts + ec
                if n % 100 == 0 or n == 1:
                    host = {k: v for k, v in metrics.items()}
                    host["train/lr"] = float(self._schedule(state.step))
                    self.logger.log(host, state.step)
                if self._preempted:
                    break
            if self._preempted:
                self.ckpt.save(state.step, state, {"train/preempted": 1.0})
                logger.warning("preemption checkpoint saved at step %d; "
                               "auto-resume will continue this run",
                               state.step)
                break
            dt = time.time() - t0
            epoch_metrics = {"train/epoch_time_s": dt,
                             "train/steps_per_s": n / max(dt, 1e-9)}
            epoch_metrics.update(device_memory_stats(self.device))
            if expert_counts is not None:
                usage = expert_counts.double().cpu().numpy()
                usage = usage / np.maximum(usage.sum(axis=1, keepdims=True),
                                           1)
                epoch_metrics["MoE_utils/expert_usage"] = usage.round(4)
            if val_iter_fn is not None:
                val_losses = []
                with swapped_in(agent, state.eval_variables()):
                    for i, batch in enumerate(_call_iter(val_iter_fn,
                                                         epoch)):
                        if i >= self.limit_val_batches:
                            break
                        batch = shard_batch(batch, self.device)
                        gen = torch.Generator(device=self.device) \
                            .manual_seed(epoch)
                        _, m = agent.validation_denoise(batch, gen)
                        val_losses.append(
                            float(m["val_act/lang_act_loss_pp"]))
                if val_losses:
                    epoch_metrics["val_act/lang_act_loss_pp"] = float(
                        np.mean(val_losses))
            if (self.rollout_callback is not None
                    and (epoch + 1) % self.rollout_freq == 0):
                epoch_metrics.update(self.rollout_callback(
                    agent, state.eval_variables(), epoch))
            self.logger.log(epoch_metrics, state.step)
            state.epoch = epoch + 1
            self.ckpt.save(state.step, state, epoch_metrics)
            logger.info("epoch %d done in %.1fs: %s", epoch, dt,
                        epoch_metrics)
        return state
