"""The training state (counterpart of
``mode_diffusion_policy_tpu/training/state.py``): parameters, BatchNorm
running statistics, optimizer state, EMA weights, the step and epoch
counters and the random stream, in one object.

The JAX state is a pytree of arrays; here the parameters are the agent's
own ``nn.Parameter`` objects (by name; with ``FusedAdamWEma`` they are
views into flat buffers, see ``training.optim.FlatLayout``), the batch
statistics the encoders' BatchNorm buffers, and the random stream one
``torch.Generator`` on the agent's device, where JAX carries a key.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch

from ..models.encoders.resnet import BatchNorm
from .optim import FusedAdamWEma


def encoder_batch_stats(agent) -> Dict[str, torch.Tensor]:
    """The running statistics of the agent's raw encoders, by buffer name
    (``static_resnet.resnet.bn1.mean`` ...)."""
    from ..models.agent import ENCODERS
    out = {}
    for name in ENCODERS:
        for mname, m in getattr(agent, name).named_modules():
            if isinstance(m, BatchNorm):
                out[f"{name}.{mname}.mean"] = m.mean
                out[f"{name}.{mname}.var"] = m.var
    return out


@dataclasses.dataclass
class TrainState:
    step: int
    params: Mapping[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: Any
    ema_params: Mapping[str, torch.Tensor]
    rng: torch.Generator
    # completed epochs, advanced by the Trainer so that a resume restarts
    # at the right epoch
    epoch: int = 0
    # gradient buffers the backward pass accumulates into (made by the
    # train step; not checkpointed)
    grads: Optional[Mapping[str, torch.Tensor]] = None

    @classmethod
    def create(cls, agent, optimizer, rng: torch.Generator, *,
               ema_dtype: Optional[torch.dtype] = None,
               param_dtype: Optional[torch.dtype] = None) -> "TrainState":
        """The state of ``agent``'s parameters. ``param_dtype=torch.bfloat16``
        stores the parameters themselves in bf16, in place (pair it with
        the optimizer's ``stochastic_round=True``); ``ema_dtype`` stores the
        EMA weights in that dtype (a copy of the parameters either way).
        With ``FusedAdamWEma`` the parameters move into the optimizer's
        flat groups (still the agent's parameters, now views)."""
        agent.check_trainable()
        params = dict(agent.named_parameters())
        if param_dtype is not None:
            with torch.no_grad():
                for p in params.values():
                    p.data = p.data.to(param_dtype)
        dev = next(iter(params.values())).device
        if isinstance(optimizer, FusedAdamWEma):
            opt_state = optimizer.init(params, flatten=True)
            params = optimizer.params
            ema = optimizer.layout.new(
                dev, lambda g: ema_dtype or g.dtype, init=params)
        else:
            opt_state = optimizer.init(params)
            ema = {n: p.detach().to(ema_dtype or p.dtype, copy=True)
                   for n, p in params.items()}
        return cls(step=0, params=params,
                   batch_stats=encoder_batch_stats(agent),
                   opt_state=opt_state, ema_params=ema, rng=rng, epoch=0)

    def eval_variables(self, use_ema: bool = True) -> Dict[str, Mapping]:
        """Variables for validation and rollouts: the EMA weights by default
        (``conf/callbacks/calvin.yaml``: evaluate_ema_weights_instead)."""
        return {"params": self.ema_params if use_ema else self.params,
                "batch_stats": self.batch_stats}

    def train_variables(self) -> Dict[str, Mapping]:
        return {"params": self.params, "batch_stats": self.batch_stats}


@contextlib.contextmanager
def swapped_in(agent, variables: Mapping[str, Mapping[str, torch.Tensor]]):
    """Run the agent on ``variables`` (``{'params': ..., 'batch_stats':
    ...}`` by name, e.g. ``TrainState.eval_variables()``) for the duration:
    each parameter's and buffer's data is swapped for the given tensor
    (no copy; another dtype is fine, the modules cast where they compute)
    and swapped back afterwards."""
    saved = []
    named = dict(agent.named_parameters())
    named.update(agent.named_buffers())
    with torch.no_grad():
        for coll in ("params", "batch_stats"):
            for n, t in variables.get(coll, {}).items():
                tgt = named[n]
                if tgt is t:
                    continue
                saved.append((tgt, tgt.data))
                tgt.data = t.detach()
    try:
        yield agent
    finally:
        with torch.no_grad():
            for tgt, data in saved:
                tgt.data = data
