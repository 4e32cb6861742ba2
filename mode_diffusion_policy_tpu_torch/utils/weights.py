"""Load the JAX package's parameter tree into the port's modules.

The port keeps the JAX tree's names and layouts (dense kernels [in, out],
stacked experts), so the mapping is by path: ``blocks_{i}`` becomes
``blocks.{i}``, and a 4-d conv ``kernel`` (HWIO) becomes the OIHW
``weight`` (an int8 ``kernel_q`` stays ``kernel_q``, turned OIHW).
Encoder BatchNorm statistics come from the ``batch_stats`` collection.
``from_jax_train_state`` carries a whole JAX ``TrainState`` (parameters,
statistics, ``FusedAdamWEmaState`` moments, EMA, step, epoch) into the
port's. Every model variant's leaves cross by the same rules: the shared
expert (``shared_w1``/``shared_b1``/``shared_w2``), the cross-attention
(``ln_3``, ``cross_att`` with its ``wq`` and ``wkv``), the proprio
embedding ``state_embed``, the scratch encoder's ``film_module{s}.fc`` and
``fc``, and the ResNet-18/34 trunks with their ``batch_stats``. A JAX tree
made by ``init`` has no ``state_embed`` (the JAX forward never calls it, so
flax never creates it): the port's own stays then, as it was drawn. Leaves are numpy arrays (``jax.tree.map(np.asarray, ...)``; bf16
leaves as ml_dtypes bfloat16); this module imports no JAX.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def dit_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``MoDeDiT`` params -> ``models.modedit.MoDeDiT`` state dict."""
    return {re.sub(r"^blocks_(\d+)\.", r"blocks.\1.", k):
            torch.from_numpy(np.array(v, np.float32))
            for k, v in _flatten(params).items()}


# leaves of the port that a JAX tree may lack (see the module docstring)
OPTIONAL_LEAVES = ("state_embed.kernel",)


def load_dit_state_(dit, sd: Mapping[str, torch.Tensor]):
    """``dit.load_state_dict(sd)``, where only the ``OPTIONAL_LEAVES`` may
    be missing from ``sd``."""
    missing, unexpected = dit.load_state_dict(sd, strict=False)
    bad = [k for k in missing if k not in OPTIONAL_LEAVES]
    if bad or unexpected:
        raise RuntimeError(f"the weights do not fit the port's MoDeDiT: "
                           f"missing {bad}, unexpected {unexpected}")
    return dit


def load_dit_(dit, params: Mapping):
    """Load JAX ``MoDeDiT`` params into the port's ``dit``
    (``load_dit_state_``)."""
    return load_dit_state_(dit, dit_state_dict(params))


def resnet_state_dict(params: Mapping, batch_stats: Mapping
                      ) -> Dict[str, torch.Tensor]:
    """JAX encoder params + batch_stats (``FiLMResNetPolicy`` at any depth,
    or ``ResNetEncoderWithFiLM``) -> the unfolded port encoder's state
    dict."""
    sd = {}
    for k, v in {**_flatten(params), **_flatten(batch_stats)}.items():
        v = np.array(v, np.float32)
        if k.endswith(".kernel") and v.ndim == 4:
            k, v = k[: -len("kernel")] + "weight", v.transpose(3, 2, 0, 1)
        sd[k] = torch.from_numpy(np.ascontiguousarray(v))
    return sd


def q8_resnet_state_dict(q8_params: Mapping) -> Dict[str, torch.Tensor]:
    """One encoder of a JAX ``q8_encoder_params`` collection (the output of
    ``quantize_resnet_params``) -> the state dict of the port's ``q8``
    ``FiLMResNetPolicy``: ``kernel_q`` from HWIO to OIHW int8, float convs
    that the quantizer skipped from HWIO ``kernel`` to OIHW ``weight``, and
    ``scale``, ``bias``, ``act_scale`` and the FiLM denses copied in f32."""
    sd = {}
    for k, v in _flatten(q8_params).items():
        if k.endswith(".kernel_q"):
            v = np.ascontiguousarray(np.asarray(v, np.int8).transpose(3, 2, 0, 1))
        else:
            v = np.array(v, np.float32)
            if k.endswith(".kernel") and v.ndim == 4:
                k, v = k[: -len("kernel")] + "weight", v.transpose(3, 2, 0, 1)
            v = np.ascontiguousarray(v)
        sd[k] = torch.from_numpy(v)
    return sd


def load_q8_encoders(agent, q8_encoder_params: Mapping):
    """Install a JAX ``q8_encoder_params`` collection ({encoder: tree}) as
    the agent's int8 encoders (``MoDEAgent.set_q8_encoders_``)."""
    from ..models.agent import ENCODERS

    return agent.set_q8_encoders_({
        name: {k: v.to(agent.device) for k, v in
               q8_resnet_state_dict(q8_encoder_params[name]).items()}
        for name in ENCODERS})


def from_jax_params(variables: Mapping, cfg, *, device="cuda"):
    """Build a ``MoDEAgent`` for ``cfg`` holding the weights of a JAX
    ``MoDEAgent.init_variables``-style tree (``params`` with
    ``inner_model``/``static_resnet``/``gripper_resnet``, and
    ``batch_stats``)."""
    from ..models.agent import ENCODERS, MoDEAgent

    agent = MoDEAgent(cfg, device=device)
    load_dit_(agent.inner_model, variables["params"]["inner_model"])
    for name in ENCODERS:
        getattr(agent, name).load_state_dict(resnet_state_dict(
            variables["params"][name], variables["batch_stats"][name]))
    return agent


def port_name(path: str, ndim: int) -> str:
    """The port's name of a JAX leaf path (``inner_model.blocks_0.x`` ->
    ``inner_model.blocks.0.x``; a 4-d conv ``kernel`` -> ``weight``)."""
    path = re.sub(r"^inner_model\.blocks_(\d+)\.", r"inner_model.blocks.\1.",
                  path)
    if path.endswith(".kernel") and ndim == 4:
        path = path[: -len("kernel")] + "weight"
    return path


def port_tensor(v, ndim_rule=True) -> torch.Tensor:
    """A numpy leaf (f32, or ml_dtypes bfloat16) as a tensor of the same
    dtype; 4-d conv kernels HWIO -> OIHW."""
    a = np.asarray(v)
    bf16 = a.dtype.name == "bfloat16"
    a = a.astype(np.float32)
    if ndim_rule and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if bf16 else t


def port_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``params``-like tree (``inner_model``, ``static_resnet``,
    ``gripper_resnet``) -> {port name: tensor}."""
    return {port_name(k, np.ndim(v)): port_tensor(v)
            for k, v in _flatten(tree).items()}


def from_jax_train_state(state, cfg, *, device="cuda"):
    """(agent, TrainState) of the port holding a JAX ``TrainState`` (numpy
    leaves): the agent's parameters in the state's dtype, the encoders'
    running statistics, the ``FusedAdamWEmaState`` count and moments, the
    EMA weights, step and epoch. The port's state has the ``FusedAdamWEma``
    flat layout (its optimizer's, with the JAX config's decay mask), and a
    generator seeded with ``cfg.seed`` (a JAX key has no torch
    counterpart). A ``FusedAdamWEma`` from ``make_optimizer`` updates it
    as it is (the update reads the layout from ``state.params``)."""
    from ..models.agent import MoDEAgent
    from ..training.optim import FusedAdamWEmaState, decay_mask, FlatLayout
    from ..training.state import TrainState, encoder_batch_stats

    variables = {"params": state.params, "batch_stats": state.batch_stats}
    agent = from_jax_params(variables, cfg, device=device)
    dev = agent.device
    params = port_tree(state.params)
    named = dict(agent.named_parameters())
    # a leaf the JAX tree lacks (OPTIONAL_LEAVES) keeps the port's value,
    # zero moments and itself as its EMA
    own = {n: p.detach().clone() for n, p in named.items()
           if n not in params}
    with torch.no_grad():
        for n, p in named.items():
            p.data = params.get(n, own.get(n)).to(dev)
    layout = FlatLayout(named, decay_mask(named))
    flat_params = layout.flatten_params_(named)
    opt = state.opt_state

    def flat(tree, fill):
        t = port_tree(tree)
        # in the dtype of the tree's other DiT kernels
        dt = t["inner_model.sigma_linear.kernel"].dtype
        t.update({n: fill(v.to(dt)) for n, v in own.items()})
        return layout.new(dev, lambda g: t[g.names[0]].dtype,
                          init={n: v.to(dev) for n, v in t.items()})

    ts = TrainState(step=int(np.asarray(state.step)), params=flat_params,
                    batch_stats=encoder_batch_stats(agent),
                    opt_state=FusedAdamWEmaState(
                        int(np.asarray(opt.count)),
                        flat(opt.mu, torch.zeros_like),
                        flat(opt.nu, torch.zeros_like)),
                    ema_params=flat(state.ema_params, lambda v: v),
                    rng=torch.Generator(device=dev).manual_seed(cfg.seed),
                    epoch=int(np.asarray(state.epoch)))
    return agent, ts


def from_jax_clip_text(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPTextModel`` params (numpy leaves) -> the port's
    ``models.encoders.clip_text.CLIPTextModel`` state dict: ``resblocks_{i}``
    becomes ``resblocks.{i}``, a dense ``kernel`` [in, out] the
    ``nn.Linear`` ``weight`` [out, in], a LayerNorm ``scale`` its
    ``weight``."""
    sd = {}
    for k, v in _flatten(params).items():
        k = re.sub(r"^resblocks_(\d+)\.", r"resblocks.\1.", k)
        v = np.array(v, np.float32)
        if k.endswith(".kernel"):
            k, v = k[: -len("kernel")] + "weight", v.T
        elif k.endswith(".scale"):
            k = k[: -len("scale")] + "weight"
        sd[k] = torch.from_numpy(np.ascontiguousarray(v))
    return sd
