"""Reference PyTorch checkpoints -> the port's parameters (counterpart of
``mode_diffusion_policy_tpu/utils/checkpoint_convert.py``).

Maps the reference MoDE state dicts (Lightning ``.ckpt``, raw ``.pt``, or
the published ``model_cleaned.safetensors``) straight onto the port's
parameter names, which are the JAX tree's (``models/modedit.py``,
``models/encoders/resnet.py``): linear ``weight`` tensors are transposed to
[in, out] kernels, the per-expert FFN weights are stacked along a leading
expert axis, the per-head q/k/v projections fused into one qkv kernel; conv
weights stay OIHW. Every converted tensor is f32 on the CPU.

Every reference option converts: a shared expert (``shared_mlp``), block
cross-attention (``cross_att`` and ``ln_3``), the proprio embedding
(``state_embed``), an identity expert (no weights: ``num_experts`` counts
the experts with weights), and the scratch ``ResNetEncoderWithFiLM``
encoders (``style="scratch"``) beside the ``FiLMResNet{18,34,50}Policy``
ones. ``safetensors`` is imported only for a ``.safetensors`` file or directory.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

# the reference's own prefix remaps for published checkpoints
_PREFIX_REMAPS = {
    "img_encoder_image_wrist.": "gripper_resnet.",
    "img_encoder_image_secondary.": "static_resnet.",
    "img_encoder_image_primary.": "static_resnet.",
    "net.": "gripper_resnet.resnet.",
}


def _t(v) -> torch.Tensor:
    """A CPU tensor of a tensor or array (its dtype kept)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


def _f32(v) -> torch.Tensor:
    return _t(v).to(torch.float32).contiguous()


def normalize_state_dict(state_dict: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """Apply the reference's historical key remaps and drop the CLIP
    towers."""
    out = {}
    for key, val in state_dict.items():
        if "visual" in key or "clip" in key.lower():
            continue
        for old, new in _PREFIX_REMAPS.items():
            if key.startswith(old):
                key = key.replace(old, new, 1)
                break
        out[key] = _t(val)
    return out


def convert_modedit(state_dict: Mapping[str, Any], n_layers: int,
                    num_experts: int, prefix: str = "model.inner_model.",
                    ) -> Dict[str, torch.Tensor]:
    """The reference MoDeDiT's weights as a ``models.modedit.MoDeDiT``
    state dict.

    Reference module paths:
      {p}sigma_emb / sigma_linear / tok_emb / goal_emb / action_emb / pos_emb
      {p}blocks.{i}.ln_1.g, .attn.{query,key,value,c_proj}, .attn.{q,k}_norm.g
      {p}blocks.{i}.router.router.mlp.{0,3}
      {p}blocks.{i}.experts.expert_{e}.mlp.{0.project,2}
      {p}ln.g, {p}out
    """
    sd = state_dict
    p = prefix
    out: Dict[str, torch.Tensor] = {}

    def dense(src: str, dst: str, bias: bool = True):
        out[f"{dst}.kernel"] = _f32(sd[f"{src}.weight"]).T.contiguous()
        if bias and f"{src}.bias" in sd:
            out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])

    dense(f"{p}sigma_emb", "sigma_emb")
    dense(f"{p}sigma_linear", "sigma_linear", bias=False)
    dense(f"{p}tok_emb", "tok_emb", bias=False)
    dense(f"{p}goal_emb", "goal_emb", bias=False)
    dense(f"{p}action_emb", "action_emb", bias=False)
    if f"{p}state_embed.weight" in sd:
        dense(f"{p}state_embed", "state_embed", bias=False)
    out["pos_emb"] = _f32(sd[f"{p}pos_emb"])
    out["ln.g"] = _f32(sd[f"{p}ln.g"])
    dense(f"{p}out", "out")
    for i in range(n_layers):
        for k, v in convert_block(sd, f"{p}blocks.{i}.", num_experts).items():
            out[f"blocks.{i}.{k}"] = v
    return out


def convert_block(sd: Mapping[str, Any], b: str,
                  num_experts: int) -> Dict[str, torch.Tensor]:
    """One reference NoiseBlockMoE's weights (key prefix ``b``) as the
    port's block state dict; ``num_experts`` counts the MLP experts (not
    the shared or an identity expert, which are outside the
    ``expert_{e}`` keys)."""

    def T(key):
        return _f32(sd[b + key]).T.contiguous()

    qkv = ("query", "key", "value")
    blk = {
        "ln_1.g": _f32(sd[b + "ln_1.g"]),
        "ln_2.g": _f32(sd[b + "ln_2.g"]),
        # the reference's separate query/key/value Linears, fused
        "attn.wqkv.kernel": torch.cat([T(f"attn.{n}.weight") for n in qkv],
                                      dim=1),
        "attn.wqkv.bias": torch.cat([_f32(sd[b + f"attn.{n}.bias"])
                                     for n in qkv]),
        "attn.c_proj.kernel": T("attn.c_proj.weight"),
        "attn.q_norm.g": _f32(sd[b + "attn.q_norm.g"]),
        "attn.k_norm.g": _f32(sd[b + "attn.k_norm.g"]),
        "router.mlp.fc1.kernel": T("router.router.mlp.0.weight"),
        "router.mlp.fc1.bias": _f32(sd[b + "router.router.mlp.0.bias"]),
        "router.mlp.fc2.kernel": T("router.router.mlp.3.weight"),
        "router.mlp.fc2.bias": _f32(sd[b + "router.router.mlp.3.bias"]),
    }
    # stacked experts (the reference Mlp: SwishGLU.project + out Linear)
    e = range(num_experts)
    blk["experts_w1"] = torch.stack(
        [T(f"experts.expert_{i}.mlp.0.project.weight") for i in e])
    blk["experts_b1"] = torch.stack(
        [_f32(sd[b + f"experts.expert_{i}.mlp.0.project.bias"]) for i in e])
    blk["experts_w2"] = torch.stack(
        [T(f"experts.expert_{i}.mlp.2.weight") for i in e])
    if b + "cross_att.query.weight" in sd:
        # block cross-attention: its own q kernel, k and v fused over the
        # context
        blk.update({
            "cross_att.wq.kernel": T("cross_att.query.weight"),
            "cross_att.wq.bias": _f32(sd[b + "cross_att.query.bias"]),
            "cross_att.wkv.kernel": torch.cat(
                [T(f"cross_att.{n}.weight") for n in ("key", "value")],
                dim=1),
            "cross_att.wkv.bias": torch.cat(
                [_f32(sd[b + f"cross_att.{n}.bias"])
                 for n in ("key", "value")]),
            "cross_att.c_proj.kernel": T("cross_att.c_proj.weight"),
            "cross_att.q_norm.g": _f32(sd[b + "cross_att.q_norm.g"]),
            "cross_att.k_norm.g": _f32(sd[b + "cross_att.k_norm.g"]),
            "ln_3.g": _f32(sd[b + "ln_3.g"])})
    if b + "shared_mlp.mlp.0.project.weight" in sd:
        blk["shared_w1"] = T("shared_mlp.mlp.0.project.weight")
        blk["shared_b1"] = _f32(sd[b + "shared_mlp.mlp.0.project.bias"])
        blk["shared_w2"] = T("shared_mlp.mlp.2.weight")
    return blk


def detect_layout(state_dict: Mapping[str, Any]):
    """Infer (n_layers, num_experts, prefix) from a reference state dict."""
    keys = list(state_dict.keys())
    prefix = ""
    for k in keys:
        m = re.match(r"(.*?)blocks\.0\.ln_1\.g$", k)
        if m:
            prefix = m.group(1)
            break
    layers = set()
    experts = set()
    for k in keys:
        m = re.match(re.escape(prefix) + r"blocks\.(\d+)\.", k)
        if m:
            layers.add(int(m.group(1)))
        m = re.match(re.escape(prefix)
                     + r"blocks\.\d+\.experts\.expert_(\d+)\.", k)
        if m:
            experts.add(int(m.group(1)))
    return (max(layers) + 1 if layers else 0,
            max(experts) + 1 if experts else 0, prefix)


_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def extract_ema_state_dict(ckpt: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The Lightning state dict with its trained weights replaced by the EMA
    weights of the callback state.

    The reference EMA callback stores ``ema_weights`` as a bare list of
    tensors in ``model.named_parameters()`` order, and its eval loader zips
    them back onto the parameter names. torch's state_dict emits each
    module's parameters before its buffers, so the parameter order is the
    state_dict's keys without the buffers (BatchNorm running statistics,
    ``num_batches_tracked``)."""
    sd = {k: _t(v) for k, v in ckpt["state_dict"].items()}
    ema_list = ckpt["callbacks"]["EMA"]["ema_weights"]
    param_names = [k for k in sd if not k.endswith(_BUFFER_SUFFIXES)]
    if len(param_names) != len(ema_list):
        raise ValueError(
            f"EMA weight count {len(ema_list)} != parameter count "
            f"{len(param_names)}: cannot align ema_weights to names")
    out = dict(sd)
    for name, w in zip(param_names, ema_list):
        out[name] = _t(w)
    return out


def load_lightning_checkpoint(path: str, use_ema: bool = True,
                              ) -> Dict[str, torch.Tensor]:
    """A Lightning ``.ckpt`` as a state dict, with the EMA weights of its
    callback state swapped in when present (and ``use_ema``)."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    if use_ema and "ema_weights" in data.get("callbacks", {}).get("EMA", {}):
        return extract_ema_state_dict(data)
    return {k: _t(v) for k, v in data["state_dict"].items()}


def _safetensors_load(path: str) -> Dict[str, torch.Tensor]:
    try:
        from safetensors.torch import load_file
    except ImportError as e:
        raise ImportError(f"reading {path} needs the 'safetensors' package, "
                          "which is not installed") from e
    return dict(load_file(path))


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A Lightning ``.ckpt``, a raw ``.pt`` or a safetensors file (or a
    directory holding ``model_cleaned.safetensors`` or
    ``model.safetensors``) as a state dict of CPU tensors."""
    if os.path.isdir(path):
        for cand in ("model_cleaned.safetensors", "model.safetensors"):
            f = os.path.join(path, cand)
            if os.path.exists(f):
                return _safetensors_load(f)
        raise FileNotFoundError(f"no safetensors found in {path}")
    if path.endswith(".safetensors"):
        return _safetensors_load(path)
    data = torch.load(path, map_location="cpu", weights_only=False)
    sd = data.get("state_dict", data) if isinstance(data, dict) else data
    return {k: _t(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# FiLM-ResNet encoders
# ---------------------------------------------------------------------------

def encoder_kwargs(resnet_type) -> Dict[str, Any]:
    """``convert_film_resnet``'s depth and style for the agent's
    ``resnet_type``: the policy encoder at depth 34 or 50, else the scratch
    ResNet-18 (``encoders.resnet.make_encoder`` picks the port's
    encoder the same way)."""
    if str(resnet_type) in ("34", "50"):
        return {"depth": int(resnet_type), "style": "policy"}
    return {"depth": 18, "style": "scratch"}


def convert_film_resnet(state_dict: Mapping[str, Any], depth: int,
                        prefix: str = "", style: str = "policy"
                        ) -> Dict[str, torch.Tensor]:
    """The reference camera encoder's weights as the state dict of the
    port's unfolded encoder. ``style="policy"``: a
    ``FiLMResNet{18,34,50}Policy`` (a timm backbone under
    ``{prefix}resnet.``, ``{prefix}film{1..4}``) as ``FiLMResNetPolicy``;
    ``style="scratch"``: a ``ResNetEncoderWithFiLM`` (the backbone at
    ``{prefix}``, ``{prefix}film_module{1..4}.modulation.1`` and the head
    ``{prefix}fc``) as the port's ``ResNetEncoderWithFiLM``. BatchNorm
    ``weight``/``bias``/``running_mean``/``running_var`` become
    ``scale``/``bias``/``mean``/``var``, Linears [in, out] kernels, convs
    stay OIHW."""
    if style not in ("policy", "scratch"):
        raise ValueError(f"style must be 'policy' or 'scratch', got "
                         f"{style!r}")
    sd = state_dict
    out: Dict[str, torch.Tensor] = {}
    stage_sizes = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}[depth]
    n_convs = 3 if depth == 50 else 2
    bb = f"{prefix}resnet." if style == "policy" else prefix

    def bn(src: str, dst: str):
        for a, b in (("weight", "scale"), ("bias", "bias"),
                     ("running_mean", "mean"), ("running_var", "var")):
            out[f"{dst}.{b}"] = _f32(sd[f"{src}.{a}"])

    def dense(src: str, dst: str):
        out[f"{dst}.kernel"] = _f32(sd[f"{src}.weight"]).T.contiguous()
        out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])

    out["resnet.conv1.weight"] = _f32(sd[f"{bb}conv1.weight"])
    bn(f"{bb}bn1", "resnet.bn1")
    for s, n_blocks in enumerate(stage_sizes):
        for i in range(n_blocks):
            src = f"{bb}layer{s + 1}.{i}."
            dst = f"resnet.layer{s + 1}_{i}."
            for c in range(1, n_convs + 1):
                out[f"{dst}conv{c}.weight"] = _f32(sd[f"{src}conv{c}.weight"])
                bn(f"{src}bn{c}", f"{dst}bn{c}")
            if f"{src}downsample.0.weight" in sd:
                out[f"{dst}downsample_conv.weight"] = _f32(
                    sd[f"{src}downsample.0.weight"])
                bn(f"{src}downsample.1", f"{dst}downsample_bn")
    if style == "policy":
        for s in range(1, 5):
            for part in ("gamma", "beta"):
                dense(f"{prefix}film{s}.{part}", f"film{s}_{part}")
    else:
        for s in range(1, 5):
            dense(f"{prefix}film_module{s}.modulation.1",
                  f"film_module{s}.fc")
        if f"{prefix}fc.weight" in sd:
            dense(f"{prefix}fc", "fc")
    return out
