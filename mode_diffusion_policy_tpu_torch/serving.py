"""Serving-mode presets (counterpart of ``mode_diffusion_policy_tpu/serving.py``).

Ported presets:

- ``reference``       the plain PyTorch graph (no kernels): per-step top-2
                      gather of the bf16/f32 experts.
- ``parity``          int8 experts + the whole-layer CUDA kernel
                      (``ops/kernels/layer_kernel.fused_layer_q8c``) +
                      BN-folded encoders.
- ``b1-latency``      ``parity`` with the whole 12-layer block stack in ONE
                      launch per denoise step (the DiT megakernel,
                      ``ops/kernels/layer_kernel.fused_dit_q8c``): the
                      one-robot latency preset.
- ``b1-latency-max``  ``b1-latency`` with int8 attention projections inside
                      the megakernel (per-row activation quant). The JAX
                      package documents it as over the parity budget:
                      validate on the task before serving.
- ``max-throughput``  int8 attention projections on the two-kernel layer
                      (``ops/kernels/attn_kernel.fused_attn_block_q8``, then
                      ``ops/kernels/moe_kernel.fused_top2_mlp_q8c`` with ln_2
                      and the residual) + int8 encoder convs, their
                      activation scales calibrated on ``calib_batch`` (or
                      dynamic without one). The JAX package documents it as
                      over the parity budget: validate on the task before
                      serving.
- ``auto``            ``parity`` when the agent lives on CUDA, else
                      ``reference``.

The four kernel presets set ``use_pallas_attn`` and ``use_pallas_moe``, as
the JAX presets do (the int8 MoE of ``use_int8_moe`` takes precedence over
the bf16 one): a sampler's off-schedule evaluation (step index -1, which
routes inline) runs each layer's attention sub-block as one kernel launch,
``ops/kernels/attn_kernel.fused_attn_block`` (bf16 projections: ``parity``,
``b1-latency``) or ``fused_attn_block_q8`` (``max-throughput``,
``b1-latency-max``), with one cond row per sample.

Each preset's flags are derived from the agent's config exactly as the JAX
function derives them (``preset_flags``): the MoE kernels where the router
picks two routed experts, the attention kernels where the head dim is a
multiple of 128, the whole-layer kernel (and the megakernel) only without
an identity or shared expert and without cross-attention. A model outside
a kernel's shapes keeps that part on the plain path, with the JAX
function's warnings.
"""
from __future__ import annotations

import logging

from .models.agent import MoDEAgentConfig

logger = logging.getLogger(__name__)

SERVING_MODES = ("reference", "parity", "max-throughput", "b1-latency",
                 "b1-latency-max", "auto")

# the flags `reference` sets: every kernel off
REFERENCE_FLAGS = dict(use_int8_moe=False, use_pallas_moe=False,
                       use_pallas_attn=False, use_fused_layer=False,
                       use_int8_attn=False, use_megakernel=False)


def preset_flags(cfg, mode: str, warn: bool = False) -> dict:
    """The kernel flags of serving preset ``mode`` for the agent config
    ``cfg`` (``models.agent.MoDEAgentConfig``), as JAX
    ``serving.apply_serving_mode`` computes them; with ``warn``, its two
    warnings for a model outside the kernels' shapes."""
    if mode == "reference":
        return dict(REFERENCE_FLAGS)
    head_dim = cfg.latent_dim // cfg.n_heads
    fusable_attn = head_dim % 128 == 0
    routed_k = cfg.top_k - (1 if cfg.use_shared_expert else 0)
    top2 = routed_k == 2
    fused_layer = (top2 and fusable_attn and not cfg.identity_expert
                   and not cfg.use_shared_expert
                   and not cfg.use_cross_attention)
    flags = dict(use_pallas_moe=top2, use_int8_moe=top2,
                 use_pallas_attn=fusable_attn)
    if mode in ("b1-latency", "b1-latency-max"):
        flags.update(use_int8_attn=mode == "b1-latency-max" and fusable_attn,
                     use_fused_layer=fused_layer, use_megakernel=fused_layer)
    else:
        flags.update(use_int8_attn=mode == "max-throughput" and fusable_attn,
                     use_fused_layer=fused_layer and mode != "max-throughput",
                     use_megakernel=False)
    if warn and not top2:
        logger.warning("serving mode %s: routed top-k=%d outside the fused "
                       "top-2 kernel: MoE stays on the plain gather path",
                       mode, routed_k)
    if warn and not fusable_attn and not mode.startswith("b1-latency"):
        logger.warning("serving mode %s: head_dim=%d not a multiple of 128: "
                       "attention stays on the plain path", mode, head_dim)
    return flags


# each preset's flags at the flagship config (MoDEAgentConfig's defaults:
# head dim 128, top-2 of 4 experts, no shared or identity expert, no
# cross-attention), where every kernel takes the model
PRESET_FLAGS = {mode: preset_flags(MoDEAgentConfig(), mode)
                for mode in SERVING_MODES if mode != "auto"}


def resolve_serving_mode(mode: str, device_type: str = "cuda") -> str:
    if mode not in SERVING_MODES:
        raise ValueError(f"unknown serving mode {mode!r}; pick one of "
                         f"{SERVING_MODES}")
    if mode == "auto":
        return "parity" if device_type == "cuda" else "reference"
    return mode


def apply_serving_mode(agent, mode: str, *, calib_batch=None):
    """Reconfigure ``agent`` (a ``models.agent.MoDEAgent``) for a serving
    mode, in place, and return it. Call after loading weights: the folded
    and int8 encoders, the int8 weights and the megakernel's layer stack
    are derived from the current weights. A second preset may be applied to
    the same agent: the int8 weights are always quantized from the f32
    values, and only ``max-throughput`` keeps int8 encoders.
    ``calib_batch`` (a dict with 'rgb_static'/'rgb_gripper' [B,T,H,W,3],
    preprocessed, and 'lang_emb') calibrates the int8 encoders' static
    activation scales for ``max-throughput``; without it they use dynamic
    per-call scales. The flags come from ``preset_flags``: a model that a
    kernel cannot take keeps that part on the plain path."""
    mode = resolve_serving_mode(mode, agent.device.type)
    agent.configure_(**preset_flags(agent.cfg, mode, warn=True))
    agent.q8 = None
    if mode == "reference":
        agent.folded = None        # the plain encoders, as the JAX preset
    else:
        agent.fold_encoders_for_inference()
    agent.quantize_for_inference()
    if mode == "max-throughput":
        if calib_batch is None:
            logger.warning("max-throughput without calib_batch: int8 "
                           "encoders use dynamic activation scales (pass a "
                           "representative batch to calibrate)")
        agent.quantize_encoders_for_inference(calib_batch=calib_batch)
    return agent
