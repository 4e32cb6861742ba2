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
"""
from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

SERVING_MODES = ("reference", "parity", "max-throughput", "b1-latency",
                 "b1-latency-max", "auto")

# presets with no port yet: {mode: what they need} (none left)
UNPORTED_MODES = {}

# config flags of each preset, the JAX package's flag map: use_pallas_moe
# and use_int8_moe on for the four kernel presets (the int8 MoE takes
# precedence, so the bf16 MoE kernel runs on none of them), and
# use_pallas_attn, where the attention sub-block outside the fused layer
# (the samplers' off-schedule evaluations, the two-kernel layer) is one
# kernel launch; `reference` turns every flag off
PRESET_FLAGS = {
    "reference": dict(use_int8_moe=False, use_pallas_moe=False,
                      use_pallas_attn=False, use_fused_layer=False,
                      use_int8_attn=False, use_megakernel=False),
    "parity": dict(use_int8_moe=True, use_pallas_moe=True,
                   use_pallas_attn=True, use_fused_layer=True,
                   use_int8_attn=False, use_megakernel=False),
    "max-throughput": dict(use_int8_moe=True, use_pallas_moe=True,
                           use_pallas_attn=True, use_fused_layer=False,
                           use_int8_attn=True, use_megakernel=False),
    "b1-latency": dict(use_int8_moe=True, use_pallas_moe=True,
                       use_pallas_attn=True, use_fused_layer=True,
                       use_int8_attn=False, use_megakernel=True),
    "b1-latency-max": dict(use_int8_moe=True, use_pallas_moe=True,
                           use_pallas_attn=True, use_fused_layer=True,
                           use_int8_attn=True, use_megakernel=True),
}


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
    per-call scales."""
    mode = resolve_serving_mode(mode, agent.device.type)
    if mode in UNPORTED_MODES:
        raise NotImplementedError(
            f"serving mode {mode!r} needs {UNPORTED_MODES[mode]}, not ported "
            "to CUDA yet (ROADMAP.md Queue 2)")
    cfg = agent.cfg
    if mode != "reference" and ((cfg.latent_dim // cfg.n_heads) % 128
                                or cfg.top_k != 2):
        raise NotImplementedError(
            f"{mode} serving outside the fused kernels' shapes (head dim a "
            "multiple of 128, top-2 routing) needs the attention and MoE "
            "kernels, not ported yet (ROADMAP.md Queue 2)")
    agent.configure_(**PRESET_FLAGS[mode])
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
