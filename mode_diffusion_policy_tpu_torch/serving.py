"""Serving-mode presets (counterpart of ``mode_diffusion_policy_tpu/serving.py``).

Ported presets:

- ``reference``  the plain PyTorch graph (no kernels): per-step top-2 gather
                 of the bf16/f32 experts.
- ``parity``     int8 experts + the whole-layer CUDA kernel
                 (``ops/kernels/layer_kernel.fused_layer_q8c``) + BN-folded
                 encoders.
- ``auto``       ``parity`` when the agent lives on CUDA, else ``reference``.

``max-throughput``, ``b1-latency`` and ``b1-latency-max`` need kernels that
are not ported yet; they raise ``NotImplementedError`` rather than run
another path.
"""
from __future__ import annotations

SERVING_MODES = ("reference", "parity", "max-throughput", "b1-latency",
                 "b1-latency-max", "auto")

UNPORTED_MODES = {
    "max-throughput": "attn_kernel.fused_attn_block_q8 (int8 attention "
                      "projections) and moe_kernel.fused_top2_mlp_q8c, plus "
                      "the int8 encoder convs",
    "b1-latency": "layer_kernel.fused_dit_q8c (the 12-layer megakernel)",
    "b1-latency-max": "layer_kernel.fused_dit_q8c with int8 attention "
                      "projections",
}


def resolve_serving_mode(mode: str, device_type: str = "cuda") -> str:
    if mode not in SERVING_MODES:
        raise ValueError(f"unknown serving mode {mode!r}; pick one of "
                         f"{SERVING_MODES}")
    if mode == "auto":
        return "parity" if device_type == "cuda" else "reference"
    return mode


def apply_serving_mode(agent, mode: str):
    """Reconfigure ``agent`` (a ``models.agent.MoDEAgent``) for a serving
    mode, in place, and return it. Call after loading weights: the folded
    encoders and the int8 experts are derived from the current weights."""
    mode = resolve_serving_mode(mode, agent.device.type)
    if mode in UNPORTED_MODES:
        raise NotImplementedError(
            f"serving mode {mode!r} needs {UNPORTED_MODES[mode]}, not ported "
            "to CUDA yet (ROADMAP.md Queue 2)")
    if mode == "reference":
        return agent
    cfg = agent.cfg
    if (cfg.latent_dim // cfg.n_heads) % 128 or cfg.top_k != 2:
        raise NotImplementedError(
            "parity serving outside the whole-layer kernel's shapes (head "
            "dim a multiple of 128, top-2 routing) needs the attention and "
            "MoE kernels, not ported yet (ROADMAP.md Queue 2)")
    agent.configure_(use_int8_moe=True, use_fused_layer=True)
    agent.fold_encoders_for_inference()
    agent.quantize_for_inference()
    return agent
