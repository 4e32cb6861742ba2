"""MoDEAgent (inference) and RolloutPolicy, in PyTorch.

Counterpart of ``mode_diffusion_policy_tpu/models/agent.py``. The JAX agent
is a set of pure functions over a caller-held variables tree; here the agent
is an ``nn.Module`` that owns its weights, and the serving transforms
(``fold_encoders_for_inference``, ``quantize_for_inference``,
``precast_for_serving``) update it in place rather than returning a new tree.
The precast keeps the f32 weights as masters beside their casts, so that
every quantization reads the f32 values, as the JAX package's does.

Served paths (``RolloutPolicy`` under a serving preset): camera frames ->
2x BN-folded FiLM-ResNet-50 (int8 convs under ``max-throughput``) ->
per-sigma top-2 routing tables -> hoisted chunk invariants (static tokens,
sigma tokens, EDM scalings) -> the configured sampler (``sampler_type``,
``num_sampling_steps`` on the ``noise_scheduler`` ladder from
``sigma_max`` to ``sigma_min``; 10-step DDIM by default) over
``MoDeDiT.forward_precomputed``, one whole-layer kernel launch per layer
and step (``parity``) or two (the attention and MoE kernels,
``max-throughput``), or over ``MoDeDiT.forward_precomputed_mega``, one
launch of the DiT megakernel per step (``b1-latency``, ``b1-latency-max``).
A sampler's off-schedule evaluations (step index -1) route and embed
inline; under the kernel presets their attention sub-blocks are still one
kernel launch per layer (``fused_attn_block``, or ``fused_attn_block_q8``
with int8 projections).

Without a preset, the bf16 kernel configuration
(``MoDEAgentConfig(use_pallas_moe=True, use_pallas_attn=True)``, the JAX
bench's ``BENCH_INT8=0`` flag set) runs per layer and step the attention
kernel ``fused_attn_block`` and the bf16 MoE kernel ``fused_top2_mlp``
over the policy's precast bf16 weights.

The policy precasts its own copy of the agent (``RolloutPolicy``): the
caller's parameters stay f32 and untouched, as the JAX policy's "training
state is untouched".
"""
from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import resolve_device
from .edm.precond import denoiser_forward, edm_scalings
from .edm.samplers import sample_loop
from .edm.schedules import get_noise_schedule
from .encoders.resnet import (FiLMResNetPolicy, calibration_stats,
                              fold_resnet_params, infer_q8_skip,
                              quantize_resnet_params)
from .modedit import MoDeDiT, MoDeDiTConfig

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MoDEAgentConfig:
    """The inference fields of the JAX ``MoDEAgentConfig``."""

    latent_dim: int = 1024
    multistep: int = 10
    sampler_type: str = "ddim"
    num_sampling_steps: int = 10
    sigma_data: float = 0.5
    sigma_min: float = 0.001
    sigma_max: float = 80.0
    noise_scheduler: str = "exponential"
    cond_dim: int = 512
    resnet_type: str = "50"
    act_window_size: int = 10
    action_dim: int = 7
    obs_seq_len: int = 1
    goal_seq_len: int = 1
    n_layers: int = 12
    n_heads: int = 8
    num_experts: int = 4
    top_k: int = 2
    seed: int = 42
    dtype: Any = torch.float32
    use_pallas_moe: bool = False
    use_int8_moe: bool = False
    use_pallas_attn: bool = False
    use_fused_layer: bool = False
    use_int8_attn: bool = False
    use_megakernel: bool = False

    @property
    def obs_dim(self) -> int:
        return 2048                  # FiLM-ResNet-50 feature dim

    def dit_config(self) -> MoDeDiTConfig:
        return MoDeDiTConfig(
            obs_dim=self.obs_dim, goal_dim=self.cond_dim,
            action_dim=self.action_dim, embed_dim=self.latent_dim,
            n_layers=self.n_layers, n_heads=self.n_heads,
            goal_seq_len=self.goal_seq_len, obs_seq_len=self.obs_seq_len,
            action_seq_len=self.act_window_size,
            num_experts=self.num_experts, top_k=self.top_k, dtype=self.dtype,
            use_int8_moe=self.use_int8_moe,
            use_pallas_moe=self.use_pallas_moe,
            use_pallas_attn=self.use_pallas_attn,
            use_fused_layer=self.use_fused_layer,
            use_int8_attn=self.use_int8_attn,
            use_megakernel=self.use_megakernel)


ENCODERS = ("static_resnet", "gripper_resnet")


def _clip_candidates(calib, headroom: float = 1.0):
    """(label, clips) candidates for the int8 encoder activation clips, from
    the calibration statistics ``calib`` ({conv: {act_amax, act_msq}},
    ``encoders.resnet.calibration_stats``), as the JAX package builds them:

    - ``amax``: the per-channel maxima (no clipping);
    - ``amax*q``: fractional amax, q in 0.9, 0.8, 0.7;
    - ``k*sigma``: min(amax, k * per-channel RMS), k in 3, 3.5, 4.

    Each clips dict is {conv: {"act_amax": clip}}, clamped at 1e-6 after
    ``headroom``. The caller picks the winner by final-feature MSE."""

    def build(fn):
        out = {}
        for name, st in calib.items():
            amax = st["act_amax"].float()
            msq = st.get("act_msq", amax ** 2).float()
            out[name] = {"act_amax": (fn(amax, msq) * headroom)
                         .clamp_min(1e-6)}
        return out

    cands = [("amax", lambda a, m: a)]
    for qf in (0.9, 0.8, 0.7):
        cands.append((f"amax*{qf}", lambda a, m, qf=qf: a * qf))
    for k in (3.0, 3.5, 4.0):
        cands.append((f"{k}*sigma",
                      lambda a, m, k=k: torch.minimum(a, k * torch.sqrt(m))))
    return [(label, build(fn)) for label, fn in cands]


class MoDEAgent(nn.Module):
    """The DiT denoiser plus two FiLM-ResNet-50 camera encoders, with
    seeded random weights (``utils/weights.from_jax_params`` loads a JAX
    parameter tree instead)."""

    def __init__(self, cfg: MoDEAgentConfig, *, device="cuda"):
        super().__init__()
        if cfg.resnet_type != "50":
            raise NotImplementedError(
                f"resnet_type {cfg.resnet_type!r} is not ported yet; only "
                "the FiLM-ResNet-50 encoders are (ROADMAP.md Queue 1)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.inner_model = MoDeDiT(cfg.dit_config(), self.device)
        for name in ENCODERS:
            self.add_module(name, FiLMResNetPolicy(
                cfg.cond_dim, 50, cfg.dtype, device=self.device))
        self.folded = None   # nn.ModuleDict of BN-folded encoders, once built
        self.q8 = None       # nn.ModuleDict of int8 encoders, once built
        self.q8_clips = {}   # the calibrated clip label of each int8 encoder
        self.q8_clip_mse = {}  # and the feature MSE of every candidate
        self.sigmas = get_noise_schedule(cfg.num_sampling_steps,
                                         cfg.noise_scheduler, cfg.sigma_min,
                                         cfg.sigma_max)
        self.init_weights_(cfg.seed)

    @torch.no_grad()
    def init_weights_(self, seed: int):
        """Seeded random weights, drawn on the agent's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.inner_model.init_weights_(gen)
        for name in ENCODERS:
            for p in getattr(self, name).parameters():
                if p.ndim == 4:    # conv OIHW: lecun normal
                    fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                    p.normal_(0.0, fan_in ** -0.5, generator=gen)

    def configure_(self, **fields):
        """Replace config fields in place: the kernel flags
        (``use_int8_moe``, ``use_pallas_moe``, ``use_pallas_attn``,
        ``use_fused_layer``, ``use_int8_attn``, ``use_megakernel``; a flag
        whose path needs another is inert without it, as in the JAX
        package), on the agent and on every DiT module that reads them, and
        the sampler's (``sampler_type``,
        ``num_sampling_steps``, ``sigma_min``, ``sigma_max``,
        ``noise_scheduler``), which rebuild the sigma schedule."""
        self.cfg = cfg = dataclasses.replace(self.cfg, **fields)
        dit_cfg = cfg.dit_config()
        for m in self.inner_model.modules():
            if isinstance(getattr(m, "cfg", None), MoDeDiTConfig):
                m.cfg = dit_cfg
        self.sigmas = get_noise_schedule(cfg.num_sampling_steps,
                                         cfg.noise_scheduler, cfg.sigma_min,
                                         cfg.sigma_max)
        return self

    @torch.no_grad()
    def fold_encoders_for_inference(self):
        """Fold the encoder BatchNorms into their convs and rewrite the 7x7/2
        stems as 4x4/1 convs over a space-to-depth input (exact rewrites).
        ``embed_visual_obs`` then prefers the folded encoders."""
        folded = {}
        for name in ENCODERS:
            mod = FiLMResNetPolicy(self.cfg.cond_dim, 50, self.cfg.dtype,
                                   folded=True, device=self.device)
            mod.load_state_dict(fold_resnet_params(
                getattr(self, name).state_dict()))
            folded[name] = mod
        self.folded = nn.ModuleDict(folded)
        return self

    def _encoder(self, folded=False, q8=False, q8_skip=()):
        return FiLMResNetPolicy(self.cfg.cond_dim, 50, self.cfg.dtype,
                                folded=folded, q8=q8, q8_skip=q8_skip,
                                device=self.device)

    def set_q8_encoders_(self, state_dicts: Dict[str, Dict[str, torch.Tensor]]):
        """Install int8 encoders from ``quantize_resnet_params`` state dicts
        ({encoder: state dict}): static activation scales when the dicts
        carry ``act_scale``, dynamic ones otherwise, and the float stages
        that the dicts kept (``infer_q8_skip``)."""
        q8 = {}
        for name in ENCODERS:
            sd = state_dicts[name]
            static = any(k.endswith(".act_scale") for k in sd)
            mod = self._encoder(True, "static" if static else True,
                                infer_q8_skip(sd))
            mod.load_state_dict(sd)
            q8[name] = mod
        self.q8 = nn.ModuleDict(q8)
        return self

    @torch.no_grad()
    def quantize_encoders_for_inference(self, calib_batch=None,
                                        headroom: float = 1.0, skip=()):
        """int8-quantize the folded encoder convs (per-output-channel int8
        weights, per-tensor or per-input-channel activation scales; see
        ``encoders.resnet.QuantConv``). ``embed_visual_obs`` then prefers
        these encoders.

        Without ``calib_batch`` the activation scales are dynamic (max |x|
        of each call's whole tensor, so the result depends on the batch).
        With ``calib_batch`` (a dict with 'rgb_static', 'rgb_gripper'
        [B,T,H,W,3], preprocessed, and 'lang_emb') the static
        per-input-channel clips are chosen per encoder, among the seven
        ``_clip_candidates``, by the final-feature MSE against the folded
        float encoder on that batch; the chosen label is logged and kept in
        ``q8_clips``, every candidate's MSE in ``q8_clip_mse``. Counterpart
        of the JAX agent's method of that name."""
        if self.folded is None:
            self.fold_encoders_for_inference()
        skip = tuple(skip)
        folded = {name: self.folded[name].state_dict() for name in ENCODERS}
        q = {name: quantize_resnet_params(folded[name], skip=skip)
             for name in ENCODERS}
        self.q8_clips, self.q8_clip_mse = {}, {}
        if calib_batch is None:
            return self.set_q8_encoders_(q)
        cond = torch.as_tensor(calib_batch["lang_emb"], device=self.device)
        cond = cond[:, 0] if cond.ndim == 3 else cond
        dyn = self._encoder(True, True, skip)
        static = self._encoder(True, "static", skip)
        for name, key in zip(ENCODERS, ("rgb_static", "rgb_gripper")):
            imgs = torch.as_tensor(calib_batch[key], device=self.device)
            T = imgs.shape[1]
            x = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
            # the images flatten to B*T rows: the FiLM cond follows
            cond_rep = cond.repeat_interleave(T, dim=0) if T > 1 else cond
            ref = self.folded[name](x, cond_rep).float()
            dyn.load_state_dict(q[name])
            calib = calibration_stats(dyn, lambda: dyn(x, cond_rep))
            best = None
            self.q8_clip_mse[name] = {}
            for label, clips in _clip_candidates(calib, headroom):
                qp = quantize_resnet_params(folded[name], act_amax=clips,
                                            skip=skip)
                static.load_state_dict(qp)
                mse = float(((static(x, cond_rep).float() - ref) ** 2).mean())
                self.q8_clip_mse[name][label] = mse
                if best is None or mse < best[0]:
                    best = (mse, label, qp)
            ref_sq = float((ref ** 2).mean())
            logger.info("int8 calibration %s: clip=%s, feature rel err %.4f",
                        name, best[1], (best[0] / max(ref_sq, 1e-12)) ** 0.5)
            self.q8_clips[name] = best[1]
            q[name] = best[2]
        return self.set_q8_encoders_(q)

    @torch.no_grad()
    def quantize_for_inference(self):
        """(Re)build the int8 experts (``cfg.use_int8_moe``) and attention
        projections (``cfg.use_int8_attn``, with or without int8 experts)
        from the f32 weights (the masters, after a serving precast), and the
        megakernel's layer stack when the megakernel runs
        (``MoDeDiTConfig.megakernel``, with or without
        ``use_fused_layer``); call after loading weights."""
        dit = self.inner_model
        dit.stacked = None
        for blk in dit.blocks:
            blk.experts_q = blk.experts_qt = None
            blk.attn.attn_q = blk.attn.attn_qt = None
        if self.cfg.use_int8_moe:
            dit.quantize_experts_()
        if self.cfg.use_int8_attn:
            dit.quantize_attn_()
        if dit.cfg.megakernel:
            dit.stack_layers_()
        return self

    @torch.no_grad()
    def precast_for_serving(self):
        """Cast the DiT matmul weights to the compute dtype once (in place,
        keeping the f32 masters: ``MoDeDiT.precast_``); bit-identical to
        casting per use."""
        if self.cfg.dtype != torch.float32:
            self.inner_model.precast_(self.cfg.dtype)
        return self

    @torch.no_grad()
    def embed_visual_obs(self, rgb_static, rgb_gripper, latent_goal):
        """rgb_*: preprocessed [B, T, H, W, 3] NHWC; latent_goal [B,1,cond] or
        [B,cond]. Returns {'state_images': [B, 2T, obs_dim]}. Runs the
        int8 encoders when built, else the folded ones, else the raw."""
        B, T = rgb_static.shape[:2]
        cond = latent_goal[:, 0] if latent_goal.ndim == 3 else latent_goal
        cond_rep = cond.repeat_interleave(T, dim=0) if T > 1 else cond
        feats = []
        for name, imgs in zip(ENCODERS, (rgb_static, rgb_gripper)):
            mod = (self.q8[name] if self.q8 is not None
                   else self.folded[name] if self.folded is not None
                   else getattr(self, name))
            x = imgs.reshape((B * T,) + tuple(imgs.shape[2:]))
            feats.append(mod(x, cond_rep).reshape(B, T, -1))
        return {"state_images": torch.cat(feats, dim=1)}

    @torch.no_grad()
    def precompute_routing(self, sigmas: Optional[np.ndarray] = None):
        """Per-layer top-2 routing tables over the scheduled sigmas (the
        trailing 0 excluded)."""
        if sigmas is None:
            sigmas = self.sigmas[:-1]
        s = torch.as_tensor(np.asarray(sigmas, np.float32), device=self.device)
        return self.inner_model.precompute_routing(s)

    def make_denoiser(self, perceptual_emb, latent_goal,
                      routing=None) -> Callable:
        """``denoiser(x, sigma_vec, step_idx)`` for the samplers. With
        ``routing`` the camera/goal tokens, the per-step sigma tokens and the
        EDM scalings are computed once per chunk, and each step runs
        ``MoDeDiT.forward_precomputed`` with the step's routing row, or,
        where the megakernel runs (``MoDeDiTConfig.megakernel``: the JAX
        agent's conditions on ``use_megakernel``),
        ``forward_precomputed_mega`` over the cached layer stack and the
        [L,S,2] tables stacked once per chunk.
        A negative ``step_idx`` is off the schedule: that call routes and
        embeds inline at its own sigma, as without ``routing``."""
        cfg = self.cfg
        dit = self.inner_model

        def inline(x, sigma, step_idx):
            return denoiser_forward(dit, perceptual_emb, x, latent_goal,
                                    sigma, sigma_data=cfg.sigma_data)

        if routing is None:
            return inline

        sched = torch.as_tensor(self.sigmas[:-1], device=self.device)
        static_x, goal_embed = dit.embed_static_tokens(perceptual_emb,
                                                       latent_goal)
        emb_all = dit.process_sigma_embeddings(sched)              # [S,1,D]
        scal_all = torch.stack(edm_scalings(sched, cfg.sigma_data), dim=1)
        mega = None
        if dit.cfg.megakernel:
            # the megakernel's shapes hold (int8 top-2 experts, head dim a
            # multiple of 128)
            if dit.stacked is None:
                raise RuntimeError("the megakernel's layer stack is missing: "
                                   "call MoDEAgent.quantize_for_inference()")
            mega = (dit.stacked, torch.stack([i for i, _ in routing]),
                    torch.stack([p for _, p in routing]))

        def denoiser(x, sigma, step_idx):
            if int(step_idx) < 0:
                return inline(x, sigma, step_idx)
            cs, co, ci = scal_all[step_idx]
            emb_t = emb_all[step_idx][None]
            if mega is not None:
                pred = dit.forward_precomputed_mega(
                    static_x, goal_embed, emb_t, x * ci, *mega, step_idx)
            else:
                overrides = [(idx, p, step_idx) for idx, p in routing]
                pred = dit.forward_precomputed(
                    static_x, goal_embed, emb_t, x * ci,
                    moe_overrides=overrides)
            return pred.float() * co + x * cs

        return denoiser

    @torch.no_grad()
    def denoise_actions(self, perceptual_emb, latent_goal, *,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None,
                        use_routing_precompute: bool = False,
                        extra_args: Optional[dict] = None,
                        noise_fn: Optional[Callable] = None):
        """Sample one action chunk [B, act_window, action_dim] with
        ``cfg.sampler_type`` over the agent's schedule. ``noise`` (unit
        normal, [B, act_window, action_dim]) overrides the initial draw from
        ``generator``; it is scaled by ``sigma_max``. ``extra_args`` are the
        sampler's options (``samplers.sample_loop``); a stochastic sampler
        draws from ``noise_fn(x)`` when given, else from ``generator``."""
        cfg = self.cfg
        B = latent_goal.shape[0]
        if noise is None:
            noise = torch.randn(B, cfg.act_window_size, cfg.action_dim,
                                generator=generator, device=self.device)
        x = noise.to(self.device, torch.float32) * cfg.sigma_max
        routing = self.precompute_routing() if use_routing_precompute else None
        denoiser = self.make_denoiser(perceptual_emb, latent_goal, routing)
        return sample_loop(cfg.sampler_type, denoiser, x, self.sigmas,
                           generator, extra_args, noise_fn=noise_fn)


def _serving_copy(agent: MoDEAgent) -> MoDEAgent:
    """A copy of ``agent`` that a serving precast may cast without reaching
    the caller: every parameter of the copy is a new ``Parameter`` over the
    caller's storage (the precast rebinds the copy's ``.data`` to a cast
    tensor and keeps the caller's f32 tensor as its master), and the
    buffers and the derived int8 tensors are shared, not copied. So the
    copy costs only the cast tensors, as the in-place precast did."""
    memo = {id(p): nn.Parameter(p.data, requires_grad=p.requires_grad)
            for p in agent.parameters()}
    dit = agent.inner_model
    shared = list(agent.buffers()) + list(dit._f32_masters.values())
    shared += list((dit.stacked or {}).values())
    for blk in dit.blocks:
        for q in (blk.experts_q, blk.experts_qt, blk.attn.attn_q,
                  blk.attn.attn_qt):
            shared += list(q or ())
    memo.update({id(t): t for t in shared})
    return copy.deepcopy(agent, memo)


class RolloutPolicy:
    """Chunked inference for env stepping: ``step(obs, goal)`` returns one
    action [B, action_dim] per call; the model runs once every
    ``multistep`` calls and produces an action chunk.

    The policy serves its own copy of the agent (``self.agent``), precast
    to the compute dtype; the caller's agent keeps its f32 parameters. It
    samples with the agent's ``sampler_type`` and schedule, passing
    ``extra_args`` (the sampler's options) to every chunk; stochastic
    samplers draw from ``self.generator``."""

    def __init__(self, agent: MoDEAgent, lang_encoder=None,
                 use_routing_precompute: bool = True, seed: int = 0,
                 extra_args: Optional[dict] = None):
        # the precast keeps the f32 masters (the caller's tensors), so the
        # copy can still be re-quantized from the f32 weights
        self.agent = _serving_copy(agent).precast_for_serving()
        self.lang = lang_encoder   # callable: list[str] -> [B,1,cond]
        self.multistep = agent.cfg.multistep
        self.generator = torch.Generator(device=agent.device).manual_seed(seed)
        self.use_routing_precompute = use_routing_precompute
        self.extra_args = dict(extra_args or {})
        self._counter = 0
        self._chunk = None

    @classmethod
    def with_serving_mode(cls, agent: MoDEAgent, lang_encoder=None,
                          mode: str = "auto", *, calib_batch=None, **kw):
        """Apply a serving preset (``serving.apply_serving_mode``, with
        ``calib_batch`` for the int8 encoders of ``max-throughput``) to the
        agent, in place (flags, folded and int8 weights; no parameter
        changes), and build the policy on it."""
        from ..serving import apply_serving_mode
        return cls(apply_serving_mode(agent, mode, calib_batch=calib_batch),
                   lang_encoder, **kw)

    def reset(self):
        self._counter = 0
        self._chunk = None

    @torch.no_grad()
    def predict_chunk(self, obs: Dict[str, Any], goal: Dict[str, Any],
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One action chunk [B, act_window, action_dim] for preprocessed
        camera frames ``obs['rgb_static'|'rgb_gripper']`` [B,T,H,W,3] and a
        goal (``lang_emb`` [B,1,cond], or ``lang_text`` with a lang
        encoder)."""
        ag = self.agent
        dev = ag.device
        if "lang_text" in goal:
            text = goal["lang_text"]
            lang_emb = self.lang([text] if isinstance(text, str) else text)
        else:
            lang_emb = goal["lang_emb"]
        lang_emb = torch.as_tensor(lang_emb, device=dev)
        emb = ag.embed_visual_obs(torch.as_tensor(obs["rgb_static"], device=dev),
                                  torch.as_tensor(obs["rgb_gripper"], device=dev),
                                  lang_emb)
        return ag.denoise_actions(
            emb, lang_emb, generator=self.generator, noise=noise,
            use_routing_precompute=self.use_routing_precompute,
            extra_args=self.extra_args)

    def step(self, obs: Dict[str, Any], goal: Dict[str, Any],
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self._counter % self.multistep == 0:
            self._chunk = self.predict_chunk(obs, goal, noise)
            self._counter = 0
        action = self._chunk[:, self._counter]
        self._counter += 1
        if self._counter == self.multistep:
            self._counter = 0
        return action
