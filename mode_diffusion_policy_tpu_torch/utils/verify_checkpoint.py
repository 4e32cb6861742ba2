"""Published-checkpoint fidelity harness (counterpart of
``mode_diffusion_policy_tpu/utils/verify_checkpoint.py``).

One command that converts a published PyTorch MoDE checkpoint (safetensors
directory, Lightning ``.ckpt`` or raw ``.pt``), rebuilds the same model
twice, the reference implementation (loaded as an oracle from
``--reference-repo``, never imported by the runtime) and the port's agent
through ``checkpoint_convert``, runs identical fixed inputs through a
ladder of checks and prints each one's MAE against its gate (the
action-chunk gate is the fidelity target, rel_action MAE <= 1e-3):

- ``encoder/<camera>``: the port's ``FiLMResNetPolicy`` against the
  torchvision-layout ``TorchFiLMResNetPolicy`` (``utils/torch_oracles``)
  on the checkpoint's encoder weights, in f32;
- ``dit/forward``: one DiT forward at a fixed sigma against the
  reference's;
- ``e2e/ddim_chunk (rel_action)``: a whole 10-step DDIM chunk against the
  reference's sampler;
- ``e2e/routing_precompute``: the agent's routing-precompute fast path
  against its dense path, in f32 (gate 1e-5);
- on CUDA, ``e2e/routing_precompute (parity)``: the ``parity`` serving
  preset (bf16, int8 experts, the whole-layer kernel on the fast path)
  against the f32 dense path, report-only: that is the preset's own
  approximation, which ``chip_smoke.py`` holds kernel-against-plain;
- with ``--int8-encoders``: the int8 encoders (``max-throughput``'s,
  calibrated on the check's frames) feature by feature against the torch
  encoders, and their chunk against the reference's, report-only unless
  ``--int8-tolerance`` is given.

The port's side runs on ``--device`` (CUDA unless ``cpu`` is asked for);
TF32 is off while the checks run. ``check_encoders`` and
``check_routing`` need no reference repo. Usage:

    python -m mode_diffusion_policy_tpu_torch.utils.verify_checkpoint \\
        --checkpoint <MoDE_CALVIN_D dir | .ckpt | .pt> \\
        --reference-repo <the reference repo, holding mode/> \\
        [--clip ViT-B-32.pt] \\
        [--tolerance 1e-3] [--image-size 112] [--out report.json]
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import logging
import sys
import types
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

GATE_DEFAULT = 1e-3
ROUTING_GATE = 1e-5
ENCODERS = ("static_resnet", "gripper_resnet")


# ---------------------------------------------------------------------------
# reference-repo oracle loading (file-path imports with stubs for the heavy
# unused dependencies)
# ---------------------------------------------------------------------------

def _stub(name, **attrs):
    if name not in sys.modules:
        mod = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(mod, k, v)
        sys.modules[name] = mod


def _load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reference_stack(reference_repo: str):
    """(modedit, score_wrappers, gc_sampling) torch modules from the
    reference repo, with stubs for torchsde/torchdiffeq/tqdm/hydra."""
    root = Path(reference_repo)
    if not (root / "mode").exists():
        raise FileNotFoundError(
            f"--reference-repo {reference_repo} has no mode/ package")
    _stub("torchsde", BrownianTree=object)
    _stub("torchdiffeq", odeint=lambda *a, **k: None)

    class _T:
        def __init__(self, it=None, total=None, disable=None):
            self.it = it

        def __iter__(self):
            return iter(self.it)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def update(self, *a):
            pass

    _stub("tqdm", trange=lambda n, disable=None: _T(range(n)),
          tqdm=lambda *a, **k: _T(*a))
    _stub("tqdm.auto", trange=lambda n, disable=None: _T(range(n)),
          tqdm=lambda *a, **k: _T(*a))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        _stub("matplotlib", pyplot=None)
        _stub("matplotlib.pyplot")
    if "hydra" not in sys.modules:
        hydra = types.ModuleType("hydra")
        hydra.utils = types.ModuleType("hydra.utils")
        hydra.utils.instantiate = lambda x: x
        sys.modules["hydra"] = hydra
        sys.modules["hydra.utils"] = hydra.utils

    edm = root / "mode" / "models" / "edm_diffusion"
    pkg = types.ModuleType("vck_refedm")
    pkg.__path__ = [str(edm)]
    sys.modules["vck_refedm"] = pkg
    for name in ("utils", "score_wrappers", "gc_sampling"):
        spec = importlib.util.spec_from_file_location(
            f"vck_refedm.{name}", edm / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[f"vck_refedm.{name}"] = mod
        spec.loader.exec_module(mod)
    modedit = _load_file_module(
        root / "mode" / "models" / "networks" / "modedit.py", "vck_modedit")
    return (modedit, sys.modules["vck_refedm.score_wrappers"],
            sys.modules["vck_refedm.gc_sampling"])


# ---------------------------------------------------------------------------
# model-shape inference from the state dict
# ---------------------------------------------------------------------------

def infer_dit_shape(sd, prefix: str) -> Dict[str, int]:
    """The MoDeDiT hyperparameters from weight shapes (torch Linear
    weights are [out, in]; the reference module paths of
    ``convert_modedit``)."""
    p = prefix
    D = sd[f"{p}ln.g"].shape[-1]
    head_dim = sd[f"{p}blocks.0.attn.q_norm.g"].shape[-1]
    seq = sd[f"{p}pos_emb"].shape[1]
    return {
        "embed_dim": int(D),
        "obs_dim": int(sd[f"{p}tok_emb.weight"].shape[1]),
        "goal_dim": int(sd[f"{p}goal_emb.weight"].shape[1]),
        "action_dim": int(sd[f"{p}action_emb.weight"].shape[1]),
        "n_heads": int(D // head_dim),
        # seq_size = goal_seq_len + obs_seq_len - 1 + action_seq_len;
        # published checkpoints use goal/obs seq len 1
        "action_seq_len": int(seq - 1),
    }


def infer_resnet_depth(sd, enc: str = "static_resnet") -> Optional[int]:
    if f"{enc}.resnet.conv1.weight" not in sd:
        return None
    if f"{enc}.resnet.layer1.0.conv3.weight" in sd:
        return 50
    return 34 if f"{enc}.resnet.layer1.2.conv1.weight" in sd else 18


def _sub_state_dict(sd, prefix: str) -> Dict[str, torch.Tensor]:
    """The entries under ``prefix``, the prefix cut, as new CPU tensors."""
    return {k[len(prefix):]: (v.detach().cpu().clone()
                              if isinstance(v, torch.Tensor)
                              else torch.tensor(np.array(v)))
            for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

class Report:
    def __init__(self, tolerance: float):
        self.tolerance = tolerance
        self.rows = []

    def add(self, module: str, mae: float, gate: Optional[float] = None,
            note: str = ""):
        gate = self.tolerance if gate is None else gate
        ok = bool(mae <= gate)
        self.rows.append({"module": module, "mae": float(mae),
                          "gate": float(gate), "pass": ok, "note": note})
        print(f"  {module:<28s} MAE {mae:.3e}  gate {gate:.0e}  "
              f"{'PASS' if ok else 'FAIL'}{('  ' + note) if note else ''}")
        return ok

    @property
    def ok(self):
        return all(r["pass"] for r in self.rows)

    def to_json(self):
        return {"pass": self.ok, "tolerance": self.tolerance,
                "modules": self.rows}


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32 on the card for the duration (matmuls and
    cuDNN convolutions), the previous settings restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _mae(a, b) -> float:
    return float((torch.as_tensor(a).double().cpu()
                  - torch.as_tensor(b).double().cpu()).abs().mean())


@torch.no_grad()
def check_encoders(report: Report, sd, depth: int, goal: torch.Tensor,
                   images: Dict[str, torch.Tensor], device, *,
                   agent=None, int8_tolerance: Optional[float] = None
                   ) -> Dict[str, torch.Tensor]:
    """The encoder rung: each camera's port ``FiLMResNetPolicy`` (the
    checkpoint's policy-style weights through ``convert_film_resnet``)
    against the torch ``TorchFiLMResNetPolicy`` on the same weights,
    images (NCHW [B,3,H,W]) and goal ([B,1,goal_dim]), in f32 on
    ``device``. With ``agent`` (whose encoders then take these weights),
    also the int8 encoders of ``max-throughput``, calibrated on these
    frames, feature by feature (report-only unless ``int8_tolerance``).
    Returns the torch encoders' features by camera (on ``device``)."""
    from ..models.encoders.resnet import FiLMResNetPolicy
    from .checkpoint_convert import convert_film_resnet
    from .torch_oracles import TorchFiLMResNetPolicy

    goal_dim = goal.shape[-1]
    feats, nhwc = {}, {}
    for enc in ENCODERS:
        tenc = TorchFiLMResNetPolicy(goal_dim, depth=depth)
        missing, _ = tenc.load_state_dict(_sub_state_dict(sd, f"{enc}."),
                                          strict=False)
        if missing:
            raise ValueError(f"{enc} weights missing: {sorted(missing)[:8]}")
        tenc = tenc.to(device).eval()
        conv = convert_film_resnet(sd, depth=depth, prefix=f"{enc}.",
                                   style="policy")
        mod = FiLMResNetPolicy(goal_dim, depth=depth, device=device)
        mod.load_state_dict(conv)
        img = images[enc].to(device)
        t_feat = tenc(img, goal.to(device))
        nhwc[enc] = img.permute(0, 2, 3, 1).contiguous()
        p_feat = mod(nhwc[enc], goal[:, 0].to(device))
        report.add(f"encoder/{enc}", _mae(p_feat, t_feat))
        feats[enc] = t_feat
        if agent is not None:
            getattr(agent, enc).load_state_dict(conv)
    if agent is not None:
        calib = {"rgb_static": nhwc["static_resnet"][:, None],
                 "rgb_gripper": nhwc["gripper_resnet"][:, None],
                 "lang_emb": goal.to(device)}
        agent.fold_encoders_for_inference()
        agent.quantize_encoders_for_inference(calib_batch=calib)
        emb_q = agent.embed_visual_obs(calib["rgb_static"],
                                       calib["rgb_gripper"],
                                       calib["lang_emb"])["state_images"]
        for i, enc in enumerate(ENCODERS):
            report.add(f"encoder/{enc} (int8)",
                       _mae(emb_q[:, i], feats[enc]),
                       gate=int8_tolerance or float("inf"),
                       note="" if int8_tolerance else
                       "report-only (set --int8-tolerance to gate)")
    return feats


@torch.no_grad()
def check_routing(report: Report, agent, emb, goal, noise) -> torch.Tensor:
    """The routing-precompute rung: the f32 agent's DDIM chunk with its
    per-sigma routing tables against its dense path (inline routing), the
    same initial noise; and on CUDA the ``parity`` preset's chunk (a bf16
    copy of the agent, int8 experts, ``fused_layer_q8c`` on the fast path)
    against the same dense chunk, report-only. Returns the dense chunk."""
    from ..models.agent import MoDEAgent
    from ..serving import apply_serving_mode

    fast = agent.denoise_actions(emb, goal, noise=noise,
                                 use_routing_precompute=True)
    dense = agent.denoise_actions(emb, goal, noise=noise)
    report.add("e2e/routing_precompute", _mae(fast, dense),
               gate=ROUTING_GATE)
    if agent.device.type == "cuda":
        import dataclasses
        served = MoDEAgent(dataclasses.replace(agent.cfg,
                                               dtype=torch.bfloat16),
                           device=agent.device)
        served.load_state_dict(agent.state_dict(), strict=False)
        apply_serving_mode(served, "parity").precast_for_serving()
        got = served.denoise_actions(emb, goal, noise=noise,
                                     use_routing_precompute=True)
        report.add("e2e/routing_precompute (parity)", _mae(got, dense),
                   gate=float("inf"),
                   note="report-only: bf16 + int8 experts vs the f32 dense "
                        f"path (JAX's gate {GATE_DEFAULT:g})")
        del served
    return dense


def build_agent(sd, n_layers: int, n_experts: int, prefix: str,
                shape: Dict[str, int], depth: Optional[int],
                num_sampling_steps: int = 10, device="cuda"):
    """The port's f32 agent for a converted checkpoint: its DiT from
    ``convert_modedit``; FiLM-ResNet-34/50 policy encoders (the
    checkpoint's depth; otherwise the one whose features are the DiT's
    observation width), which ``check_encoders`` loads."""
    from ..models.agent import MoDEAgent, MoDEAgentConfig
    from .checkpoint_convert import convert_modedit
    from .weights import load_dit_state_

    agent = MoDEAgent(MoDEAgentConfig(
        latent_dim=shape["embed_dim"], n_layers=n_layers,
        n_heads=shape["n_heads"], cond_dim=shape["goal_dim"],
        action_dim=shape["action_dim"],
        act_window_size=shape["action_seq_len"],
        resnet_type=str(depth) if depth in (34, 50) else
        ("50" if shape["obs_dim"] == 2048 else "34"),
        num_experts=n_experts, top_k=2,
        num_sampling_steps=num_sampling_steps), device=device)
    load_dit_state_(agent.inner_model, convert_modedit(
        sd, n_layers=n_layers, num_experts=n_experts, prefix=prefix))
    return agent.eval()


def verify(checkpoint: str, reference_repo: str, clip: Optional[str] = None,
           resnet_ckpt: Optional[str] = None, tolerance: float = GATE_DEFAULT,
           image_size: int = 112, batch: int = 2, seed: int = 0,
           num_sampling_steps: int = 10, int8_encoders: bool = False,
           int8_tolerance: Optional[float] = None,
           device="cuda") -> Report:
    from ..models.edm import sample_loop
    from ..utils.device import resolve_device
    from .checkpoint_convert import (detect_layout, load_torch_checkpoint,
                                     normalize_state_dict)

    dev = resolve_device(device)
    report = Report(tolerance)
    print(f"checkpoint: {checkpoint}")
    sd = normalize_state_dict(load_torch_checkpoint(checkpoint))
    n_layers, n_experts, prefix = detect_layout(sd)
    shape = infer_dit_shape(sd, prefix)
    depth = infer_resnet_depth(sd)
    print(f"detected: layers={n_layers} experts={n_experts} "
          f"D={shape['embed_dim']} heads={shape['n_heads']} "
          f"obs={shape['obs_dim']} resnet={depth}")

    ref_modedit, ref_sw, ref_gs = load_reference_stack(reference_repo)

    # ---- the reference model, loaded with its own weights (CPU, f32) ------
    torch.manual_seed(seed)
    tdit = ref_modedit.MoDeDiT(
        obs_dim=shape["obs_dim"], goal_dim=shape["goal_dim"], device="cpu",
        goal_conditioned=True, action_dim=shape["action_dim"],
        embed_dim=shape["embed_dim"], embed_pdrob=0.0, attn_pdrop=0.3,
        n_layers=n_layers, n_heads=shape["n_heads"], goal_seq_len=1,
        obs_seq_len=1, action_seq_len=shape["action_seq_len"], state_dim=8,
        mlp_pdrop=0.1, goal_drop=0.1, cond_router=True,
        num_experts=n_experts, top_k=2, router_normalize=True,
        use_argmax=False, use_shared_expert=False,
        use_noise_token_as_input=True, init_style="olmoe")
    missing, unexpected = tdit.load_state_dict(_sub_state_dict(sd, prefix),
                                               strict=False)
    if missing:
        raise ValueError(f"DiT weights missing from checkpoint: "
                         f"{sorted(missing)[:8]}...")
    if unexpected:
        logger.warning("unused DiT checkpoint keys: %s",
                       sorted(unexpected)[:8])
    tdit.eval()

    # ---- the port's agent through the converter --------------------------
    obs_dim_ok = shape["obs_dim"] in (512, 2048)
    agent = build_agent(sd, n_layers, n_experts, prefix, shape, depth,
                        num_sampling_steps, dev)

    rng = np.random.default_rng(seed)
    B, W, A = batch, shape["action_seq_len"], shape["action_dim"]
    goal = torch.from_numpy(rng.standard_normal(
        (B, 1, shape["goal_dim"])).astype(np.float32))
    goal_d = goal.to(dev)

    with no_tf32():
        # ---- encoders -----------------------------------------------------
        has_encoders = depth is not None
        if has_encoders:
            images = {enc: torch.from_numpy(
                rng.standard_normal((B, 3, image_size, image_size))
                .astype(np.float32) * 0.3) for enc in ENCODERS}
            feats = check_encoders(
                report, sd, depth, goal, images, dev,
                agent=agent if int8_encoders and depth in (34, 50) else None,
                int8_tolerance=int8_tolerance)
            state_images = torch.stack(
                [feats[enc].cpu() for enc in ENCODERS], dim=1)
        else:
            logger.warning("no encoder weights in checkpoint: using random "
                           "perceptual embeddings for the DiT/e2e checks")
            state_images = torch.from_numpy(rng.standard_normal(
                (B, 2, shape["obs_dim"])).astype(np.float32))

        # ---- one DiT forward at a fixed sigma -----------------------------
        actions = torch.from_numpy(
            rng.standard_normal((B, W, A)).astype(np.float32))
        sigma = torch.full((B,), 1.7)
        with torch.no_grad():
            t_pred = tdit({"state_images": state_images}, actions, goal,
                          sigma)
            emb = {"state_images": state_images.to(dev)}
            p_pred = agent.inner_model(emb, actions.to(dev), goal_d,
                                       sigma.to(dev))
        report.add("dit/forward", _mae(p_pred, t_pred))

        # ---- the end-to-end 10-step DDIM chunk ----------------------------
        sigmas = np.asarray(agent.sigmas, np.float32)
        noise = torch.from_numpy(rng.standard_normal((B, W, A))
                                 .astype(np.float32))
        x0 = noise * agent.cfg.sigma_max
        with torch.no_grad():
            denoiser = ref_sw.GCDenoiser(tdit,
                                         sigma_data=agent.cfg.sigma_data)
            t_out = ref_gs.sample_ddim(
                denoiser, {"state_images": state_images}, x0, goal,
                torch.from_numpy(sigmas), disable=True)
            den = agent.make_denoiser(emb, goal_d)
            p_out = sample_loop("ddim", den, x0.to(dev), sigmas)
        report.add("e2e/ddim_chunk (rel_action)", _mae(p_out, t_out),
                   note="BASELINE fidelity target")

        # ---- the serving fast path: what eval and serving run --------------
        check_routing(report, agent, emb, goal_d, noise.to(dev))

        # ---- the int8 encoders end to end on these weights ----------------
        if int8_encoders and has_encoders and agent.q8 is not None:
            nhwc = {enc: images[enc].permute(0, 2, 3, 1)[:, None].to(dev)
                    for enc in ENCODERS}
            emb_q = agent.embed_visual_obs(nhwc["static_resnet"],
                                           nhwc["gripper_resnet"], goal_d)
            with torch.no_grad():
                p_q = sample_loop("ddim", agent.make_denoiser(emb_q, goal_d),
                                  x0.to(dev), sigmas)
            report.add("e2e/int8_encoders (vs torch)", _mae(p_q, t_out),
                       gate=int8_tolerance or float("inf"),
                       note="" if int8_tolerance else
                       "report-only (set --int8-tolerance to gate)")
        elif int8_encoders and depth == 18:
            logger.warning("--int8-encoders: the agent's ResNet-18 is the "
                           "scratch encoder; the policy-style ResNet-18 is "
                           "held in f32 only")

    # ---- optional CLIP text tower ----------------------------------------
    if clip:
        _verify_clip(clip, reference_repo, report, dev)
    if resnet_ckpt and not has_encoders:
        logger.warning("--resnet given but checkpoint has no encoder keys; "
                       "standalone backbone verification not implemented")
    if not obs_dim_ok:
        logger.warning("obs_dim=%d outside the reference encoder family",
                       shape["obs_dim"])
    return report


def _verify_clip(clip_path: str, reference_repo: str, report: Report,
                 device):
    from ..config.builders import build_lang_clip
    from ..models.encoders.tokenizer import tokenize

    clip_py = Path(reference_repo) / "mode" / "models" / "networks" / "clip.py"
    ref_clip = _load_file_module(clip_py, "vck_refclip")
    try:
        jit_model = torch.jit.load(clip_path, map_location="cpu")
        t_sd = jit_model.state_dict()
    except RuntimeError:
        t_sd = torch.load(clip_path, map_location="cpu")
        t_sd = t_sd.get("state_dict", t_sd)
    tmodel = ref_clip.build_model({k: v.float() for k, v in t_sd.items()})
    tmodel.eval()

    lang = build_lang_clip(clip_checkpoint=clip_path, device=device)
    texts = ["push the red block", "open the drawer",
             "turn on the led light"]
    ids = np.asarray(tokenize(texts))
    with torch.no_grad():
        t_emb = tmodel.encode_text(torch.tensor(ids).long())
    report.add("clip/encode_text", _mae(lang(texts)[:, 0], t_emb))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="published MoDE checkpoint: safetensors dir, "
                        "Lightning .ckpt, or raw .pt")
    p.add_argument("--clip", default=None,
                   help="OpenAI CLIP checkpoint (jit .pt or state dict) for "
                        "the language-tower check")
    p.add_argument("--resnet", default=None,
                   help="timm ImageNet backbone .pt (reserved; encoder "
                        "weights usually ship inside the MoDE checkpoint)")
    p.add_argument("--reference-repo", required=True,
                   help="path to the PyTorch reference repo (oracle side), "
                        "holding its mode/ package")
    p.add_argument("--tolerance", type=float, default=GATE_DEFAULT)
    p.add_argument("--int8-encoders", action="store_true",
                   help="also measure the int8-encoder (max-throughput) "
                        "path on these weights")
    p.add_argument("--int8-tolerance", type=float, default=None,
                   help="gate the int8-encoder checks (report-only if unset)")
    p.add_argument("--image-size", type=int, default=112,
                   help="input resolution for the encoder checks (112 keeps "
                        "CPU runs fast; weight coverage identical to 224)")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the port's side runs ('cpu' to run its plain "
                        "versions on the CPU)")
    p.add_argument("--out", default=None, help="write the JSON report here")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    report = verify(args.checkpoint, args.reference_repo, clip=args.clip,
                    resnet_ckpt=args.resnet, tolerance=args.tolerance,
                    image_size=args.image_size, batch=args.batch,
                    seed=args.seed, int8_encoders=args.int8_encoders,
                    int8_tolerance=args.int8_tolerance, device=args.device)
    verdict = "PASS" if report.ok else "FAIL"
    print(f"fidelity: {verdict} ({len(report.rows)} checks, "
          f"tolerance {args.tolerance:g})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report.to_json(), f, indent=2)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
