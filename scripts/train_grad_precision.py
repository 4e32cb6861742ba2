"""How far the training gradient of each precision lies from float64, for
the JAX package and the PyTorch port on the same weights and the same
draws, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/train_grad_precision.py [--img 224] [--b 8]
        [--layers 2] [--latent 256] [--heads 2] [--cond 32] [--frames normal]

The model is by default the tests' small DiT (D=256, 2 layers, 2 heads)
with both FiLM-ResNet-50 encoders at full size, random weights from a
numpy seed, the dropouts off; ``--layers``, ``--latent``, ``--heads`` and
``--cond`` set the DiT's depth and widths. ``--frames uint8`` makes the
frames as ``chip_smoke.py``'s gradient check does (uniform uint8 at
CALVIN's 200 px static and 84 px gripper sizes, resized to ``--img`` and
CLIP-normalized by the port's ``preprocess_camera``) in place of
standard-normal images; sigma, noise and the Gumbel noise are fixed (the JAX
draws are patched to the same constants). For each of JAX f32, JAX bf16
(compute dtype), port f32 and port bf16 it prints the loss's relative
error against JAX float64 (``jax.enable_x64``) and the relative L2 error
of the gradient: the DiT's leaves and the encoders' leaves in total, and
the worst leaf of each. At a random init the encoders' gradients are
ill-conditioned, and these numbers are the floor that the gradient check
of ``chip_smoke.py`` phase 22 sets its encoder and bf16 gates by.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mode_diffusion_policy_tpu.models.modedit as jmodedit  # noqa: E402
from mode_diffusion_policy_tpu.models.agent import MoDEAgent as JAgent  # noqa: E402
from mode_diffusion_policy_tpu.models.agent import \
    MoDEAgentConfig as JCfg  # noqa: E402
from mode_diffusion_policy_tpu_torch.models.agent import \
    MoDEAgentConfig as TCfg  # noqa: E402
from mode_diffusion_policy_tpu_torch.ops.image import \
    preprocess_camera  # noqa: E402
from mode_diffusion_policy_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_params, port_tree)

DIMS = dict(latent_dim=256, n_layers=2, n_heads=2, cond_dim=32,
            num_experts=4, top_k=2, attn_pdrop=0.0, mlp_pdrop=0.0,
            goal_drop=0.0, embed_pdrob=0.0, entropy_gamma=0.01,
            router_z_delta=0.001)


def random_variables(agent, img, seed=0):
    shapes = jax.eval_shape(lambda k: agent.init_variables(
        k, image_hw=(img, img)), jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1].key)
        v = r.standard_normal(s.shape)
        out = (r.uniform(0.5, 1.5, s.shape) if name == "var" else
               1.0 + 0.1 * v if name in ("g", "scale") else
               0.05 * v if name in ("mean", "bias") else
               v / np.sqrt(np.prod(s.shape[:3]))
               if name == "kernel" and len(s.shape) == 4 else
               0.5 * v if "router" in jax.tree_util.keystr(path) else
               0.05 * v)
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, {"params": shapes["params"],
               "batch_stats": shapes["batch_stats"]})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", type=int, default=224)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--layers", type=int, default=DIMS["n_layers"])
    ap.add_argument("--latent", type=int, default=DIMS["latent_dim"])
    ap.add_argument("--heads", type=int, default=DIMS["n_heads"])
    ap.add_argument("--cond", type=int, default=DIMS["cond_dim"])
    ap.add_argument("--frames", choices=("normal", "uint8"),
                    default="normal")
    args = ap.parse_args(argv)
    B, img = args.b, args.img
    DIMS.update(n_layers=args.layers, latent_dim=args.latent,
                n_heads=args.heads, cond_dim=args.cond)
    r = np.random.default_rng(21)
    d = {"sigma": np.exp(r.standard_normal(B) * 0.5 + np.log(0.5)).astype(
        np.float32),
        "noise": r.standard_normal((B, 10, 7)).astype(np.float32),
        "gumbel": [r.gumbel(size=(B, 14, 4)).astype(np.float32)
                   for _ in range(DIMS["n_layers"])]}
    calls = []

    def gumbel_topk(key, log_probs, k):
        g = d["gumbel"][len(calls) % DIMS["n_layers"]]
        calls.append(1)
        return jax.lax.top_k(log_probs + jnp.asarray(g, log_probs.dtype),
                             k)[1]

    normal = jax.random.normal

    def fake_normal(key, shape=(), dtype=None):
        if tuple(shape) == (B, 10, 7):
            return jnp.asarray(d["noise"], dtype or jnp.float32)
        return normal(key, shape, dtype or jnp.float32)

    jmodedit.gumbel_topk_sample = gumbel_topk
    jax.random.normal = fake_normal
    v = random_variables(JAgent(JCfg(resnet_type="50", **DIMS)), img)
    rr = np.random.default_rng(3)
    batch = {"rgb_static": rr.standard_normal((B, 1, img, img, 3)),
             "rgb_gripper": rr.standard_normal((B, 1, img, img, 3)),
             "actions": rr.standard_normal((B, 10, 7)) * 0.3,
             "lang_emb": rr.standard_normal((B, 1, DIMS["cond_dim"]))}
    if args.frames == "uint8":
        for cam, hw in (("rgb_static", 200), ("rgb_gripper", 84)):
            raw = torch.tensor(rr.integers(0, 256, (B, 1, hw, hw, 3),
                                           dtype=np.uint8))
            batch[cam] = preprocess_camera(raw, size=img).numpy()
    batch = {k: x.astype(np.float32) for k, x in batch.items()}

    def jax_run(dt):
        agent = JAgent(JCfg(resnet_type="50", dtype=dt, **DIMS))
        agent.sample_density = lambda k, s: jnp.asarray(d["sigma"])
        pdt = jnp.float64 if dt == jnp.float64 else jnp.float32
        vv = jax.tree.map(lambda a: jnp.asarray(a, pdt), v)

        def lf(params):
            return agent.training_loss(
                {"params": params, "batch_stats": vv["batch_stats"]},
                jax.tree.map(lambda a: jnp.asarray(a, pdt), batch),
                jax.random.PRNGKey(5))[0]

        loss, g = jax.jit(jax.value_and_grad(lf))(vv["params"])
        g = jax.tree.map(lambda a: np.asarray(a, np.float64), g)
        return float(loss), {k: t.numpy() for k, t in port_tree(g).items()}

    def port_run(dt):
        agent = from_jax_params(v, TCfg(dtype=dt, **DIMS), device="cpu")
        loss, _ = agent.training_loss(
            {k: torch.tensor(x) for k, x in batch.items()}, None,
            sigma=torch.tensor(d["sigma"]), noise=torch.tensor(d["noise"]),
            gumbel=[torch.tensor(g) for g in d["gumbel"]])
        loss.backward()
        return float(loss.detach()), {n: p.grad.double().numpy()
                                      for n, p in agent.named_parameters()}

    runs = {"jax_f32": jax_run(jnp.float32), "jax_bf16": jax_run(jnp.bfloat16),
            "port_f32": port_run(torch.float32),
            "port_bf16": port_run(torch.bfloat16)}
    with jax.enable_x64():
        l64, g64 = jax_run(jnp.float64)
    out = {}
    for name, (loss, g) in runs.items():
        row = {"loss_rel": abs(loss - l64) / abs(l64)}
        for part, pick in (("dit", lambda n: n.startswith("inner_model.")),
                           ("encoders",
                            lambda n: not n.startswith("inner_model."))):
            names = [n for n in g64 if pick(n)]
            # leaves whose gradient is zero to rounding (within 1e-6 of
            # their part's largest) have no relative error
            top = max(np.linalg.norm(g64[n]) for n in names)
            num = sum(np.linalg.norm(g[n] - g64[n]) ** 2 for n in names)
            den = sum(np.linalg.norm(g64[n]) ** 2 for n in names)
            worst = max((np.linalg.norm(g[n] - g64[n])
                         / np.linalg.norm(g64[n]), n) for n in names
                        if np.linalg.norm(g64[n]) > 1e-6 * top)
            row[f"{part}_total_rel"] = float((num / den) ** 0.5)
            row[f"{part}_worst_leaf"] = [worst[1], float(worst[0])]
        out[name] = row
    print(json.dumps({"img": img, "batch": B, "frames": args.frames,
                      "dit": {k: DIMS[k] for k in ("n_layers", "latent_dim",
                                                   "n_heads", "cond_dim")},
                      "vs_jax_f64": out}))


if __name__ == "__main__":
    main()
