"""Checkpoint export: a training run of the port -> the published layout
(``model_cleaned.safetensors`` with the reference's key names, plus
``config.json`` and ``README.md``), with an optional upload to the
Hugging Face hub (counterpart of ``mode_diffusion_policy_tpu/utils/
export.py``, after the reference ``mode/utils/save_to_hf.py``).

``modedit_params_to_torch_layout`` is the inverse of
``checkpoint_convert.convert_modedit``: [in, out] kernels back to [out, in]
Linear weights, the stacked experts unstacked, the fused qkv split into
query/key/value, so an exported model loads back through the converter
(and into the reference implementation). The options ``convert_modedit``
reads are written back as well: the proprio embedding ``state_embed``,
a shared expert and block cross-attention. Only the DiT is exported, as
the JAX export does.

``load_run_params`` reads the port's run directory
(``training.loop.CheckpointManager``: ``<run>/saved_models[/best]/<step>/
state.pt``) where the JAX package reads orbax checkpoints.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Mapping, Optional

import torch

logger = logging.getLogger(__name__)

DIT_PREFIX = "inner_model."


def modedit_params_to_torch_layout(params: Mapping[str, torch.Tensor],
                                   prefix: str = "model.inner_model."
                                   ) -> Dict[str, torch.Tensor]:
    """The port's ``MoDeDiT`` state dict (its own names, as
    ``convert_modedit`` makes them) -> flat reference-named tensors, each
    in its stored dtype, contiguous, on the CPU."""
    sd = {k: v.detach().cpu() for k, v in params.items()}
    out: Dict[str, torch.Tensor] = {}
    p = prefix

    def put(name, t):
        out[name] = t.contiguous()

    def dense(src: str, dst: str, bias: bool = True):
        put(f"{dst}.weight", sd[f"{src}.kernel"].T)
        if bias and f"{src}.bias" in sd:
            put(f"{dst}.bias", sd[f"{src}.bias"])

    dense("sigma_emb", f"{p}sigma_emb")
    dense("sigma_linear", f"{p}sigma_linear", bias=False)
    dense("tok_emb", f"{p}tok_emb", bias=False)
    dense("goal_emb", f"{p}goal_emb", bias=False)
    dense("action_emb", f"{p}action_emb", bias=False)
    if "state_embed.kernel" in sd:
        dense("state_embed", f"{p}state_embed", bias=False)
    put(f"{p}pos_emb", sd["pos_emb"])
    put(f"{p}ln.g", sd["ln.g"])
    dense("out", f"{p}out")

    i = 0
    while f"blocks.{i}.ln_1.g" in sd:
        s, b = f"blocks.{i}.", f"{p}blocks.{i}."
        put(b + "ln_1.g", sd[s + "ln_1.g"])
        put(b + "ln_2.g", sd[s + "ln_2.g"])
        qkv_k, qkv_b = sd[s + "attn.wqkv.kernel"], sd[s + "attn.wqkv.bias"]
        D = qkv_k.shape[0]
        for j, name in enumerate(("query", "key", "value")):
            put(b + f"attn.{name}.weight", qkv_k[:, j * D:(j + 1) * D].T)
            put(b + f"attn.{name}.bias", qkv_b[j * D:(j + 1) * D])
        dense(s + "attn.c_proj", b + "attn.c_proj", bias=False)
        put(b + "attn.q_norm.g", sd[s + "attn.q_norm.g"])
        put(b + "attn.k_norm.g", sd[s + "attn.k_norm.g"])
        dense(s + "router.mlp.fc1", b + "router.router.mlp.0")
        dense(s + "router.mlp.fc2", b + "router.router.mlp.3")
        w1, b1, w2 = (sd[s + n] for n in ("experts_w1", "experts_b1",
                                          "experts_w2"))
        for e in range(w1.shape[0]):
            eb = b + f"experts.expert_{e}."
            put(eb + "mlp.0.project.weight", w1[e].T)
            put(eb + "mlp.0.project.bias", b1[e])
            put(eb + "mlp.2.weight", w2[e].T)
        if s + "shared_w1" in sd:
            put(b + "shared_mlp.mlp.0.project.weight", sd[s + "shared_w1"].T)
            put(b + "shared_mlp.mlp.0.project.bias", sd[s + "shared_b1"])
            put(b + "shared_mlp.mlp.2.weight", sd[s + "shared_w2"].T)
        if s + "cross_att.wq.kernel" in sd:
            dense(s + "cross_att.wq", b + "cross_att.query")
            kv_k = sd[s + "cross_att.wkv.kernel"]
            kv_b = sd[s + "cross_att.wkv.bias"]
            for j, name in enumerate(("key", "value")):
                put(b + f"cross_att.{name}.weight",
                    kv_k[:, j * D:(j + 1) * D].T)
                put(b + f"cross_att.{name}.bias", kv_b[j * D:(j + 1) * D])
            dense(s + "cross_att.c_proj", b + "cross_att.c_proj", bias=False)
            put(b + "cross_att.q_norm.g", sd[s + "cross_att.q_norm.g"])
            put(b + "cross_att.k_norm.g", sd[s + "cross_att.k_norm.g"])
            put(b + "ln_3.g", sd[s + "ln_3.g"])
        i += 1
    return out


def save_cleaned_checkpoint(params: Mapping[str, torch.Tensor], out_dir: str,
                            config: Optional[Dict] = None,
                            model_card: Optional[str] = None) -> str:
    """Write ``model_cleaned.safetensors`` (+ ``config.json`` +
    ``README.md``), the published-checkpoint format. ``params``: an agent's
    or a run's weights by name (the DiT's under ``inner_model.`` are
    exported in the reference layout), or an already flat reference-named
    dict (written as it is)."""
    from safetensors.torch import save_file

    os.makedirs(out_dir, exist_ok=True)
    dit = {k[len(DIT_PREFIX):]: v for k, v in params.items()
           if k.startswith(DIT_PREFIX)}
    flat = modedit_params_to_torch_layout(dit) if dit else {
        k: v.detach().cpu().contiguous() for k, v in params.items()}
    path = os.path.join(out_dir, "model_cleaned.safetensors")
    save_file(flat, path)
    if config is not None:
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
    if model_card:
        with open(os.path.join(out_dir, "README.md"), "w") as f:
            f.write(model_card)
    logger.info("wrote %d tensors to %s", len(flat), path)
    return path


def push_to_hub(out_dir: str, repo_id: str, token: Optional[str] = None):
    """Upload an exported checkpoint directory to the Hugging Face hub.
    Needs the ``huggingface_hub`` package and network access."""
    from huggingface_hub import HfApi
    api = HfApi(token=token)
    api.create_repo(repo_id, exist_ok=True)
    api.upload_folder(folder_path=out_dir, repo_id=repo_id)
    logger.info("uploaded %s to %s", out_dir, repo_id)


def load_run_params(run_dir: str, use_ema: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """The best (else the newest) saved state of a port training run
    (``<run_dir>/saved_models[/best]/<step>/state.pt``) as its weights by
    name, on the CPU in their stored dtype: the EMA weights, or the
    trained ones with ``use_ema=False``."""
    from ..training.loop import CheckpointManager

    base = os.path.join(os.path.abspath(run_dir), "saved_models")
    for sub in (os.path.join(base, "best"), base):
        steps = CheckpointManager._steps(sub)
        if not steps:
            continue
        path = os.path.join(sub, str(steps[-1]), CheckpointManager.FILE)
        saved = torch.load(path, map_location="cpu", weights_only=False)
        ema = saved.get("ema_params")
        params = ema if (use_ema and ema) else saved["params"]
        logger.info("restored step %d from %s (ema=%s)", saved["step"], sub,
                    use_ema and bool(ema))
        return dict(params)
    raise FileNotFoundError(f"no port checkpoints under {base}")


def main(argv=None):
    """CLI: export a port training run to the published safetensors
    layout. Usage:
        python -m mode_diffusion_policy_tpu_torch.utils.export \\
            --run-dir runs/mode_calvin --out-dir export/ [--repo-id user/x]
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--run-dir", required=True,
                    help="training run directory holding saved_models/")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--repo-id", default=None,
                    help="optional HF hub repo to upload to (needs network)")
    ap.add_argument("--use-ema", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="export the EMA weights (the reference's choice); "
                         "--no-use-ema exports the trained weights")
    args = ap.parse_args(argv)

    params = load_run_params(args.run_dir, use_ema=args.use_ema)
    save_cleaned_checkpoint(params, args.out_dir)
    if args.repo_id:
        push_to_hub(args.out_dir, args.repo_id)


if __name__ == "__main__":
    main()
