"""Where the wgmma expert-product stages spend their time, on one NVIDIA GPU.

    python3 scripts/wgmma_stage_variants.py VARIANT

VARIANT is one of:
- ``base``:    the kernels as they are;
- ``noepi``:   the stages' epilogues skipped (the products and loads alone);
- ``noprod``:  the products skipped (the loads and epilogues alone).

The variant is built from an edited copy of ``mode_diffusion_policy_tpu_torch
/csrc`` under ``build/wgmma_variants/<VARIANT>`` (listed in .gitignore) and
times, at b=128 x 14 tokens (flagship widths, the bench's seeded inputs),
the device ms per launch of each stage of ``fused_top2_mlp`` and
``fused_layer_q8c`` (torch.profiler). The two edited variants compute
wrong results: they only split a stage's time between its parts. Run each
variant in its own process (a process loads one build). Prints one JSON
line with the card's name and power limit; needs CUDA; imports nothing
of JAX.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EDITS = {
    "base": [],
    "noepi": [("Op::store(d, a, tl, rw, cols, z, sum);",
               "if (a.M < 0) Op::store(d, a, tl, rw, cols, z, sum);")],
    "noprod": [("Op::mma(d, st, b, wg);", "")],
}


def main(argv):
    if len(argv) != 1 or argv[0] not in EDITS:
        raise SystemExit(f"usage: wgmma_stage_variants.py {'|'.join(EDITS)}")
    variant = argv[0]
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_stage_variants: CUDA is not available")
    import bench_kernels_torch as bk
    from mode_diffusion_policy_tpu_torch.ops.kernels import _build
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_layer_q8c)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp)

    work = ROOT / "build" / "wgmma_variants" / variant
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, work / "csrc")
    header = work / "csrc" / "wgmma_stages.cuh"
    text = header.read_text()
    for old, new in EDITS[variant]:
        if text.count(old) != 1:
            raise SystemExit(f"{variant}: the edit target is not unique: {old}")
        text = text.replace(old, new)
    header.write_text(text)
    _build.CSRC_DIR, _build.BUILD_DIR = work / "csrc", work / "lib"

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    a = bk.moe_inputs(128, dev)
    w = bk.layer_inputs(128, dev, L=1)
    attn = (w["c"], w["ln1"], w["wqkv"], w["bqkv"], w["q_g"], w["k_g"],
            w["wout"])
    out = {
        "fused_top2_mlp": bk.stage_ms(lambda: fused_top2_mlp(
            a["x"], a["idx"], a["probs"], *a["bf16"], residual=True,
            ln_g=a["ln_g"])),
        "fused_layer_q8c": bk.stage_ms(lambda: fused_layer_q8c(
            w["x"], *attn, w["ln2"], w["q"], w["idx"], w["probs"],
            qexp_t=w["qt"])),
    }
    print(json.dumps({"variant": variant, "card": card, "stages_ms": out}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
