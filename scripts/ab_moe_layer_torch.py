"""Time the port's MoE and layer kernels of one checkout, for an A/B of two
checkouts on the same card.

    python3 scripts/ab_moe_layer_torch.py [ROOT]

ROOT (default: the checkout holding this script) is the root of a checkout
of this repository; its kernels are built from its own csrc/ and timed at
b=128 and b=1 (x 14 tokens, D=1024, hidden 4096, top-2 of 4, ln_2 and the
residual fused, seeded random weights from that checkout's
bench_kernels_torch inputs): fused_top2_mlp, fused_top2_mlp_q8 and
fused_layer_q8c (bf16 projections), each warm (CUDA events around 50 or
100 launches), with the L2 cache flushed before each launch, and as the
sum of its stages' device times (torch.profiler): at b=1 the launches
are bound by the host, whose time moves between processes, and the
device time is the number that compares the kernels. Run it
from two checkouts in turns in one call (A, B, B, A) to compare them; it
prints one JSON line with the card's name and power limit. Needs CUDA;
imports nothing of JAX.
"""
from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path


def main(argv):
    root = Path(argv[0] if argv else Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_moe_layer_torch: CUDA is not available")
    import bench_kernels_torch as bk
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_layer_q8c)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp, fused_top2_mlp_q8)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    kmajor = "qexp_t" in inspect.signature(fused_layer_q8c).parameters
    out = {}
    for B in (128, 1):
        n = 50 if B == 128 else 100
        a = bk.moe_inputs(B, dev)
        kw = dict(residual=True, ln_g=a["ln_g"])
        head = (a["x"], a["idx"], a["probs"])
        w = bk.layer_inputs(B, dev, L=1)
        lkw = {}
        if kmajor:
            from mode_diffusion_policy_tpu_torch.ops.quant import (
                kmajor_experts)
            lkw["qexp_t"] = kmajor_experts(w["q"])
        attn = (w["c"], w["ln1"], w["wqkv"], w["bqkv"], w["q_g"], w["k_g"],
                w["wout"])
        for name, fn in (
                ("fused_top2_mlp",
                 lambda: fused_top2_mlp(*head, *a["bf16"], **kw)),
                ("fused_top2_mlp_q8",
                 lambda: fused_top2_mlp_q8(*head, a["q"], **kw)),
                ("fused_layer_q8c",
                 lambda: fused_layer_q8c(w["x"], *attn, w["ln2"], w["q"],
                                         w["idx"], w["probs"], **lkw))):
            stages = bk.stage_ms(fn)
            out[f"{name} b{B}"] = dict(
                ms=bk.cuda_time_ms(fn, n),
                ms_cold_l2=bk.cuda_time_cold_ms(fn, 20),
                device_ms=sum(stages.values()) if stages else None)
    print(json.dumps({"root": str(root), "card": card, "ms": out}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
