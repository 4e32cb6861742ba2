"""Time the port's MoE, attention and layer kernels of one checkout, for an
A/B of two checkouts on the same card.

    python3 scripts/ab_moe_layer_torch.py [ROOT] [--save FILE]
    python3 scripts/ab_moe_layer_torch.py --compare FILE FILE [FILE ...]

ROOT (default: the checkout holding this script) is the root of a checkout of
this repository; its kernels are built from its own csrc/ and timed at b=128
and b=1 (x 14 tokens, D=1024, 8 heads of 128, hidden 4096, top-2 of 4, ln_2 and
the residual fused, seeded random weights from that checkout's
bench_kernels_torch inputs): fused_top2_mlp, fused_top2_mlp_q8,
fused_top2_mlp_q8c, fused_attn_block_q8 (its projections quantized from the
bench layer's bf16 weights), fused_attn_block, fused_layer_q8c (bf16
projections) and fused_dit_q8c (the bench layer stacked 12 times, bf16
projections), each warm (CUDA events around 50 or 100 launches), with the L2
cache flushed before each launch, and as the sum of its stages' device times
(torch.profiler): at b=1 the launches are bound by the host, whose time moves
between processes, and the device time is the number that compares the kernels.
Where the checkout's wrappers take the K-major weight copies (qexp_t, qattn_t,
the megakernel stack's w1_t and w2_t), they get them. Run it from two checkouts
in turns in one call (A, B, B, A) to compare them; it prints one JSON line with
the card's name and power limit. With --save it also writes each kernel's
output to FILE (torch.save, on the CPU); --compare then says, kernel by kernel,
whether the saved outputs of several runs are equal bit for bit (the same
seeded inputs on both trees). Needs CUDA for the timing; imports nothing of
JAX.
"""
from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path


def compare(files):
    import torch
    runs = [torch.load(f) for f in files]
    out = {}
    for name in runs[0]:
        got = [r.get(name) for r in runs]
        out[name] = all(g is not None and torch.equal(g, got[0])
                        for g in got)
    print(json.dumps({"compare": [str(f) for f in files],
                      "bit_equal": out}), flush=True)


def main(argv):
    if argv[:1] == ["--compare"]:
        return compare(argv[1:])
    save = None
    if "--save" in argv:
        i = argv.index("--save")
        save = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    root = Path(argv[0] if argv else Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_moe_layer_torch: CUDA is not available")
    import bench_kernels_torch as bk
    from mode_diffusion_policy_tpu_torch.ops import quant
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block, fused_attn_block_q8)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c, fused_layer_q8c)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp, fused_top2_mlp_q8, fused_top2_mlp_q8c)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)

    def takes(fn, kw):
        return kw in inspect.signature(fn).parameters

    out, outputs = {}, {}
    for B in (128, 1):
        n = 50 if B == 128 else 100
        a = bk.moe_inputs(B, dev)
        kw = dict(residual=True, ln_g=a["ln_g"])
        head = (a["x"], a["idx"], a["probs"])
        w = bk.layer_inputs(B, dev)
        stack = dict(w["stackL"])
        stack.setdefault("w1_t", stack["w1_q"].transpose(-1, -2).contiguous())
        stack.setdefault("w2_t", stack["w2_q"].transpose(-1, -2).contiguous())
        L = stack["wqkv"].shape[0]
        tabs = (w["idx"][None].expand(L, 1, 2).contiguous(),
                w["probs"][None].expand(L, 1, 2).contiguous())
        lkw, mkw, akw = {}, {}, {}
        if takes(fused_layer_q8c, "qexp_t"):
            lkw["qexp_t"] = quant.kmajor_experts(w["q"])
        if takes(fused_top2_mlp_q8c, "qexp_t"):
            mkw["qexp_t"] = quant.kmajor_experts(a["q"])
        qa = quant.quantize_attn(w["wqkv"].float(), w["bqkv"],
                                 w["wout"].float())
        if takes(fused_attn_block_q8, "qattn_t"):
            akw["qattn_t"] = quant.kmajor_attn(qa)
        attn = (w["c"], w["ln1"], w["wqkv"], w["bqkv"], w["q_g"], w["k_g"],
                w["wout"])
        for name, fn in (
                ("fused_top2_mlp",
                 lambda: fused_top2_mlp(*head, *a["bf16"], **kw)),
                ("fused_top2_mlp_q8",
                 lambda: fused_top2_mlp_q8(*head, a["q"], **kw)),
                ("fused_top2_mlp_q8c",
                 lambda: fused_top2_mlp_q8c(*head, a["q"], **kw, **mkw)),
                ("fused_attn_block_q8",
                 lambda: fused_attn_block_q8(w["x"], w["c"], w["ln1"], qa,
                                             w["q_g"], w["k_g"], **akw)),
                ("fused_attn_block",
                 lambda: fused_attn_block(w["x"], *attn)),
                ("fused_layer_q8c",
                 lambda: fused_layer_q8c(w["x"], *attn, w["ln2"], w["q"],
                                         w["idx"], w["probs"], **lkw)),
                ("fused_dit_q8c",
                 lambda: fused_dit_q8c(w["x"], w["c"], stack, *tabs))):
            outputs[f"{name} b{B}"] = fn().cpu()
            stages = bk.stage_ms(fn)
            out[f"{name} b{B}"] = dict(
                ms=bk.cuda_time_ms(fn, n),
                ms_cold_l2=bk.cuda_time_cold_ms(fn, 20),
                device_ms=sum(stages.values()) if stages else None)
    if save:
        torch.save(outputs, save)
    print(json.dumps({"root": str(root), "card": card, "ms": out}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
