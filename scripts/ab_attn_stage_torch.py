"""Time the attention stage of the port's attention-bearing kernels in one
checkout, for an A/B of two checkouts on the same card.

    python3 scripts/ab_attn_stage_torch.py [ROOT] [--save FILE]
    python3 scripts/ab_attn_stage_torch.py --compare FILE FILE [FILE ...]

ROOT (default: the checkout holding this script) is the root of a checkout
of this repository; its kernels are built from its own csrc/. At T = 14, 20,
64 and 160 tokens per sample, b=128 and b=1 (D=1024, 8 heads of 128, the
bench layer's seeded weights from that checkout's
bench_kernels_torch.layer_inputs, x drawn from a seed per shape, the shared
cond row), it times fused_attn_block, fused_attn_block_q8 (its projections
quantized from the bench layer's), fused_layer_q8c (bf16 projections) and
the 12-layer fused_dit_q8c (the bench layer stacked, bf16 projections) warm
with CUDA events, and their attention stage: the device ms of the
attn_kernel stage in each per-layer launcher (torch.profiler,
chip_smoke.attn_stage_ms) and the megakernel's attention ms a layer from its
own clock (times=, chip_smoke.dit_split), with the megakernel's launch info
(DIT_INFO: registers, local bytes, key block). Beside them stand the
stage's bound (chip_smoke.attn_stage_cost) and one causal SDPA call on the
stage's bf16 q^, k^ and v (chip_smoke.attn_stage_yardstick), both from the
chip_smoke.py of the checkout holding this script. Run it from two checkouts
in turns in one call (A, B, B, A) to compare them; it prints one JSON line
with the card's name and power limit. With --save it also writes each
launcher's output to FILE (torch.save, on the CPU); --compare then says,
output by output, whether the saved outputs of several runs are equal bit
for bit. Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import inspect
import json
import runpy
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = ((14, 128), (14, 1), (20, 128), (20, 1), (64, 128), (64, 1),
          (160, 128), (160, 1))


def compare(files):
    import torch
    runs = [torch.load(f) for f in files]
    out = {name: all(r.get(name) is not None and torch.equal(r[name],
                                                             runs[0][name])
                     for r in runs)
           for name in runs[0]}
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
    root = Path(argv[0] if argv else HERE)
    sys.path.insert(0, str(root.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_attn_stage_torch: CUDA is not available")
    smoke = runpy.run_path(str(HERE / "chip_smoke.py"),
                           run_name="chip_smoke_ab")
    import bench_kernels_torch as bk
    from mode_diffusion_policy_tpu_torch.ops import quant
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block, fused_attn_block_q8)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        DIT_INFO, dit_stage_names, fused_dit_q8c, fused_layer_q8c)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    w = bk.layer_inputs(1, dev)
    D, H = w["wout"].shape[0], w["wout"].shape[0] // w["q_g"].shape[0]
    stack = dict(w["stackL"])
    stack.setdefault("w1_t", stack["w1_q"].transpose(-1, -2).contiguous())
    stack.setdefault("w2_t", stack["w2_q"].transpose(-1, -2).contiguous())
    L = stack["wqkv"].shape[0]
    tabs = (w["idx"][None].expand(L, 1, 2).contiguous(),
            w["probs"][None].expand(L, 1, 2).contiguous())
    lkw, akw = {}, {}
    if "qexp_t" in inspect.signature(fused_layer_q8c).parameters:
        lkw["qexp_t"] = quant.kmajor_experts(w["q"])
    qa = quant.quantize_attn(w["wqkv"].float(), w["bqkv"], w["wout"].float())
    if "qattn_t" in inspect.signature(fused_attn_block_q8).parameters:
        akw["qattn_t"] = quant.kmajor_attn(qa)
    attn = (w["c"], w["ln1"], w["wqkv"], w["bqkv"], w["q_g"], w["k_g"],
            w["wout"])
    out, outputs = {}, {}
    for T, B in SHAPES:
        g = torch.Generator(device=dev).manual_seed(1000 * T + B)
        x = (torch.randn(B, T, D, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)
        calls = {
            "fused_attn_block": lambda: fused_attn_block(x, *attn),
            "fused_attn_block_q8": lambda: fused_attn_block_q8(
                x, w["c"], w["ln1"], qa, w["q_g"], w["k_g"], **akw),
            "fused_layer_q8c": lambda: fused_layer_q8c(
                x, *attn, w["ln2"], w["q"], w["idx"], w["probs"], **lkw)}
        big = B * T > 4096
        n = 5 if big else 20
        stage = smoke["attn_stage_ms"](calls, 3 if big else 10)
        sdpa = smoke["attn_stage_yardstick"](x, *attn[:6], n)
        rec = {}
        for name, fn in {**calls, "fused_dit_q8c": lambda: fused_dit_q8c(
                x, w["c"], stack, *tabs)}.items():
            outputs[f"{name} b{B}_T{T}"] = fn().cpu()
            ms = bk.cuda_time_ms(fn, n)
            if name == "fused_dit_q8c":
                st = smoke["dit_split"](
                    fused_dit_q8c, dit_stage_names, x, w["c"], stack, *tabs,
                    {}, False, fused_dit_q8c.last_grid[5])["attn"] / L / 1e3
            else:
                st = stage[name]
            rec[name] = dict(ms=ms, attn_stage=smoke["attn_stage_record"](
                st, B, T, H, D // H, name == "fused_attn_block_q8", sdpa))
        rec["fused_dit_q8c"]["info"] = dict(zip(DIT_INFO,
                                                fused_dit_q8c.last_grid))
        out[f"b{B}_T{T}"] = rec
    if save:
        torch.save(outputs, save)
    print(json.dumps({"root": str(root), "card": card, "ms": out}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
