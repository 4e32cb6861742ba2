"""Micro-benchmarks of the PyTorch/CUDA port's kernels at the flagship hot
shapes, on one NVIDIA GPU.

Usage: python3 bench_kernels_torch.py [moe|layer ...]   (default: both)

Counterpart of ``bench_kernels.py``'s ``bench_moe`` and ``bench_layer``:

- ``moe``: the three top-2 MoE kernels, ``fused_top2_mlp`` (bf16 experts),
  ``fused_top2_mlp_q8`` (int8 experts, bf16 products) and
  ``fused_top2_mlp_q8c`` (int8 x int8 products), with ln_2 fused and the
  residual seed as the model calls them, at b=128 x 14 tokens (and b=1),
  D=1024, hidden 4096, top-2 of 4: kernel ms (warm and with the L2 cache
  flushed before each call), the plain version's ms, the
  least time the card could take (bound), a PyTorch library route of the
  same function and the per-stage device ms;
- ``layer``: one layer as the attention kernel then the int8 MoE kernel
  (two launches), as ``fused_layer_q8c`` (one launch), as a one-layer
  ``fused_dit_q8c`` launch, and per layer of a 12-layer ``fused_dit_q8c``
  launch, at b=128.

Timing uses CUDA events around many launches after a warm-up (the method
of ``chip_smoke.cuda_time_ms``, copied here). Each function returns a dict
(``chip_smoke.py`` uses them) and ``main`` prints one JSON line per
function, with the card's name and power limit. Without CUDA it prints a
skip line and exits 0. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import warnings

# H100 SXM peak rates (NVIDIA data sheet, dense) used for the bounds
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
D, HH, E, T = 1024, 4096, 4, 14


def cuda_time_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_time_cold_ms(fn, iters):
    """ms of one call that finds the L2 cache cold, as a layer finds it
    after the other layers' weights went through: a 128 MB write before
    each call, CUDA events around the call alone."""
    import torch
    buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def stage_ms(fn, iters=10):
    """Device ms per __global__ stage of one call, from torch.profiler
    (CUPTI); None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the profiler's cycle notice
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
    rows = {}
    for ev in averages:
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        m = re.search(r"(\w+_kernel)(<\d+>)?", ev.key)
        if us and m:
            name = m.group(1) + (m.group(2) or "")
            rows[name] = rows.get(name, 0.0) + us / iters / 1e3
    return rows or None


def bound(flops, ops8, nbytes):
    """(ms, what bounds it): the larger of the operations over the card's
    peak rate for their type and the bytes over its memory rate."""
    ops_ms = (flops / PEAK_BF16 + ops8 / PEAK_INT8) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def moe_cost(B, int8_products, int8_weights):
    """(bf16 flops, int8 ops, bytes) of one top-2 MoE call with ln_2 and
    the residual: the two selected experts' up and down products and
    weights (with their scales and biases), ln_2, x read and the output
    written once."""
    N = B * T
    ops = 2 * (2 * N * D * 2 * HH + 2 * N * HH * D)
    if int8_weights:
        expert = D * 2 * HH + HH * D + 2 * HH * 8 + D * 4
    else:
        expert = (D * 2 * HH + HH * D + 2 * HH) * 2
    nbytes = 2 * N * D * 2 + D * 4 + 2 * expert
    return (0, ops, nbytes) if int8_products else (ops, 0, nbytes)


def moe_inputs(B, device, seed=0):
    """The bench's MoE inputs: x [B,14,1024] bf16, ln_2 scale, random f32
    experts (N(0, 0.02), zero b1) in bf16 and quantized to int8, experts
    1 and 3 with probabilities 0.6 and 0.4 as a one-row routing table."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.quant import quantize_experts
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=device) * sc

    w1, w2 = randn(E, D, 2 * HH, sc=0.02), randn(E, HH, D, sc=0.02)
    b1 = torch.zeros(E, 2 * HH, device=device)
    return dict(
        x=randn(B, T, D).to(torch.bfloat16),
        ln_g=1.0 + randn(D, sc=0.1),
        bf16=tuple(w.to(torch.bfloat16) for w in (w1, b1, w2)),
        q=quantize_experts(w1, b1, w2),
        idx=torch.tensor([[1, 3]], dtype=torch.int32, device=device),
        probs=torch.tensor([[0.6, 0.4]], device=device))


def library_moe_bf16(x, ln_g, w1, b1, w2, e, p):
    """The bf16 top-2 MoE with ln_2 and the residual as one PyTorch route:
    the row norm and SwishGLU in torch ops, cuBLAS bf16 products, the
    weighted sum in f32 (a speed yardstick only)."""
    import torch
    import torch.nn.functional as F
    x32 = x.float()
    xm = (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + 1e-12)
          * ln_g).to(x.dtype)
    out = xm.float()
    for slot in range(2):
        h = torch.matmul(xm, w1[e[slot]]) + b1[e[slot]]
        val, gate = h.chunk(2, dim=-1)
        out = out + p[slot] * torch.matmul(val * F.silu(gate),
                                           w2[e[slot]]).float()
    return out.to(x.dtype)


def bench_moe():
    """Each MoE kernel at each batch: {kernel: {"b<B>": {ms, ms_cold_l2,
    plain_ms, library_ms, library_is, bound_ms, bound_by, stages_ms}}}.
    ``ms`` repeats the call on the same weights, which stay in the 50 MB L2
    cache where they fit (the int8 experts, 25 MB); ``ms_cold_l2`` flushes
    it before each call."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp, fused_top2_mlp_q8, fused_top2_mlp_q8c,
        fused_top2_mlp_q8_ref, fused_top2_mlp_q8c_ref, fused_top2_mlp_ref)
    from mode_diffusion_policy_tpu_torch.ops.quant import dequantize_experts
    dev = torch.device("cuda", 0)
    out = {"fused_top2_mlp": {}, "fused_top2_mlp_q8": {},
           "fused_top2_mlp_q8c": {}}
    for B in (128, 1):
        a = moe_inputs(B, dev)
        kw = dict(residual=True, ln_g=a["ln_g"])
        head = (a["x"], a["idx"], a["probs"])
        e, p = a["idx"][0].tolist(), a["probs"][0].tolist()
        # the int8 experts dequantized to bf16 outside the timed call: the
        # library route has no int8-weight product
        deq = tuple(t.to(torch.bfloat16) for t in dequantize_experts(a["q"]))
        rows = {
            "fused_top2_mlp": (
                lambda: fused_top2_mlp(*head, *a["bf16"], **kw),
                lambda: fused_top2_mlp_ref(*head, *a["bf16"], **kw),
                lambda: library_moe_bf16(a["x"], a["ln_g"], *a["bf16"], e,
                                         p),
                "cuBLAS bf16 products, SwishGLU and sum in torch ops",
                moe_cost(B, False, False)),
            "fused_top2_mlp_q8": (
                lambda: fused_top2_mlp_q8(*head, a["q"], **kw),
                lambda: fused_top2_mlp_q8_ref(*head, a["q"], **kw),
                lambda: library_moe_bf16(a["x"], a["ln_g"], *deq, e, p),
                "the bf16 route on the int8 experts dequantized to bf16 "
                "outside the timed call (no PyTorch call multiplies int8 "
                "weights with bf16 activations)",
                moe_cost(B, False, True)),
            "fused_top2_mlp_q8c": (
                lambda: fused_top2_mlp_q8c(*head, a["q"], **kw),
                lambda: fused_top2_mlp_q8c_ref(*head, a["q"], **kw),
                None, None, moe_cost(B, True, True)),
        }
        n = 50 if B == 128 else 100
        for name, (kern, plain, lib, lib_is, cost) in rows.items():
            b_ms, by = bound(*cost)
            out[name][f"b{B}"] = dict(
                ms=cuda_time_ms(kern, n),
                ms_cold_l2=cuda_time_cold_ms(kern, 20),
                plain_ms=cuda_time_ms(plain, 3),
                library_ms=None if lib is None else cuda_time_ms(lib, 20),
                library_is=lib_is, bound_ms=b_ms, bound_by=by,
                gflop_bf16=cost[0] / 1e9, gop_int8=cost[1] / 1e9,
                mbytes=cost[2] / 1e6, stages_ms=stage_ms(kern))
    return out


def layer_inputs(B, device, L=12, seed=0):
    """One layer's bench weights (bf16 projections, int8 experts) at D=1024,
    8 heads of 128, and the same layer stacked L times."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.quant import (QuantizedExperts,
                                                           quantize_experts)
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, sc=1.0, off=0.0):
        return torch.randn(*shape, generator=g, device=device) * sc + off

    hd = 128
    bf = torch.bfloat16
    w = dict(x=randn(B, T, D, sc=0.5).to(bf), c=randn(1, 1, D, sc=0.2),
             ln1=randn(D, sc=0.1, off=1.0), ln2=randn(D, sc=0.1, off=1.0),
             wqkv=randn(D, 3 * D, sc=0.02).to(bf), bqkv=randn(3 * D, sc=0.02),
             q_g=randn(hd, sc=0.1, off=1.0), k_g=randn(hd, sc=0.1, off=1.0),
             wout=randn(D, D, sc=0.02).to(bf),
             idx=torch.tensor([[1, 3]], dtype=torch.int32, device=device),
             probs=torch.tensor([[0.6, 0.4]], device=device))
    w["q"] = quantize_experts(randn(E, D, 2 * HH, sc=0.02),
                              torch.zeros(E, 2 * HH, device=device),
                              randn(E, HH, D, sc=0.02))
    one = {k: w[k][None] for k in ("ln1", "q_g", "k_g", "ln2", "wqkv",
                                   "bqkv", "wout")}
    one.update({k: v[None] for k, v in zip(QuantizedExperts._fields, w["q"])})
    w["stack1"] = one
    w["stackL"] = {k: v.expand(L, *v.shape[1:]).contiguous()
                   for k, v in one.items()}
    return w


def bench_layer():
    """One layer four ways (ms per layer): the attention kernel then the
    int8 MoE kernel, fused_layer_q8c, a one-layer fused_dit_q8c launch, and
    a 12-layer fused_dit_q8c launch over 12."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c, fused_layer_q8c)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp_q8c)
    dev = torch.device("cuda", 0)
    B, n = 128, 50
    w = layer_inputs(B, dev)
    L = w["stackL"]["wqkv"].shape[0]
    attn = (w["c"], w["ln1"], w["wqkv"], w["bqkv"], w["q_g"], w["k_g"],
            w["wout"])

    def two_kernel():
        return fused_top2_mlp_q8c(fused_attn_block(w["x"], *attn), w["idx"],
                                  w["probs"], w["q"], residual=True,
                                  ln_g=w["ln2"])

    def one_layer():
        return fused_layer_q8c(w["x"], *attn, w["ln2"], w["q"], w["idx"],
                               w["probs"])

    def mega(stack, n):
        tabs = (w["idx"][None].expand(n, 1, 2).contiguous(),
                w["probs"][None].expand(n, 1, 2).contiguous())
        return lambda: fused_dit_q8c(w["x"], w["c"], stack, *tabs)

    return {f"b{B}": dict(
        two_kernel_ms=cuda_time_ms(two_kernel, n),
        fused_layer_ms=cuda_time_ms(one_layer, n),
        megakernel_l1_ms=cuda_time_ms(mega(w["stack1"], 1), n),
        megakernel_per_layer_ms=cuda_time_ms(mega(w["stackL"], L),
                                             max(5, n // L)) / L)}


ALL = {"moe": bench_moe, "layer": bench_layer}


def main(argv):
    import torch
    names = argv or list(ALL)
    unknown = [n for n in names if n not in ALL]
    if unknown:
        raise SystemExit(f"unknown bench {unknown}; pick from {list(ALL)}")
    if not torch.cuda.is_available():
        print(json.dumps({"skipped": "CUDA is not available"}))
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    for n in names:
        print(json.dumps({"bench": n, "card": card, "result": ALL[n]()}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
