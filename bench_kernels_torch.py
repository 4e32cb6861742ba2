"""Micro-benchmarks of the PyTorch/CUDA port's kernels at the flagship hot
shapes, on one NVIDIA GPU.

Usage: python3 bench_kernels_torch.py [attn_proj|attn_core|encoder|moe|layer|proj ...]
(default: all)

Counterpart of ``bench_kernels.py``:

- ``attn_proj``: the attention sub-block's QKV and output products at
  b=128 x 14 tokens, D=1024, in bf16 (cuBLAS) and in int8 (per-token
  activation quantization, ``torch._int_mm``): ms, TFLOP/s (TOP/s), bound;
- ``attn_core``: causal attention at B=128, H=8, T=14, hd=128 as a chain
  of torch ops (bf16 logits, f32 softmax, bf16 probabilities, ``@ v``),
  beside ``scaled_dot_product_attention`` on the same q, k, v;
- ``encoder``: the two FiLM-ResNet-50 camera encoders at b=128, 224 px,
  raw, BN-folded, int8 with dynamic and with calibrated static activation
  scales, and each int8 conv's passes (quantize, patches, ``_int_mm``,
  epilogue) in one encoder;
- ``moe``: the three top-2 MoE kernels, ``fused_top2_mlp`` (bf16 experts),
  ``fused_top2_mlp_q8`` (int8 experts, bf16 products) and
  ``fused_top2_mlp_q8c`` (int8 x int8 products), with ln_2 fused and the
  residual seed as the model calls them, at b=128 x 14 tokens (and b=1),
  D=1024, hidden 4096, top-2 of 4: kernel ms (warm and with the L2 cache
  flushed before each call), the plain version's ms, the
  least time the card could take (bound), a PyTorch library route of the
  same function, the per-stage device ms and the expert-product stages'
  achieved TFLOP/s (TOP/s) and share of their bound;
- ``layer``: one layer at b=128 as ``fused_layer_q8c`` with bf16
  projections (one launch; warm and L2-flushed, beside its bound, a
  PyTorch library route and its per-stage ms and rates), as the bf16
  attention kernel then the int8 MoE kernel (two launches, the same bits),
  as ``fused_layer_q8c`` with int8 projections beside the int8 attention
  kernel then the int8 MoE kernel (one launch against two, the same bits),
  as a one-layer ``fused_dit_q8c`` launch, and per layer of a 12-layer
  ``fused_dit_q8c`` launch;
- ``proj``: the two attention kernels, ``fused_attn_block_q8`` (int8
  projections) and ``fused_attn_block`` (bf16 projections), under each
  tile plan of their two wgmma projections (64 or 128 rows x 64 or 128
  columns) at b=128 and b=1: the projection stages' device ms and rates,
  the launch's ms and the wrapper's host ms per launch, the measurement
  behind the default plan (``attn_kernel.proj_tile_plan``), and whether
  each plan's output equals the default plan's bit for bit.

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


def card():
    """The device every bench runs on: the first CUDA card."""
    import torch
    return torch.device("cuda", 0)


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


# a __global__ stage's name in a profiler key, with its integer template
# arguments (the tile's consumer warpgroups, the kind of product)
STAGE_NAME = r"(\w+_kernel)(<[\d, ]+>)?"


def host_ms(fn, iters=100):
    """ms of host time per call of ``fn`` in a loop that does not wait for
    the card (the wrapper's checks, allocation and launches): where it
    exceeds the device time, a loop of launches is bound by the host."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return dt


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
        m = re.search(STAGE_NAME, ev.key)
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


def moe_stage_costs(N, int8_products, int8_weights, partials=None,
                    TH=1024):
    """{"moe_up": cost, "moe_down": cost} of the two expert-product stages
    of one top-2 MoE call over N token rows, each cost (bf16 flops, int8
    ops, bytes): both selected experts' weights, the stage's inputs read
    once and its output written once (up: act, bf16, or f32 for int8
    products; down: the bf16 sum's seed and output or, with ``partials``,
    its f32 partials, one per (slot, block_hidden block), as the wgmma
    stages write them for few token rows (the default))."""
    if partials is None:
        from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
            WIDE_TILE_ROWS)
        partials = N <= WIDE_TILE_ROWS
    up, down = 2 * 2 * N * D * 2 * HH, 2 * 2 * N * HH * D
    w = 1 if int8_weights else 2
    a = 1 if int8_products else 2
    up_bytes = 2 * D * 2 * HH * w + N * D * a + 2 * N * HH * (4 if a == 1
                                                             else 2)
    down_bytes = 2 * HH * D * w + 2 * N * HH * a + (
        2 * (HH // TH) * N * D * 4 if partials else 2 * N * D * 2)

    def cost(ops, nbytes):
        return (0, ops, nbytes) if int8_products else (ops, 0, nbytes)

    return {"moe_up": cost(up, up_bytes), "moe_down": cost(down, down_bytes)}


def proj_stage_costs(N, bf16=False):
    """{"qkv_wg": cost, "cproj_wg": cost} of the two projection stages of
    one attention call over N token rows, each cost (bf16 flops, int8 ops,
    bytes). int8 (fused_attn_block_q8): the int8 rows and their scales
    read, the int8 weight and its column scales (and bias) read; bf16
    (fused_attn_block): the bf16 rows and weight (and bias) read; the
    output written (QKV f32; c_proj bf16, with the residual read)."""
    if bf16:
        qkv = (2 * N * D * 3 * D, 0,
               2 * N * D + 2 * 3 * D * D + 4 * 3 * D + 4 * N * 3 * D)
        cproj = (2 * N * D * D, 0, 2 * N * D + 2 * D * D + 2 * N * D * 2)
        return {"qkv_wg": qkv, "cproj_wg": cproj}
    qkv = (0, 2 * N * D * 3 * D,
           N * D + 4 * N + 3 * D * D + 2 * 4 * 3 * D + 4 * N * 3 * D)
    cproj = (0, 2 * N * D * D,
             N * D + 4 * N + D * D + 4 * D + 2 * N * D * 2)
    return {"qkv_wg": qkv, "cproj_wg": cproj}


def stage_rates(rows, costs):
    """For each stage of ``rows`` (device ms per launch, from stage_ms)
    whose name starts with a key of ``costs``: its achieved rate
    (TFLOP/s of bf16 products or TOP/s of int8 products) and its share of
    its own bound (bound ms over stage ms)."""
    out = {}
    for name, ms in (rows or {}).items():
        for key, (flops, ops8, nbytes) in costs.items():
            if name.startswith(key):
                b_ms, by = bound(flops, ops8, nbytes)
                out[name] = dict(
                    rate=(flops + ops8) / ms / 1e9,
                    unit="TOP/s int8" if ops8 else "TFLOP/s bf16",
                    bound_ms=b_ms, bound_by=by, bound_share=b_ms / ms)
    return out


def fmt_rates(rates):
    return "; ".join(f"{k} {v['rate']:.0f} {v['unit']}, {v['bound_share']:.2f} "
                     f"of its {v['bound_by']} bound"
                     for k, v in sorted(rates.items()))


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


def quant_rows_lib(a):
    """Per-row int8 quantization in stock torch ops (the library yardstick)."""
    import torch
    s = a.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    return torch.round(a * (1.0 / s)).clamp_(-127, 127).to(torch.int8), s


def int_mm_rows(a, b):
    """torch._int_mm needs more than 16 rows: pad a with zero rows."""
    import torch
    M = a.shape[0]
    if M > 16:
        return torch._int_mm(a, b)
    pad = torch.zeros(32 - M, a.shape[1], dtype=a.dtype, device=a.device)
    return torch._int_mm(torch.cat([a, pad]), b)[:M]


def library_attn(x, c, ln1_g, qa, q_g, k_g):
    """The int8-projection attention sub-block as stock PyTorch calls
    (torch._int_mm for QKV and c_proj, SDPA in bf16): a speed yardstick."""
    import torch
    import torch.nn.functional as F
    B, T, D = x.shape
    hd = q_g.shape[0]
    H = D // hd
    x32 = x.reshape(B * T, D).float()
    h = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + 1e-12) \
        * ln1_g + c.reshape(1, D).float()
    hq, hs = quant_rows_lib(h)
    qkv = int_mm_rows(hq, qa.wqkv_q).float() * (hs * qa.wqkv_s) + qa.bqkv
    q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))

    def rms(a, g):
        return (a * torch.rsqrt(a.pow(2).mean(-1, keepdim=True) + 1e-12)
                * g).to(x.dtype)

    o = F.scaled_dot_product_attention(rms(q, q_g), rms(k, k_g),
                                       v.to(x.dtype), is_causal=True)
    oq, os_ = quant_rows_lib(o.transpose(1, 2).reshape(B * T, D).float())
    y = int_mm_rows(oq, qa.wout_q).float() * (os_ * qa.wout_s)
    return (x32 + y).to(x.dtype).reshape(B, T, D)


def library_moe(x, ln2_g, qe, e, p, TH):
    """The int8 top-2 MoE with ln_2 and the residual as stock PyTorch calls
    (torch._int_mm for the up and down products, the row quantizations in
    torch ops): a speed yardstick."""
    import torch
    import torch.nn.functional as F
    B, T, D = x.shape
    x32 = x.reshape(B * T, D).float()
    xm = (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + 1e-12)
          * ln2_g).to(x.dtype).float()
    xq, sx = quant_rows_lib(xm)
    acc = xm
    HH = qe.w1_q.shape[-1] // 2
    for slot in range(2):
        up = int_mm_rows(xq, qe.w1_q[e[slot]]).float() \
            * (sx * qe.w1_s[e[slot]]) + qe.b1[e[slot]]
        act = up[:, :HH] * F.silu(up[:, HH:])
        for kb in range(HH // TH):
            aq, sa = quant_rows_lib(act[:, kb * TH:(kb + 1) * TH])
            acc = acc + p[slot] * int_mm_rows(
                aq, qe.w2_q[e[slot], kb * TH:(kb + 1) * TH]).float() \
                * (sa * qe.w2_s[e[slot]])
    return acc.to(x.dtype).reshape(B, T, D)


def layer_cost(B, T, D, H, HH):
    """(bf16 flops, int8 ops, bytes) of one fused layer call with top-2
    routing: every input read once, the output written once, only the two
    selected experts' weights counted."""
    N, hd = B * T, D // H
    pairs = T * (T + 1) // 2                  # causal (query, key) pairs
    bf16 = 2 * N * D * 3 * D + 2 * N * D * D + B * H * pairs * hd * 4
    int8 = 2 * N * D * 2 * HH * 2 + 2 * N * HH * D * 2
    expert = D * 2 * HH + 2 * HH * 8 + HH * D + D * 4
    nbytes = (2 * N * D * 2 + 2 * (3 * D * D + D * D) + 3 * D * 4
              + 4 * D * 4 + 2 * expert)
    return bf16, int8, nbytes


def layer_q8_cost(B, T, D, H, HH):
    """(bf16 flops, int8 ops, bytes) of one fused layer call with int8
    projections: layer_cost with the QKV and c_proj products in int8 and
    their weights as int8 with f32 column scales."""
    bf16, int8, nbytes = layer_cost(B, T, D, H, HH)
    N = B * T
    proj = 2 * N * D * 3 * D + 2 * N * D * D
    return bf16 - proj, int8 + proj, nbytes - 4 * D * D + 4 * D * 4


def library_attn_bf16(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout):
    """The bf16-projection attention sub-block as stock PyTorch calls
    (cuBLAS bf16 QKV and c_proj, SDPA): a speed yardstick, and the
    attention half of library_layer."""
    import torch
    import torch.nn.functional as F
    B, T, D = x.shape
    hd = q_g.shape[0]
    H = D // hd

    def rms(a, g):
        a = a.float()
        return a * torch.rsqrt(a.pow(2).mean(-1, keepdim=True) + 1e-12) * g

    h = (rms(x, ln1_g) + c.float()).to(x.dtype)
    qkv = torch.matmul(h, wqkv) + bqkv
    q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    o = F.scaled_dot_product_attention(rms(q, q_g).to(x.dtype),
                                       rms(k, k_g).to(x.dtype), v,
                                       is_causal=True)
    return x + torch.matmul(o.transpose(1, 2).reshape(B, T, D), wout)


def library_layer(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout, ln2_g, deq, e,
                  p):
    """The same layer as stock PyTorch calls (bf16 matmuls, SDPA, experts
    dequantized to bf16 ahead of time): a speed yardstick only."""
    import torch
    import torch.nn.functional as F
    xmid = library_attn_bf16(x, c, ln1_g, wqkv, bqkv, q_g, k_g, wout)
    xm = (xmid.float() * torch.rsqrt(xmid.float().pow(2).mean(
        -1, keepdim=True) + 1e-12) * ln2_g).to(x.dtype)
    out = xm.float()
    for slot in range(2):
        w1, b1, w2 = deq[e[slot]]
        hcat = torch.matmul(xm, w1) + b1
        val, gate = hcat.chunk(2, dim=-1)
        out = out + p[slot] * torch.matmul(val * F.silu(gate), w2).float()
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
    from mode_diffusion_policy_tpu_torch.ops.quant import (dequantize_experts,
                                                       kmajor_experts)
    dev = card()
    out = {"fused_top2_mlp": {}, "fused_top2_mlp_q8": {},
           "fused_top2_mlp_q8c": {}}
    for B in (128, 1):
        a = moe_inputs(B, dev)
        qt = kmajor_experts(a["q"])
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
                lambda: fused_top2_mlp_q8c(*head, a["q"], qexp_t=qt, **kw),
                lambda: fused_top2_mlp_q8c_ref(*head, a["q"], **kw),
                lambda: library_moe(a["x"], a["ln_g"], a["q"], e, p, 1024),
                "library_moe: torch._int_mm products, row quantization, "
                "SwishGLU and sum in torch ops",
                moe_cost(B, True, True)),
        }
        n = 50 if B == 128 else 100
        for name, (kern, plain, lib, lib_is, cost) in rows.items():
            b_ms, by = bound(*cost)
            stages = stage_ms(kern)
            out[name][f"b{B}"] = dict(
                ms=cuda_time_ms(kern, n),
                ms_cold_l2=cuda_time_cold_ms(kern, 20),
                plain_ms=cuda_time_ms(plain, 3),
                library_ms=None if lib is None else cuda_time_ms(lib, 20),
                library_is=lib_is, bound_ms=b_ms, bound_by=by,
                gflop_bf16=cost[0] / 1e9, gop_int8=cost[1] / 1e9,
                mbytes=cost[2] / 1e6, stages_ms=stages,
                stage_rates=stage_rates(stages, moe_stage_costs(
                    B * T, name == "fused_top2_mlp_q8c",
                    name != "fused_top2_mlp")))
    return out


def layer_inputs(B, device, L=12, seed=0):
    """One layer's bench weights (bf16 projections, int8 experts) at D=1024,
    8 heads of 128, and the same layer stacked L times (with the K-major
    int8 expert copies that the megakernel reads)."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.quant import (
        QuantizedExperts, kmajor_experts, quantize_experts)
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
    w["qt"] = kmajor_experts(w["q"])
    one = {k: w[k][None] for k in ("ln1", "q_g", "k_g", "ln2", "wqkv",
                                   "bqkv", "wout")}
    one.update({k: v[None] for k, v in zip(QuantizedExperts._fields, w["q"])})
    one.update(w1_t=w["qt"].w1_t[None], w2_t=w["qt"].w2_t[None])
    w["stack1"] = one
    w["stackL"] = {k: v.expand(L, *v.shape[1:]).contiguous()
                   for k, v in one.items()}
    return w


def bench_layer():
    """One layer at b=128 (ms per layer): fused_layer_q8c with bf16
    projections warm and with the L2 cache flushed, beside its bound, a
    PyTorch library route of the same layer (library_layer) and its
    per-stage device ms and rates; the bf16 attention kernel then the int8
    MoE kernel (two launches, the same bits), warm and flushed;
    fused_layer_q8c with int8 projections beside the int8 attention kernel
    then the int8 MoE kernel (the same bits), warm and flushed, with its
    bound, library route (library_attn then library_moe) and stages; a
    one-layer fused_dit_q8c launch, and a 12-layer fused_dit_q8c launch
    over 12."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block, fused_attn_block_q8)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c, fused_layer_q8c)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp_q8c)
    from mode_diffusion_policy_tpu_torch.ops.quant import (dequantize_experts,
                                                       kmajor_attn,
                                                       quantize_attn)
    dev = card()
    B, n, H = 128, 50, 8
    w = layer_inputs(B, dev)
    L = w["stackL"]["wqkv"].shape[0]
    attn = (w["c"], w["ln1"], w["wqkv"], w["bqkv"], w["q_g"], w["k_g"],
            w["wout"])
    qa = quantize_attn(w["wqkv"].float(), w["bqkv"], w["wout"].float())
    qat = kmajor_attn(qa)
    moe = dict(residual=True, ln_g=w["ln2"], qexp_t=w["qt"])

    def two_kernel():
        return fused_top2_mlp_q8c(fused_attn_block(w["x"], *attn), w["idx"],
                                  w["probs"], w["q"], **moe)

    def one_layer():
        return fused_layer_q8c(w["x"], *attn, w["ln2"], w["q"], w["idx"],
                               w["probs"], qexp_t=w["qt"])

    def two_kernel_q8():
        return fused_top2_mlp_q8c(fused_attn_block_q8(
            w["x"], w["c"], w["ln1"], qa, w["q_g"], w["k_g"], qattn_t=qat),
            w["idx"], w["probs"], w["q"], **moe)

    def one_layer_q8():
        return fused_layer_q8c(w["x"], w["c"], w["ln1"], None, None,
                               w["q_g"], w["k_g"], None, w["ln2"], w["q"],
                               w["idx"], w["probs"], qattn=qa, qattn_t=qat,
                               qexp_t=w["qt"])

    def library_q8():
        return library_moe(library_attn(w["x"], w["c"], w["ln1"], qa,
                                        w["q_g"], w["k_g"]), w["ln2"], w["q"],
                           w["idx"][0].tolist(), w["probs"][0].tolist(), 1024)

    def mega(stack, n):
        tabs = (w["idx"][None].expand(n, 1, 2).contiguous(),
                w["probs"][None].expand(n, 1, 2).contiguous())
        return lambda: fused_dit_q8c(w["x"], w["c"], stack, *tabs)

    w1, b1, w2 = dequantize_experts(w["q"])
    deq = [tuple(t[e].to(torch.bfloat16) for t in (w1, b1, w2))
           for e in range(E)]
    lib = (w["x"], *attn[:2], attn[2], attn[3].to(torch.bfloat16), *attn[4:],
           w["ln2"], deq, w["idx"][0].tolist(), w["probs"][0].tolist())
    b_ms, by = bound(*layer_cost(B, T, D, H, HH))
    b8_ms, by8 = bound(*layer_q8_cost(B, T, D, H, HH))
    stages, stages8 = stage_ms(one_layer), stage_ms(one_layer_q8)
    costs8 = {**moe_stage_costs(B * T, True, True), **proj_stage_costs(B * T)}
    return {f"b{B}": dict(
        fused_layer_ms=cuda_time_ms(one_layer, n),
        fused_layer_ms_cold_l2=cuda_time_cold_ms(one_layer, 20),
        bound_ms=b_ms, bound_by=by,
        library_ms=cuda_time_ms(lambda: library_layer(*lib), 20),
        library_is="library_layer: cuBLAS bf16 products, SDPA, the int8 "
                   "experts dequantized to bf16 outside the timed call",
        stages_ms=stages,
        stage_rates=stage_rates(stages, {
            **moe_stage_costs(B * T, True, True),
            **proj_stage_costs(B * T, bf16=True)}),
        two_kernel_ms=cuda_time_ms(two_kernel, n),
        two_kernel_ms_cold_l2=cuda_time_cold_ms(two_kernel, 20),
        int8_attn=dict(
            fused_layer_ms=cuda_time_ms(one_layer_q8, n),
            fused_layer_ms_cold_l2=cuda_time_cold_ms(one_layer_q8, 20),
            bound_ms=b8_ms, bound_by=by8,
            library_ms=cuda_time_ms(library_q8, 20),
            library_is="library_attn then library_moe: torch._int_mm "
                       "products, SDPA, row quantization in torch ops",
            stages_ms=stages8, stage_rates=stage_rates(stages8, costs8),
            two_kernel_ms=cuda_time_ms(two_kernel_q8, n),
            two_kernel_ms_cold_l2=cuda_time_cold_ms(two_kernel_q8, 20)),
        megakernel_l1_ms=cuda_time_ms(mega(w["stack1"], 1), n),
        megakernel_per_layer_ms=cuda_time_ms(mega(w["stackL"], L),
                                             max(5, n // L)) / L)}


PROJ_TILES = ((128, 128), (128, 64), (64, 128), (64, 64))


def bench_proj():
    """The two attention kernels at b=128 and b=1 under each tile plan of
    their two projections (the same plan for both): {"b<B>": {"default":
    the default plan's name, "int8" (fused_attn_block_q8) and "bf16"
    (fused_attn_block): {"<rows>x<cols>": {ms, host_ms, stages_ms,
    stage_rates, equal_to_default}}}}."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block, fused_attn_block_q8, proj_tile_plan)
    from mode_diffusion_policy_tpu_torch.ops.quant import (kmajor_attn,
                                                       quantize_attn)
    dev = card()
    out = {}
    for B in (128, 1):
        w = layer_inputs(B, dev, L=1)
        qa = quantize_attn(w["wqkv"].float(), w["bqkv"], w["wout"].float())
        qat = kmajor_attn(qa)
        d = proj_tile_plan(B * T, D, 1)
        kinds = {
            "int8": lambda tiles: fused_attn_block_q8(
                w["x"], w["c"], w["ln1"], qa, w["q_g"], w["k_g"],
                qattn_t=qat, tiles=tiles),
            "bf16": lambda tiles: fused_attn_block(
                w["x"], w["c"], w["ln1"], w["wqkv"], w["bqkv"], w["q_g"],
                w["k_g"], w["wout"], tiles=tiles)}
        row = {"default": f"{d.tile_m}x{d.tile_n}"}
        for kind, call in kinds.items():
            want = call(None)
            plans = {}
            for tm, tn in PROJ_TILES:
                def fn(tiles=(tm, tn, tm, tn)):
                    return call(tiles)
                stages = stage_ms(fn)
                plans[f"{tm}x{tn}"] = dict(
                    ms=cuda_time_ms(fn, 50 if B == 128 else 100),
                    host_ms=host_ms(fn), stages_ms=stages,
                    stage_rates=stage_rates(stages, proj_stage_costs(
                        B * T, bf16=kind == "bf16")),
                    equal_to_default=bool(torch.equal(fn(), want)))
            row[kind] = plans
        out[f"b{B}"] = row
    return out


def attn_proj_cost(N, int8):
    """(bf16 flops, int8 ops, bytes) of the QKV and output projections of
    ``bench_attn_proj``: x [N, D] bf16 read once, the weights (bf16, or
    int8 with f32 column scales) read once, the output written once (bf16,
    or f32 from the int8 route)."""
    ops = 2 * N * D * (3 * D + D)
    if int8:
        return 0, ops, N * D * 2 + 4 * D * D + 4 * D * 4 + N * D * 4
    return ops, 0, N * D * 2 + 4 * D * D * 2 + N * D * 2


def bench_attn_proj():
    """The attention sub-block's two products at the DiT's hot shape
    (b=128 x 14 tokens: N=1792, D=1024), as ``bench_kernels.py``'s
    ``bench_attn_proj``: ``qkv = x @ wqkv`` then ``qkv[:, :D] @ wout``
    in bf16 (cuBLAS through ``torch.matmul``), and the int8 route
    (per-output-channel int8 weights, per-token activation quantization,
    ``torch._int_mm``, the f32 scales): {"bf16"|"int8": {ms, tflops,
    bound_ms, bound_by, bound_share}}."""
    import torch
    dev = card()
    N = 128 * T
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, sc=1.0):
        return torch.randn(*shape, generator=g, device=dev) * sc

    x = randn(N, D).to(torch.bfloat16)
    wqkv = randn(D, 3 * D, sc=0.02).to(torch.bfloat16)
    wout = randn(D, D, sc=0.02).to(torch.bfloat16)

    def q8(w):
        s = w.float().abs().amax(dim=0) / 127.0
        return torch.round(w.float() / s).to(torch.int8), s

    (qkv_q, qkv_s), (out_q, out_s) = q8(wqkv), q8(wout)

    def quant_dot(a, wq, ws):
        ax = a.float().abs().amax(dim=-1, keepdim=True) / 127.0
        aq = torch.round(a.float() / ax).to(torch.int8)
        return torch._int_mm(aq, wq).float() * ax * ws

    routes = {
        "bf16": lambda: torch.matmul(torch.matmul(x, wqkv)[:, :D], wout),
        "int8": lambda: quant_dot(quant_dot(x, qkv_q, qkv_s)[:, :D].to(
            torch.bfloat16), out_q, out_s)}
    out = {}
    for name, fn in routes.items():
        cost = attn_proj_cost(N, name == "int8")
        ms = cuda_time_ms(fn, 50)
        b_ms, by = bound(*cost)
        out[name] = dict(ms=ms, tflops=(cost[0] + cost[1]) / ms / 1e9,
                         unit="TOP/s int8" if cost[1] else "TFLOP/s bf16",
                         bound_ms=b_ms, bound_by=by, bound_share=b_ms / ms)
    out["shape"] = f"N={N} (b=128 x {T} tokens), D={D}"
    return out


def attn_core_cost(B, H, T, hd):
    """(bf16 flops, 0, bytes) of causal attention over q, k, v [B,T,H,hd]
    bf16: the causal (query, key) pairs' two products, q, k, v read once
    and the output written once."""
    pairs = T * (T + 1) // 2
    return (B * H * pairs * hd * 4, 0, 4 * B * T * H * hd * 2)


def bench_attn_core():
    """The attention core at the DiT's hot shape (B=128, H=8, T=14,
    hd=128), as ``bench_kernels.py``'s ``bench_attn_core``: bf16 logits,
    f32 causal softmax, bf16 probabilities, ``@ v``, in torch ops; beside
    it, as a yardstick, ``scaled_dot_product_attention`` (causal) on the
    same q, k, v: {"chain"|"sdpa": {ms, bound_share}, bound_ms, bound_by,
    max_abs_diff}."""
    import math

    import torch
    import torch.nn.functional as F
    dev = card()
    B, H, hd = 128, 8, 128
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, T, H, hd, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    mask = torch.ones(T, T, dtype=torch.bool, device=dev).tril()

    def chain():
        logits = torch.einsum("bthd,bshd->bhts", q, k).float() \
            / math.sqrt(hd)
        logits = logits.masked_fill(~mask, float("-inf"))
        p = torch.softmax(logits, dim=-1).to(torch.bfloat16)
        return torch.einsum("bhts,bshd->bthd", p, v).reshape(B, T, H * hd)

    def sdpa():
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)
        return o.transpose(1, 2).reshape(B, T, H * hd)

    b_ms, by = bound(*attn_core_cost(B, H, T, hd))
    out = {"bound_ms": b_ms, "bound_by": by,
           "max_abs_diff": float((chain().float() - sdpa().float()).abs()
                                 .max()),
           "shape": f"B={B}, H={H}, T={T}, hd={hd}"}
    for name, fn in (("chain", chain), ("sdpa", sdpa)):
        ms = cuda_time_ms(fn, 100)
        out[name] = dict(ms=ms, bound_share=b_ms / ms)
    return out


ENC_B, ENC_HW = 128, 224


def encoder_agent(dev):
    """The port agent of ``bench_kernels.py``'s ``bench_encoder`` (latent
    1024, 1 layer, 8 heads, cond 512, 2x FiLM-ResNet-50, bf16) with every
    parameter and every BatchNorm statistic 0.01."""
    import itertools

    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import (
        ENCODERS, MoDEAgent, MoDEAgentConfig)
    cfg = MoDEAgentConfig(latent_dim=1024, n_layers=1, n_heads=8,
                          cond_dim=512, resnet_type="50",
                          dtype=torch.bfloat16)
    agent = MoDEAgent(cfg, device=dev)
    stats = itertools.chain.from_iterable(
        getattr(agent, name).buffers() for name in ENCODERS)
    with torch.no_grad():
        for t in itertools.chain(agent.parameters(), stats):
            if t.is_floating_point():
                t.fill_(0.01)
    return agent


def split_forward(mod, name, rows):
    """A forward for the int8 conv ``mod`` that computes what
    ``QuantConv.forward`` computes, with CUDA events after each of its
    passes; appends (name, M, K, N, events) to ``rows``."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.encoders.resnet import (
        conv_operands_i8, int_mm)

    def forward(x):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        xq, post = mod.quantize_input(x)
        ev[1].record()
        a, b, shape = conv_operands_i8(xq, mod.kernel_q, mod.stride, mod.pad)
        ev[2].record()
        y = int_mm(a, b)
        ev[3].record()
        out = mod.epilogue(y.reshape(shape).permute(0, 3, 1, 2), post)
        ev[4].record()
        rows.append((name, a.shape[0], a.shape[1], b.shape[1], ev))
        return out
    return forward


CONV_PASSES = ("quantize", "patches", "int_mm", "epilogue")


def conv_split(enc, x, cond, runs=3):
    """Device ms of each int8 conv of ``enc`` (``QuantConv``), in forward
    order, split into its passes: the activation quantization, the int8
    patch and weight matrices, ``torch._int_mm`` and the epilogue (mean of
    ``runs`` forwards, CUDA events between the passes); with the product's
    int8 TOP/s and its bound, and whether the split forward's output
    equals the plain forward's bit for bit."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.encoders.resnet import (
        QuantConv)
    want = enc(x, cond)
    convs = [(n, m) for n, m in enc.named_modules()
             if isinstance(m, QuantConv)]
    rows = []
    for n, m in convs:
        m.forward = split_forward(m, n, rows)
    try:
        for _ in range(runs):
            got = enc(x, cond)
        torch.cuda.synchronize()
    finally:
        for _, m in convs:
            del m.forward
    per = len(convs)
    entries = []
    for i, (name, M, K, N, _) in enumerate(rows[:per]):
        ms = [sum(rows[r * per + i][4][p].elapsed_time(
            rows[r * per + i][4][p + 1]) for r in range(runs)) / runs
            for p in range(len(CONV_PASSES))]
        b_ms, by = bound(0, 2 * M * K * N, M * K + K * N + 4 * M * N)
        entries.append(dict(
            conv=name, M=M, K=K, N=N, ms=sum(ms),
            **{f"{p}_ms": t for p, t in zip(CONV_PASSES, ms)},
            int_mm_tops=2 * M * K * N / ms[2] / 1e9,
            int_mm_bound_ms=b_ms, int_mm_bound_by=by))
    return entries, bool(torch.equal(got, want))


def bench_encoder():
    """The two camera encoders at b=128, 224 x 224, as ``bench_kernels.py``
    ``bench_encoder`` runs them (``encoder_agent``; both cameras' frames
    and the goal drawn from a seed): the device ms of
    ``embed_visual_obs`` under four routes (the raw encoders, BN-folded,
    int8 with dynamic activation scales, int8 with static scales
    calibrated on the same batch); for one encoder on the dynamic int8
    route, each conv's passes (``conv_split``), their sum against that
    encoder's ms, and the five largest convs."""
    import torch
    dev = card()
    agent = encoder_agent(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rs, rg = (torch.randn(ENC_B, 1, ENC_HW, ENC_HW, 3, generator=g,
                          device=dev) for _ in range(2))
    goal = torch.randn(ENC_B, 1, 512, generator=g, device=dev)

    def enc(serving=True):
        return lambda: agent.embed_visual_obs(rs, rg, goal, serving=serving)

    out = {"shape": f"2 cameras, b={ENC_B}, {ENC_HW}x{ENC_HW}, "
                    "FiLM-ResNet-50 bf16, every weight 0.01"}
    out["unfolded_ms"] = cuda_time_ms(enc(serving=False), 5)
    agent.fold_encoders_for_inference()
    out["folded_ms"] = cuda_time_ms(enc(), 5)
    agent.quantize_encoders_for_inference()
    dyn = agent.q8
    out["int8_dynamic_ms"] = cuda_time_ms(enc(), 5)
    agent.quantize_encoders_for_inference(calib_batch={
        "rgb_static": rs, "rgb_gripper": rg, "lang_emb": goal})
    out["int8_static_ms"] = cuda_time_ms(enc(), 5)
    out["int8_static_clips"] = dict(agent.q8_clips)
    out["finite"] = bool(torch.isfinite(
        enc()()["state_images"].float()).all())
    one = dyn["static_resnet"]
    x, cond = rs[:, 0], goal[:, 0]
    entries, same = conv_split(one, x, cond)
    total = cuda_time_ms(lambda: one(x, cond), 5)
    top = sorted(entries, key=lambda e: -e["ms"])[:5]
    out["int8_dynamic_split"] = dict(
        encoder="static_resnet", convs=entries, conv_count=len(entries),
        sum_ms=sum(e["ms"] for e in entries), encoder_ms=total,
        pass_sums_ms={p: sum(e[f"{p}_ms"] for e in entries)
                      for p in CONV_PASSES},
        largest_five=[e["conv"] for e in top],
        split_output_equal=same)
    return out


ALL = {"attn_proj": bench_attn_proj, "attn_core": bench_attn_core,
       "encoder": bench_encoder, "moe": bench_moe, "layer": bench_layer,
       "proj": bench_proj}


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
