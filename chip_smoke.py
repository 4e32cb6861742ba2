"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mode_diffusion_policy_tpu_torch/csrc``
(plain nvcc, one process per source, started together), holds each kernel
against its plain PyTorch version at the served shapes, and drives the
served paths at full flagship width (12 layers, D=1024, 2x FiLM-ResNet-50 at
224 px, seeded random weights made on the card) through ``RolloutPolicy``:

- ``parity`` at b=128 and b=1 (the whole-layer kernel ``fused_layer_q8c``,
  120 launches per chunk);
- ``b1-latency`` and ``b1-latency-max`` at b=1 (the DiT megakernel
  ``fused_dit_q8c``, 10 launches per chunk, bf16 or int8 attention
  projections);
- ``max-throughput`` at b=128 (int8 encoder convs calibrated on a few
  synthetic frames, then per layer and step the attention kernel
  ``fused_attn_block_q8`` and the MoE kernel ``fused_top2_mlp_q8c``: 120
  launches of each per chunk),

each preset applied in turn to the same agent, each policy serving its own
precast copy of it; then the evaluation sweep's samplers (``conf/sweep.yaml``:
ddim, dpmpp_2m, euler, heun, dpmpp_2s_ancestral) on ``parity`` at b=128,
and dpmpp_2s_ancestral on ``max-throughput`` (b=128), ``b1-latency`` and
``b1-latency-max`` (b=1), whose off-schedule evaluations route inline and
run the attention sub-block through ``fused_attn_block`` (bf16
projections) or ``fused_attn_block_q8`` with one cond row per sample;
then the bf16 kernel configuration (``use_pallas_moe`` and
``use_pallas_attn``, no int8, no preset) at b=128 and b=1: per layer and
step ``fused_attn_block`` then the bf16 MoE kernel ``fused_top2_mlp``
(120 + 120 launches per chunk); the kernel bench
(``bench_kernels_torch.py``), the path of ``fused_top2_mlp_q8`` and the
measurement behind the int8 projections' tile plan; and the whole-layer
kernel with int8 projections (``max-throughput``'s flags with
``use_fused_layer``, the megakernel off) at b=128 and b=1: 120
``fused_layer_q8c`` launches per chunk.

For the megakernel it also checks each layer against the plain layer, the
whole stack against the plain stack and against 12 chained
``fused_layer_q8c`` launches (with int8 projections
``fused_layer_q8c(qattn=)``), bit for bit, and prints its launch (grid,
CTAs per SM, dynamic and static shared memory, ring stages, registers) and
the device time of each stage of one step, read by the kernel after every
grid barrier; for the two-kernel
layer, each kernel against its plain version (at b=128, b=1 and 3 x 13
tokens) and, on every layer, attention then MoE against a one-layer
megakernel launch with int8 projections, bit for bit; for
``fused_layer_q8c`` with int8 projections, the kernel against its plain
version and, on every layer, against the int8 attention kernel then the
int8 MoE kernel, bit for bit; for ``fused_attn_block``, the kernel against its
plain version with a shared and a per-sample cond at b=128, b=1 and 3 x 13
tokens, and, on every layer,
``fused_attn_block`` then the MoE kernel against one ``fused_layer_q8c``
launch, bit for bit; for both attention kernels, a per-sample cond of equal
rows against the shared row, bit for bit; for ``fused_attn_block``, also its
output under every tile plan of its bf16 wgmma projections against the
default plan's (reported); for the int8 convs,
``torch._int_mm`` against exact CPU sums; for ``fused_top2_mlp`` and
``fused_top2_mlp_q8``, each against its plain version, and the int8-weight
kernel with unit scales against the bf16 kernel on the same weights, bit
for bit. It checks the launch counts of
every path and the kernel-vs-plain action error, times the kernels, their
plain versions, a PyTorch-library composition of the same work, whole
chunks and the encoders, with the achieved TFLOP/s (TOP/s) of the
products that the kernels run on wgmma (the expert products of every MoE
kernel, the int8 attention's projections), and prints one JSON line for the
kernels and a final status line. Every phase that fails exits non-zero; without CUDA nothing is run.
Imports nothing of JAX.
"""
from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import time
import warnings

from bench_kernels_torch import (STAGE_NAME, fmt_rates, layer_cost,
                                 layer_q8_cost, library_attn,
                                 library_attn_bf16, library_layer,
                                 library_moe, moe_stage_costs,
                                 proj_stage_costs, stage_rates)

T0 = time.perf_counter()

# H100 SXM peak rates (NVIDIA data sheet, dense) used for the bounds
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

# kernel vs plain version, one layer, in bf16. Both round every cast the
# same way and their int8 products are exact, but their f32 sums of bf16
# products run in another order (tensor-core tiles vs cuBLAS), and the
# layer amplifies last-bit differences: a bf16 flip in q/k moves the
# softmax, a flip in x_mid moves an int8 input, and one int8 step moves a
# whole output row. So some outputs land one bf16 step apart, and the gate
# counts bf16 steps relative to the output's size: mean |diff| <= 2^-8 *
# mean |out| (about one step on half the elements), max |diff| <= 2^-5 *
# max |out| (four steps at the largest value). A wrong expert, scale or
# hidden block changes the MoE contribution itself, far beyond that.
LAYER_MEAN_REL = 2.0 ** -8
LAYER_MAX_REL = 2.0 ** -5
# kernel path vs plain path, whole chunk: the parity preset's budget, or
# twice the distance between two valid plain evaluations (products
# accumulated in f32 vs f64) when that noise floor is larger. 120 layer
# calls per chunk each inject the last-bit differences described above;
# the floor measures how far they carry on this model and these weights.
# On the megakernel paths the floor is the larger of two such distances:
# products in f64, and products, norms' sums of squares and softmax in
# f64. With int8 attention projections (b1-latency-max) the only float
# products left are short bf16 dot products that f32 holds exactly, so the
# products-only floor is zero there, while the kernel's last bits still
# move in its norms and softmax sums.
CHUNK_MAE_TOL = 1e-3
CHUNK_FLOOR_FACTOR = 2.0
# megakernel vs its plain version: each layer (a one-layer launch of the
# same kernel) is held to the layer gates above on its own input, and the
# whole 12-layer launch must equal those launches chained, bit for bit. The
# whole stack against the plain stack is printed, not gated: each layer
# carries its last-bit differences into the next, and over 12 layers even
# two plain stacks (products accumulated in f32 vs f64) differ by more
# than the layer gate (mean 8.3e-3 against a gate of 3.2e-3 at b=1 on an
# H100 80GB HBM3 at 700 W), so the layer gate cannot hold there for any two
# implementations.


def phase(name, start):
    print(f"[{time.perf_counter() - T0:8.1f} s] {name} "
          f"({time.perf_counter() - start:.1f} s)", flush=True)


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


def dit_cost(B, T, D, H, HH, L, int8_attn):
    """(bf16 flops, int8 ops, bytes) of one megakernel call: L layers of
    layer_cost, but the activation read once and the output written once,
    and the attention weights in int8 with their scales when int8_attn."""
    bf16, int8, nbytes = layer_cost(B, T, D, H, HH)
    N = B * T
    proj = 2 * N * D * 3 * D + 2 * N * D * D
    nbytes -= 2 * N * D * 2
    if int8_attn:
        bf16, int8 = bf16 - proj, int8 + proj
        nbytes -= (3 * D * D + D * D) + (-4 * D * 4)
    return L * bf16, L * int8, L * nbytes + 2 * N * D * 2


def bound_of(bf16, int8, nbytes):
    ops_ms = (bf16 / PEAK_BF16 + int8 / PEAK_INT8) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


# the __global__ names of every DiT kernel's stages (the megakernel's, the
# layer kernel's, the two-kernel paths', the wgmma MoE stages')
DIT_KERNELS = (r"fused_dit_kernel|(ln1|ln1_quant|attn|quant_f32|ln2_quant|"
               r"quant_row|act_quant|moe_sum|ln2|moe_up_wg|moe_down_wg|"
               r"moe_up_bf16_wg|moe_down_bf16_wg|qkv_wg|cproj_wg)_kernel")


def chunk_split(policy, obs, goal, noise, chunk_ms):
    """One chunk under torch.profiler: device time in the DiT kernels (the
    megakernel's, the layer kernel's or the two-kernel path's stages) and in
    the rest (encoders, glue). The device idle share is one minus the device busy time over
    ``chunk_ms``, the chunk's wall time measured without the profiler (the
    profiler's own host overhead lengthens the chunk it traces)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    policy.predict_chunk(obs, goal, noise)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            policy.predict_chunk(obs, goal, noise)
            torch.cuda.synchronize()
        averages = prof.key_averages()
    dit = other = 0.0
    for ev in averages:
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if not us:
            continue
        if re.search(DIT_KERNELS, ev.key):
            dit += us / 1e3
        else:
            other += us / 1e3
    if dit + other == 0.0:
        return None
    return dict(chunk_ms=chunk_ms, dit_device_ms=dit, other_device_ms=other,
                idle_share=max(0.0, 1.0 - (dit + other) / chunk_ms))


def kernel_stages(fn, label, iters=10, costs=None):
    """Device time per __global__ stage of one launch, from torch.profiler
    (CUPTI); prints 'not measured' when the trace holds no device time.
    With ``costs`` (bench_kernels_torch.moe_stage_costs) it also prints the
    expert-product stages' achieved rates and shares of their bounds."""
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
    if not rows:
        print("  per-stage device time: not measured (no device time in the "
              "profiler trace)", flush=True)
        return None
    total = sum(rows.values())
    print(f"  per-stage device time, {label}, ms per launch: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(rows.items(), key=lambda r: -r[1]))
        + f"; sum {total:.4f}", flush=True)
    if costs:
        print(f"  expert products, {label}: "
              f"{fmt_rates(stage_rates(rows, costs))}", flush=True)
    return rows


def check_megakernel(dit, st, idx_L, p_L, emb_all, steps, T, gen,
                     deq_layers, cfg):
    """The DiT megakernel at full width, b=1 and b=128, at two routing
    steps: each layer (a one-layer slice of the stack) against the plain
    layer on the kernel's own input, with the layer gates; the whole stack
    against those single-layer launches chained (bit for bit) and against
    12 chained fused_layer_q8c launches (bf16 projections; with int8
    projections fused_layer_q8c(qattn=); bit for bit); the distance of the
    whole stack to the plain stack beside that of two plain stacks. Then
    the kernel's, the plain version's and the library yardstick's times,
    the launch's grid and shared memory, and the device time of each stage
    of one step from the kernel's own clock reads after every grid
    barrier."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        DIT_INFO, DIT_KMAJOR_ATTN, STACKED_QATTN, dit_stage_names,
        fused_dit_q8c, fused_dit_q8c_ref, fused_layer_q8c)
    from mode_diffusion_policy_tpu_torch.ops.quant import (
        AttnKMajor, QuantizedAttn, QuantizedExperts)

    dev = st["w1_q"].device
    int8_attn = "sqkv" in st
    name = "int8" if int8_attn else "bf16"
    L, D, H, HH = cfg.n_layers, cfg.latent_dim, cfg.n_heads, 4 * cfg.latent_dim
    blk = dit.blocks[0]
    kw = dict(eps1=blk.ln_1.eps, eps_qk=blk.attn.q_norm.eps,
              eps2=blk.ln_2.eps)
    out = dict(max_abs_err=0.0, stack_max_abs_err=0.0, stack_vs_plain=[])
    qexp_L = [QuantizedExperts(*(st[k][l] for k in QuantizedExperts._fields))
              for l in range(L)]
    # the K-major copies that fused_layer_q8c reads, made once per
    # quantization (MoDeDiT.quantize_experts_)
    qt_L = [blk.experts_qt for blk in dit.blocks]
    for B in (1, 128):
        for s in steps:
            x = torch.randn(B, T, D, generator=gen, device=dev).to(
                torch.bfloat16)
            c = emb_all[s][None]
            full = fused_dit_q8c(x, c, st, idx_L, p_L, step=s, **kw)
            torch.cuda.synchronize()
            y = x
            worst = 0.0
            for l in range(L):
                stl = {k: v[l:l + 1] for k, v in st.items()}
                tabs = (idx_L[l:l + 1], p_L[l:l + 1])
                yk = fused_dit_q8c(y, c, stl, *tabs, step=s, **kw)
                yp = fused_dit_q8c_ref(y, c, stl, *tabs, step=s, **kw)
                d = (yk.float() - yp.float()).abs()
                mean_tol = LAYER_MEAN_REL * yp.float().abs().mean().item()
                max_tol = LAYER_MAX_REL * yp.float().abs().max().item()
                if not (bool(torch.isfinite(yk).all())
                        and d.mean().item() <= mean_tol
                        and d.max().item() <= max_tol):
                    raise SystemExit(
                        f"fused_dit_q8c {name} b={B} step={s} layer {l}: "
                        f"max {d.max().item():.3e} (tol {max_tol:.3e}), mean "
                        f"{d.mean().item():.3e} (tol {mean_tol:.3e})")
                worst = max(worst, d.mean().item() / mean_tol,
                            d.max().item() / max_tol)
                out["max_abs_err"] = max(out["max_abs_err"], d.max().item())
                y = yk
            chained = (full.float() - y.float()).abs().max().item()
            if chained != 0.0:
                raise SystemExit(f"fused_dit_q8c {name} b={B} step={s}: the "
                                 f"stack differs from its layers chained "
                                 f"({chained:.3e})")
            # the stack == L chained per-layer kernel launches
            z = x
            for l in range(L):
                if int8_attn:
                    z = fused_layer_q8c(
                        z, c, st["ln1"][l], None, None, st["q_g"][l],
                        st["k_g"][l], None, st["ln2"][l], qexp_L[l],
                        idx_L[l], p_L[l], step=s, qexp_t=qt_L[l],
                        qattn=QuantizedAttn(*(st[k][l]
                                              for k in STACKED_QATTN)),
                        qattn_t=AttnKMajor(*(st[k][l]
                                             for k in DIT_KMAJOR_ATTN)), **kw)
                else:
                    z = fused_layer_q8c(
                        z, c, st["ln1"][l], st["wqkv"][l], st["bqkv"][l],
                        st["q_g"][l], st["k_g"][l], st["wout"][l],
                        st["ln2"][l], qexp_L[l], idx_L[l], p_L[l], step=s,
                        qexp_t=qt_L[l], **kw)
            vs_layer = (full.float() - z.float()).abs().max().item()
            layer_name = ("fused_layer_q8c(qattn=)" if int8_attn
                          else "fused_layer_q8c")
            msg = f", vs {L} chained {layer_name} max {vs_layer:.1e}"
            if vs_layer != 0.0:
                raise SystemExit(f"fused_dit_q8c {name} b={B} step={s}: "
                                 f"differs from {L} chained {layer_name} "
                                 f"launches ({vs_layer:.3e})")
            plain = fused_dit_q8c_ref(x, c, st, idx_L, p_L, step=s, **kw)
            exact = fused_dit_q8c_ref(x, c, st, idx_L, p_L, step=s,
                                      acc_dtype=torch.float64, **kw)
            d = (full.float() - plain.float()).abs()
            fl = (plain.float() - exact.float()).abs()
            print(f"  fused_dit_q8c {name} b={B} step={s}: {L} layers each "
                  f"within the layer gates (worst {worst:.2f} of the gate); "
                  f"stack == layers chained{msg}; stack vs plain stack max "
                  f"{d.max().item():.3e}, mean {d.mean().item():.3e}; plain "
                  f"f32 vs plain f64 stack max {fl.max().item():.3e}, mean "
                  f"{fl.mean().item():.3e}", flush=True)
            if not bool(torch.isfinite(full).all()):
                raise SystemExit(f"fused_dit_q8c {name} b={B} step={s}: "
                                 "non-finite output")
            out["stack_max_abs_err"] = max(out["stack_max_abs_err"],
                                           d.max().item())
            out["stack_vs_plain"].append(dict(
                B=B, step=s, mean=d.mean().item(), floor_mean=fl.mean().item()))
        info = dict(zip(DIT_INFO, fused_dit_q8c.last_grid))

        # timing at step 0 on this B
        x = torch.randn(B, T, D, generator=gen, device=dev).to(torch.bfloat16)
        c = emb_all[0][None]
        k_ms = cuda_time_ms(
            lambda: fused_dit_q8c(x, c, st, idx_L, p_L, step=0, **kw),
            20 if B == 1 else 10)
        p_ms = cuda_time_ms(
            lambda: fused_dit_q8c_ref(x, c, st, idx_L, p_L, step=0, **kw), 2)

        def library():
            y = x
            for args in deq_layers:
                y = library_layer(y, c, *args)
            return y

        l_ms = cuda_time_ms(library, 3)
        bound, by = bound_of(*dit_cost(B, T, D, H, HH, L, int8_attn))
        split = dit_split(fused_dit_q8c, dit_stage_names, x, c, st, idx_L,
                          p_L, kw, int8_attn, info["consumer_warpgroups"])
        out[B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                      bound_by=by, info=info, stage_split_us=split)
        print(f"  fused_dit_q8c {name} b={B}: kernel {k_ms:.4f} ms/launch, "
              f"bound {bound:.4f} ms ({by}), plain {p_ms:.3f} ms, library "
              f"({L} x library_layer) {l_ms:.4f} ms; launch {info}",
              flush=True)
        print(f"  fused_dit_q8c {name} b={B}: device us per step by stage "
              f"(between grid barriers, summed over the {L} layers): "
              + ", ".join(f"{k} {v:.1f}" for k, v in split.items()),
              flush=True)
    return out


def dit_split(fused_dit_q8c, dit_stage_names, x, c, st, idx_L, p_L, kw,
              int8_attn, wgs):
    """One megakernel step with its clock buffer: the device us of each
    stage (from one grid barrier to the next, as CTA 0 sees it), summed
    over the layers, and the whole step ("total"). The SM clock of CTA 0
    gives the intervals, %globaltimer their scale."""
    import torch
    names = dit_stage_names(int8_attn, 64 * wgs)
    L = st["ln1"].shape[0]
    times = torch.zeros(1 + L * len(names), 2, dtype=torch.int64,
                        device=x.device)
    fused_dit_q8c(x, c, st, idx_L, p_L, step=0, times=times, **kw)
    t = times.cpu().double()
    ns_per_clock = (t[-1, 0] - t[0, 0]) / (t[-1, 1] - t[0, 1])
    gaps = ((t[1:, 1] - t[:-1, 1]) * ns_per_clock / 1e3).tolist()
    split = dict.fromkeys(names, 0.0)
    for i, us in enumerate(gaps):
        split[names[i % len(names)]] += us
    split["total"] = sum(gaps)
    return split


def attn_cost(B, T, D, H):
    """(bf16 flops, int8 ops, bytes) of one fused_attn_block_q8 call: the
    int8 QKV and c_proj products, the causal attention of each sample, x
    read and the output written once, the int8 weights and f32 vectors."""
    N, hd = B * T, D // H
    pairs = T * (T + 1) // 2
    bf16 = B * H * pairs * hd * 4
    int8 = 2 * N * D * 3 * D + 2 * N * D * D
    nbytes = 2 * N * D * 2 + 4 * D * D + (3 * D * 3 + D * 3) * 4 + 2 * hd * 4
    return bf16, int8, nbytes


def moe_cost(B, T, D, HH):
    """(bf16 flops, int8 ops, bytes) of one fused_top2_mlp_q8c call with
    top-2 routing: the two selected experts' int8 up and down products and
    weights, ln_2, x read and the output written once."""
    N = B * T
    int8 = 2 * (2 * N * D * 2 * HH + 2 * N * HH * D)
    expert = D * 2 * HH + 2 * HH * 8 + HH * D + D * 4
    return 0, int8, 2 * N * D * 2 + D * 4 + 2 * expert


def layer_gate(name, got, want):
    """The bf16-step-relative layer gates; returns (max |diff|, share of
    the gate used)."""
    import torch
    d = (got.float() - want.float()).abs()
    mean_tol = LAYER_MEAN_REL * want.float().abs().mean().item()
    max_tol = LAYER_MAX_REL * want.float().abs().max().item()
    if not (bool(torch.isfinite(got).all()) and d.mean().item() <= mean_tol
            and d.max().item() <= max_tol):
        raise SystemExit(f"{name}: kernel disagrees with its plain version: "
                         f"max {d.max().item():.3e} (tol {max_tol:.3e}), "
                         f"mean {d.mean().item():.3e} (tol {mean_tol:.3e})")
    return d.max().item(), max(d.mean().item() / mean_tol,
                               d.max().item() / max_tol)


def check_two_kernel(dit, routing, emb_all, steps, T, gen, cfg):
    """fused_attn_block_q8 and fused_top2_mlp_q8c at full width, b=128, b=1
    and a ragged 3 x 13 tokens, on the flagship agent's int8 weights and
    their K-major copies: each against its plain version on the same input
    with the layer gates (the MoE kernel in all four prenorm/residual
    combinations, the attention kernel also with one cond row per sample,
    and with equal rows bit for bit against the shared row); at b=128 and
    b=1, for every layer, attention then MoE equal to a one-layer
    fused_dit_q8c launch with int8 projections, bit for bit (identity i).
    Then the kernels', the plain versions' and the library yardsticks'
    times, the per-stage device ms and the wgmma stages' rates."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block_q8, fused_attn_block_q8_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        DIT_KMAJOR, DIT_KMAJOR_ATTN, STACKED_QATTN, fused_dit_q8c)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp_q8c, fused_top2_mlp_q8c_ref)
    from mode_diffusion_policy_tpu_torch.ops.quant import QuantizedExperts

    dev = emb_all.device
    D, H, HH = cfg.latent_dim, cfg.n_heads, 4 * cfg.latent_dim
    TH = min(1024, HH)
    out = {"attn": dict(max_abs_err=0.0), "moe": dict(max_abs_err=0.0)}

    def kw_attn(blk):
        return dict(ln_eps=blk.ln_1.eps, qk_eps=blk.attn.q_norm.eps,
                    qattn_t=blk.attn.attn_qt)

    def attn_args(blk, x, c):
        a = blk.attn
        return (x, c, blk.ln_1.g, a.attn_q, a.q_norm.g, a.k_norm.g)

    def moe(blk, y, idx, probs, **kw):
        return fused_top2_mlp_q8c(y, idx, probs, blk.experts_q,
                                  qexp_t=blk.experts_qt, **kw)

    for B, TT in ((128, T), (1, T), (3, T - 1)):
        for s in steps:
            blk = dit.blocks[0]
            idx, probs = routing[0]
            x = torch.randn(B, TT, D, generator=gen, device=dev).to(
                torch.bfloat16)
            c = emb_all[s][None]
            args = attn_args(blk, x, c)
            y = fused_attn_block_q8(*args, **kw_attn(blk))
            torch.cuda.synchronize()
            err, used = layer_gate(f"fused_attn_block_q8 {B}x{TT} step={s}",
                                   y, fused_attn_block_q8_ref(
                                       *args, **kw_attn(blk)))
            err2, used2 = check_cond_rows(
                "fused_attn_block_q8", fused_attn_block_q8,
                fused_attn_block_q8_ref, (args[0], *args[2:]), c,
                per_sample_cond(dit, B, gen), kw_attn(blk))
            out["attn"]["max_abs_err"] = max(out["attn"]["max_abs_err"], err,
                                             err2)
            msg = [f"attention {used:.2f} (per-sample cond {used2:.2f}; "
                   "equal rows == shared row, bit for bit)"]
            for ln, resid in ((True, True), (True, False), (False, True),
                              (False, False)):
                kw = dict(step=s, residual=resid,
                          ln_g=blk.ln_2.g if ln else None,
                          ln_eps=blk.ln_2.eps)
                got = moe(blk, y, idx, probs, **kw)
                torch.cuda.synchronize()
                err, used = layer_gate(
                    f"fused_top2_mlp_q8c {B}x{TT} step={s} ln={ln} "
                    f"residual={resid}", got, fused_top2_mlp_q8c_ref(
                        y, idx, probs, blk.experts_q, **kw))
                out["moe"]["max_abs_err"] = max(out["moe"]["max_abs_err"],
                                                err)
                msg.append(f"MoE ln={int(ln)} residual={int(resid)} "
                           f"{used:.2f}")
            print(f"  {B} x {TT} tokens, step={s}, experts "
                  f"{idx[s].tolist()}: within the layer gates (share of the "
                  f"gate used: {', '.join(msg)})", flush=True)
        if TT != T:
            continue
        # (i) attention -> MoE == a one-layer megakernel launch, every layer
        s = steps[-1]
        y = torch.randn(B, T, D, generator=gen, device=dev).to(torch.bfloat16)
        c = emb_all[s][None]
        for l, blk in enumerate(dit.blocks):
            idx, probs = routing[l]
            two = moe(blk, fused_attn_block_q8(*attn_args(blk, y, c),
                                               **kw_attn(blk)),
                      idx, probs, step=s, residual=True, ln_g=blk.ln_2.g,
                      ln_eps=blk.ln_2.eps)
            st = {"ln1": blk.ln_1.g[None], "q_g": blk.attn.q_norm.g[None],
                  "k_g": blk.attn.k_norm.g[None], "ln2": blk.ln_2.g[None]}
            st.update({k: v[None] for k, v in zip(STACKED_QATTN,
                                                  blk.attn.attn_q)})
            st.update({k: v[None] for k, v in zip(QuantizedExperts._fields,
                                                  blk.experts_q)})
            # the K-major copies the megakernel's s8 products read
            st.update({k: v[None] for k, v in zip(DIT_KMAJOR,
                                                  blk.experts_qt)})
            st.update({k: v[None] for k, v in zip(DIT_KMAJOR_ATTN,
                                                  blk.attn.attn_qt)})
            one = fused_dit_q8c(y, c, st, idx[None], probs[None], step=s,
                                eps1=blk.ln_1.eps, eps_qk=blk.attn.q_norm.eps,
                                eps2=blk.ln_2.eps)
            diff = (two.float() - one.float()).abs().max().item()
            if diff != 0.0:
                raise SystemExit(f"b={B} layer {l}: fused_attn_block_q8 -> "
                                 f"fused_top2_mlp_q8c differs from a one-layer"
                                 f" fused_dit_q8c launch ({diff:.3e})")
            y = two
        print(f"  b={B} step={s}: attention -> MoE == one-layer megakernel "
              f"launch, bit for bit, on all {len(dit.blocks)} layers "
              "(chained)", flush=True)

        # timing at step 0 on this B, layer 0
        blk = dit.blocks[0]
        idx, probs = routing[0]
        x = torch.randn(B, T, D, generator=gen, device=dev).to(torch.bfloat16)
        c = emb_all[0][None]
        args = attn_args(blk, x, c)
        y = fused_attn_block_q8(*args, **kw_attn(blk))
        e, p = idx[0].tolist(), probs[0].tolist()
        moe_kw = dict(step=0, residual=True, ln_g=blk.ln_2.g,
                      ln_eps=blk.ln_2.eps)
        iters = 50 if B == 128 else 100
        rows = {
            "attn": (lambda: fused_attn_block_q8(*args, **kw_attn(blk)),
                     lambda: fused_attn_block_q8_ref(*args, **kw_attn(blk)),
                     lambda: library_attn(*args), attn_cost(B, T, D, H),
                     proj_stage_costs(B * T)),
            "moe": (lambda: moe(blk, y, idx, probs, **moe_kw),
                    lambda: fused_top2_mlp_q8c_ref(y, idx, probs,
                                                   blk.experts_q, **moe_kw),
                    lambda: library_moe(y, blk.ln_2.g, blk.experts_q, e, p,
                                        TH), moe_cost(B, T, D, HH),
                    moe_stage_costs(B * T, True, True)),
        }
        for name, (kern, plain, lib, cost, _) in rows.items():
            k_ms = cuda_time_ms(kern, iters)
            p_ms = cuda_time_ms(plain, 3)
            l_ms = cuda_time_ms(lib, 20)
            bound, by = bound_of(*cost)
            out[name][B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                bound_ms=bound, bound_by=by)
            print(f"  {name} b={B}: kernel {k_ms:.4f} ms/launch, bound "
                  f"{bound:.4f} ms ({by}; {cost[1] / 1e9:.2f} GOP int8, "
                  f"{cost[2] / 1e6:.1f} MB), plain {p_ms:.3f} ms, library "
                  f"{l_ms:.4f} ms", flush=True)
        for name, label in (("attn", "fused_attn_block_q8"),
                            ("moe", "fused_top2_mlp_q8c")):
            st_ms = kernel_stages(rows[name][0], f"{label} b={B}",
                                  costs=rows[name][4])
            out[name][f"stages_b{B}"] = st_ms
            out[name][f"stage_rates_b{B}"] = stage_rates(st_ms, rows[name][4])
    return out


def attn_bf16_cost(B, T, D, H):
    """(bf16 flops, int8 ops, bytes) of one fused_attn_block call: the bf16
    QKV and c_proj products, the causal attention of each sample, x read
    and the output written once, the bf16 weights, the f32 bias, norms and
    the cond row (one per sample where it is per sample, not counted)."""
    N, hd = B * T, D // H
    pairs = T * (T + 1) // 2
    bf16 = 2 * N * D * 3 * D + 2 * N * D * D + B * H * pairs * hd * 4
    nbytes = 2 * N * D * 2 + 2 * 4 * D * D + (3 * D + 2 * D) * 4 + 2 * hd * 4
    return bf16, 0, nbytes


def per_sample_cond(dit, B, gen):
    """One cond row per sample [B,1,D], as an inline call makes them: the
    sigma tokens of B random sigmas in the schedule's range."""
    import torch
    sigma = torch.exp(torch.empty(B, device=gen.device).uniform_(
        -6.9, 4.38, generator=gen))
    return dit.process_sigma_embeddings(sigma)


def check_cond_rows(name, kern, ref, args, c, c_rows, kw):
    """A per-sample cond whose rows all equal the shared row gives the
    shared-row launch bit for bit; one with distinct rows stays within the
    layer gates of the plain version. Returns (max |diff|, gate share)."""
    import torch
    B = args[0].shape[0]
    shared = kern(args[0], c, *args[1:], **kw)
    same = kern(args[0], c.expand(B, 1, -1).contiguous(), *args[1:], **kw)
    torch.cuda.synchronize()
    diff = (shared.float() - same.float()).abs().max().item()
    if diff != 0.0:
        raise SystemExit(f"{name} b={B}: a per-sample cond of equal rows "
                         f"differs from the shared row ({diff:.3e})")
    got = kern(args[0], c_rows, *args[1:], **kw)
    torch.cuda.synchronize()
    return layer_gate(f"{name} b={B} per-sample cond", got,
                      ref(args[0], c_rows, *args[1:], **kw))


def check_attn_bf16(dit, routing, emb_all, steps, T, gen, cfg):
    """fused_attn_block at full width, b=128, b=1 and 3 x 13 tokens, on the
    parity policy's bf16 weights: against its plain version with a shared
    cond row and with one per sample (layer gates), a per-sample cond of
    equal rows bit for bit against the shared row; the output under every
    tile plan of the bf16 wgmma projections against the default plan's
    (reported: the kernels share the default plan at a given row count);
    on every layer, the kernel then fused_top2_mlp_q8c (ln_2, residual)
    against one fused_layer_q8c launch with bf16 projections, bit for bit
    (chained: identity ii). Then the kernel's, the plain version's and the
    library yardstick's times."""
    from bench_kernels_torch import PROJ_TILES
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block, fused_attn_block_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_layer_q8c)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp_q8c)

    dev = emb_all.device
    D, H = cfg.latent_dim, cfg.n_heads
    out = {"max_abs_err": 0.0, "plans_equal": {}}

    def weights(blk):
        a = blk.attn
        return (blk.ln_1.g, a.wqkv.kernel, a.wqkv.bias, a.q_norm.g,
                a.k_norm.g, a.c_proj.kernel)

    def kw(blk):
        return dict(ln_eps=blk.ln_1.eps, qk_eps=blk.attn.q_norm.eps)

    for B, Tb in ((128, T), (1, T), (3, 13)):
        blk = dit.blocks[0]
        for s in steps:
            x = torch.randn(B, Tb, D, generator=gen, device=dev).to(
                torch.bfloat16)
            c = emb_all[s][None]
            args = (x, *weights(blk))
            got = fused_attn_block(x, c, *args[1:], **kw(blk))
            torch.cuda.synchronize()
            err, used = layer_gate(
                f"fused_attn_block b={B} x {Tb} step={s}", got,
                fused_attn_block_ref(x, c, *args[1:], **kw(blk)))
            err2, used2 = check_cond_rows(
                "fused_attn_block", fused_attn_block, fused_attn_block_ref,
                args, c, per_sample_cond(dit, B, gen), kw(blk))
            out["max_abs_err"] = max(out["max_abs_err"], err, err2)
            # the bf16 products' bits under every tile plan
            equal = {f"{tm}x{tn}": bool(torch.equal(fused_attn_block(
                x, c, *args[1:], tiles=(tm, tn, tm, tn), **kw(blk)), got))
                for tm, tn in PROJ_TILES}
            out["plans_equal"][f"b{B}x{Tb}_step{s}"] = equal
            print(f"  fused_attn_block b={B} x {Tb} tokens step={s}: within "
                  f"the layer gates (share used: shared cond {used:.2f}, "
                  f"per-sample cond {used2:.2f}); per-sample cond of equal "
                  f"rows == shared row, bit for bit; output under each "
                  f"projection tile plan == the default plan's: {equal}",
                  flush=True)
        if B == 3:
            continue
        # attention -> MoE == one fused_layer_q8c launch, every layer
        s = steps[-1]
        y = torch.randn(B, T, D, generator=gen, device=dev).to(torch.bfloat16)
        c = emb_all[s][None]
        for l, blk in enumerate(dit.blocks):
            idx, probs = routing[l]
            w = weights(blk)
            two = fused_top2_mlp_q8c(
                fused_attn_block(y, c, *w, **kw(blk)), idx, probs,
                blk.experts_q, step=s, residual=True, ln_g=blk.ln_2.g,
                ln_eps=blk.ln_2.eps, qexp_t=blk.experts_qt)
            one = fused_layer_q8c(
                y, c, w[0], w[1], w[2], w[3], w[4], w[5], blk.ln_2.g,
                blk.experts_q, idx, probs, step=s, qexp_t=blk.experts_qt,
                eps1=blk.ln_1.eps, eps_qk=blk.attn.q_norm.eps,
                eps2=blk.ln_2.eps)
            diff = (two.float() - one.float()).abs().max().item()
            if diff != 0.0:
                raise SystemExit(f"b={B} layer {l}: fused_attn_block -> "
                                 f"fused_top2_mlp_q8c differs from one "
                                 f"fused_layer_q8c launch ({diff:.3e})")
            y = two
        print(f"  b={B} step={s}: fused_attn_block -> fused_top2_mlp_q8c == "
              f"fused_layer_q8c, bit for bit, on all {len(dit.blocks)} "
              "layers (chained)", flush=True)

        # timing at step 0 on this B, layer 0, shared cond
        blk = dit.blocks[0]
        x = torch.randn(B, T, D, generator=gen, device=dev).to(torch.bfloat16)
        c = emb_all[0][None]
        w = weights(blk)
        k_ms = cuda_time_ms(lambda: fused_attn_block(x, c, *w, **kw(blk)),
                            50 if B == 128 else 100)
        p_ms = cuda_time_ms(lambda: fused_attn_block_ref(x, c, *w, **kw(blk)),
                            3)
        lib = (w[0], w[1], w[2].to(torch.bfloat16), w[3], w[4], w[5])
        l_ms = cuda_time_ms(lambda: library_attn_bf16(x, c, *lib), 20)
        cost = attn_bf16_cost(B, T, D, H)
        bound, by = bound_of(*cost)
        out[B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                      bound_ms=bound, bound_by=by)
        print(f"  fused_attn_block b={B}: kernel {k_ms:.4f} ms/launch, bound "
              f"{bound:.4f} ms ({by}; {cost[0] / 1e9:.2f} GFLOP bf16, "
              f"{cost[2] / 1e6:.1f} MB), plain {p_ms:.3f} ms, library "
              f"{l_ms:.4f} ms", flush=True)
        out[f"stages_b{B}"] = kernel_stages(
            lambda: fused_attn_block(x, c, *w, **kw(blk)),
            f"fused_attn_block b={B}")
    return out


# Evaluations per chunk of the sweep's runs, (on the schedule, off it), as
# the JAX samplers make them on the exponential schedule that ends at 0
# (tests/test_torch_samplers.py pins the port's to JAX's, step for step).
SWEEP_EVALS = {("ddim", 10): (10, 0), ("dpmpp_2m", 10): (10, 0),
               ("euler", 10): (10, 0), ("heun", 10): (19, 0),
               ("dpmpp_2s_ancestral", 10): (10, 9),
               ("dpmpp_2s_ancestral", 4): (4, 3),
               ("dpmpp_2s_ancestral", 16): (16, 15)}


def sweep_run(policy, mode, sampler, steps, r, cfg, zero_launches,
              launches_of):
    """One chunk of ``sampler`` at ``steps`` steps through the preset's
    policy (eager, the launch counters on): its launch counts against the
    table, the action MAE of the kernel path against the plain path and
    the f32-vs-f64 floors, with the same initial and sampler noise (the
    policy's generator re-seeded before each chunk), and the chunk ms."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block_q8_ref, fused_attn_block_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c_ref, fused_layer_q8c_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp_q8c_ref)

    ag = policy.agent
    ag.configure_(sampler_type=sampler, num_sampling_steps=steps)
    dit = ag.inner_model
    L = cfg.n_layers
    on, off = SWEEP_EVALS[(sampler, steps)]

    def chunk():
        policy.generator.manual_seed(11)
        return policy.predict_chunk(r["obs"], r["goal"], r["noise"])

    chunk()                                   # warm-up
    torch.cuda.synchronize()
    zero_launches()
    kern = chunk()
    torch.cuda.synchronize()
    counts = launches_of()
    c = ag.cfg
    want = dict.fromkeys(counts, 0)
    if c.use_megakernel:
        want["fused_dit_q8c"] = on
    elif c.use_fused_layer:
        want["fused_layer_q8c"] = on * L
    else:
        want["fused_attn_block_q8"] = on * L
        want["fused_top2_mlp_q8c"] = on * L
    want["fused_attn_block_q8" if c.use_int8_attn
         else "fused_attn_block"] += off * L
    if counts != want:
        raise SystemExit(f"sweep {mode} {sampler} {steps} steps: launches "
                         f"{counts}, expected {want}")
    if not bool(torch.isfinite(kern).all()) or tuple(kern.shape) != (
            r["noise"].shape[0], cfg.act_window_size, cfg.action_dim):
        raise SystemExit(f"sweep {mode} {sampler}: bad chunk "
                         f"{tuple(kern.shape)}")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - c0) * 1e3)
    impls = ("layer_impl", "dit_impl", "attn_impl", "attn_impl_bf16",
             "moe_impl")
    kernels = {k: getattr(dit, k) for k in impls}

    def plain(acc=torch.float32, red=torch.float32):
        kw = dict(acc_dtype=acc, red_dtype=red)
        dit.layer_impl = functools.partial(fused_layer_q8c_ref, **kw)
        dit.dit_impl = functools.partial(fused_dit_q8c_ref, **kw)
        dit.attn_impl = functools.partial(fused_attn_block_q8_ref, **kw)
        dit.attn_impl_bf16 = functools.partial(fused_attn_block_ref, **kw)
        dit.moe_impl = functools.partial(fused_top2_mlp_q8c_ref,
                                         red_dtype=red)
        return chunk()

    p = plain()
    floors = [(p - plain(torch.float64)).abs().mean().item()]
    if c.use_int8_attn or c.use_megakernel:
        floors.append((p - plain(torch.float64, torch.float64))
                      .abs().mean().item())
    for k, fn in kernels.items():
        setattr(dit, k, fn)
    mae = (kern - p).abs().mean().item()
    tol = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * max(floors))
    row = dict(mode=mode, sampler=sampler, steps=steps,
               batch=r["noise"].shape[0], evals_on=on, evals_off=off,
               launches={k: v for k, v in counts.items() if v},
               action_mae=mae, action_floor=max(floors),
               chunk_ms=statistics.median(times))
    if off and steps == 10:
        # where the off-schedule evaluations' time goes: the DiT kernels'
        # device time against the rest (the inline path's embeddings,
        # router and dense experts in PyTorch, the encoders)
        row["split"] = chunk_split(policy, r["obs"], r["goal"], r["noise"],
                                   row["chunk_ms"])
    print(f"  sweep {mode} b={row['batch']} {sampler} {steps} steps: "
          f"{on} + {off} off-schedule evaluations, launches "
          f"{row['launches']}; action MAE kernel-vs-plain {mae:.3e} (tol "
          f"{tol:.3e}, floors {', '.join(f'{f:.3e}' for f in floors)}); "
          f"chunk {row['chunk_ms']:.2f} ms (median of 3: "
          f"{', '.join(f'{t:.2f}' for t in times)}); split "
          f"{row.get('split', 'not taken')}", flush=True)
    if mae > tol:
        raise SystemExit(f"sweep {mode} {sampler} {steps} steps: kernel "
                         "path disagrees with plain path")
    return row


def check_int8_convs(q8_mod, gen):
    """The int8 conv route (int8 patches, torch._int_mm) on three of the
    encoder's convs at their real shapes: the int32 result equals an exact
    CPU computation of the same int8 inputs."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.encoders.resnet import (
        conv2d_i8)
    r = q8_mod.resnet
    for name, conv, hw in (("stem 4x4", r.conv1, 112),
                           ("layer1_0 3x3", r.layer1_0.conv2, 56),
                           ("layer2_0 3x3 stride 2", r.layer2_0.conv2, 56),
                           ("layer2_0 1x1 stride 2 downsample",
                            r.layer2_0.downsample_conv, 56)):
        C = conv.kernel_q.shape[1]
        xq = torch.randint(-127, 128, (8, C, hw, hw), generator=gen,
                           device=conv.kernel_q.device, dtype=torch.int8)
        got = conv2d_i8(xq, conv.kernel_q, conv.stride, conv.pad)
        want = conv2d_i8(xq.cpu(), conv.kernel_q.cpu(), conv.stride,
                         conv.pad)
        if not torch.equal(got.cpu(), want):
            raise SystemExit(f"int8 conv {name}: torch._int_mm differs from "
                             "the exact CPU sums")
        print(f"  int8 conv {name} {tuple(got.shape)}: torch._int_mm == "
              "exact CPU int32 sums", flush=True)


def encoder_times(agent, x, cond, iters=5):
    """Device ms of one camera encoder at this batch: folded bf16, int8
    with dynamic scales and int8 with the calibrated scales."""
    from mode_diffusion_policy_tpu_torch.models.agent import ENCODERS
    from mode_diffusion_policy_tpu_torch.models.encoders.resnet import (
        FiLMResNetPolicy, quantize_resnet_params)
    name = ENCODERS[0]
    folded = agent.folded[name]
    dyn = FiLMResNetPolicy(agent.cfg.cond_dim, 50, agent.cfg.dtype,
                           folded=True, q8=True, device=x.device)
    dyn.load_state_dict(quantize_resnet_params(folded.state_dict()))
    return {"folded_bf16": cuda_time_ms(lambda: folded(x, cond), iters),
            "int8_dynamic": cuda_time_ms(lambda: dyn(x, cond), iters),
            "int8_calibrated": cuda_time_ms(lambda: agent.q8[name](x, cond),
                                            iters)}

def check_moe_bf16(dit, routing, steps, T, gen, cfg):
    """fused_top2_mlp and fused_top2_mlp_q8 at full width, b=128, b=1 and a
    ragged 3 x 13 tokens, on the flagship agent's experts (the parity
    policy's bf16 precast and int8 experts of layer 0): each against its
    plain version with the layer gates, over [S,2] tables with a step and
    single [2] rows, residual on and off, ln_2 fused or not; and
    fused_top2_mlp_q8 with unit scales on the int8 weights against
    fused_top2_mlp on the same weights cast to bf16, bit for bit. Returns
    the largest |kernel - plain| of each kernel."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp, fused_top2_mlp_q8, fused_top2_mlp_q8_ref,
        fused_top2_mlp_ref)
    from mode_diffusion_policy_tpu_torch.ops.quant import QuantizedExperts

    dev = gen.device
    D = cfg.latent_dim
    blk = dit.blocks[0]
    idx, probs = routing[0]
    bf = torch.bfloat16
    w16 = (blk.experts_w1, blk.experts_b1, blk.experts_w2)
    qe = blk.experts_q
    unit = QuantizedExperts(qe.w1_q, torch.ones_like(qe.w1_s),
                            qe.b1.to(bf).float(), qe.w2_q,
                            torch.ones_like(qe.w2_s))
    unit16 = (qe.w1_q.to(bf), qe.b1.to(bf), qe.w2_q.to(bf))
    kernels = (("fused_top2_mlp", fused_top2_mlp, fused_top2_mlp_ref, w16),
               ("fused_top2_mlp_q8", fused_top2_mlp_q8, fused_top2_mlp_q8_ref,
                (qe,)))
    err = dict.fromkeys((k[0] for k in kernels), 0.0)
    combos = ((True, True, True), (True, False, True), (False, True, False),
              (False, False, False))

    def call_kw(s, tables, resid, ln):
        return (idx, probs) if tables else (idx[s], probs[s]), dict(
            step=s if tables else None, residual=resid,
            ln_g=blk.ln_2.g if ln else None, ln_eps=blk.ln_2.eps)

    for B, TT in ((128, T), (1, T), (3, T - 1)):
        for s in steps:
            x = torch.randn(B, TT, D, generator=gen, device=dev).to(bf)
            used = {k[0]: 0.0 for k in kernels}
            for tables, resid, ln in combos:
                rows, kw = call_kw(s, tables, resid, ln)
                for name, kern, ref, wts in kernels:
                    got = kern(x, *rows, *wts, **kw)
                    torch.cuda.synchronize()
                    e, u = layer_gate(
                        f"{name} b={B}x{TT} step={s} tables={tables} "
                        f"residual={resid} ln={ln}", got,
                        ref(x, *rows, *wts, **kw))
                    err[name] = max(err[name], e)
                    used[name] = max(used[name], u)
            print(f"  {B} x {TT} tokens, step {s}, experts "
                  f"{idx[s].tolist()}: both kernels within the layer gates "
                  f"over tables/rows, residual, ln_2 (largest share of the "
                  "gate used: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                            used.items()) + ")", flush=True)
        xs = (torch.randn(B, TT, D, generator=gen, device=dev) * 0.01).to(bf)
        for tables, resid, ln in combos[::3]:
            rows, kw = call_kw(steps[-1], tables, resid, ln)
            a = fused_top2_mlp_q8(xs, *rows, unit, **kw)
            b = fused_top2_mlp(xs, *rows, *unit16, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(a, b) and bool(torch.isfinite(a).all())):
                raise SystemExit(
                    f"b={B}x{TT}: fused_top2_mlp_q8 with unit scales differs "
                    f"from fused_top2_mlp on the same weights "
                    f"({(a.float() - b.float()).abs().max().item():.3e})")
        print(f"  {B} x {TT} tokens: fused_top2_mlp_q8 with unit scales == "
              "fused_top2_mlp on the int8 weights cast to bf16, bit for bit",
              flush=True)
    return err


def bf16_config_run(agent, results, cfg, zero_launches, launches_of):
    """The bf16 kernel configuration at full width: ``agent`` reconfigured
    with the JAX bench's BENCH_INT8=0 flag set (use_pallas_moe,
    use_pallas_attn; use_fused_layer set and inert without int8 experts),
    no preset (the raw encoders, no int8 weights), served by
    RolloutPolicy(agent). One 10-step DDIM chunk at b=128 and at b=1 with
    the launch counters on (120 fused_attn_block, 120 fused_top2_mlp,
    nothing else), the action MAE against the plain versions and the
    f32-vs-f64 floors, the chunk ms (median of 3) and its device split."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block, fused_attn_block_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp, fused_top2_mlp_ref)

    agent.configure_(use_pallas_moe=True, use_pallas_attn=True,
                     use_int8_moe=False, use_fused_layer=True,
                     use_int8_attn=False, use_megakernel=False)
    agent.folded = agent.q8 = None
    agent.quantize_for_inference()
    policy = RolloutPolicy(agent, seed=0)
    dit = policy.agent.inner_model
    L, S = cfg.n_layers, cfg.num_sampling_steps
    out = {}
    for B in (128, 1):
        r = results[B]

        def chunk():
            return policy.predict_chunk(r["obs"], r["goal"], r["noise"])

        zero_launches()
        kern = chunk()
        torch.cuda.synchronize()
        counts = launches_of()
        want = {**dict.fromkeys(counts, 0), "fused_attn_block": L * S,
                "fused_top2_mlp": L * S}
        if counts != want:
            raise SystemExit(f"bf16 configuration b={B}: launches {counts}, "
                             f"expected {want}")
        if tuple(kern.shape) != (B, cfg.act_window_size, cfg.action_dim) \
                or not bool(torch.isfinite(kern).all()):
            raise SystemExit(f"bf16 configuration b={B}: bad chunk "
                             f"{tuple(kern.shape)}")
        evals = {}
        for key, kw in (("plain", {}),
                        ("exact", {"acc_dtype": torch.float64}),
                        ("exact_all", {"acc_dtype": torch.float64,
                                       "red_dtype": torch.float64})):
            dit.attn_impl_bf16 = functools.partial(fused_attn_block_ref, **kw)
            dit.moe_impl_bf16 = functools.partial(fused_top2_mlp_ref, **kw)
            evals[key] = chunk()
        dit.attn_impl_bf16, dit.moe_impl_bf16 = fused_attn_block, fused_top2_mlp

        def mae_of(a, b):
            return (a - b).abs().mean().item()

        mae = mae_of(kern, evals["plain"])
        floors = (mae_of(evals["plain"], evals["exact"]),
                  mae_of(evals["plain"], evals["exact_all"]))
        tol = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * max(floors))
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            chunk()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - c0) * 1e3)
        row = dict(launches={k: v for k, v in counts.items() if v},
                   action_mae=mae, action_floor=max(floors),
                   chunk_ms=statistics.median(times))
        row["split"] = chunk_split(policy, r["obs"], r["goal"], r["noise"],
                                   row["chunk_ms"])
        print(f"  bf16 configuration b={B}, one 10-step DDIM chunk: launches "
              f"{row['launches']}; action MAE kernel-vs-plain {mae:.3e} (tol "
              f"{tol:.3e}), plain-f32-vs-plain-f64 {floors[0]:.3e} "
              f"(products) / {floors[1]:.3e} (products, norms, softmax), "
              f"parity-vs-this {mae_of(kern, r['parity_chunk']):.3e}; chunk "
              f"{row['chunk_ms']:.2f} ms (median of 3: "
              f"{', '.join(f'{t:.2f}' for t in times)}); split "
              f"{row['split']}", flush=True)
        if mae > tol:
            raise SystemExit(f"bf16 configuration b={B}: kernel path "
                             "disagrees with plain path")
        out[B] = row
    return out


def fused_layer_int8_run(agent, results, routing, emb_all, steps, T, gen,
                         cfg, zero_launches, launches_of):
    """The whole-layer kernel with int8 projections at full width: the
    agent reconfigured with the flags that run it (use_int8_moe,
    use_pallas_moe, use_pallas_attn, use_fused_layer, use_int8_attn; the
    megakernel off: max-throughput's flags with the fused layer), the
    folded bf16 encoders, served by RolloutPolicy(agent). Layer 0 of
    fused_layer_q8c(qattn=) against its plain version with the layer gates
    at b=128 and b=1; on all 12 layers (chained) equal to
    fused_attn_block_q8 then fused_top2_mlp_q8c, bit for bit (identity
    iii), at b=128 and b=1; one 10-step DDIM chunk at b=128 and at b=1
    with the launch counters on (120 fused_layer_q8c launches, nothing
    else), its action MAE against the plain version and the f32-vs-f64
    floors, the chunk ms and its device split; the kernel's, the plain
    version's and the library yardstick's times, and its stages."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block_q8)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_layer_q8c, fused_layer_q8c_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp_q8c)

    agent.configure_(use_int8_moe=True, use_pallas_moe=True,
                     use_pallas_attn=True, use_fused_layer=True,
                     use_int8_attn=True, use_megakernel=False)
    agent.q8 = None
    agent.fold_encoders_for_inference()
    agent.quantize_for_inference()
    policy = RolloutPolicy(agent, seed=0)
    dit = policy.agent.inner_model
    L, S = cfg.n_layers, cfg.num_sampling_steps
    D, H, HH = cfg.latent_dim, cfg.n_heads, 4 * cfg.latent_dim
    dev = emb_all.device
    out = {"max_abs_err": 0.0}

    def layer(blk, x, c, idx, probs, s, fn=fused_layer_q8c):
        a = blk.attn
        return fn(x, c, blk.ln_1.g, None, None, a.q_norm.g, a.k_norm.g, None,
                  blk.ln_2.g, blk.experts_q, idx, probs, step=s,
                  qattn=a.attn_q, qattn_t=a.attn_qt, qexp_t=blk.experts_qt,
                  eps1=blk.ln_1.eps, eps_qk=a.q_norm.eps, eps2=blk.ln_2.eps)

    def two_kernel(blk, x, c, idx, probs, s):
        a = blk.attn
        y = fused_attn_block_q8(x, c, blk.ln_1.g, a.attn_q, a.q_norm.g,
                                a.k_norm.g, ln_eps=blk.ln_1.eps,
                                qk_eps=a.q_norm.eps, qattn_t=a.attn_qt)
        return fused_top2_mlp_q8c(y, idx, probs, blk.experts_q, step=s,
                                  residual=True, ln_g=blk.ln_2.g,
                                  ln_eps=blk.ln_2.eps, qexp_t=blk.experts_qt)

    for B in (128, 1):
        blk = dit.blocks[0]
        idx, probs = routing[0]
        used = []
        for s in steps:
            x = torch.randn(B, T, D, generator=gen, device=dev).to(
                torch.bfloat16)
            c = emb_all[s][None]
            got = layer(blk, x, c, idx, probs, s)
            torch.cuda.synchronize()
            err, u = layer_gate(f"fused_layer_q8c(qattn=) b={B} step={s}",
                                got, layer(blk, x, c, idx, probs, s,
                                           fn=fused_layer_q8c_ref))
            out["max_abs_err"] = max(out["max_abs_err"], err)
            used.append(f"step {s} {u:.2f}")
        # (iii) the layer == attention kernel then MoE kernel, every layer
        s = steps[-1]
        y = torch.randn(B, T, D, generator=gen, device=dev).to(
            torch.bfloat16)
        c = emb_all[s][None]
        for l, blk in enumerate(dit.blocks):
            idx, probs = routing[l]
            one = layer(blk, y, c, idx, probs, s)
            two = two_kernel(blk, y, c, idx, probs, s)
            diff = (one.float() - two.float()).abs().max().item()
            if diff != 0.0:
                raise SystemExit(f"b={B} layer {l}: fused_layer_q8c(qattn=) "
                                 f"differs from fused_attn_block_q8 -> "
                                 f"fused_top2_mlp_q8c ({diff:.3e})")
            y = one
        print(f"  fused_layer_q8c(qattn=) b={B}: layer 0 within the layer "
              f"gates (share used: {', '.join(used)}); == fused_attn_block_q8"
              f" -> fused_top2_mlp_q8c, bit for bit, on all {L} layers "
              "(chained)", flush=True)

    for B in (128, 1):
        r = results[B]

        def chunk():
            return policy.predict_chunk(r["obs"], r["goal"], r["noise"])

        chunk()                                   # warm-up
        torch.cuda.synchronize()
        zero_launches()
        kern = chunk()
        torch.cuda.synchronize()
        counts = launches_of()
        want = {**dict.fromkeys(counts, 0), "fused_layer_q8c": L * S}
        if counts != want:
            raise SystemExit(f"fused layer, int8 projections, b={B}: "
                             f"launches {counts}, expected {want}")
        if tuple(kern.shape) != (B, cfg.act_window_size, cfg.action_dim) \
                or not bool(torch.isfinite(kern).all()):
            raise SystemExit(f"fused layer, int8 projections, b={B}: bad "
                             f"chunk {tuple(kern.shape)}")
        evals = {}
        for key, kw in (("plain", {}),
                        ("exact", {"acc_dtype": torch.float64}),
                        ("exact_all", {"acc_dtype": torch.float64,
                                       "red_dtype": torch.float64})):
            dit.layer_impl = functools.partial(fused_layer_q8c_ref, **kw)
            evals[key] = chunk()
        dit.layer_impl = fused_layer_q8c

        def mae_of(a, b):
            return (a - b).abs().mean().item()

        mae = mae_of(kern, evals["plain"])
        floors = (mae_of(evals["plain"], evals["exact"]),
                  mae_of(evals["plain"], evals["exact_all"]))
        tol = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * max(floors))
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            chunk()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - c0) * 1e3)
        row = dict(launches={k: v for k, v in counts.items() if v},
                   action_mae=mae, action_floor=max(floors),
                   chunk_ms=statistics.median(times))
        row["split"] = chunk_split(policy, r["obs"], r["goal"], r["noise"],
                                   row["chunk_ms"])
        print(f"  fused layer with int8 projections b={B}, one 10-step DDIM "
              f"chunk: launches {row['launches']}; action MAE "
              f"kernel-vs-plain {mae:.3e} (tol {tol:.3e}), "
              f"plain-f32-vs-plain-f64 {floors[0]:.3e} (products) / "
              f"{floors[1]:.3e} (products, norms, softmax); chunk "
              f"{row['chunk_ms']:.2f} ms (median of 3: "
              f"{', '.join(f'{t:.2f}' for t in times)}); split "
              f"{row['split']}", flush=True)
        if mae > tol:
            raise SystemExit(f"fused layer, int8 projections, b={B}: kernel "
                             "path disagrees with plain path")
        out[f"chunk_b{B}"] = row

    # timing at step 0, layer 0
    blk = dit.blocks[0]
    idx, probs = routing[0]
    for B in (128, 1):
        x = torch.randn(B, T, D, generator=gen, device=dev).to(
            torch.bfloat16)
        c = emb_all[0][None]
        a = blk.attn
        e, p = idx[0].tolist(), probs[0].tolist()

        def library():
            y = library_attn(x, c, blk.ln_1.g, a.attn_q, a.q_norm.g,
                             a.k_norm.g)
            return library_moe(y, blk.ln_2.g, blk.experts_q, e, p,
                               min(1024, HH))

        k_ms = cuda_time_ms(lambda: layer(blk, x, c, idx, probs, 0),
                            50 if B == 128 else 100)
        p_ms = cuda_time_ms(lambda: layer(blk, x, c, idx, probs, 0,
                                          fn=fused_layer_q8c_ref), 3)
        l_ms = cuda_time_ms(library, 20)
        bound, by = bound_of(*layer_q8_cost(B, T, D, H, HH))
        costs = {**moe_stage_costs(B * T, True, True),
                 **proj_stage_costs(B * T)}
        st_ms = kernel_stages(lambda: layer(blk, x, c, idx, probs, 0),
                              f"fused_layer_q8c(qattn=) b={B}", costs=costs)
        out[B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                      bound_by=by, stages_ms=st_ms,
                      stage_rates=stage_rates(st_ms, costs))
        print(f"  fused_layer_q8c(qattn=) b={B}: kernel {k_ms:.4f} ms/launch, "
              f"bound {bound:.4f} ms ({by}), plain {p_ms:.3f} ms, library "
              f"(library_attn then library_moe) {l_ms:.4f} ms", flush=True)
    return out


def main():
    import torch

    t = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    # full-f32 plain versions: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    phase("phase 1: card facts", t)

    t = time.perf_counter()
    from mode_diffusion_policy_tpu_torch.ops.kernels import _build
    libs = _build.build()
    for name, path in sorted(libs.items()):
        log = path.with_suffix(".log").read_text()
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"  {path.name}: registers per kernel {regs}, spill stores "
              f"{spills}", flush=True)
    phase(f"phase 2: built {', '.join(sorted(libs))}", t)

    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig, RolloutPolicy)
    from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block, fused_attn_block_q8, fused_attn_block_q8_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c, fused_dit_q8c_ref, fused_layer_q8c, fused_layer_q8c_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp, fused_top2_mlp_q8, fused_top2_mlp_q8c,
        fused_top2_mlp_q8c_ref)
    # every kernel's launch count; each served path is driven with all of
    # them set to 0 just before and read just after
    counters = (fused_attn_block_q8, fused_top2_mlp_q8c, fused_layer_q8c,
                fused_dit_q8c, fused_attn_block, fused_top2_mlp,
                fused_top2_mlp_q8)

    def launches_of():
        return {k.__name__: k.launches for k in counters}

    def zero_launches():
        for k in counters:
            k.launches = 0
    from mode_diffusion_policy_tpu_torch.ops.quant import dequantize_experts

    dev = torch.device("cuda", 0)
    cfg = MoDEAgentConfig(latent_dim=1024, n_layers=12, n_heads=8,
                          cond_dim=512, resnet_type="50", num_experts=4,
                          top_k=2, dtype=torch.bfloat16)
    t = time.perf_counter()
    agent = MoDEAgent(cfg, device=dev)
    policy = RolloutPolicy.with_serving_mode(agent, mode="parity", seed=0)
    policies = {"parity": policy}
    # the policy serves its own precast copy of the agent: the kernels'
    # plain versions are swapped in there
    dit = policy.agent.inner_model
    copy_bytes = sum(p.numel() * p.element_size()
                     for n, p in policy.agent.named_parameters()
                     if p.data_ptr() != agent.get_parameter(n).data_ptr())
    print(f"  the policy's precast copy holds {copy_bytes / 1e9:.3f} GB of "
          "cast parameters of its own (the caller's agent stays f32)",
          flush=True)
    phase("setup: full-width agent, parity preset", t)

    # ---- phase 3: the kernel against its plain version ------------------
    t = time.perf_counter()
    blk = dit.blocks[0]
    routing = policy.agent.precompute_routing()
    idx, probs = routing[0]
    sched = torch.as_tensor(agent.sigmas[:-1], device=dev)
    emb_all = dit.process_sigma_embeddings(sched)
    steps = [0, len(agent.sigmas) - 2]
    rows = {tuple(idx[s].tolist()) for s in steps}
    D, H, HH = cfg.latent_dim, cfg.n_heads, 4 * cfg.latent_dim
    T = dit.cfg.goal_seq_len + 2 + cfg.act_window_size + 1
    gen = torch.Generator(device=dev).manual_seed(1)
    a = blk.attn

    def layer_args(B, step):
        x = torch.randn(B, T, D, generator=gen, device=dev).to(torch.bfloat16)
        return ((x, emb_all[step][None], blk.ln_1.g, a.wqkv.kernel,
                 a.wqkv.bias, a.q_norm.g, a.k_norm.g, a.c_proj.kernel,
                 blk.ln_2.g, blk.experts_q, idx, probs),
                dict(step=step, qexp_t=blk.experts_qt, eps1=blk.ln_1.eps,
                     eps_qk=a.q_norm.eps, eps2=blk.ln_2.eps))

    max_err = 0.0
    for B in (128, 1):
        for s in steps:
            args, kw = layer_args(B, s)
            got = fused_layer_q8c(*args, **kw)
            torch.cuda.synchronize()
            want = fused_layer_q8c_ref(*args, **kw)
            d = (got.float() - want.float()).abs()
            mean_tol = LAYER_MEAN_REL * want.float().abs().mean().item()
            max_tol = LAYER_MAX_REL * want.float().abs().max().item()
            ok = (bool(torch.isfinite(got).all()) and
                  d.mean().item() <= mean_tol and d.max().item() <= max_tol)
            print(f"  fused_layer_q8c b={B} step={s} experts="
                  f"{idx[s].tolist()}: max {d.max().item():.3e} (tol "
                  f"{max_tol:.3e}), mean {d.mean().item():.3e} (tol "
                  f"{mean_tol:.3e}), elements differing "
                  f"{(d > 0).float().mean().item():.3f}", flush=True)
            if not ok:
                raise SystemExit("kernel disagrees with its plain version")
            max_err = max(max_err, d.max().item())
    if len(rows) < 2:
        print("  note: both checked steps route to the same experts",
              flush=True)
    phase("phase 3: kernel vs plain version", t)

    # ---- phases 4-5: the served path at b=128 and b=1 -------------------
    rng = torch.Generator(device=dev).manual_seed(2)
    results = {}
    for ph, B in ((4, 128), (5, 1)):
        t = time.perf_counter()
        frames = {k: torch.randint(0, 256, (B, 1, 224, 224, 3), generator=rng,
                                   device=dev, dtype=torch.uint8)
                  for k in ("rgb_static", "rgb_gripper")}
        goal = {"lang_emb": torch.randn(B, 1, cfg.cond_dim, generator=rng,
                                        device=dev)}
        policy.reset()
        chunks = 2
        zero_launches()
        actions = []
        for _ in range(chunks * cfg.multistep):
            obs = {k: preprocess_camera(v) for k, v in frames.items()}
            actions.append(policy.step(obs, goal))
        torch.cuda.synchronize()
        counts = launches_of()
        launches = counts.pop("fused_layer_q8c")
        if any(counts.values()):
            raise SystemExit(f"parity b={B}: launches of other kernels "
                             f"{counts}, expected 0")
        want_launches = chunks * cfg.n_layers * cfg.num_sampling_steps
        for act in actions:
            if tuple(act.shape) != (B, cfg.action_dim) or \
                    not bool(torch.isfinite(act).all()):
                raise SystemExit(f"bad action {tuple(act.shape)} at b={B}")
        if launches != want_launches:
            raise SystemExit(f"b={B}: {launches} kernel launches, expected "
                             f"{want_launches}")
        # kernel path vs plain path: same weights, frames and noise
        obs = {k: preprocess_camera(v) for k, v in frames.items()}
        noise = torch.randn(B, cfg.act_window_size, cfg.action_dim,
                            generator=rng, device=dev)
        kern = policy.predict_chunk(obs, goal, noise)
        again = policy.predict_chunk(obs, goal, noise)
        dit.layer_impl = fused_layer_q8c_ref
        plain = policy.predict_chunk(obs, goal, noise)
        dit.layer_impl = functools.partial(fused_layer_q8c_ref,
                                           acc_dtype=torch.float64)
        exact = policy.predict_chunk(obs, goal, noise)
        dit.layer_impl = fused_layer_q8c

        def mae_of(a, b):
            return (a - b).abs().mean().item()

        mae = mae_of(kern, plain)
        floor = mae_of(plain, exact)
        tol = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * floor)
        print(f"  b={B}: {chunks} chunks, {launches} launches, chunk "
              f"{tuple(kern.shape)}, |action| mean "
              f"{plain.abs().mean().item():.3f}; action MAE kernel-vs-plain "
              f"{mae:.3e} (tol {tol:.3e}), plain-f32-vs-plain-f64 {floor:.3e}, "
              f"kernel-vs-plain-f64 {mae_of(kern, exact):.3e}, kernel run "
              f"twice max diff {(kern - again).abs().max().item():.3e}",
              flush=True)
        if not (mae <= tol and bool(torch.isfinite(kern).all())):
            raise SystemExit(f"b={B}: kernel path disagrees with plain path")
        results[B] = dict(obs=obs, goal=goal, noise=noise, launches=launches,
                          action_mae=mae, action_floor=floor,
                          frames=frames, parity_chunk=kern)
        phase(f"phase {ph}: parity path at b={B}", t)

    # ---- phase 6: timing -------------------------------------------------
    t = time.perf_counter()
    w1, b1, w2 = dequantize_experts(blk.experts_q)
    deq = [(w1[e].to(torch.bfloat16), b1[e].to(torch.bfloat16),
            w2[e].to(torch.bfloat16)) for e in range(cfg.num_experts)]
    timing = {}
    for B in (128, 1):
        args, kw = layer_args(B, 0)
        e = idx[0].tolist()
        p = probs[0].tolist()
        lib_args = (*args[:9], deq, e, p)
        k_ms = cuda_time_ms(lambda: fused_layer_q8c(*args, **kw), 50)
        p_ms = cuda_time_ms(lambda: fused_layer_q8c_ref(*args, **kw), 5)
        l_ms = cuda_time_ms(lambda: library_layer(*lib_args), 20)
        bf16, int8, nbytes = layer_cost(B, T, D, H, HH)
        ops_ms = (bf16 / PEAK_BF16 + int8 / PEAK_INT8) * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        r = results[B]
        chunk = []
        for _ in range(3):
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            policy.predict_chunk(r["obs"], r["goal"], r["noise"])
            torch.cuda.synchronize()
            chunk.append((time.perf_counter() - c0) * 1e3)
        timing[B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=max(ops_ms, bytes_ms),
                         bound_by="operations" if ops_ms >= bytes_ms
                         else "bytes", chunk_ms=statistics.median(chunk),
                         bf16_gflop=bf16 / 1e9, int8_gop=int8 / 1e9,
                         mbytes=nbytes / 1e6)
        print(f"  b={B}: kernel {k_ms:.4f} ms/launch, bound "
              f"{timing[B]['bound_ms']:.4f} ms ({timing[B]['bound_by']}; "
              f"{bf16 / 1e9:.2f} GFLOP bf16, {int8 / 1e9:.2f} GOP int8, "
              f"{nbytes / 1e6:.1f} MB), plain {p_ms:.3f} ms, library "
              f"{l_ms:.4f} ms; chunk end to end {timing[B]['chunk_ms']:.2f} ms "
              f"(median of 3: {', '.join(f'{c:.2f}' for c in chunk)})",
              flush=True)
    stages = {}
    for B in (128, 1):
        args, kw = layer_args(B, 0)
        stages[f"b{B}"] = kernel_stages(lambda: fused_layer_q8c(*args, **kw),
                                        f"b={B}", costs=moe_stage_costs(
                                            B * T, True, True))
    r1 = results[1]
    split = {"parity": chunk_split(policy, r1["obs"], r1["goal"],
                                   r1["noise"], timing[1]["chunk_ms"])}
    print(f"  parity b=1 chunk split: {split['parity']}", flush=True)
    r128 = results[128]
    split_b128 = chunk_split(policy, r128["obs"], r128["goal"],
                             r128["noise"], timing[128]["chunk_ms"])
    print(f"  parity b=128 chunk split: {split_b128}", flush=True)
    phase("phase 6: timing", t)

    # ---- phases 7-10: the b1 presets and the DiT megakernel ---------------
    mega = {}
    chunk_b1 = {"parity": timing[1]["chunk_ms"]}
    deq_layers = None
    for ph, mode in ((7, "b1-latency"), (9, "b1-latency-max")):
        t = time.perf_counter()
        policy = RolloutPolicy.with_serving_mode(agent, mode=mode, seed=0)
        policies[mode] = policy
        dit = policy.agent.inner_model
        st = dit.stacked
        int8_attn = "sqkv" in st
        nbytes = sum(v.numel() * v.element_size() for v in st.values())
        shared = sum(st[k].numel() * st[k].element_size()
                     for k in ("w1_q", "w1_s", "b1", "w2_q", "w2_s", "w1_t",
                               "w2_t")
                     + (("wqkv", "sqkv", "bqkv", "wout", "sout", "wqkv_t",
                         "wout_t") if int8_attn else ()))
        kmajor = sum(st[k].numel() * st[k].element_size()
                     for k in ("w1_t", "w2_t", "wqkv_t", "wout_t") if k in st)
        print(f"  {mode}: layer stack {nbytes / 1e6:.1f} MB, of which "
              f"{shared / 1e6:.1f} MB hold the blocks' int8 weights and "
              f"their K-major copies ({kmajor / 1e6:.1f} MB; the blocks "
              f"point at their slices); added "
              f"{(nbytes - shared) / 1e6:.1f} MB", flush=True)
        idx_L = torch.stack([i for i, _ in routing])
        p_L = torch.stack([p for _, p in routing])
        if deq_layers is None:
            # the library yardstick's per-layer weights: bf16 attention and
            # the step-0 experts dequantized to bf16 (same for both presets)
            deq_layers = []
            for l in range(cfg.n_layers):
                w1, b1, w2 = dequantize_experts(dit.blocks[l].experts_q)
                bl, at = dit.blocks[l], dit.blocks[l].attn
                deq_layers.append((
                    bl.ln_1.g, at.wqkv.kernel.to(torch.bfloat16),
                    at.wqkv.bias.to(torch.bfloat16), at.q_norm.g,
                    at.k_norm.g, at.c_proj.kernel.to(torch.bfloat16),
                    bl.ln_2.g, {e: (w1[e].to(torch.bfloat16),
                                    b1[e].to(torch.bfloat16),
                                    w2[e].to(torch.bfloat16))
                                for e in idx_L[l, 0].tolist()},
                    idx_L[l, 0].tolist(), p_L[l, 0].tolist()))
                del w1, b1, w2
        mega[mode] = check_megakernel(
            dit, st, idx_L, p_L, emb_all, steps, T, gen, deq_layers, cfg)
        phase(f"phase {ph}: {mode} megakernel vs plain", t)

        t = time.perf_counter()
        r = results[1]
        policy.reset()
        chunks = 2
        zero_launches()
        actions = []
        for _ in range(chunks * cfg.multistep):
            obs = {k: preprocess_camera(v) for k, v in r["frames"].items()}
            actions.append(policy.step(obs, r["goal"]))
        torch.cuda.synchronize()
        counts = launches_of()
        launches = counts.pop("fused_dit_q8c")
        want_launches = chunks * cfg.num_sampling_steps
        for act in actions:
            if tuple(act.shape) != (1, cfg.action_dim) or \
                    not bool(torch.isfinite(act).all()):
                raise SystemExit(f"{mode}: bad action {tuple(act.shape)}")
        if launches != want_launches or any(counts.values()):
            raise SystemExit(
                f"{mode}: {launches} megakernel launches (expected "
                f"{want_launches}), other kernels {counts} (expected 0)")
        kern = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
        again = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
        dit.dit_impl = fused_dit_q8c_ref
        plain = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
        dit.dit_impl = functools.partial(fused_dit_q8c_ref,
                                         acc_dtype=torch.float64)
        exact = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
        dit.dit_impl = functools.partial(fused_dit_q8c_ref,
                                         acc_dtype=torch.float64,
                                         red_dtype=torch.float64)
        exact_all = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
        dit.dit_impl = fused_dit_q8c

        def mae_of(a, b):
            return (a - b).abs().mean().item()

        mae = mae_of(kern, plain)
        floors = (mae_of(plain, exact), mae_of(plain, exact_all))
        floor = max(floors)
        tol = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * floor)
        chunk = []
        for _ in range(3):
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            policy.predict_chunk(r["obs"], r["goal"], r["noise"])
            torch.cuda.synchronize()
            chunk.append((time.perf_counter() - c0) * 1e3)
        chunk_b1[mode] = statistics.median(chunk)
        split[mode] = chunk_split(policy, r["obs"], r["goal"], r["noise"],
                                  chunk_b1[mode])
        print(f"  {mode} b=1: {chunks} chunks, {launches} megakernel "
              f"launches, other kernels {counts}; "
              f"action MAE kernel-vs-plain {mae:.3e} (tol {tol:.3e}), "
              f"plain-f32-vs-plain-f64 {floors[0]:.3e} (products) / "
              f"{floors[1]:.3e} (products, norms, softmax), "
              f"kernel-vs-plain-f64 {mae_of(kern, exact):.3e} / "
              f"{mae_of(kern, exact_all):.3e}, parity-vs-this "
              f"{mae_of(kern, r['parity_chunk']):.3e}, "
              f"kernel run twice max diff "
              f"{(kern - again).abs().max().item():.3e}; chunk "
              f"{chunk_b1[mode]:.2f} ms (median of 3: "
              f"{', '.join(f'{c:.2f}' for c in chunk)}); split "
              f"{split[mode]}", flush=True)
        if not (mae <= tol and bool(torch.isfinite(kern).all())):
            raise SystemExit(f"{mode}: kernel path disagrees with plain path")
        mega[mode].update(launches=launches, action_mae=mae,
                          action_floor=floor)
        phase(f"phase {ph + 1}: {mode} path at b=1", t)
    print("  b=1 chunk ms (median of 3), parity / b1-latency / "
          "b1-latency-max: " + " / ".join(
              f"{chunk_b1[m]:.2f}" for m in ("parity", "b1-latency",
                                             "b1-latency-max")), flush=True)

    # ---- phases 11-14: max-throughput, the two-kernel layer -------------
    t = time.perf_counter()
    crng = torch.Generator(device=dev).manual_seed(3)
    calib = {k: preprocess_camera(torch.randint(
        0, 256, (4, 1, 224, 224, 3), generator=crng, device=dev,
        dtype=torch.uint8)) for k in ("rgb_static", "rgb_gripper")}
    calib["lang_emb"] = torch.randn(4, 1, cfg.cond_dim, generator=crng,
                                    device=dev)
    policy = RolloutPolicy.with_serving_mode(
        agent, mode="max-throughput", calib_batch=calib, seed=0)
    policies["max-throughput"] = policy
    dit = policy.agent.inner_model
    for name, label in policy.agent.q8_clips.items():
        mses = policy.agent.q8_clip_mse[name]
        print(f"  {name}: clip {label}; feature MSE per candidate " + ", ".join(
            f"{k} {v:.3e}" for k, v in mses.items()), flush=True)
    phase("phase 11: max-throughput preset, int8 encoders calibrated on 4 "
          "synthetic frames", t)

    t = time.perf_counter()
    two = check_two_kernel(dit, routing, emb_all, steps, T, gen, cfg)
    check_int8_convs(policy.agent.q8["static_resnet"], gen)
    phase("phase 12: fused_attn_block_q8, fused_top2_mlp_q8c and the int8 "
          "convs vs plain", t)

    t = time.perf_counter()
    r = results[128]
    policy.reset()
    zero_launches()
    actions = []
    for _ in range(cfg.multistep):
        obs = {k: preprocess_camera(v) for k, v in r["frames"].items()}
        actions.append(policy.step(obs, r["goal"]))
    torch.cuda.synchronize()
    mt_launches = launches_of()
    want_launches = cfg.n_layers * cfg.num_sampling_steps
    for act in actions:
        if tuple(act.shape) != (128, cfg.action_dim) or \
                not bool(torch.isfinite(act).all()):
            raise SystemExit(f"max-throughput: bad action {tuple(act.shape)}")
    if mt_launches != {**dict.fromkeys(mt_launches, 0),
                       "fused_attn_block_q8": want_launches,
                       "fused_top2_mlp_q8c": want_launches}:
        raise SystemExit(f"max-throughput b=128, one chunk: launches "
                         f"{mt_launches}, expected {want_launches} attention "
                         f"and MoE, 0 layer and 0 megakernel")
    kern = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
    again = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
    evals = {}
    for key, (attn_kw, moe_kw) in (
            ("plain", ({}, {})),
            ("exact", ({"acc_dtype": torch.float64}, {})),
            ("exact_all", ({"acc_dtype": torch.float64,
                            "red_dtype": torch.float64},
                           {"red_dtype": torch.float64}))):
        dit.attn_impl = functools.partial(fused_attn_block_q8_ref, **attn_kw)
        dit.moe_impl = functools.partial(fused_top2_mlp_q8c_ref, **moe_kw)
        evals[key] = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
    dit.attn_impl, dit.moe_impl = fused_attn_block_q8, fused_top2_mlp_q8c

    def mae_of(a, b):
        return (a - b).abs().mean().item()

    mt_mae = mae_of(kern, evals["plain"])
    mt_floors = (mae_of(evals["plain"], evals["exact"]),
                 mae_of(evals["plain"], evals["exact_all"]))
    tol = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * max(mt_floors))
    print(f"  max-throughput b=128, one chunk: launches {mt_launches}; "
          f"chunk {tuple(kern.shape)}, action MAE kernel-vs-plain "
          f"{mt_mae:.3e} (tol {tol:.3e}), plain-f32-vs-plain-f64 "
          f"{mt_floors[0]:.3e} (products) / {mt_floors[1]:.3e} (products, "
          f"norms, softmax), parity-vs-this "
          f"{mae_of(kern, r['parity_chunk']):.3e}, kernel run twice max diff "
          f"{(kern - again).abs().max().item():.3e}", flush=True)
    if not (mt_mae <= tol and bool(torch.isfinite(kern).all())):
        raise SystemExit("max-throughput: kernel path disagrees with plain "
                         "path")
    phase("phase 13: max-throughput path at b=128", t)

    t = time.perf_counter()
    chunk = []
    for _ in range(3):
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        policy.predict_chunk(r["obs"], r["goal"], r["noise"])
        torch.cuda.synchronize()
        chunk.append((time.perf_counter() - c0) * 1e3)
    mt_chunk = statistics.median(chunk)
    mt_split = chunk_split(policy, r["obs"], r["goal"], r["noise"], mt_chunk)
    x_enc = r["obs"]["rgb_static"][:, 0]
    enc_ms = encoder_times(policy.agent, x_enc, r["goal"]["lang_emb"][:, 0])
    print(f"  b=128 chunk ms (median of 3), parity / max-throughput: "
          f"{timing[128]['chunk_ms']:.2f} / {mt_chunk:.2f} (max-throughput: "
          f"{', '.join(f'{c:.2f}' for c in chunk)}); max-throughput split "
          f"{mt_split}; one camera encoder at b=128, "
          f"device ms: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     enc_ms.items()), flush=True)
    phase("phase 14: max-throughput timing", t)

    # ---- phase 15: fused_attn_block, the per-sample cond ------------------
    t = time.perf_counter()
    pdit = policies["parity"].agent.inner_model
    attn16 = check_attn_bf16(pdit, routing, emb_all, steps, T, gen, cfg)
    phase("phase 15: fused_attn_block vs plain, per-sample cond, and with "
          "the MoE kernel == fused_layer_q8c on every layer", t)

    # ---- phases 16-17: the evaluation sweep's samplers --------------------
    t = time.perf_counter()
    sweep = []
    for sampler, steps_ in (("ddim", 10), ("dpmpp_2m", 10), ("euler", 10),
                            ("heun", 10), ("dpmpp_2s_ancestral", 10),
                            ("dpmpp_2s_ancestral", 4),
                            ("dpmpp_2s_ancestral", 16)):
        sweep.append(sweep_run(policies["parity"], "parity", sampler, steps_,
                               results[128], cfg, zero_launches,
                               launches_of))
    phase("phase 16: the sweep's samplers on parity at b=128", t)
    t = time.perf_counter()
    for mode, B in (("max-throughput", 128), ("b1-latency", 1),
                    ("b1-latency-max", 1)):
        sweep.append(sweep_run(policies[mode], mode, "dpmpp_2s_ancestral",
                               10, results[B], cfg, zero_launches,
                               launches_of))
    phase("phase 17: dpmpp_2s_ancestral on max-throughput, b1-latency and "
          "b1-latency-max", t)
    main_path = next(r for r in sweep if r["mode"] == "parity"
                     and r["sampler"] == "dpmpp_2s_ancestral"
                     and r["steps"] == 10)

    # ---- phases 18-20: the bf16 kernel configuration, fused_top2_mlp and
    # fused_top2_mlp_q8 --------------------------------------------------
    t = time.perf_counter()
    moe16_err = check_moe_bf16(pdit, routing, steps, T, gen, cfg)
    phase("phase 18: fused_top2_mlp and fused_top2_mlp_q8 vs plain, and "
          "the unit-scale q8 launch == the bf16 launch", t)
    t = time.perf_counter()
    bf16cfg = bf16_config_run(agent, results, cfg, zero_launches,
                              launches_of)
    phase("phase 19: the bf16 kernel configuration at b=128 and b=1", t)
    t = time.perf_counter()
    import bench_kernels_torch
    zero_launches()
    bench = bench_kernels_torch.bench_moe()
    bench_launches = launches_of()
    if not (bench_launches["fused_top2_mlp_q8"]
            and bench_launches["fused_top2_mlp"]):
        raise SystemExit(f"kernel bench: launches {bench_launches}")
    bench_layer = bench_kernels_torch.bench_layer()
    for name in ("fused_top2_mlp", "fused_top2_mlp_q8", "fused_top2_mlp_q8c"):
        for key, row in bench[name].items():
            print(f"  {name} {key}: kernel {row['ms']:.4f} ms/launch "
                  f"({row['ms_cold_l2']:.4f} with the L2 cache flushed), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                  f"{row['gflop_bf16']:.2f} GFLOP bf16, {row['gop_int8']:.2f}"
                  f" GOP int8, {row['mbytes']:.1f} MB), plain "
                  f"{row['plain_ms']:.3f} ms, library {row['library_ms']} ms;"
                  f" stages {row['stages_ms']}", flush=True)
            if row["stage_rates"]:
                print(f"    expert products: {fmt_rates(row['stage_rates'])}",
                      flush=True)
    lay = bench_layer["b128"]
    q8 = lay["int8_attn"]
    print(f"  kernel bench launches {bench_launches}; one layer at b=128: "
          f"fused_layer_q8c {lay['fused_layer_ms']:.4f} ms "
          f"({lay['fused_layer_ms_cold_l2']:.4f} with the L2 cache flushed), "
          f"bound {lay['bound_ms']:.4f} ms ({lay['bound_by']}), library "
          f"{lay['library_ms']:.4f} ms; fused_attn_block then "
          f"fused_top2_mlp_q8c {lay['two_kernel_ms']:.4f} ms "
          f"({lay['two_kernel_ms_cold_l2']:.4f} flushed); with int8 "
          f"projections fused_layer_q8c {q8['fused_layer_ms']:.4f} ms "
          f"({q8['fused_layer_ms_cold_l2']:.4f} flushed), bound "
          f"{q8['bound_ms']:.4f} ms, library {q8['library_ms']:.4f} ms, "
          f"fused_attn_block_q8 then fused_top2_mlp_q8c "
          f"{q8['two_kernel_ms']:.4f} ms ({q8['two_kernel_ms_cold_l2']:.4f} "
          f"flushed); megakernel one layer {lay['megakernel_l1_ms']:.4f}, "
          f"per layer of 12 {lay['megakernel_per_layer_ms']:.4f} ms; expert "
          f"products {fmt_rates(lay['stage_rates'])}; int8 layer's wgmma "
          f"stages {fmt_rates(q8['stage_rates'])}", flush=True)
    bench_proj = bench_kernels_torch.bench_proj()
    for key, row in bench_proj.items():
        for kind, name in (("int8", "fused_attn_block_q8"),
                           ("bf16", "fused_attn_block")):
            print(f"  {name} {key} by projection tiles (default "
                  f"{row['default']}): " + "; ".join(
                      f"{k} {v['ms']:.4f} ms (host {v['host_ms']:.4f}), "
                      + ", ".join(f"{n.split('_kernel')[0]} {m:.4f}"
                                  for n, m in (v['stages_ms'] or {}).items()
                                  if "wg_kernel" in n)
                      + ("" if v["equal_to_default"] else
                         ", output differs from the default plan's")
                      for k, v in row[kind].items()), flush=True)
    phase("phase 20: kernel bench (bench_kernels_torch: moe, layer, proj)",
          t)

    # ---- phase 21: the whole-layer kernel with int8 projections ----------
    t = time.perf_counter()
    layer8 = fused_layer_int8_run(agent, results, routing, emb_all, steps, T,
                                  gen, cfg, zero_launches, launches_of)
    phase("phase 21: fused_layer_q8c with int8 projections: vs plain, == "
          "the two int8 kernels on every layer, chunks at b=128 and b=1", t)

    # ---- results -----------------------------------------------------------
    t128 = timing[128]
    kernels = [{
        "name": "fused_layer_q8c",
        "route": "cuda",
        "source": "mode_diffusion_policy_tpu_torch/csrc/fused_layer_q8c.cu",
        "replaces": "mode_diffusion_policy_tpu/ops/pallas/layer_kernel.py:162",
        "launches": results[128]["launches"],
        "max_abs_err": max_err,
        "ms": t128["ms"],
        "plain_ms": t128["plain_ms"],
        "bound_ms": t128["bound_ms"],
        "bound_by": t128["bound_by"],
        "library_ms": t128["library_ms"],
        "shape": "b=128 x 14 tokens, D=1024, hidden 4096, top-2 of 4",
        "b1": {"launches": results[1]["launches"], **{
            k: timing[1][k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}},
        "chunk_ms": {"b128": t128["chunk_ms"], "b1": timing[1]["chunk_ms"]},
        "chunk_split_b128": split_b128,
        "action_mae": {"b128": results[128]["action_mae"],
                       "b1": results[1]["action_mae"]},
        "action_floor": {"b128": results[128]["action_floor"],
                         "b1": results[1]["action_floor"]},
        "stages_ms": stages,
        "moe_stage_rates": {
            k: stage_rates(v, moe_stage_costs(B * T, True, True))
            for (k, v), B in zip(stages.items(), (128, 1))},
        "int8_attn": {
            "launches": layer8["chunk_b128"]["launches"]["fused_layer_q8c"],
            "max_abs_err": layer8["max_abs_err"],
            **{k: layer8[128][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
            "library_is": "library_attn then library_moe (torch._int_mm, "
                          "SDPA, torch ops)",
            "launches_are": "use_int8_moe, use_pallas_attn, use_fused_layer"
                            ", use_int8_attn (megakernel off), b=128, one "
                            "10-step DDIM chunk",
            "b1": {k: layer8[1][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
            "stages_ms": {"b128": layer8[128]["stages_ms"],
                          "b1": layer8[1]["stages_ms"]},
            "stage_rates": {"b128": layer8[128]["stage_rates"],
                            "b1": layer8[1]["stage_rates"]},
            "chunk": {"b128": layer8["chunk_b128"],
                      "b1": layer8["chunk_b1"]},
        },
    }]
    m1, m8 = mega["b1-latency"], mega["b1-latency-max"]
    kernels.append({
        "name": "fused_dit_q8c",
        "route": "cuda",
        "source": "mode_diffusion_policy_tpu_torch/csrc/fused_dit_q8c.cu",
        "replaces": "mode_diffusion_policy_tpu/ops/pallas/layer_kernel.py:415",
        "launches": m1["launches"],
        "max_abs_err": max(m1["max_abs_err"], m8["max_abs_err"]),
        **{k: m1[1][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        "shape": "12 layers, b=1 x 14 tokens, D=1024, hidden 4096, top-2 "
                 "of 4, bf16 attention projections (b1-latency)",
        "info": {"bf16": {f"b{B}": m1[B]["info"] for B in (1, 128)},
                 "int8": {f"b{B}": m8[B]["info"] for B in (1, 128)}},
        "stage_split_us": {
            "bf16": {f"b{B}": m1[B]["stage_split_us"] for B in (1, 128)},
            "int8": {f"b{B}": m8[B]["stage_split_us"] for B in (1, 128)}},
        "max_abs_err_is": "one-layer launches vs the plain layer on the "
                          "same input (the whole launch equals them chained "
                          "and 12 chained fused_layer_q8c launches)",
        "stack_max_abs_err": max(m1["stack_max_abs_err"],
                                 m8["stack_max_abs_err"]),
        "stack_vs_plain": {"b1-latency": m1["stack_vs_plain"],
                           "b1-latency-max": m8["stack_vs_plain"]},
        "b128": {k: m1[128][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
        "int8_attn": {"launches": m8["launches"],
                      "b1": {k: m8[1][k] for k in (
                          "ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms")},
                      "b128": {k: m8[128][k] for k in (
                          "ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms")}},
        "chunk_ms_b1": chunk_b1,
        "chunk_split_b1": split,
        "action_mae": {"b1-latency": m1["action_mae"],
                       "b1-latency-max": m8["action_mae"]},
        "action_floor": {"b1-latency": m1["action_floor"],
                         "b1-latency-max": m8["action_floor"]},
    })
    mt = {"chunk_ms_b128": {"max-throughput": mt_chunk,
                            "parity": t128["chunk_ms"]},
          "chunk_split_b128": mt_split,
          "encoder_ms_b128": enc_ms, "action_mae": mt_mae,
          "action_floor": max(mt_floors)}
    for name, key, src, line, shape in (
            ("fused_attn_block_q8", "attn", "fused_attn_block_q8.cu",
             "attn_kernel.py:264",
             "b=128 x 14 tokens, D=1024, 8 heads of 128, int8 QKV and c_proj"),
            ("fused_top2_mlp_q8c", "moe", "fused_top2_mlp_q8c.cu",
             "moe_kernel.py:350",
             "b=128 x 14 tokens, D=1024, hidden 4096, top-2 of 4, ln_2 and "
             "the residual fused")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"mode_diffusion_policy_tpu_torch/csrc/{src}",
            "replaces": f"mode_diffusion_policy_tpu/ops/pallas/{line}",
            "launches": mt_launches[name],
            "max_abs_err": two[key]["max_abs_err"],
            **{k: two[key][128][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
            "shape": shape,
            "b1": dict(two[key][1]),
            "stages_ms": {"b128": two[key]["stages_b128"],
                          "b1": two[key]["stages_b1"]},
            "stage_rates": {"b128": two[key]["stage_rates_b128"],
                            "b1": two[key]["stage_rates_b1"]},
            "max_throughput": mt,
        })
    kernels.append({
        "name": "fused_attn_block",
        "route": "cuda",
        "source": "mode_diffusion_policy_tpu_torch/csrc/fused_attn_block.cu",
        "replaces": "mode_diffusion_policy_tpu/ops/pallas/attn_kernel.py:138",
        "launches": main_path["launches"]["fused_attn_block"],
        "max_abs_err": attn16["max_abs_err"],
        **{k: attn16[128][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        "shape": "b=128 x 14 tokens, D=1024, 8 heads of 128, bf16 QKV and "
                 "c_proj",
        "launches_are": "parity b=128, one 10-step dpmpp_2s_ancestral chunk "
                        "(9 off-schedule evaluations x 12 layers)",
        "b1": dict(attn16[1]),
        "stages_ms": {"b128": attn16["stages_b128"],
                      "b1": attn16["stages_b1"]},
        "sweep": sweep,
    })
    b16 = bench["fused_top2_mlp"]
    kernels.append({
        "name": "fused_top2_mlp",
        "route": "cuda",
        "source": "mode_diffusion_policy_tpu_torch/csrc/fused_top2_mlp.cu",
        "replaces": "mode_diffusion_policy_tpu/ops/pallas/moe_kernel.py:97",
        "launches": bf16cfg[128]["launches"]["fused_top2_mlp"],
        "max_abs_err": moe16_err["fused_top2_mlp"],
        **{k: b16["b128"][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        "library_is": b16["b128"]["library_is"],
        "shape": "b=128 x 14 tokens, D=1024, hidden 4096, top-2 of 4, bf16 "
                 "experts, ln_2 and the residual fused",
        "launches_are": "the bf16 kernel configuration, b=128, one 10-step "
                        "DDIM chunk (10 steps x 12 layers)",
        "ms_cold_l2": b16["b128"]["ms_cold_l2"],
        "b1": {k: b16["b1"][k] for k in (
            "ms", "ms_cold_l2", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "stages_ms": {"b128": b16["b128"]["stages_ms"],
                      "b1": b16["b1"]["stages_ms"]},
        "moe_stage_rates": {"b128": b16["b128"]["stage_rates"],
                            "b1": b16["b1"]["stage_rates"]},
        "bf16_config": {f"b{B}": row for B, row in bf16cfg.items()},
    })
    b8 = bench["fused_top2_mlp_q8"]
    kernels.append({
        "name": "fused_top2_mlp_q8",
        "route": "cuda",
        "source": "mode_diffusion_policy_tpu_torch/csrc/fused_top2_mlp.cu",
        "replaces": "mode_diffusion_policy_tpu/ops/pallas/moe_kernel.py:216",
        "launches": bench_launches["fused_top2_mlp_q8"],
        "max_abs_err": moe16_err["fused_top2_mlp_q8"],
        **{k: b8["b128"][k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
        "library_is": b8["b128"]["library_is"],
        "shape": "b=128 x 14 tokens, D=1024, hidden 4096, top-2 of 4, int8 "
                 "experts with bf16 products, ln_2 and the residual fused",
        "launches_are": "the kernel bench (bench_kernels_torch.bench_moe: "
                        "warm-up, timed and profiled launches at b=128 and "
                        "b=1)",
        "ms_cold_l2": b8["b128"]["ms_cold_l2"],
        "b1": {k: b8["b1"][k] for k in (
            "ms", "ms_cold_l2", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "stages_ms": {"b128": b8["b128"]["stages_ms"],
                      "b1": b8["b1"]["stages_ms"]},
        "bench_q8c": bench["fused_top2_mlp_q8c"],
        "bench_layer": bench_layer,
        "bench_proj": bench_proj,
    })
    phase("done", T0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
