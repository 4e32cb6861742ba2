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

The variants phase (before phase 22) builds every model option away from
the flagship through ``config.builders.build_agent`` from a
``conf/model/mode_agent.yaml``-shaped dict at the flagship widths (12
layers, D=1024, 8 heads of 128, hidden 4096, seeded random weights), one
agent at a time, and serves each under its presets (``VARIANTS``): the goal
embedding in the cond token with FiLM-ResNet-34 encoders
(``goal_routing_r34``: ``parity``, ``b1-latency`` and ``max-throughput``
at b=128, ``b1-latency`` and ``b1-latency-max`` at b=1; one cond row per
sample in ``fused_layer_q8c``, ``fused_dit_q8c`` and
``fused_attn_block_q8`` at b=128, where at b=1 the sample's one row is the
shared-row launch), a
shared expert with the scratch ResNet-18 (``shared_r18``: two train steps
at B=8 on the plain path, then ``parity`` on the trained weights,
``fused_attn_block`` and ``fused_top2_mlp_q8c`` without ln_2 fused), an
identity expert with cross-attention (``identity_cross``:
``fused_attn_block``, the MoE and cross-attention plain) and the plain
paths (``plain_paths``: non-causal, a router over the tokens, no goal or
noise token, proprio, ``init_style="normal"``: ``fused_top2_mlp_q8c``
alone). Each cell's launches per chunk must equal the table's, and its
chunk must meet the same agent's ``reference`` chunk and its own plain
evaluation by the action-MAE rule (the floor against the plain evaluation
is the f32-vs-f64 one, as in the other phases). On goal_routing_r34's
weights it also holds ``fused_layer_q8c`` and ``fused_dit_q8c`` with one
cond row per sample at b=128 against their plain versions
(``cond_row_checks``: equal rows bit-equal to the shared row, the 12-layer
megakernel launch too; the 12-layer launch with distinct rows layer by
layer within the layer gates and equal to its layers chained; a per-token
cond whose rows are equal within each sample gives the per-sample launch
bit for bit), and at b=1 their one-row launch, and times both kinds of
cond; one ``variants`` JSON line.

The long-token phase (after the variants phase) builds the shipped
CALVIN config with the override ``act_seq_len=16`` through the port's
loader and builders (12 layers, D=1024, 2 FiLM-ResNet-50s, seeded random
weights; T=20 tokens per sample) and serves it under ``parity`` (b=128,
b=1), ``max-throughput`` (b=128), ``b1-latency`` and ``b1-latency-max``
(b=1) and the bf16 kernel configuration (b=128), each cell by the
variants phase's rule with the launches of T=14; holds each of the five
attention-bearing launchers (``fused_layer_q8c`` with bf16 and int8
projections, ``fused_dit_q8c`` with both stacks, ``fused_attn_block``,
``fused_attn_block_q8``) to its plain version at T = 17, 20, 64 and 160,
b=128 and b=1, with a shared, a per-sample and a per-token cond (the
layer gates; a per-token cond of rows equal within each sample is the
per-sample launch, bit for bit) and times each beside its bound, plain
version and library yardstick; checks at T=20 with a per-token cond that
``fused_attn_block`` then ``fused_top2_mlp_q8c`` equals ``fused_layer_q8c``
on all 12 layers and the megakernel its layers chained and 12 chained
``fused_layer_q8c`` launches, bit for bit; and runs one chain of
``LongHorizonEvaluator`` on the fake env under ``auto`` with 16 actions a
chunk. One ``long_tokens`` JSON line; the five kernels' entries in the
``kernels`` line gain a ``long_tokens`` record.

Phase 22 trains: the flagship with the shipped CALVIN training settings
(``TRAIN_MODEL``, ``TRAIN_OPT``, ``TRAIN_EMA``, ``TRAIN_TRANSFORMS``,
which ``check_train_settings`` holds to what the port's config builders
read from ``conf/config_calvin.yaml``, but for the from-scratch router aux
weights) through ``Trainer.setup`` and ``Trainer.fit`` for one epoch of 8
batches at B=32 of synthetic CALVIN-sized uint8 frames, with one
validation batch and a rollout hook, once with the bf16 training state
(``bf16_full_state``, stochastic rounding) and once with the f32 master
state: finite losses, 8 optimizer steps, each step's LR equal to
``tri_stage_schedule``, EMA apart from the parameters; a fresh Trainer on
the same log dir resumes with every tensor equal bit for bit; the trained
EMA weights are served through ``parity`` at b=128 (120
``fused_layer_q8c`` launches, the kernel-vs-plain action MAE rule); the
gradient of one b=8 batch in f32 and in the bf16 compute dtype against
float64 on the card; the median step, its forward+backward and
optimizer+EMA split, the device idle share and the peak memory with and
without ``encoder_remat``, printed as one ``train`` JSON line before the
``kernels`` line.

Phase 23 evaluates phase 22's trained EMA weights (its bf16 run directory,
kept until then) through the ``evaluate_calvin`` CLI
(``evaluate(parse_args(argv))``: ``--checkpoint`` on the run, 2 chains on
the fake env at 224 px, 25 env steps per subtask) under ``parity``,
``reference`` and ``b1-latency``: equal results, 120 ``fused_layer_q8c``
/ 0 / 10 ``fused_dit_q8c`` launches per chunk, every logged action (before
the gripper's binarization) within max(1e-3, 2 x the b=1 floor) of the
``reference`` run's, one CLIP tower call per distinct instruction; then
the agent proxy on 127.0.0.1 (actions bit-equal to an in-process wrapper,
recovery after a request that raises) and the Trainer's rollout hook
(``build_calvin_rollout_callback`` on the fake env). It prints env steps
per second, the chunk's ms inside the loop, the host ms per env step, the
tower's ms, a subtask's device idle share and the proxy's round trip, as
one ``eval`` JSON line before the ``kernels`` line.

Phase 24 trains from disk through the ``training_calvin`` CLI: it writes a
synthetic CALVIN store at CALVIN's sizes (16 training and 4 validation
episodes of 64 frames, 200 x 200 static and 84 x 84 gripper frames),
extracts its packed actions with ``data.preprocess``, times the CLI's
datamodule at 0 and 4 workers with and without the shared-memory cache
(the first 3 batches of 4 workers + cache equal to the inline ones, bit
for bit), runs ``training_calvin.main`` on the shipped config with
``batch_size=32``, 8 steps, 4 workers, the cache and the rollout hook on
the fake env (2 chains), then again with 2 epochs (it resumes at step 8),
and restores the run directory with ``evaluate_calvin`` under ``parity``
(120 ``fused_layer_q8c`` launches per chunk). Finite losses, no port
segment left under ``/dev/shm``; the CLI's ms per step beside phase 22's,
the loader's ms per batch and a CLI step's device idle share, as one
``cli`` JSON line.

Phase 25 runs the LIBERO slice: it writes LIBERO-10's ten task files
(``<SCENE>_<instruction>_demo.hdf5``, 3 demos of 64 frames each at
LIBERO's sizes: 128 x 128 agentview and eye-in-hand frames, 7 joint
states, 2 gripper states, 7 actions); without ``h5py`` on the machine the
same arrays go to ``.npy`` files read through the datasets'
``demo_arrays`` seam, and it says so. It times the shipped config's
datamodule at batch 128 without and with ``cache_all`` (the first 3
batches equal bit for bit), runs ``training_libero.main`` on the shipped
config at ``batch_size=128`` (the static camera at 224 px, the gripper at
112; 8 steps, one profiled, the rollout hook on the fake env), restores
that run with ``evaluate_libero`` on the fake env at 224 px under
``parity``, ``reference`` and ``b1-latency`` (120 ``fused_layer_q8c`` / 0
/ 10 ``fused_dit_q8c`` launches per chunk, actions within max(1e-3, 2 x
the b=1 floor) of ``reference``'s), runs ``SingleTaskEvaluator`` on phase
22's EMA weights under ``parity`` and ``determinism_check --fake-env``
twice (equal hashes), and prints one ``libero`` JSON line.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import multiprocessing
import os
import re
import signal
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

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
            full, worst, err = check_stack_layers(
                f"fused_dit_q8c {name} b={B} step={s}", st, x, c, idx_L, p_L,
                s, kw)
            out["max_abs_err"] = max(out["max_abs_err"], err)
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


def check_stack_layers(label, st, x, c, idx_L, p_L, step, kw):
    """One megakernel launch over the whole stack ``st``, and each layer (a
    one-layer slice of the stack) against the plain layer on the kernel's
    own input, by the layer gates; the whole launch must equal its layers
    chained, bit for bit. Returns (the launch's output, the worst share of
    the gates used, the largest max |diff|)."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c, fused_dit_q8c_ref)
    full = fused_dit_q8c(x, c, st, idx_L, p_L, step=step, **kw)
    torch.cuda.synchronize()
    y, worst, max_err = x, 0.0, 0.0
    for l in range(st["ln1"].shape[0]):
        stl = {k: v[l:l + 1] for k, v in st.items()}
        tabs = (idx_L[l:l + 1], p_L[l:l + 1])
        yk = fused_dit_q8c(y, c, stl, *tabs, step=step, **kw)
        err, share = layer_gate(f"{label} layer {l}", yk,
                                fused_dit_q8c_ref(y, c, stl, *tabs,
                                                  step=step, **kw))
        worst, max_err = max(worst, share), max(max_err, err)
        y = yk
    chained = (full.float() - y.float()).abs().max().item()
    if chained != 0.0:
        raise SystemExit(f"{label}: the stack differs from its layers "
                         f"chained ({chained:.3e})")
    return full, worst, max_err


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


@contextlib.contextmanager
def plain_impls(dit, **kw):
    """Inside the ``with`` block every kernel function of ``dit`` is its
    plain version, given those of the keyword arguments (``acc_dtype``,
    ``red_dtype``, ``mlp_dtype``) that it takes; the kernels are put back
    after it."""
    import inspect
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block_q8_ref, fused_attn_block_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c_ref, fused_layer_q8c_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp_q8c_ref, fused_top2_mlp_ref)
    refs = {"layer_impl": fused_layer_q8c_ref, "dit_impl": fused_dit_q8c_ref,
            "attn_impl": fused_attn_block_q8_ref,
            "attn_impl_bf16": fused_attn_block_ref,
            "moe_impl": fused_top2_mlp_q8c_ref,
            "moe_impl_bf16": fused_top2_mlp_ref}
    old = {k: getattr(dit, k) for k in refs}
    for k, fn in refs.items():
        args = inspect.signature(fn).parameters
        setattr(dit, k, functools.partial(
            fn, **{a: v for a, v in kw.items() if a in args}))
    try:
        yield
    finally:
        for k, fn in old.items():
            setattr(dit, k, fn)


def plain_evals(dit, chunk, n=3):
    """``chunk()`` on the plain versions (``plain_impls``) at the first
    ``n`` of four precisions: f32; products in f64; products, norms' sums
    and softmax in f64; and with the int8 MoE's float arithmetic around its
    products in f64 too (``fused_top2_mlp_q8c_ref``'s ``mlp_dtype``). All
    but the first are near-exact evaluations: their distance from the
    first is a floor."""
    import torch
    f64 = torch.float64
    out = []
    for kw in ({}, {"acc_dtype": f64}, {"acc_dtype": f64, "red_dtype": f64},
               {"acc_dtype": f64, "red_dtype": f64, "mlp_dtype": f64})[:n]:
        with plain_impls(dit, **kw):
            out.append(chunk())
    return out


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


def check_token_rows(name, kern, args, kw):
    """A per-token cond [B,T,D] whose rows are equal within each sample
    gives the launch with one row per sample (``args[1]``, [B,1,D]; at
    b=1 the shared-row launch), bit for bit."""
    import torch
    x, rows = args[:2]
    one = kern(*args, **kw)
    tok = kern(x, rows.expand(*x.shape).contiguous(), *args[2:], **kw)
    torch.cuda.synchronize()
    if not torch.equal(one, tok):
        raise SystemExit(
            f"{name} b={x.shape[0]} x {x.shape[1]}: a per-token cond of "
            "rows equal within each sample differs from the per-sample "
            f"launch ({(one.float() - tok.float()).abs().max().item():.3e})")


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
    p, *exacts = plain_evals(
        dit, chunk, 3 if c.use_int8_attn or c.use_megakernel else 2)
    floors = [(p - e).abs().mean().item() for e in exacts]
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


# the bf16 kernel configuration's name where a preset's would stand
BF16_CONFIG = "bf16-config"


def bf16_config_policy(agent):
    """``agent`` reconfigured with the JAX bench's BENCH_INT8=0 flag set
    (use_pallas_moe, use_pallas_attn; use_fused_layer set and inert without
    int8 experts), no preset (the raw encoders, no int8 weights), and its
    RolloutPolicy."""
    from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
    agent.configure_(use_pallas_moe=True, use_pallas_attn=True,
                     use_int8_moe=False, use_fused_layer=True,
                     use_int8_attn=False, use_megakernel=False)
    agent.folded = agent.q8 = None
    agent.quantize_for_inference()
    return RolloutPolicy(agent, seed=0)


def bf16_config_run(agent, results, cfg, zero_launches, launches_of):
    """The bf16 kernel configuration at full width (``bf16_config_policy``).
    One 10-step DDIM chunk at b=128 and at b=1 with
    the launch counters on (120 fused_attn_block, 120 fused_top2_mlp,
    nothing else), the action MAE against the plain versions and the
    f32-vs-f64 floors, the chunk ms (median of 3) and its device split."""
    import torch

    policy = bf16_config_policy(agent)
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
        evals = dict(zip(("plain", "exact", "exact_all"),
                         plain_evals(dit, chunk)))

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
        evals = dict(zip(("plain", "exact", "exact_all"),
                         plain_evals(dit, chunk)))

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


# ---------------------------------------------------------------------------
# the variants phase: every model option away from the flagship, served
# through the kernels at the flagship widths
# ---------------------------------------------------------------------------

# (options of conf/model/mode_agent.yaml's inner_model or the model, the
# presets served at their batch, and the launches of each kernel per
# 10-step DDIM chunk; every other kernel launches 0 times). At b=1 the
# goal-routing cond is one [1,1,D] row, which the whole-layer kernels take
# as the shared row: b1-latency at b=128 serves the megakernel with one
# cond row per sample.
VARIANTS = {
    "goal_routing_r34": (
        {"use_goal_in_routing": True, "resnet_type": "34"},
        (("parity", 128, {"fused_layer_q8c": 120}),
         ("b1-latency", 1, {"fused_dit_q8c": 10}),
         ("b1-latency", 128, {"fused_dit_q8c": 10}),
         ("b1-latency-max", 1, {"fused_dit_q8c": 10}),
         ("max-throughput", 128, {"fused_attn_block_q8": 120,
                                  "fused_top2_mlp_q8c": 120}))),
    "shared_r18": (
        {"use_shared_expert": True, "num_experts": 5, "top_k": 3,
         "resnet_type": "18"},
        (("parity", 128, {"fused_attn_block": 120,
                          "fused_top2_mlp_q8c": 120}),)),
    "identity_cross": (
        {"identity_expert": True, "use_cross_attention": True,
         "noise_in_cross_attention": True},
        (("parity", 128, {"fused_attn_block": 120}),)),
    "plain_paths": (
        {"causal": False, "cond_router": False, "router_normalize": False,
         "goal_conditioned": False, "use_noise_token_as_input": False,
         "use_proprio": True, "init_style": "normal"},
        (("parity", 128, {"fused_top2_mlp_q8c": 120}),)),
}
VARIANT_TRAIN_B = 8
# a cell's action MAEs are taken over at least this many samples: a b=1
# cell serves this many single-sample chunks. On one sample the distance
# between two valid evaluations is one draw of a few int8 rounding flips:
# under b1-latency-max at b=1 it read from 1.3e-3 to 4.8e-3 across models
# and samplers on an H100, too noisy a floor to gate a kernel by
CELL_SAMPLES = 8


def variant_model_cfg(opts):
    """A conf/model/mode_agent.yaml-shaped dict at the flagship widths
    with the variant's options (``resnet_type`` and ``use_proprio`` at the
    model level, the rest in ``model.inner_model``)."""
    model_level = ("resnet_type", "use_proprio")
    return {"latent_dim": 1024, "cond_dim": 512, "seed": 42,
            "entropy_gamma": 0.01, "router_z_delta": 0.001,
            **{k: v for k, v in opts.items() if k in model_level},
            "model": {"inner_model": {
                "n_layers": 12, "n_heads": 8, "num_experts": 4, "top_k": 2,
                **{k: v for k, v in opts.items() if k not in model_level}}}}


def variant_cell(name, agent, mode, B, want, inputs, zero_launches,
                 launches_of, calib=None, policy=None):
    """One cell: ``mode`` applied to ``agent`` (``BF16_CONFIG``: the bf16
    kernel configuration, ``bf16_config_policy``); each kernel the cell
    launches held on block 0 to its plain version by the layer gates
    (``cell_kernel_checks``); one chunk at batch ``B`` with its launches
    counted (each kernel as ``want`` says, the others 0), against the same
    agent's ``reference`` chunk and against the preset's plain evaluation
    (its kernels' plain versions), each by the action-MAE rule max(1e-3,
    2 x floor). Against the plain evaluation, as in every other phase, the
    floor is the larger distance between the plain evaluation and two
    near-exact ones (products in f64; products, norms and softmax in f64).
    Against the reference it is the larger of that and the plain
    evaluation's distance from the reference chunk: the preset's own
    approximation of the reference (int8 experts; int8 projections and
    encoders where it has them). Where ``B`` is below ``CELL_SAMPLES``
    the MAEs are means over ``CELL_SAMPLES / B`` chunks at batch ``B``,
    each on its own samples; launches and times are the first chunk's.
    The chunk's ms (median of 3) beside. ``policy``: the preset's policy
    on ``agent``, where the caller has made it already."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
    windows = [({k: v[i:i + B] for k, v in inputs[0].items()},
                {"lang_emb": inputs[1][i:i + B]}, inputs[2][i:i + B])
               for i in range(0, max(B, CELL_SAMPLES), B)]
    if policy is None:
        policy = (bf16_config_policy(agent) if mode == BF16_CONFIG else
                  RolloutPolicy.with_serving_mode(agent, mode=mode, seed=0,
                                                  calib_batch=calib))
    layer_err = cell_kernel_checks(f"{name} {mode}", policy.agent, B, want,
                                   inputs[2].device)
    zero_launches()
    kerns = [policy.predict_chunk(*windows[0])]
    torch.cuda.synchronize()
    counts = launches_of()
    dit = policy.agent.inner_model
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        policy.predict_chunk(*windows[0])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    kerns += [policy.predict_chunk(*w) for w in windows[1:]]
    # the int8 MoE kernel's plain version has no float products to take to
    # f64: where that kernel runs, its float arithmetic around the products
    # is (mlp_dtype); alone, the norms' sums moved its served chunk by a
    # quarter of what the kernel did (plain_paths on an H100)
    n = 4 if "fused_top2_mlp_q8c" in want else 3
    evals = [plain_evals(dit, lambda w=w: policy.predict_chunk(*w), n)
             for w in windows]
    del policy
    ref_policy = RolloutPolicy.with_serving_mode(agent, mode="reference",
                                                 seed=0)
    refs = [ref_policy.predict_chunk(*w) for w in windows]
    del ref_policy

    def mae_of(a, b):
        return statistics.fmean((x - y).abs().mean().item()
                                for x, y in zip(a, b))

    plains = [e[0] for e in evals]
    exact_floor = max(mae_of(plains, [e[i] for e in evals])
                      for i in range(1, n))
    mae, mae_plain = mae_of(kerns, refs), mae_of(kerns, plains)
    plain_ref = mae_of(plains, refs)
    tol_plain = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * exact_floor)
    # the preset's own approximation of the reference (int8 experts, and
    # int8 projections and encoders where the preset has them): the plain
    # evaluation's distance from the reference chunk
    floor = max(exact_floor, plain_ref)
    tol = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * floor)
    launched = {k: v for k, v in counts.items() if v}
    print(f"  {name} {mode} b={B}: launches {launched}; action MAE over "
          f"{len(windows) * B} samples vs "
          f"reference {mae:.3e} (tol {tol:.3e}, floor {floor:.3e}), "
          f"kernel-vs-plain {mae_plain:.3e} (tol {tol_plain:.3e}, "
          f"plain-f32-vs-f64 floor {exact_floor:.3e}), "
          f"plain-vs-reference {plain_ref:.3e}; chunk "
          f"{statistics.median(ms):.2f} ms (median of 3: "
          f"{', '.join(f'{m:.2f}' for m in ms)})", flush=True)
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    if bad:
        raise SystemExit(f"variants: {name} {mode} b={B} launched {bad}, "
                         f"the table says {want}")
    if not (all(bool(torch.isfinite(k).all()) for k in kerns)
            and mae <= tol and mae_plain <= tol_plain):
        raise SystemExit(f"variants: {name} {mode} b={B} disagrees with "
                         "its reference chunk or its plain evaluation")
    return {"launches": launched, "samples": len(windows) * B,
            "layer_max_abs_err": layer_err,
            "action_mae_vs_reference": mae,
            "action_mae_vs_plain": mae_plain, "tol_vs_plain": tol_plain,
            "plain_floor": exact_floor, "plain_vs_reference": plain_ref,
            "action_floor": floor, "tol": tol, "chunk_ms": statistics.median(ms)}


def cell_kernel_checks(label, agent, B, want, dev):
    """Each per-layer kernel that a cell launches (``want``), once on block
    0 of the served agent at batch ``B`` and step 0, on a random input and
    the block's own cond (one row per sample under
    ``use_goal_in_routing``), against its plain version by the layer
    gates; the megakernel's layers are held in ``cond_row_checks``.
    Returns the largest max |diff|."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block, fused_attn_block_q8, fused_attn_block_q8_ref,
        fused_attn_block_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_layer_q8c, fused_layer_q8c_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp, fused_top2_mlp_q8c, fused_top2_mlp_q8c_ref,
        fused_top2_mlp_ref)
    gen = torch.Generator(device=dev).manual_seed(21)
    dit = agent.inner_model
    cfg = dit.cfg
    blk, a = dit.blocks[0], dit.blocks[0].attn
    T, D = cfg.total_tokens, cfg.embed_dim
    idx, probs = agent.precompute_routing()[0]
    emb = dit.process_sigma_embeddings(torch.as_tensor(
        agent.sigmas[:1], device=dev))
    goal = dit.goal_emb(torch.randn(B, 1, cfg.goal_dim, generator=gen,
                                    device=dev).to(cfg.dtype))
    c = dit.cond_token(emb, goal)
    x = torch.randn(B, T, D, generator=gen, device=dev).to(torch.bfloat16)
    attn_kw = dict(ln_eps=blk.ln_1.eps, qk_eps=a.q_norm.eps)
    checks = {
        "fused_layer_q8c": (fused_layer_q8c, fused_layer_q8c_ref, (
            x, c, blk.ln_1.g, a.wqkv.kernel, a.wqkv.bias, a.q_norm.g,
            a.k_norm.g, a.c_proj.kernel, blk.ln_2.g, blk.experts_q, idx,
            probs), dict(step=0, qexp_t=blk.experts_qt, eps1=blk.ln_1.eps,
                         eps_qk=a.q_norm.eps, eps2=blk.ln_2.eps)),
        "fused_attn_block": (fused_attn_block, fused_attn_block_ref, (
            x, c, blk.ln_1.g, a.wqkv.kernel, a.wqkv.bias, a.q_norm.g,
            a.k_norm.g, a.c_proj.kernel), attn_kw),
        "fused_attn_block_q8": (fused_attn_block_q8, fused_attn_block_q8_ref,
                                (x, c, blk.ln_1.g, a.attn_q, a.q_norm.g,
                                 a.k_norm.g),
                                dict(attn_kw, qattn_t=a.attn_qt)),
        # ln_2 fused but beside a shared expert, which takes the normed
        # input as the residual seed
        "fused_top2_mlp_q8c": (fused_top2_mlp_q8c, fused_top2_mlp_q8c_ref, (
            blk.ln_2(x) if cfg.use_shared_expert else x, idx, probs,
            blk.experts_q), dict(
                step=0, residual=True, qexp_t=blk.experts_qt,
                ln_g=None if cfg.use_shared_expert else blk.ln_2.g,
                ln_eps=blk.ln_2.eps)),
        "fused_top2_mlp": (fused_top2_mlp, fused_top2_mlp_ref, (
            x, idx, probs, blk.experts_w1, blk.experts_b1, blk.experts_w2),
            dict(step=0, residual=True, ln_g=blk.ln_2.g,
                 ln_eps=blk.ln_2.eps))}
    worst = 0.0
    for name in want:
        if name not in checks:
            continue
        kern, ref, args, kw = checks[name]
        got = kern(*args, **kw)
        torch.cuda.synchronize()
        err, _ = layer_gate(f"{label} {name} b={B}", got, ref(*args, **kw))
        worst = max(worst, err)
    return worst


def cond_row_checks(parity_dit, b1_stack, routing, emb_all, gen, T):
    """The per-sample cond of fused_layer_q8c and fused_dit_q8c on a served
    variant's weights. At b=128 (B cond rows): equal rows give
    the shared-row launch bit for bit; distinct rows stay within the layer
    gates of the plain version; the megakernel's whole 12-layer launch with
    distinct rows holds each of its layers to the plain layer on the
    kernel's own input and equals them chained, bit for bit, and its
    distance to the plain stack is printed beside the f32-vs-f64 plain
    floor. At b=1 the sample's own row is one [1,1,D] row, which the
    wrappers launch as the shared row (1 cond row): that launch is held to
    the plain version with the sample's own row. A per-token cond whose
    rows are equal within each sample gives the per-sample launch bit for
    bit. Each kernel's ms with one row per sample beside the shared
    row's."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c, fused_dit_q8c_ref, fused_layer_q8c,
        fused_layer_q8c_ref)
    dit = parity_dit
    blk, D = dit.blocks[0], dit.cfg.embed_dim
    a = blk.attn
    idx, probs = routing[0]
    idx_L = torch.stack([i for i, _ in routing])
    p_L = torch.stack([p for _, p in routing])
    c = emb_all[0][None]
    st = b1_stack
    one = {k: v[:1] for k, v in st.items()}
    eps = dict(eps1=blk.ln_1.eps, eps_qk=a.q_norm.eps, eps2=blk.ln_2.eps)
    kw_layer = dict(step=0, qexp_t=blk.experts_qt, **eps)
    kw_dit = dict(step=0, **eps)
    out = {"fused_layer_q8c": {}, "fused_dit_q8c": {}}
    worst = 0.0
    for B in (128, 1):
        x = torch.randn(B, T, D, generator=gen, device=c.device).to(
            torch.bfloat16)
        rows = per_sample_cond(dit, B, gen)
        stride = rows.numel() != D
        args = (x, blk.ln_1.g, a.wqkv.kernel, a.wqkv.bias, a.q_norm.g,
                a.k_norm.g, a.c_proj.kernel, blk.ln_2.g, blk.experts_q, idx,
                probs)
        for name, kern, ref, kargs, kw in (
                ("fused_layer_q8c", fused_layer_q8c, fused_layer_q8c_ref,
                 args, kw_layer),
                ("fused_dit_q8c", fused_dit_q8c, fused_dit_q8c_ref,
                 (x, one, idx_L[:1], p_L[:1]), kw_dit)):
            label = name if name == "fused_layer_q8c" else \
                f"{name} (one layer)"
            if stride:
                err, share = check_cond_rows(label, kern, ref, kargs, c, rows,
                                             kw)
            else:
                err, share = layer_gate(
                    f"{label} b=1, the sample's own row",
                    kern(x, rows, *kargs[1:], **kw),
                    ref(x, rows, *kargs[1:], **kw))
            worst = max(worst, err)
            check_token_rows(label, kern, (x, rows, *kargs[1:]), kw)
            out[name][f"b{B}"] = {"c_rows": rows.shape[0], "max_abs_err": err,
                                  "gate_share": share}
        if stride:
            # the whole megakernel launch with one row per sample
            full, share_L, err_L = check_stack_layers(
                f"fused_dit_q8c b={B} per-sample cond", st, x, rows, idx_L,
                p_L, 0, eps)
            whole = fused_dit_q8c(x, c, st, idx_L, p_L, **kw_dit)
            same = fused_dit_q8c(x, c.expand(B, 1, D).contiguous(), st,
                                 idx_L, p_L, **kw_dit)
            torch.cuda.synchronize()
            if not torch.equal(whole, same):
                raise SystemExit(f"fused_dit_q8c b={B}: equal cond rows "
                                 "differ from the shared row over 12 layers")
            plain = fused_dit_q8c_ref(x, rows, st, idx_L, p_L, **kw_dit)
            exact = fused_dit_q8c_ref(x, rows, st, idx_L, p_L,
                                      acc_dtype=torch.float64, **kw_dit)
            vs_plain = (full.float() - plain.float()).abs().mean().item()
            floor = (plain.float() - exact.float()).abs().mean().item()
            worst = max(worst, err_L)
            out["fused_dit_q8c"][f"b{B}"]["stack"] = {
                "layers": st["ln1"].shape[0], "max_abs_err": err_L,
                "gate_share": share_L, "vs_plain_mean": vs_plain,
                "plain_f32_vs_f64_mean": floor}
            print(f"  fused_dit_q8c b={B}, one cond row per sample: "
                  f"{st['ln1'].shape[0]} layers each within the layer gates "
                  f"(worst {share_L:.2f} of the gate), the launch == its "
                  f"layers chained; stack vs plain stack mean {vs_plain:.3e}"
                  f", plain f32 vs f64 mean {floor:.3e}", flush=True)
        for name, launch, iters in (
                ("fused_layer_q8c",
                 lambda cc: fused_layer_q8c(x, cc, *args[1:], **kw_layer),
                 20),
                ("fused_dit_q8c",
                 lambda cc: fused_dit_q8c(x, cc, st, idx_L, p_L, **kw_dit),
                 10)):
            row = out[name][f"b{B}"]
            row["ms_shared"] = cuda_time_ms(lambda: launch(c), iters)
            if stride:
                row["ms_per_sample"] = cuda_time_ms(lambda: launch(rows),
                                                    iters)
    line = "; ".join(
        f"{k} {b}: " + (f"{v['ms_per_sample']:.4f} ms per-sample cond vs "
                        f"{v['ms_shared']:.4f} ms shared row"
                        if v["c_rows"] > 1 else
                        f"{v['ms_shared']:.4f} ms (one sample: its row is "
                        "the shared-row launch)")
        for k, rows_ in out.items() for b, v in rows_.items())
    print(f"  per-sample cond: {line}", flush=True)
    return out, worst


def variant_inputs(gen, dev, B=128, actions=10):
    """b=128 preprocessed 224 px frames, a 512-wide goal and the initial
    noise of ``actions`` actions; a cell at b=1 takes the first sample."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera
    obs = {k: preprocess_camera(torch.randint(
        0, 256, (B, 1, 224, 224, 3), generator=gen, device=dev,
        dtype=torch.uint8)) for k in CAMS}
    return (obs, torch.randn(B, 1, 512, generator=gen, device=dev),
            torch.randn(B, actions, 7, generator=gen, device=dev))


def variant_train(agent, dev):
    """Two train steps of ``agent`` at B=8 on synthetic frames (the plain
    path: no kernel), with autograd on; returns each step's metrics."""
    import torch
    from mode_diffusion_policy_tpu_torch.training.loop import make_train_step
    from mode_diffusion_policy_tpu_torch.training.optim import make_optimizer
    from mode_diffusion_policy_tpu_torch.training.state import TrainState
    gen = torch.Generator(device=dev).manual_seed(13)
    batches = [eval_batch(b) for b in train_batches(gen, 2, VARIANT_TRAIN_B,
                                                    dev)]
    with torch.enable_grad():
        opt, _ = make_optimizer(dict(agent.named_parameters()))
        state = TrainState.create(agent, opt, gen)
        step = make_train_step(agent, opt, device=dev)
        out = []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            out.append({k: float(v) for k, v in m.items()
                        if k.startswith("train/")})
            out[-1]["step_ms"] = (time.perf_counter() - t0) * 1e3
    for m in out:
        if not all(math.isfinite(v) for v in m.values()) or \
                "train/load_balancing_loss" not in m:
            raise SystemExit(f"variants: shared_r18 train step {m}")
    print(f"  shared_r18: two train steps at B={VARIANT_TRAIN_B}: {out}",
          flush=True)
    del state, opt, step
    return out


def variants_phase(zero_launches, launches_of, dev):
    """Each variant of ``VARIANTS`` built in turn through
    ``config.builders.build_agent`` at the flagship widths (seeded random
    weights) and served under its presets (``variant_cell``); the
    per-sample cond of both whole-layer kernels on goal_routing_r34's
    weights (``cond_row_checks``); two train steps of shared_r18 before
    its parity chunk, which serves the trained weights. Each agent is
    freed before the next is built."""
    import gc
    import torch
    from mode_diffusion_policy_tpu_torch.config.builders import build_agent
    gen = torch.Generator(device=dev).manual_seed(12)
    inputs = variant_inputs(gen, dev)
    calib = {**{k: v[:4] for k, v in inputs[0].items()},
             "lang_emb": inputs[1][:4]}
    res = {"cells": {}, "train": None, "cond_rows": None}
    for name, (opts, cells) in VARIANTS.items():
        t = time.perf_counter()
        agent = build_agent(variant_model_cfg(opts), dtype=torch.bfloat16,
                            device=dev)[0]
        cfg = agent.cfg
        print(f"  {name}: resnet_type {cfg.resnet_type}, obs_dim "
              f"{cfg.obs_dim}, {cfg.dit_config().total_tokens} tokens, "
              f"experts {cfg.num_experts} (routed "
              f"{cfg.dit_config().num_routed_experts}, top "
              f"{cfg.dit_config().router_top_k})", flush=True)
        if name == "shared_r18":
            res["train"] = variant_train(agent, dev)
        policies = {}
        for mode, B, want in cells:
            res["cells"][f"{name}/{mode}/b{B}"] = variant_cell(
                name, agent, mode, B, want, inputs, zero_launches,
                launches_of, calib if mode == "max-throughput" else None)
            if name == "goal_routing_r34" and mode in (
                    "parity", "b1-latency") and mode not in policies:
                from mode_diffusion_policy_tpu_torch.models.agent import \
                    RolloutPolicy
                policies[mode] = RolloutPolicy.with_serving_mode(
                    agent, mode=mode, seed=0).agent
        if policies:
            pa = policies["parity"]
            sched = torch.as_tensor(pa.sigmas[:-1], device=dev)
            res["cond_rows"], res["cond_rows_max_err"] = cond_row_checks(
                pa.inner_model, policies["b1-latency"].inner_model.stacked,
                pa.precompute_routing(),
                pa.inner_model.process_sigma_embeddings(sched), gen,
                pa.inner_model.cfg.total_tokens)
        del agent, policies
        gc.collect()
        torch.cuda.empty_cache()
        phase(f"variants: {name}", t)
    return res


# ---------------------------------------------------------------------------
# the long-token phase: more than 16 tokens per sample
# ---------------------------------------------------------------------------

# the token counts of the launchers' checks: just past 16, the shipped
# config with act_seq_len=16 (T=20), and two long samples whose keys
# stream through the attention stage's shared memory in blocks
LONG_T = (17, 20, 64, 160)
LONG_ACTIONS = 16
# the served cells of the act_seq_len=16 agent: the preset (or the bf16
# kernel configuration), the batch, and the launches of each kernel per
# 10-step DDIM chunk, those of the same cell at T=14
LONG_CELLS = (
    ("parity", 128, {"fused_layer_q8c": 120}),
    ("parity", 1, {"fused_layer_q8c": 120}),
    ("max-throughput", 128, {"fused_attn_block_q8": 120,
                             "fused_top2_mlp_q8c": 120}),
    ("b1-latency", 1, {"fused_dit_q8c": 10}),
    ("b1-latency-max", 1, {"fused_dit_q8c": 10}),
    (BF16_CONFIG, 128, {"fused_attn_block": 120, "fused_top2_mlp": 120}))


def long_agent(dev):
    """The shipped CALVIN config with the override act_seq_len=16 through
    the port's loader and builders, as training_calvin and evaluate_calvin
    build it: 12 layers, D=1024, 2 FiLM-ResNet-50s, seeded random weights,
    T=20 tokens per sample."""
    import torch
    from mode_diffusion_policy_tpu_torch.config.builders import build_agent
    from mode_diffusion_policy_tpu_torch.config.loader import load_config
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "conf"), "config_calvin", [f"act_seq_len={LONG_ACTIONS}"])
    agent = build_agent(cfg["model"], dtype=torch.bfloat16, device=dev)[0]
    T = agent.cfg.dit_config().total_tokens
    if (agent.cfg.act_window_size, agent.cfg.multistep, T) != (
            LONG_ACTIONS, LONG_ACTIONS, 20):
        raise SystemExit(f"long tokens: act_seq_len={LONG_ACTIONS} built "
                         f"window {agent.cfg.act_window_size}, multistep "
                         f"{agent.cfg.multistep}, {T} tokens")
    return agent


def long_launchers(policies, dev):
    """The five attention-bearing launchers on the act_seq_len=16 agent's
    served weights (layer 0; the megakernel with bf16 and with int8
    projections, on one-layer slices of its stacks for the checks and the
    whole 12-layer stacks for the times): name -> dict(kern, ref: the
    kernel and its plain version; args, kw: their arguments after (x, c);
    cost: (bf16 flops, int8 ops, bytes) of the timed call at (B, T); and
    over (x, c) the timed call, its plain version and the library
    yardstick)."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block, fused_attn_block_q8, fused_attn_block_q8_ref,
        fused_attn_block_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c, fused_dit_q8c_ref, fused_layer_q8c,
        fused_layer_q8c_ref)
    from mode_diffusion_policy_tpu_torch.ops.quant import dequantize_experts
    pa = policies["parity"].agent
    pd, md = pa.inner_model, policies["max-throughput"].agent.inner_model
    cfg = pd.cfg
    D, H, HH, L = cfg.embed_dim, cfg.n_heads, 4 * cfg.embed_dim, cfg.n_layers
    routing = pa.precompute_routing()
    idx, probs = routing[0]
    idx_L = torch.stack([i for i, _ in routing])
    p_L = torch.stack([p for _, p in routing])
    e, p = idx[0].tolist(), probs[0].tolist()
    blk, a = pd.blocks[0], pd.blocks[0].attn
    mblk, ma = md.blocks[0], md.blocks[0].attn
    eps = dict(eps1=blk.ln_1.eps, eps_qk=a.q_norm.eps, eps2=blk.ln_2.eps)
    attn_kw = dict(ln_eps=blk.ln_1.eps, qk_eps=a.q_norm.eps)
    bf = torch.bfloat16
    # the library yardsticks' experts, dequantized to bf16 ahead of time
    deq = {}
    for l, b in enumerate(pd.blocks):
        w1, b1, w2 = dequantize_experts(b.experts_q)
        deq[l] = {k: (w1[k].to(bf), b1[k].to(bf), w2[k].to(bf))
                  for k in idx_L[l, 0].tolist()}
        del w1, b1, w2

    def lib_layer(l, b, x, c):
        at = b.attn
        return library_layer(x, c, b.ln_1.g, at.wqkv.kernel.to(bf),
                             at.wqkv.bias.to(bf), at.q_norm.g, at.k_norm.g,
                             at.c_proj.kernel.to(bf), b.ln_2.g, deq[l],
                             idx_L[l, 0].tolist(), p_L[l, 0].tolist())

    def lib_stack(x, c):
        for l, b in enumerate(pd.blocks):
            x = lib_layer(l, b, x, c)
        return x

    layer_args = (blk.ln_1.g, a.wqkv.kernel, a.wqkv.bias, a.q_norm.g,
                  a.k_norm.g, a.c_proj.kernel, blk.ln_2.g, blk.experts_q,
                  idx, probs)
    q8_args = (mblk.ln_1.g, None, None, ma.q_norm.g, ma.k_norm.g, None,
               mblk.ln_2.g, mblk.experts_q, idx, probs)
    attn_args = (blk.ln_1.g, a.wqkv.kernel, a.wqkv.bias, a.q_norm.g,
                 a.k_norm.g, a.c_proj.kernel)

    def layer(kern, ref, args, kw, cost, lib):
        return dict(kern=kern, ref=ref, args=args, kw=kw, cost=cost, lib=lib,
                    time=lambda x, c: kern(x, c, *args, **kw),
                    plain=lambda x, c: ref(x, c, *args, **kw))

    out = {
        "fused_layer_q8c": layer(
            fused_layer_q8c, fused_layer_q8c_ref, layer_args,
            dict(step=0, qexp_t=blk.experts_qt, **eps),
            lambda B, T: layer_cost(B, T, D, H, HH),
            lambda x, c: lib_layer(0, blk, x, c)),
        "fused_layer_q8c_qattn": layer(
            fused_layer_q8c, fused_layer_q8c_ref, q8_args,
            dict(step=0, qexp_t=mblk.experts_qt, qattn=ma.attn_q,
                 qattn_t=ma.attn_qt, **eps),
            lambda B, T: layer_q8_cost(B, T, D, H, HH),
            lambda x, c: library_moe(
                library_attn(x, c, mblk.ln_1.g, ma.attn_q, ma.q_norm.g,
                             ma.k_norm.g), mblk.ln_2.g, mblk.experts_q, e, p,
                min(1024, HH))),
        "fused_attn_block": layer(
            fused_attn_block, fused_attn_block_ref, attn_args, attn_kw,
            lambda B, T: attn_bf16_cost(B, T, D, H),
            lambda x, c: library_attn_bf16(
                x, c, blk.ln_1.g, a.wqkv.kernel, a.wqkv.bias.to(bf),
                a.q_norm.g, a.k_norm.g, a.c_proj.kernel)),
        "fused_attn_block_q8": layer(
            fused_attn_block_q8, fused_attn_block_q8_ref,
            (mblk.ln_1.g, ma.attn_q, ma.q_norm.g, ma.k_norm.g),
            dict(attn_kw, qattn_t=ma.attn_qt),
            lambda B, T: attn_cost(B, T, D, H),
            lambda x, c: library_attn(x, c, mblk.ln_1.g, ma.attn_q,
                                      ma.q_norm.g, ma.k_norm.g)),
    }
    for name, mode in (("fused_dit_q8c", "b1-latency"),
                       ("fused_dit_q8c_int8", "b1-latency-max")):
        st = policies[mode].agent.inner_model.stacked
        int8 = "sqkv" in st
        out[name] = dict(
            kern=fused_dit_q8c, ref=fused_dit_q8c_ref,
            args=({k: v[:1] for k, v in st.items()}, idx_L[:1], p_L[:1]),
            kw=dict(step=0, **eps),
            cost=lambda B, T, int8=int8: dit_cost(B, T, D, H, HH, L, int8),
            lib=lib_stack,
            time=lambda x, c, st=st: fused_dit_q8c(x, c, st, idx_L, p_L,
                                                   step=0, **eps),
            plain=lambda x, c, st=st: fused_dit_q8c_ref(x, c, st, idx_L, p_L,
                                                        step=0, **eps))
    return out


def long_conds(agent, B, T, gen):
    """The three cond shapes at B samples of T tokens: the sigma token of
    the schedule's first step as the shared [1,1,D] row, one sigma token
    per sample [B,1,D], one per token [B,T,D] (the sigma tokens of random
    sigmas in the schedule's range)."""
    import torch
    dit = agent.inner_model
    first = torch.as_tensor(agent.sigmas[:1], device=gen.device)
    D = dit.cfg.embed_dim
    return {"shared": dit.process_sigma_embeddings(first)[0][None],
            "per-sample": per_sample_cond(dit, B, gen),
            "per-token": per_sample_cond(dit, B * T, gen).reshape(B, T, D)}


def long_kernel_checks(policies, dev):
    """Each of the five attention-bearing launchers (``long_launchers``)
    against its plain version at T in LONG_T, b=128 and b=1, with a shared,
    a per-sample and a per-token cond, by the layer gates of phases 3, 12,
    15 and 21 (the megakernel on one-layer launches of both stacks, as
    phases 7 and 9 hold its layers); a per-token cond whose rows are equal
    within each sample gives the per-sample launch bit for bit. Then, at
    each T and b with the shared row (the served cond), the kernel's ms
    beside its bound (this call's bytes and operations), its plain
    version's and the library yardstick's ms, and the kernel's ms with a
    per-token cond; the megakernel's times are of its whole 12-layer
    launch, with its attention key block. Returns name -> "b{B}_T{T}" ->
    record."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        DIT_INFO, fused_dit_q8c)
    launchers = long_launchers(policies, dev)
    pa = policies["parity"].agent
    D = pa.inner_model.cfg.embed_dim
    gen = torch.Generator(device=dev).manual_seed(31)
    out = {name: {} for name in launchers}
    for T in LONG_T:
        for B in (128, 1):
            x = torch.randn(B, T, D, generator=gen, device=dev).to(
                torch.bfloat16)
            conds = long_conds(pa, B, T, gen)
            line = []
            for name, k in launchers.items():
                kern, ref, args, kw = k["kern"], k["ref"], k["args"], k["kw"]
                errs, shares = [], []
                for cname, c in conds.items():
                    got = kern(x, c, *args, **kw)
                    torch.cuda.synchronize()
                    err, share = layer_gate(
                        f"{name} b={B} x {T} tokens, {cname} cond", got,
                        ref(x, c, *args, **kw))
                    errs.append(err)
                    shares.append(share)
                check_token_rows(f"{name} (T={T})", kern,
                                 (x, conds["per-sample"], *args), kw)
                c, big = conds["shared"], B * T > 4096
                ms = cuda_time_ms(lambda: k["time"](x, c), 5 if big else 20)
                ms_tok = cuda_time_ms(
                    lambda: k["time"](x, conds["per-token"]),
                    5 if big else 20)
                p_ms = cuda_time_ms(lambda: k["plain"](x, c), 2)
                l_ms = cuda_time_ms(lambda: k["lib"](x, c), 2 if big else 5)
                bf16, int8, nbytes = k["cost"](B, T)
                # the per-token cond's rows, read once (the cost counts the
                # shared row's)
                bound, by = bound_of(bf16, int8, nbytes)
                bound_tok, _ = bound_of(bf16, int8, nbytes + 4 * B * T * D)
                rec = dict(T=T, B=B, max_abs_err=max(errs),
                           gate_share=max(shares), ms=ms,
                           ms_per_token_cond=ms_tok, plain_ms=p_ms,
                           library_ms=l_ms, bound_ms=bound, bound_by=by,
                           bound_ms_per_token_cond=bound_tok,
                           gflop_bf16=bf16 / 1e9, gop_int8=int8 / 1e9,
                           mbytes=nbytes / 1e6)
                if kern is fused_dit_q8c:
                    rec["info"] = dict(zip(DIT_INFO, fused_dit_q8c.last_grid))
                out[name][f"b{B}_T{T}"] = rec
                line.append(f"{name} {ms:.4f} ms (bound {bound:.4f} {by}; "
                            f"per-token cond {ms_tok:.4f}; plain {p_ms:.3f},"
                            f" library {l_ms:.4f}; gate {max(shares):.2f})")
            print(f"  b={B} x {T} tokens, shared / per-sample / per-token "
                  "cond within the layer gates, per-token cond of equal "
                  "rows == per-sample launch: " + "; ".join(line),
                  flush=True)
    return out


def long_identities(policies, dev):
    """At T=20 on the act_seq_len=16 agent, with one cond row per token:
    fused_attn_block then fused_top2_mlp_q8c equals one fused_layer_q8c
    launch on every layer (chained), and the whole megakernel launch
    equals its one-layer launches chained (each layer within the layer
    gates of its plain layer) and the layers' fused_layer_q8c launches
    chained, bit for bit, at b=128 and b=1."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_layer_q8c)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp_q8c)
    pa = policies["parity"].agent
    dit = pa.inner_model
    st = policies["b1-latency"].agent.inner_model.stacked
    routing = pa.precompute_routing()
    idx_L = torch.stack([i for i, _ in routing])
    p_L = torch.stack([p for _, p in routing])
    D, T = dit.cfg.embed_dim, dit.cfg.total_tokens
    gen = torch.Generator(device=dev).manual_seed(32)
    blk0 = dit.blocks[0]
    eps = dict(eps1=blk0.ln_1.eps, eps_qk=blk0.attn.q_norm.eps,
               eps2=blk0.ln_2.eps)
    out = {}
    for B in (128, 1):
        x = torch.randn(B, T, D, generator=gen, device=dev).to(torch.bfloat16)
        c = long_conds(pa, B, T, gen)["per-token"]
        y = z = x
        for l, blk in enumerate(dit.blocks):
            idx, probs = routing[l]
            a = blk.attn
            w = (blk.ln_1.g, a.wqkv.kernel, a.wqkv.bias, a.q_norm.g,
                 a.k_norm.g, a.c_proj.kernel)
            two = fused_top2_mlp_q8c(
                fused_attn_block(y, c, *w, ln_eps=blk.ln_1.eps,
                                 qk_eps=a.q_norm.eps),
                idx, probs, blk.experts_q, step=0, residual=True,
                ln_g=blk.ln_2.g, ln_eps=blk.ln_2.eps, qexp_t=blk.experts_qt)
            one = fused_layer_q8c(y, c, *w, blk.ln_2.g, blk.experts_q, idx,
                                  probs, step=0, qexp_t=blk.experts_qt, **eps)
            if not torch.equal(two, one):
                raise SystemExit(
                    f"T={T} b={B} layer {l}: fused_attn_block -> "
                    f"fused_top2_mlp_q8c differs from fused_layer_q8c "
                    f"({(two.float() - one.float()).abs().max().item():.3e})")
            y = two
            z = fused_layer_q8c(z, c, st["ln1"][l], st["wqkv"][l],
                                st["bqkv"][l], st["q_g"][l], st["k_g"][l],
                                st["wout"][l], st["ln2"][l],
                                dit.blocks[l].experts_q, idx_L[l], p_L[l],
                                step=0, qexp_t=dit.blocks[l].experts_qt,
                                **eps)
        L = len(dit.blocks)
        full, share, err = check_stack_layers(
            f"fused_dit_q8c T={T} b={B} per-token cond", st, x, c, idx_L,
            p_L, 0, eps)
        if not torch.equal(full, z):
            raise SystemExit(f"fused_dit_q8c T={T} b={B}: differs from {L} "
                             "chained fused_layer_q8c launches")
        out[f"b{B}"] = dict(dit_layers_gate_share=share,
                            dit_layers_max_abs_err=err)
        print(f"  T={T} b={B}, per-token cond: fused_attn_block -> "
              f"fused_top2_mlp_q8c == fused_layer_q8c on all {L} layers "
              f"(chained); the {L}-layer megakernel == its layers chained "
              f"(each within the layer gates, worst {share:.2f}) == {L} "
              "chained fused_layer_q8c, bit for bit", flush=True)
    return out


def long_chain(agent, zero_launches, launches_of, dev):
    """One five-task chain of LongHorizonEvaluator on FakeCalvinEnv (224
    px, the subtask solved after EVAL_STEPS_TO_SUCCESS steps) under the
    `auto` preset (parity on CUDA), through evaluate_calvin's
    PreprocPolicy with the CLIP tower's cache, as evaluate_calvin.evaluate
    runs it: 16 actions a chunk, 120 fused_layer_q8c launches per chunk,
    nothing else, finite actions of 16 rows, the chain solved."""
    import argparse

    import torch
    from mode_diffusion_policy_tpu_torch.config.builders import \
        build_lang_clip
    from mode_diffusion_policy_tpu_torch.data.calvin_dataset import (
        DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
    from mode_diffusion_policy_tpu_torch.evaluation.evaluate_calvin import (
        CAMERAS, PreprocPolicy, build_env, load_val_annotations)
    from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import \
        LangEmbeddingCache
    from mode_diffusion_policy_tpu_torch.rollout.rollout_long_horizon import \
        LongHorizonEvaluator
    from mode_diffusion_policy_tpu_torch.serving import (
        apply_serving_mode, resolve_serving_mode)
    mode = resolve_serving_mode("auto", dev.type)
    apply_serving_mode(agent, mode)
    env, oracle = build_env(argparse.Namespace(
        fake_env=True, image_size=TRAIN_IMG,
        fake_steps_to_success=EVAL_STEPS_TO_SUCCESS),
        DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
    policy = PreprocPolicy(agent, LangEmbeddingCache(build_lang_clip(
        device=dev)), sizes={cam: TRAIN_IMG for cam in CAMERAS})
    ev = LongHorizonEvaluator(env, oracle, load_val_annotations(),
                              num_sequences=1, ep_len=EVAL_EP_LEN)
    chunks = []
    predict = policy.predict_chunk

    def counted(*a, **k):
        out = predict(*a, **k)
        chunks.append((*out.shape, bool(torch.isfinite(out).all())))
        return out

    policy.predict_chunk = counted
    zero_launches()
    t0 = time.perf_counter()
    results = ev.evaluate_policy(policy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches_of()
    launches = counts.pop("fused_layer_q8c")
    per_chunk = agent.cfg.n_layers * agent.cfg.num_sampling_steps
    ok = (mode == "parity" and results == [5] and chunks
          and set(chunks) == {(1, LONG_ACTIONS, agent.cfg.action_dim, True)}
          and policy.multistep == LONG_ACTIONS
          and launches == per_chunk * len(chunks)
          and not any(counts.values()))
    row = {"mode": mode, "chains": 1, "result": results, "chunks":
           len(chunks), "launches": launches,
           "launches_per_chunk": launches / max(len(chunks), 1),
           "other_launches": counts, "wall_s": wall}
    print(f"  LongHorizonEvaluator, 1 chain on FakeCalvinEnv, auto -> "
          f"{mode}, {LONG_ACTIONS} actions a chunk: {row}", flush=True)
    if not ok:
        raise SystemExit(f"long tokens: the evaluation chain failed: {row}")
    return row


def long_tokens_phase(zero_launches, launches_of, dev):
    """More than 16 tokens per sample: the act_seq_len=16 agent
    (``long_agent``, T=20) served in every cell of LONG_CELLS by the
    variants phase's rule (``variant_cell``: launches per chunk as at T=14,
    action MAE against the same agent's reference chunk and against the
    plain evaluation within max(1e-3, 2 x floor)); the five attention-
    bearing launchers at T in LONG_T with all three cond shapes
    (``long_kernel_checks``); the T=20 identities (``long_identities``);
    one long-horizon chain under auto (``long_chain``)."""
    import gc

    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
    t = time.perf_counter()
    agent = long_agent(dev)
    gen = torch.Generator(device=dev).manual_seed(30)
    inputs = variant_inputs(gen, dev, actions=LONG_ACTIONS)
    calib = {**{k: v[:4] for k, v in inputs[0].items()},
             "lang_emb": inputs[1][:4]}
    res = {"tokens": agent.cfg.dit_config().total_tokens, "cells": {}}
    policies = {mode: RolloutPolicy.with_serving_mode(
        agent, mode=mode, seed=0,
        calib_batch=calib if mode == "max-throughput" else None)
        for mode in ("parity", "max-throughput", "b1-latency",
                     "b1-latency-max")}
    for mode, B, want in LONG_CELLS[:-1]:
        res["cells"][f"{mode}/b{B}"] = variant_cell(
            "act_seq_len=16", agent, mode, B, want, inputs, zero_launches,
            launches_of, policy=policies[mode])
    phase("long tokens: the act_seq_len=16 agent served by parity, "
          "max-throughput, b1-latency, b1-latency-max", t)
    t = time.perf_counter()
    res["kernels"] = long_kernel_checks(policies, dev)
    phase("long tokens: the five launchers at T = "
          f"{', '.join(map(str, LONG_T))}, b=128 and b=1, three cond shapes",
          t)
    t = time.perf_counter()
    res["identities"] = long_identities(policies, dev)
    del policies
    gc.collect()
    torch.cuda.empty_cache()
    mode, B, want = LONG_CELLS[-1]
    res["cells"][f"{mode}/b{B}"] = variant_cell(
        "act_seq_len=16", agent, mode, B, want, inputs, zero_launches,
        launches_of)
    res["chain"] = long_chain(agent, zero_launches, launches_of, dev)
    del agent
    gc.collect()
    torch.cuda.empty_cache()
    phase("long tokens: T=20 identities, the bf16 kernel configuration, "
          "one auto chain", t)
    return res


# ---------------------------------------------------------------------------
# phase 22: training
# ---------------------------------------------------------------------------

# the shipped training settings as the port's config builders read them
# from conf/config_calvin.yaml (check_train_settings holds them to it):
# conf/model/mode_agent.yaml (widths, dropouts, goal drop, density, EDM,
# optimizer and schedule), conf/config_calvin.yaml:24-42 (precision bf16,
# bf16_full_state, auto_layout), conf/callbacks/calvin.yaml:5-14 (EMA) and
# conf/datamodule/transforms/calvin_transforms.yaml:3-22 (cameras). The
# router aux weights are the from-scratch ones (the YAML's comment on
# entropy_gamma: 0.01 when training from scratch, which random weights
# are; router_z_delta 0.001, the JAX config's default and bench_train.py's)
FROM_SCRATCH = {"entropy_gamma": 0.01, "router_z_delta": 0.001}
TRAIN_MODEL = dict(latent_dim=1024, n_layers=12, n_heads=8, cond_dim=512,
                   resnet_type="50", num_experts=4, top_k=2,
                   attn_pdrop=0.3, mlp_pdrop=0.1, goal_drop=0.1,
                   embed_pdrob=0.0, use_argmax=False,
                   sigma_sample_density_type="loglogistic", sigma_data=0.5,
                   sigma_min=0.001, sigma_max=80.0, entropy_gamma=0.01,
                   router_z_delta=0.001, encoder_remat=True)
TRAIN_OPT = dict(learning_rate=1e-4, betas=(0.9, 0.95),
                 transformer_weight_decay=0.05, use_lr_scheduler=True,
                 total_steps=45000, phase_ratio=(0.02, 0.08, 0.9),
                 init_lr_scale=0.1, final_lr_scale=1e-6)
TRAIN_EMA = dict(inv_gamma=1.0, power=2 / 3, min_value=0.0,
                 max_value=0.9999, start_step=0)
TRAIN_IMG = 224
TRAIN_TRANSFORMS = {"train": {
    cam: [{"_target_": "torchvision.transforms.Resize", "size": TRAIN_IMG},
          {"_target_": "mode.utils.transforms.RandomShiftsAug", "pad": pad},
          {"_target_": "mode.utils.transforms.ScaleImageTensor"},
          {"_target_": "torchvision.transforms.Normalize"}]
    for cam, pad in (("rgb_static", 10), ("rgb_gripper", 4))}}
# CALVIN's frames and the reference's per-GPU batch
TRAIN_B, STATIC_HW, GRIPPER_HW, N_BATCHES = 32, 200, 84, 8
GRAD_B = 8
# gates of the gradient check against float64 on the card: the loss and
# each DiT leaf (relative L2) in f32 as asked, the rest by the floor rule
# (twice JAX's own error). At a random init the encoders' gradients are
# ill-conditioned (BatchNorm ResNet-50), and the bf16 compute dtype carries
# that into the DiT's. JAX's own gradients lie from its float64 ones, on
# this check's inputs (uniform uint8 frames at CALVIN's sizes, resized to
# 224 and normalized, b=8, a 512-wide goal) with a 12-layer DiT at D=256
# (`scripts/train_grad_precision.py --layers 12 --cond 512 --frames uint8`
# on the CPU, its own random weights; D=1024 does not fit there), by:
# - f32: 3.86e-2 over the encoders' leaves, worst leaf 4.84e-2;
# - bf16: 1.32e-1 over the DiT's leaves (3.95e-2 with 2 layers: the error
#   grows with the depth) and 1.16 over the encoders'.
# The bf16 encoders' total is printed but not gated: JAX's own is above
# the 1.0 of a zero gradient, so no gate of the floor rule could fail one
# (the CPU test test_bf16_compute_grads_match_jax holds the port's bf16
# gradient to JAX's leaf by leaf).
GRAD_F32_LOSS_REL, GRAD_F32_LEAF_REL = 1e-5, 1e-3
GRAD_F32_ENC_LEAF_REL, GRAD_F32_ENC_TOTAL_REL = 2 * 4.84e-2, 2 * 3.86e-2
GRAD_BF16_LOSS_REL = 2e-2
GRAD_BF16_DIT_TOTAL_REL = 2 * 1.32e-1


def check_train_settings():
    """TRAIN_MODEL, TRAIN_OPT, TRAIN_EMA and TRAIN_TRANSFORMS against what
    the port's builders make of the shipped ``conf/config_calvin.yaml``:
    equal but for the from-scratch router aux weights (FROM_SCRATCH), and
    the trainer's flags as phase 22 sets them. Returns the deviations
    ({key: (used, config's)}); raises SystemExit on any other
    difference."""
    from mode_diffusion_policy_tpu_torch.config.builders import (
        build_agent_config, build_ema_cfg, build_optimizer_kwargs)
    from mode_diffusion_policy_tpu_torch.config.loader import load_config
    from mode_diffusion_policy_tpu_torch.training_calvin import CONF_DIR
    from mode_diffusion_policy_tpu_torch.training_common import \
        parse_camera_pipelines
    cfg = load_config(CONF_DIR, "config_calvin")
    agent_cfg = build_agent_config(cfg["model"])
    model = {k: (v, getattr(agent_cfg, k)) for k, v in TRAIN_MODEL.items()}
    bad = {k: pair for k, pair in model.items()
           if pair[0] != pair[1] and k not in FROM_SCRATCH}
    bad.update({f"optimizer.{k}": (v, got) for k, v, got in (
        (k, v, build_optimizer_kwargs(cfg["model"]).get(k))
        for k, v in TRAIN_OPT.items()) if v != got})
    ema = build_ema_cfg(**cfg["callbacks"]["ema"])
    if ema != TRAIN_EMA:
        bad["ema"] = (TRAIN_EMA, ema)
    cams = parse_camera_pipelines(cfg["datamodule"]["transforms"])
    if cams != parse_camera_pipelines(TRAIN_TRANSFORMS):
        bad["transforms"] = (TRAIN_TRANSFORMS, cams)
    trainer = cfg["trainer"]
    if not (trainer["precision"] == "bf16" and trainer["bf16_full_state"]
            and trainer["auto_layout"]):
        bad["trainer"] = trainer
    if bad or set(build_optimizer_kwargs(cfg["model"])) != set(TRAIN_OPT):
        raise SystemExit(f"phase 22's settings differ from "
                         f"conf/config_calvin.yaml: {bad}")
    return {k: model[k] for k in FROM_SCRATCH}


def train_batches(gen, n, B, dev):
    """Synthetic CALVIN-sized batches made on the card: uint8 static and
    gripper frames, 10 x 7 actions, a 512-wide language embedding."""
    import torch
    out = []
    for _ in range(n):
        out.append({
            "rgb_static": torch.randint(0, 256, (B, 1, STATIC_HW, STATIC_HW,
                                                 3), generator=gen,
                                        device=dev, dtype=torch.uint8),
            "rgb_gripper": torch.randint(0, 256, (B, 1, GRIPPER_HW,
                                                  GRIPPER_HW, 3),
                                         generator=gen, device=dev,
                                         dtype=torch.uint8),
            "actions": torch.randn(B, 10, 7, generator=gen, device=dev)
            * 0.3,
            "lang_emb": torch.randn(B, 1, 512, generator=gen, device=dev)})
    return out


def eval_batch(batch):
    from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera
    out = dict(batch)
    for cam in ("rgb_static", "rgb_gripper"):
        out[cam] = preprocess_camera(batch[cam], size=TRAIN_IMG)
    return out


def device_busy_ms(fn):
    """One call of ``fn`` under torch.profiler: the device time of the
    kernels it launches (None when the trace holds no device time) and the
    host time of the same call, up to a synchronize, in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
        averages = prof.key_averages()
    return busy_ms(averages), host


def busy_ms(averages):
    """The device time in a profiler's ``key_averages()``, in ms (None when
    the trace holds none)."""
    busy = 0.0
    for ev in averages:
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        busy += (us or 0.0) / 1e3
    return busy or None


def fit_run(bf16_state, log_dir, batches, val, dev):
    """Trainer.setup + Trainer.fit for one epoch of ``batches`` on a new
    flagship agent, each step timed (host clock to a synchronize, and CUDA
    events split at the optimizer), the applied LR and the optimizer count
    recorded. Gates: finite losses, count == len(batches), every step's LR
    == tri_stage_schedule(count), EMA != params."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig)
    from mode_diffusion_policy_tpu_torch.training.loop import Trainer
    from mode_diffusion_policy_tpu_torch.training.optim import \
        tri_stage_schedule
    from mode_diffusion_policy_tpu_torch.training_common import (
        make_train_preprocess, parse_camera_pipelines)
    cfg = MoDEAgentConfig(dtype=torch.bfloat16, **TRAIN_MODEL)
    agent = MoDEAgent(cfg, device=dev)
    trainer = Trainer(
        agent, log_dir=log_dir, max_epochs=1,
        limit_train_batches=len(batches), limit_val_batches=1,
        rollout_freq=1, optimizer_kwargs=TRAIN_OPT, ema_kwargs=TRAIN_EMA,
        preprocess_fn=make_train_preprocess(
            parse_camera_pipelines(TRAIN_TRANSFORMS)),
        rollout_callback=lambda ag, variables, epoch: {
            "eval_lh/avg_seq_len": 1.0},
        auto_layout=True, bf16_full_state=bf16_state, device=dev)
    state = trainer.setup(seed=0)
    opt = trainer._optimizer
    sched = tri_stage_schedule(TRAIN_OPT["learning_rate"],
                               TRAIN_OPT["total_steps"],
                               TRAIN_OPT["phase_ratio"])
    rec = {"step_ms": [], "fwd_bwd_ms": [], "opt_ema_ms": [], "loss": [],
           "lr_ok": []}
    events = {}
    update = opt.update_with_ema

    def timed_update(*a, **k):
        events["opt0"].record()
        out = update(*a, **k)
        events["opt1"].record()
        return out

    opt.update_with_ema = timed_update
    step = trainer._train_step

    def timed_step(st, batch):
        count = st.opt_state.count
        for k in ("s0", "opt0", "opt1", "s1"):
            events[k] = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events["s0"].record()
        st, metrics = step(st, batch)
        events["s1"].record()
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["fwd_bwd_ms"].append(events["s0"].elapsed_time(events["opt0"]))
        rec["opt_ema_ms"].append(events["opt0"].elapsed_time(events["opt1"]))
        rec["loss"].append(float(metrics["train/total_loss"]))
        rec["lr_ok"].append(bool(opt.last_lr == sched(count)))
        return st, metrics

    trainer._train_step = timed_step
    t0 = time.perf_counter()
    state = trainer.fit(state, lambda: iter(batches), lambda: iter([val]))
    rec["fit_s"] = time.perf_counter() - t0
    ema_moved = any(not torch.equal(state.ema_params[n].float(), p.float())
                    for n, p in state.params.items())
    kind = "bf16_full_state" if bf16_state else "f32_state"
    print(f"  {kind}: {len(rec['loss'])} steps, losses "
          f"{[round(x, 4) for x in rec['loss']]}, step ms "
          f"{[round(x, 1) for x in rec['step_ms']]}, optimizer count "
          f"{state.opt_state.count}, LR == tri_stage_schedule at every step "
          f"{all(rec['lr_ok'])}, EMA != params {ema_moved}, fit "
          f"{rec['fit_s']:.1f} s (checkpoints included)", flush=True)
    if not (all(math.isfinite(x) for x in rec["loss"])
            and state.opt_state.count == len(batches) == state.step
            and all(rec["lr_ok"]) and ema_moved and state.epoch == 1):
        raise SystemExit(f"{kind}: the fit failed its gates")
    opt.update_with_ema = update
    trainer._train_step = step
    return trainer, state, rec


def step_profile(trainer, state, batch, rec):
    """On the fit's own trainer (its preprocessing included): the device
    idle share of one more step (profiler busy time over the host time of
    the same step) and the peak memory of one step with and without
    encoder_remat."""
    import torch
    busy, host = device_busy_ms(lambda: trainer._train_step(state, batch))
    peaks = {}
    for remat in (True, False):
        trainer.agent.configure_(encoder_remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer._train_step(state, batch)
        torch.cuda.synchronize()
        peaks["remat" if remat else "no_remat"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    trainer.agent.configure_(encoder_remat=True)
    return {
        "step_ms_median_3_8": statistics.median(rec["step_ms"][2:]),
        "step_ms_spread_3_8": [min(rec["step_ms"][2:]),
                               max(rec["step_ms"][2:])],
        "fwd_bwd_ms_median": statistics.median(rec["fwd_bwd_ms"][2:]),
        "opt_ema_ms_median": statistics.median(rec["opt_ema_ms"][2:]),
        "profiled_step_host_ms": host, "device_busy_ms": busy,
        "idle_share": None if busy is None else 1.0 - busy / host,
        "peak_gib": peaks, "losses": rec["loss"],
        "fit_s_with_checkpoint": rec["fit_s"]}


def round_trip(log_dir, state, dev):
    """A fresh Trainer on the same log dir auto-resumes: every tensor of the
    state equals the saved one bit for bit, and step, epoch, the optimizer
    count and the generator state continue."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig)
    from mode_diffusion_policy_tpu_torch.training.loop import Trainer
    agent = MoDEAgent(MoDEAgentConfig(dtype=torch.bfloat16, **TRAIN_MODEL),
                      device=dev)
    t2 = Trainer(agent, log_dir=log_dir, max_epochs=2,
                 optimizer_kwargs=TRAIN_OPT, ema_kwargs=TRAIN_EMA,
                 bf16_full_state=True, device=dev)
    s2 = t2.setup(seed=1)
    bad = []
    n_tensors = 0
    for what, a, b in (("params", state.params, s2.params),
                       ("ema", state.ema_params, s2.ema_params),
                       ("mu", state.opt_state.mu, s2.opt_state.mu),
                       ("nu", state.opt_state.nu, s2.opt_state.nu),
                       ("batch_stats", state.batch_stats, s2.batch_stats)):
        for n, x in a.items():
            n_tensors += 1
            if b[n].dtype != x.dtype or not torch.equal(b[n], x):
                bad.append(f"{what}:{n}")
    rng_ok = torch.equal(s2.rng.get_state(), state.rng.get_state())
    ok = (t2.resumed and not bad and rng_ok and s2.step == state.step
          and s2.epoch == state.epoch
          and s2.opt_state.count == state.opt_state.count)
    print(f"  round trip: resumed {t2.resumed} at step {s2.step} epoch "
          f"{s2.epoch} count {s2.opt_state.count}; {n_tensors} tensors, "
          f"{len(bad)} differ; generator state equal {rng_ok}", flush=True)
    if not ok:
        raise SystemExit(f"checkpoint round trip failed: {bad[:5]}")
    return {"tensors": n_tensors, "bit_equal": True, "step": s2.step,
            "epoch": s2.epoch, "generator_equal": rng_ok}


def grad_errors(loss, grads, l64, g64):
    """A gradient's distance from the float64 one: the loss's, each leaf's
    (relative L2; leaves whose gradient is zero to rounding, within 1e-6
    of their part's largest, have none), the worst leaf and the total of
    the DiT's leaves and of the encoders'."""
    top = {dit: max(float(g.norm()) for n, g in g64.items()
                    if n.startswith("inner_model.") == dit)
           for dit in (True, False)}
    leaf, sq = {}, {"dit": [0.0, 0.0], "encoders": [0.0, 0.0]}
    for n, g in g64.items():
        err = float((grads[n].double() - g).norm())
        ref = float(g.norm())
        part = sq["dit" if n.startswith("inner_model.") else "encoders"]
        part[0], part[1] = part[0] + err ** 2, part[1] + ref ** 2
        if ref > 1e-6 * top[n.startswith("inner_model.")]:
            leaf[n] = err / ref
    dit = {n: e for n, e in leaf.items() if n.startswith("inner_model.")}
    enc = {n: e for n, e in leaf.items() if n not in dit}
    wd, we = max(dit, key=dit.get), max(enc, key=enc.get)
    return {
        "loss": loss, "loss_rel": abs(loss - l64) / abs(l64),
        "dit_worst_leaf": [wd, dit[wd]],
        "encoders_worst_leaf": [we, enc[we]],
        "dit_total_rel": (sq["dit"][0] / sq["dit"][1]) ** 0.5,
        "encoders_total_rel": (sq["encoders"][0]
                               / sq["encoders"][1]) ** 0.5,
        "total_rel": ((sq["dit"][0] + sq["encoders"][0])
                      / (sq["dit"][1] + sq["encoders"][1])) ** 0.5,
        "leaves": len(leaf), "leaves_near_zero": len(g64) - len(leaf)}


def f32_grad_gates(f32):
    """Phase 22d's f32 gates on ``grad_errors``' result: (value, gate)."""
    return {"f32_loss_rel": (f32["loss_rel"], GRAD_F32_LOSS_REL),
            "f32_dit_leaf_rel_l2": (f32["dit_worst_leaf"][1],
                                    GRAD_F32_LEAF_REL),
            "f32_encoder_leaf_rel_l2": (f32["encoders_worst_leaf"][1],
                                        GRAD_F32_ENC_LEAF_REL),
            "f32_encoders_total_rel_l2": (f32["encoders_total_rel"],
                                          GRAD_F32_ENC_TOTAL_REL)}


def grad_inputs(dev):
    """Phase 22d's gradient check inputs, made on the card from their
    seeds: the first GRAD_B rows of the first training batch (preprocessed
    for eval), the model options with the dropouts off, and the noise and
    Gumbel draws (sigma is drawn from the agent's density after them)."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera
    Bg = min(GRAD_B, TRAIN_B)
    raw = {k: v[:Bg] for k, v in train_batches(
        torch.Generator(device=dev).manual_seed(7), 1, TRAIN_B,
        dev)[0].items()}
    batch = dict(raw)
    for cam in ("rgb_static", "rgb_gripper"):
        batch[cam] = preprocess_camera(raw[cam], size=TRAIN_IMG)
    model = dict(TRAIN_MODEL, attn_pdrop=0.0, mlp_pdrop=0.0, goal_drop=0.0)
    gen = torch.Generator(device=dev).manual_seed(5)
    T = 1 + 1 + 2 + 10
    draws = {"noise": torch.randn(Bg, 10, 7, generator=gen, device=dev),
             "gumbel": [-torch.log(-torch.log(torch.rand(
                 Bg, T, 4, generator=gen, device=dev).clamp_min(1e-30)))
                 for _ in range(TRAIN_MODEL["n_layers"])]}
    return batch, model, draws, gen


def grad_check(weights, dev):
    """One batch (b=8) through the loss and its gradient with the same
    weights, sigma, noise and Gumbel noise, the dropouts off: f32 and the
    bf16 compute dtype against float64 on the card."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig)
    batch, model, draws, gen = grad_inputs(dev)
    Bg = len(batch["actions"])
    res = {}
    for name, dt in (("f64", torch.float64), ("f32", torch.float32),
                     ("bf16", torch.bfloat16)):
        agent = MoDEAgent(MoDEAgentConfig(dtype=dt, **model), device=dev)
        if "sigma" not in draws:
            draws["sigma"] = agent.sample_density(gen, (Bg,), dev)
        agent.load_state_dict(weights)
        if dt == torch.float64:
            agent = agent.double()
        cast = torch.float64 if dt == torch.float64 else torch.float32
        b = {k: v.to(cast) if v.is_floating_point() else v
             for k, v in batch.items()}
        d = {"sigma": draws["sigma"].to(cast),
             "noise": draws["noise"].to(cast),
             "gumbel": [g.to(cast) for g in draws["gumbel"]]}
        loss, _ = agent.training_loss(b, None, **d)
        loss.backward()
        loss = float(loss.detach())
        grads = {n: p.grad for n, p in agent.named_parameters()}
        if name == "f64":
            l64, g64 = loss, grads
            continue
        res[name] = grad_errors(loss, grads, l64, g64)
        del agent, grads
        torch.cuda.empty_cache()
    f32, b16 = res["f32"], res["bf16"]
    gates = dict(f32_grad_gates(f32),
                 bf16_loss_rel=(b16["loss_rel"], GRAD_BF16_LOSS_REL),
                 bf16_dit_total_rel_l2=(b16["dit_total_rel"],
                                        GRAD_BF16_DIT_TOTAL_REL))
    print(f"  gradient vs f64 (b={Bg}, loss {l64:.6f}, {f32['leaves']} "
          f"leaves, {f32['leaves_near_zero']} with a zero gradient): "
          + "; ".join(f"{k} {v:.2e} (gate {g:.2e})"
                      for k, (v, g) in gates.items())
          + f"; not gated: bf16 encoders' total "
          f"{b16['encoders_total_rel']:.2e}; worst f32 leaves "
          f"{f32['dit_worst_leaf'][0]}, {f32['encoders_worst_leaf'][0]}; "
          f"all leaves' total f32 {f32['total_rel']:.2e}, bf16 "
          f"{b16['total_rel']:.2e}", flush=True)
    if not all(v <= g for v, g in gates.values()):
        raise SystemExit("gradient check against float64 failed")
    res["f64_loss"] = l64
    res["gates"] = {k: {"value": v, "gate": g} for k, (v, g) in gates.items()}
    return res


def serve_trained(state, dev, zero_launches, launches_of):
    """The trained EMA weights (and running statistics) in a new agent,
    served through RolloutPolicy.with_serving_mode(agent, "parity") at
    b=128: 120 fused_layer_q8c launches per chunk, and the kernel-vs-plain
    action MAE within max(1e-3, 2 x the plain-vs-plain floor)."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig, RolloutPolicy)
    from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera
    cfg = MoDEAgentConfig(dtype=torch.bfloat16, **TRAIN_MODEL)
    agent = MoDEAgent(cfg, device=dev)
    sd = {n: t.float() for n, t in state.ema_params.items()}
    sd.update({n: t.float() for n, t in state.batch_stats.items()})
    agent.load_state_dict(sd)
    policy = RolloutPolicy.with_serving_mode(agent, mode="parity", seed=0)
    gen = torch.Generator(device=dev).manual_seed(9)
    B = 128
    obs = {k: preprocess_camera(torch.randint(
        0, 256, (B, 1, hw, hw, 3), generator=gen, device=dev,
        dtype=torch.uint8), size=TRAIN_IMG) for k, hw in (("rgb_static", STATIC_HW),
                                         ("rgb_gripper", GRIPPER_HW))}
    goal = {"lang_emb": torch.randn(B, 1, 512, generator=gen, device=dev)}
    noise = torch.randn(B, 10, 7, generator=gen, device=dev)
    zero_launches()
    kern = policy.predict_chunk(obs, goal, noise)
    torch.cuda.synchronize()
    counts = launches_of()
    plain, exact = plain_evals(policy.agent.inner_model,
                               lambda: policy.predict_chunk(obs, goal, noise),
                               2)
    mae = (kern - plain).abs().mean().item()
    floor = (plain - exact).abs().mean().item()
    tol = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * floor)
    launches = counts.pop("fused_layer_q8c")
    print(f"  the trained EMA weights served by parity at b={B}: {launches} "
          f"fused_layer_q8c launches, others {counts}; action MAE "
          f"kernel-vs-plain {mae:.3e} (tol {tol:.3e}), floor {floor:.3e}",
          flush=True)
    if not (launches == 120 and not any(counts.values()) and mae <= tol
            and bool(torch.isfinite(kern).all())):
        raise SystemExit("serving the trained weights failed")
    return {"launches": launches, "action_mae": mae, "action_floor": floor,
            "tol": tol}


def train_phase(smi, zero_launches, launches_of, root, dev=None):
    """Phase 22: the flagship train step and the Trainer on the card (with
    autograd on: the serving phases run with it off). The bf16 run's
    directory, ``<root>/bf16``, stays for phase 23; the caller removes
    ``root``."""
    import torch
    with torch.enable_grad():
        return _train_phase(smi, zero_launches, launches_of, root,
                            dev or torch.device("cuda", 0))


def _train_phase(smi, zero_launches, launches_of, root, dev):
    import gc
    import shutil

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(f"  device memory held by the earlier phases: "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
    deviations = check_train_settings()
    print(f"  the training settings equal conf/config_calvin.yaml's as the "
          f"port's builders read them, but for the from-scratch router aux "
          f"weights (used, config's): {deviations}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    batches = train_batches(gen, N_BATCHES, TRAIN_B, dev)
    val = eval_batch(train_batches(gen, 1, TRAIN_B, dev)[0])
    out = {"card": smi, "batch": TRAIN_B, "steps": N_BATCHES,
           "model": {k: v for k, v in TRAIN_MODEL.items()},
           "config_deviations": deviations,
           "optimizer": TRAIN_OPT, "ema": TRAIN_EMA}
    t = time.perf_counter()
    trainer, state, rec = fit_run(True, f"{root}/bf16", batches, val, dev)
    out["round_trip"] = round_trip(f"{root}/bf16", state, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["bf16_full_state"] = step_profile(trainer, state, batches[0],
                                          rec)
    phase("phase 22a: Trainer.fit with the bf16 training state, "
          "checkpoint round trip", t)
    t = time.perf_counter()
    out["serve"] = serve_trained(state, dev, zero_launches, launches_of)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 22b: the trained EMA weights served by parity", t)
    t = time.perf_counter()
    trainer, state, rec = fit_run(False, f"{root}/f32", batches, val, dev)
    out["f32_state"] = step_profile(trainer, state, batches[0], rec)
    weights = {n: p.detach().float().clone()
               for n, p in trainer.agent.state_dict().items()}
    del trainer, state
    shutil.rmtree(f"{root}/f32", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 22c: Trainer.fit with the f32 master state", t)
    t = time.perf_counter()
    out["grad_check"] = grad_check(weights, dev)
    phase("phase 22d: gradients against float64", t)
    for kind in ("bf16_full_state", "f32_state"):
        r = out[kind]
        print(f"  {kind}: median step {r['step_ms_median_3_8']:.1f} ms "
              f"(steps 3-8, {r['step_ms_spread_3_8'][0]:.1f}-"
              f"{r['step_ms_spread_3_8'][1]:.1f}), forward+backward "
              f"{r['fwd_bwd_ms_median']:.1f} ms, optimizer+EMA "
              f"{r['opt_ema_ms_median']:.1f} ms; one profiled step: host "
              f"{r['profiled_step_host_ms']:.1f} ms, device busy "
              f"{r['device_busy_ms']} ms, idle share {r['idle_share']}; "
              f"peak {r['peak_gib']['remat']:.2f} GiB (no remat "
              f"{r['peak_gib']['no_remat']:.2f})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 23: evaluation (the CALVIN long-horizon CLI, the agent proxy, the
# Trainer's rollout hook) on phase 22's trained EMA weights
# ---------------------------------------------------------------------------

# 2 five-task chains on the fake env at 224 px (8 until the long-token
# phase needed their time), every task solvable after 25 env steps (three
# chunks per subtask), 360 steps allowed per subtask
EVAL_SEQUENCES, EVAL_STEPS_TO_SUCCESS, EVAL_EP_LEN = 2, 25, 360
PROXY_STEPS = 30
EVAL_KEYS = {"eval_lh/avg_seq_len"} | {f"eval_lh/sr_chain_{i}"
                                       for i in range(1, 6)}
CAMS = ("rgb_static", "rgb_gripper")


def eval_argv(root, mode):
    """The CLI's argv for one run on phase 22's bf16 run directory."""
    return ["--checkpoint", f"{root}/bf16", "--fake-env",
            "--fake-steps-to-success", str(EVAL_STEPS_TO_SUCCESS),
            "--num-sequences", str(EVAL_SEQUENCES),
            "--ep-len", str(EVAL_EP_LEN), "--image-size", str(TRAIN_IMG),
            "--bf16", "--serving-mode", mode, "--num-videos", "0",
            "--log-dir", f"{root}/eval_{mode}"]


@contextlib.contextmanager
def eval_probe(env_cls=None, loop=None):
    """Class-level wrappers that record one evaluation run: every action
    the env's ``step`` receives (``env_cls``, by default the CALVIN env
    wrapper: before its gripper binarization) and the host ms of that step
    (fake env + wrapper), the ms of every policy step and chunk (host
    clock to a synchronize; the chunk's copy to the host synchronizes
    there anyway), of every CLIP tower call, and the wall seconds of each
    call of the rollout loop (``loop``: (class, method), by default
    ``LongHorizonEvaluator.evaluate_policy``). The originals are restored
    on exit."""
    import torch
    from mode_diffusion_policy_tpu_torch.evaluation import \
        evaluate_calvin as ec
    from mode_diffusion_policy_tpu_torch.models.agent import RolloutPolicy
    from mode_diffusion_policy_tpu_torch.models.encoders.clip_text import \
        LangClip
    from mode_diffusion_policy_tpu_torch.rollout.env import CalvinEnvWrapper
    from mode_diffusion_policy_tpu_torch.rollout.rollout_long_horizon import \
        LongHorizonEvaluator
    rec = {k: [] for k in ("actions", "env_ms", "step_ms", "chunk_ms",
                           "tower_ms", "loop_s")}

    def timed(fn, key, sync=False, scale=1e3, log_action=False):
        def wrapped(self, *a, **k):
            if log_action:
                rec["actions"].append(np.array(a[0], np.float64).reshape(-1))
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            if sync:
                torch.cuda.synchronize()
            rec[key].append((time.perf_counter() - t0) * scale)
            return out
        return wrapped

    loop_cls, loop_fn = loop or (LongHorizonEvaluator, "evaluate_policy")
    plan = [(env_cls or CalvinEnvWrapper, "step",
             dict(key="env_ms", log_action=True)),
            (ec.PreprocPolicy, "step", dict(key="step_ms")),
            (RolloutPolicy, "predict_chunk", dict(key="chunk_ms", sync=True)),
            (LangClip, "__call__", dict(key="tower_ms", sync=True)),
            (loop_cls, loop_fn, dict(key="loop_s", sync=True, scale=1.0))]
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in plan]
    try:
        for cls, name, kw in plan:
            setattr(cls, name, timed(cls.__dict__[name], **kw))
        yield rec
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def eval_run(root, mode, zero_launches, launches_of):
    """``evaluate_calvin`` (``evaluate(parse_args(argv))``: ``main`` without
    its two printed lines) on phase 22's run directory under ``mode``, the
    launches of every kernel counted from 0 over the whole run."""
    import torch
    from mode_diffusion_policy_tpu_torch.evaluation import \
        evaluate_calvin as ec
    args = ec.parse_args(eval_argv(root, mode))
    t0 = time.perf_counter()
    with eval_probe() as rec:
        zero_launches()
        ev = ec.evaluate(args)
        torch.cuda.synchronize()
        counts = launches_of()
    rec["run_s"] = time.perf_counter() - t0
    path = f"{args.log_dir}/results.json"
    with open(path) as f:
        rec["ranking"] = json.load(f)["0"]
    rec["counts"] = counts
    return ev, rec


def eval_floor(policy, raw, mode, dev):
    """At b=1 on the run's own weights (``policy``, an evaluation's
    ``PreprocPolicy``) and one of its env's observations (``raw``: uint8
    frames per camera): the plain-f32-vs-plain-f64 action distance of the
    preset's DiT function (``parity``: the layer; ``b1-latency``: the whole
    stack, products and then also norms and softmax in f64), and the
    kernel-vs-plain one."""
    import torch
    from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera
    obs = {c: preprocess_camera(torch.as_tensor(raw[c], device=dev),
                                size=policy.sizes[c]) for c in CAMS}
    goal = {"lang_text": "open the drawer"}
    noise = torch.randn(1, 10, 7, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    kern = policy.predict_chunk(obs, goal, noise)
    plain, *exacts = plain_evals(
        policy.agent.inner_model,
        lambda: policy.predict_chunk(obs, goal, noise),
        2 if mode == "parity" else 3)
    floors = [(plain - e).abs().mean().item() for e in exacts]
    return max(floors), (kern - plain).abs().mean().item()


def subtask_idle(ev):
    """One subtask of the first chain, run again on the same policy: its
    wall ms, then its device busy ms under torch.profiler; the idle share
    is one minus busy over the unprofiled wall time (chunk_split's
    reading)."""
    import torch
    from mode_diffusion_policy_tpu_torch.evaluation.utils import \
        get_env_state_for_initial_condition
    evaluator, policy = ev.evaluator, ev.policy
    state, seq = evaluator.eval_sequences[0]

    def run():
        robot, scene = get_env_state_for_initial_condition(state)
        evaluator.env.reset(robot_obs=robot, scene_obs=scene)
        if not evaluator.rollout(policy, seq[0]):
            raise SystemExit("phase 23: the profiled subtask failed")

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, _ = device_busy_ms(run)
    return {"subtask": seq[0], "env_steps": EVAL_STEPS_TO_SUCCESS,
            "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": None if busy is None else max(0.0, 1 - busy / wall)}


def proxy_check(ev, dev):
    """The agent proxy on 127.0.0.1 at a free port, in a thread: __init__,
    PROXY_STEPS steps of raw CALVIN-shaped observations over two
    instructions, a request that raises on the server, a fresh __init__
    and 3 steps, __shutdown__. Every action must equal an in-process
    CalvinAgentWrapper's (same agent, seed and inputs) bit for bit."""
    from mode_diffusion_policy_tpu_torch.data.calvin_dataset import (
        DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
    from mode_diffusion_policy_tpu_torch.evaluation import \
        evaluate_calvin as ec
    from mode_diffusion_policy_tpu_torch.evaluation.agent_proxy import (
        AgentProxyClient, CalvinAgentWrapper, start_server)
    from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import \
        LangEmbeddingCache
    lang = ev.lang_cache.encoder

    def create_agent():
        policy = ec.PreprocPolicy(ev.agent, LangEmbeddingCache(lang),
                                  sizes={c: TRAIN_IMG for c in CAMS})
        return CalvinAgentWrapper(policy, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO,
                                  TRAIN_IMG)

    rng = np.random.default_rng(23)

    def raw_obs():
        return {"rgb_obs": {
            "rgb_static": rng.integers(0, 256, (STATIC_HW, STATIC_HW, 3),
                                       dtype=np.uint8),
            "rgb_gripper": rng.integers(0, 256, (GRIPPER_HW, GRIPPER_HW, 3),
                                        dtype=np.uint8)},
            "robot_obs": rng.standard_normal(15)}

    texts = ("open the drawer", "push the sliding door to the right")
    server = start_server(create_agent, "127.0.0.1", 0, background=True)
    remote_ms, local_ms, equal, n = [], [], True, 0
    try:
        client = AgentProxyClient(
            f"http://127.0.0.1:{server.server_address[1]}")
        client.init()
        local = create_agent()
        for i in range(PROXY_STEPS):
            obs, text = raw_obs(), texts[i * 2 // PROXY_STEPS]
            t0 = time.perf_counter()
            got = client.step(obs, text)
            remote_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            want = local.step(obs, text)
            local_ms.append((time.perf_counter() - t0) * 1e3)
            equal &= bool(np.array_equal(got, want))
            n += 1
        try:
            client._call("no_such_method")
            raised = False
        except RuntimeError:
            raised = True
        client.init()
        local = create_agent()
        for _ in range(3):
            obs = raw_obs()
            equal &= bool(np.array_equal(client.step(obs, texts[0]),
                                         local.step(obs, texts[0])))
            n += 1
        shut = client.shutdown() == "shutdown"
    finally:
        server.shutdown()
        server.server_close()
    out = {"steps": n, "bit_equal": equal, "error_raised": raised,
           "shutdown": shut,
           "round_trip_ms_median": statistics.median(remote_ms),
           "in_process_step_ms_median": statistics.median(local_ms),
           "round_trip_ms_chunk_steps": remote_ms[::10],
           "in_process_ms_chunk_steps": local_ms[::10]}
    if not (equal and raised and shut):
        raise SystemExit(f"phase 23c: the agent proxy failed: {out}")
    return out


def rollout_hook(trained, dev):
    """build_calvin_rollout_callback({"fake_env": True, ...}) called for one
    epoch on the trained agent (``trained``: the EMA weights and running
    statistics that the parity run restored, in a training-config agent):
    it must return the eval_lh metrics. One chain, one chunk per subtask:
    the hook serves the plain path."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig)
    from mode_diffusion_policy_tpu_torch.models.encoders.clip_text import \
        LangClip
    from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import \
        LangEmbeddingCache
    from mode_diffusion_policy_tpu_torch.training.state import \
        encoder_batch_stats
    from mode_diffusion_policy_tpu_torch.training_common import (
        build_calvin_rollout_callback, parse_camera_pipelines)
    agent = MoDEAgent(MoDEAgentConfig(dtype=torch.bfloat16, **TRAIN_MODEL),
                      device=dev)
    agent.load_state_dict(trained)
    variables = {"params": dict(agent.named_parameters()),
                 "batch_stats": encoder_batch_stats(agent)}
    cb = build_calvin_rollout_callback(
        {"fake_env": True, "fake_hw": TRAIN_IMG, "fake_steps_to_success": 10,
         "num_sequences": 1, "ep_len": EVAL_EP_LEN},
        LangEmbeddingCache(LangClip.initialize_random(0, device=dev)),
        parse_camera_pipelines(TRAIN_TRANSFORMS))
    t0 = time.perf_counter()
    metrics = cb(agent, variables, 0)
    wall = time.perf_counter() - t0
    print(f"  rollout hook (plain path, 1 chain): {metrics} in "
          f"{wall:.1f} s", flush=True)
    if set(metrics) != EVAL_KEYS or metrics["eval_lh/avg_seq_len"] != 5.0:
        raise SystemExit(f"phase 23d: rollout hook metrics {metrics}")
    return {"metrics": metrics, "wall_s": wall}


def eval_phase(smi, zero_launches, launches_of, root, chunk_b1, dev=None):
    """Phase 23: the evaluation CLI under parity, reference and b1-latency
    on phase 22's trained EMA weights, the agent proxy, the rollout hook."""
    import gc

    import torch
    dev = dev or torch.device("cuda", 0)
    out = {"card": smi, "sequences": EVAL_SEQUENCES,
           "steps_to_success": EVAL_STEPS_TO_SUCCESS}
    runs = {}
    for ph, mode in (("23a", "parity"), ("23a", "reference"),
                     ("23b", "b1-latency")):
        t = time.perf_counter()
        ev, rec = eval_run(root, mode, zero_launches, launches_of)
        chunks, steps = len(rec["chunk_ms"]), len(rec["env_ms"])
        counts = dict(rec["counts"])
        acfg = ev.agent.cfg
        want = {"parity": ("fused_layer_q8c",
                           acfg.n_layers * acfg.num_sampling_steps),
                "b1-latency": ("fused_dit_q8c",
                               acfg.num_sampling_steps)}.get(mode)
        launches = counts.pop(want[0]) if want else 0
        cache = ev.lang_cache
        instructions = {ev.evaluator.val_annotations[task][0]
                        for _, chain in ev.evaluator.eval_sequences
                        for task in chain}
        r = {"chunks": chunks, "env_steps": steps, "launches": launches,
             "launches_per_chunk": launches / max(chunks, 1),
             "other_launches": counts, "ranking": rec["ranking"],
             "env_steps_per_s": steps / rec["loop_s"][0],
             "loop_s": rec["loop_s"][0], "run_s": rec["run_s"],
             "chunk_ms_median": statistics.median(rec["chunk_ms"]),
             "chunk_ms_first": rec["chunk_ms"][0],
             "policy_step_ms_mean": statistics.fmean(rec["step_ms"]),
             "env_host_ms_mean": statistics.fmean(rec["env_ms"]),
             "env_host_ms_median": statistics.median(rec["env_ms"]),
             "tower_calls": len(rec["tower_ms"]),
             "tower_ms_median": statistics.median(rec["tower_ms"]),
             "tower_ms_first": rec["tower_ms"][0],
             "cache_encoder_calls": cache.encoder_calls,
             "instructions": len(instructions)}
        ok = (chunks == EVAL_SEQUENCES * 5 * 3
              and steps == EVAL_SEQUENCES * 5 * EVAL_STEPS_TO_SUCCESS
              and rec["ranking"]["avg_seq_len"] == 5.0
              and not any(counts.values())
              and launches == (want[1] * chunks if want else 0)
              and cache.encoder_calls == cache.encoded_texts
              == len(instructions) == len(rec["tower_ms"])
              and all(np.isfinite(a).all() for a in rec["actions"]))
        if want:
            r["floor_b1"], r["kernel_vs_plain_b1"] = eval_floor(
                ev.policy, ev.env.get_obs()["rgb_obs"], mode, dev)
        if mode == "parity":
            # the restored weights (not the preset's folded encoders), for
            # the rollout hook (23d)
            trained = {k: v.clone() for k, v in ev.agent.state_dict().items()
                       if k.split(".", 1)[0] not in ("folded", "q8")}
            r["subtask"] = subtask_idle(ev)
            t2 = time.perf_counter()
            out["proxy"] = proxy_check(ev, dev)
            phase("phase 23c: the agent proxy over localhost", t2)
        runs[mode] = (r, np.stack(rec["actions"]))
        print(f"  {mode}: {chunks} chunks, {steps} env steps, "
              f"{r['env_steps_per_s']:.1f} env steps/s; {launches} "
              f"{want[0] if want else 'kernel'} launches "
              f"({r['launches_per_chunk']:.0f} per chunk), others {counts}; "
              f"chunk in the loop {r['chunk_ms_median']:.2f} ms (median; "
              f"phase 6's bare parity b=1 chunk {chunk_b1:.2f} ms); policy "
              f"step {r['policy_step_ms_mean']:.3f} ms (mean); env + wrapper "
              f"{r['env_host_ms_mean']:.3f} ms per step; CLIP tower "
              f"{r['tower_calls']} calls for {r['instructions']} "
              f"instructions, {r['tower_ms_median']:.2f} ms each (first "
              f"{r['tower_ms_first']:.1f}); results {rec['ranking']}; run "
              f"{r['run_s']:.1f} s ({smi})", flush=True)
        if not ok:
            raise SystemExit(f"phase {ph}: {mode} evaluation failed its "
                             f"gates: {r}")
        del ev
        gc.collect()
        torch.cuda.empty_cache()
        phase(f"phase {ph}: evaluate_calvin --serving-mode {mode}", t)
    ref_actions = runs["reference"][1]
    for mode in ("parity", "b1-latency"):
        r, actions = runs[mode]
        r["action_mae_vs_reference"] = float(
            np.abs(actions - ref_actions).mean())
        r["tol"] = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * r["floor_b1"])
        r["rankings_equal"] = r["ranking"] == runs["reference"][0]["ranking"]
        print(f"  {mode} vs reference over {len(actions)} actions: MAE "
              f"{r['action_mae_vs_reference']:.3e} (tol {r['tol']:.3e}, "
              f"floor at b=1 {r['floor_b1']:.3e}, kernel-vs-plain at b=1 "
              f"{r['kernel_vs_plain_b1']:.3e}); rankings equal "
              f"{r['rankings_equal']}", flush=True)
        if not (r["rankings_equal"]
                and r["action_mae_vs_reference"] <= r["tol"]):
            raise SystemExit(f"phase 23: {mode} disagrees with reference")
    # the megakernel equals 12 chained layer-kernel launches bit for bit
    # (phases 7-8), so the two kernel runs should act alike to the bit
    out["b1_latency_equals_parity"] = bool(np.array_equal(
        runs["parity"][1], runs["b1-latency"][1]))
    print(f"  b1-latency's actions equal parity's bit for bit: "
          f"{out['b1_latency_equals_parity']}", flush=True)
    out.update({mode: runs[mode][0] for mode in runs})
    p = out["parity"]["subtask"]
    print(f"  parity, one subtask ({p['env_steps']} env steps, 3 chunks): "
          f"{p['wall_ms']:.1f} ms, device busy {p['device_busy_ms']} ms, "
          f"idle share {p['idle_share']} ({smi})", flush=True)
    x = out["proxy"]
    print(f"  agent proxy: {x['steps']} steps bit-equal {x['bit_equal']}; "
          f"round trip {x['round_trip_ms_median']:.2f} ms median vs "
          f"in-process step {x['in_process_step_ms_median']:.2f} ms "
          f"({smi})", flush=True)
    t = time.perf_counter()
    out["rollout_hook"] = rollout_hook(trained, dev)
    phase("phase 23d: the Trainer's rollout hook", t)
    return out

# ---------------------------------------------------------------------------
# phase 24: the training_calvin CLI on an episode store on disk
# ---------------------------------------------------------------------------

# a synthetic CALVIN store in the layout of tests/calvin_fixture.py at
# CALVIN's sizes: 200 x 200 static and 84 x 84 gripper frames (uint8),
# robot_obs 15, scene_obs 24, rel_actions and actions 7, one 64-frame
# language window per episode; 16 training episodes (~145 MB of npz) and 4
# validation episodes of 64 frames
CLI_EPISODES = {"training": 16, "validation": 4}
CLI_EP_LEN = 64
CLI_STEPS = 8
CLI_PROFILED_STEP = 6     # of the resumed run: its interval is profiled
LOADER_BATCHES = 8
LOADER_CONFIGS = ((0, False), (0, True), (4, False), (4, True))
CLI_INSTRUCTIONS = ("open the drawer", "close the drawer", "turn on the led",
                    "turn off the led", "push the red block to the right",
                    "lift the blue block from the table",
                    "move the slider to the left",
                    "rotate the pink block to the right")
BATCH_KEYS = ("rgb_static", "rgb_gripper", "actions", "robot_obs", "idx")


def write_store(store):
    """Write the store (seeded numpy draws); return its npz bytes."""
    import pathlib
    r = np.random.default_rng(0)
    nbytes = 0
    for split, n_ep in CLI_EPISODES.items():
        d = pathlib.Path(store) / split
        (d / "lang_annotations").mkdir(parents=True)
        indx = []
        for ep in range(n_ep):
            start = ep * CLI_EP_LEN
            frames = {
                "rgb_static": r.integers(0, 256, (CLI_EP_LEN, STATIC_HW,
                                                  STATIC_HW, 3), np.uint8),
                "rgb_gripper": r.integers(0, 256, (CLI_EP_LEN, GRIPPER_HW,
                                                   GRIPPER_HW, 3), np.uint8),
                "robot_obs": r.standard_normal((CLI_EP_LEN, 15)).astype(
                    np.float32),
                "scene_obs": r.standard_normal((CLI_EP_LEN, 24)).astype(
                    np.float32),
                "rel_actions": r.uniform(-1, 1, (CLI_EP_LEN, 7)).astype(
                    np.float32),
                "actions": r.uniform(-1, 1, (CLI_EP_LEN, 7)).astype(
                    np.float32)}
            for t in range(CLI_EP_LEN):
                path = d / f"episode_{start + t:07d}.npz"
                np.savez(path, **{k: v[t] for k, v in frames.items()})
                nbytes += path.stat().st_size
            indx.append((start, start + CLI_EP_LEN - 1))
        np.save(d / "ep_start_end_ids.npy", np.asarray(indx))
        lang = {"info": {"indx": indx}, "language": {
            "emb": r.standard_normal((n_ep, 1, 384)).astype(np.float32),
            "ann": [CLI_INSTRUCTIONS[i % len(CLI_INSTRUCTIONS)]
                    for i in range(n_ep)]}}
        np.save(d / "lang_annotations" / "auto_lang_ann.npy",
                np.asarray(lang, dtype=object), allow_pickle=True)
    return nbytes


def cli_argv(store, log_dir, epochs):
    """The CLI's argv: the shipped config with only these overrides."""
    return [f"root_data_dir={store}", f"log_dir={log_dir}", "batch_size=32",
            f"trainer.max_epochs={epochs}",
            f"trainer.limit_train_batches={CLI_STEPS}",
            "trainer.limit_val_batches=1", "num_workers=4",
            "datamodule.use_shm_cache=true",
            "callbacks.rollout_lh.fake_env=true",
            "callbacks.rollout_lh.num_sequences=2",
            "callbacks.rollout_lh.rollout_freq=1"]


def loader_runs(store, lang_cache):
    """The CLI's datamodule (``build_calvin_datamodule`` on the shipped
    config: batch 32, the packed actions, the tower's cache on the card as
    the embedder) at 0 and 4 workers, with and without the shm cache: the
    setup's seconds, the first batch's ms, the host ms per batch after it
    (median of LOADER_BATCHES; the consumer takes each batch at once, so
    this is the loader's own rate), and the first 3 batches."""
    import os
    from mode_diffusion_policy_tpu_torch.config.builders import \
        build_calvin_datamodule
    from mode_diffusion_policy_tpu_torch.config.loader import load_config
    from mode_diffusion_policy_tpu_torch.training_calvin import CONF_DIR
    out = {}
    for workers, shm in LOADER_CONFIGS:
        cfg = load_config(CONF_DIR, "config_calvin", overrides=[
            f"root_data_dir={store}", "batch_size=32",
            f"num_workers={workers}",
            f"datamodule.use_shm_cache={str(shm).lower()}"])
        t0 = time.perf_counter()
        dm = build_calvin_datamodule(
            cfg["datamodule"], lang_embed=lang_cache,
            shm_tag=f"smoke{os.getpid()}w{workers}").setup()
        setup_s = time.perf_counter() - t0
        try:
            it = dm.train_batches(epoch=0)
            t = time.perf_counter()
            first = [next(it)]
            first_ms = (time.perf_counter() - t) * 1e3
            ms = []
            for _ in range(LOADER_BATCHES):
                t = time.perf_counter()
                batch = next(it)
                ms.append((time.perf_counter() - t) * 1e3)
                if len(first) < 3:
                    first.append(batch)
            it.close()
        finally:
            dm.close()
        out[(workers, shm)] = {
            "setup_s": setup_s, "first_batch_ms": first_ms,
            "batch_ms_median": statistics.median(ms),
            "batch_ms_spread": [min(ms), max(ms)], "first3": first}
    return out


def same_batches(a, b):
    """Equal batch lists, bit for bit (the language embedding on the card
    compared there)."""
    import torch
    return len(a) == len(b) and all(
        x["lang_text"] == y["lang_text"]
        and torch.equal(x["lang_emb"], y["lang_emb"])
        and all(x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
                for k in BATCH_KEYS)
        for x, y in zip(a, b))


@contextlib.contextmanager
def cli_probe(profile_fresh=False):
    """Wraps ``Trainer.setup`` so that each CLI run records its trainer,
    the step it set up at (0, or the resumed step) and, per train step,
    the loss, the step's host ms to a synchronize and the interval since
    the previous step ended (the wait for the loader, the copy to the card
    and the step). In a resumed run (in every run with
    ``profile_fresh``), the interval of its step CLI_PROFILED_STEP runs
    under torch.profiler (device busy time). The original is restored on
    exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mode_diffusion_policy_tpu_torch.training import loop
    setup = loop.Trainer.setup
    runs = []

    def probed(self, *a, **k):
        state = setup(self, *a, **k)
        rec = {"trainer": self, "start_step": state.step, "loss": [],
               "step_ms": [], "interval_ms": []}
        runs.append(rec)
        step = self._train_step

        def timed(st, batch):
            t_in = time.perf_counter()
            st, metrics = step(st, batch)
            rec["loss"].append(float(metrics["train/total_loss"]))
            torch.cuda.synchronize()
            t = time.perf_counter()
            rec["step_ms"].append((t - t_in) * 1e3)
            if "t_end" in rec:
                rec["interval_ms"].append((t - rec["t_end"]) * 1e3)
            n = len(rec["loss"])
            if (self.resumed or profile_fresh) and \
                    n == CLI_PROFILED_STEP - 1:
                rec["prof"] = profile(activities=[ProfilerActivity.CUDA])
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    rec["prof"].start()
                t = time.perf_counter()
            elif "prof" in rec and n == CLI_PROFILED_STEP:
                prof = rec.pop("prof")
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    prof.stop()
                    rec["profiled_interval_ms"] = (t - rec["t_end"]) * 1e3
                    rec["device_busy_ms"] = busy_ms(prof.key_averages())
                # the next step's interval starts after the profiler's work
                t = time.perf_counter()
            rec["t_end"] = t
            return st, metrics

        self._train_step = timed
        return state

    loop.Trainer.setup = probed
    try:
        yield runs
    finally:
        loop.Trainer.setup = setup


def cli_run(store, log_dir, epochs):
    """``training_calvin.main`` on the store; returns its TrainingRun, the
    probe's record and the run's seconds."""
    from mode_diffusion_policy_tpu_torch import training_calvin
    t0 = time.perf_counter()
    with cli_probe() as runs:
        run = training_calvin.main(cli_argv(store, log_dir, epochs))
    rec = runs[-1]
    rec["run_s"] = time.perf_counter() - t0
    return run, rec


def cli_phase(smi, zero_launches, launches_of, root, train_step_ms,
              dev=None):
    """Phase 24: the store, its extraction, the loader at 0 and 4 workers
    with and without the shm cache, two runs of the CLI (fresh, then
    resumed) and the run directory restored by ``evaluate_calvin``."""
    import gc
    import pathlib

    import torch
    with torch.enable_grad():
        gc.collect()
        torch.cuda.empty_cache()
        return _cli_phase(smi, zero_launches, launches_of,
                          pathlib.Path(root), train_step_ms,
                          dev or torch.device("cuda", 0))


def _cli_phase(smi, zero_launches, launches_of, root, train_step_ms, dev):
    import glob

    import torch
    from mode_diffusion_policy_tpu_torch.data import preprocess
    from mode_diffusion_policy_tpu_torch.data.shm_cache import SEGMENT_PREFIX
    from mode_diffusion_policy_tpu_torch.evaluation import \
        evaluate_calvin as ec
    from mode_diffusion_policy_tpu_torch.models.encoders.clip_text import \
        LangClip
    from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import \
        LangEmbeddingCache
    t_phase = time.perf_counter()
    store = root / "calvin"
    out = {"card": smi, "episodes": CLI_EPISODES, "ep_len": CLI_EP_LEN,
           "batch": TRAIN_B, "steps_per_run": CLI_STEPS}
    t = time.perf_counter()
    out["store_bytes"] = write_store(store)
    out["store_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for split in CLI_EPISODES:
        preprocess.main(["--in-root", str(store / split)])
    out["extract_s"] = time.perf_counter() - t
    phase("phase 24a: the episode store and its extraction", t_phase)

    t = time.perf_counter()
    lang_cache = LangEmbeddingCache(LangClip.initialize_random(0,
                                                               device=dev))
    loaders = loader_runs(store, lang_cache)
    first3_equal = same_batches(loaders[(4, True)]["first3"],
                                loaders[(0, False)]["first3"])
    out["loader"] = {f"workers{w}_{'shm' if c else 'npz'}": {
        k: v for k, v in r.items() if k != "first3"}
        for (w, c), r in loaders.items()}
    out["shm_cache_s"] = (loaders[(0, True)]["setup_s"]
                          - loaders[(0, False)]["setup_s"])
    out["first3_equal"] = first3_equal
    del loaders, lang_cache
    phase("phase 24b: the loader at 0 and 4 workers, with and without the "
          "shm cache", t)

    runs = {}
    for name, epochs in (("fresh", 1), ("resumed", 2)):
        t = time.perf_counter()
        run, rec = cli_run(store, root / "cli_runs", epochs)
        runs[name] = (run, rec)
        phase(f"phase 24{'c' if name == 'fresh' else 'd'}: training_calvin "
              f"{name} run", t)
    run_dir = runs["fresh"][0].run_dir
    fresh, resumed = runs["fresh"][1], runs["resumed"][1]
    losses = fresh["loss"] + resumed["loss"]
    busy = resumed.get("device_busy_ms")
    out["runs"] = {name: {
        "resumed": rec["trainer"].resumed, "start_step": run.start_step,
        "end_step": run.state.step, "losses": rec["loss"],
        "step_ms": rec["step_ms"], "interval_ms": rec["interval_ms"],
        "run_s": rec["run_s"]} for name, (run, rec) in runs.items()}
    out["cli_step_ms_median_3_8"] = statistics.median(fresh["interval_ms"][1:])
    out["cli_step_alone_ms_median_3_8"] = statistics.median(
        fresh["step_ms"][2:])
    out["phase22_step_ms_median_3_8"] = train_step_ms
    out["profiled_step"] = {
        "step": CLI_PROFILED_STEP, "interval_ms":
        resumed.get("profiled_interval_ms"), "device_busy_ms": busy,
        "idle_share": None if busy is None else
        1.0 - busy / resumed["profiled_interval_ms"]}
    files_ok = ((run_dir / ".hydra" / "config.yaml").is_file()
                and (run_dir / "saved_models" / str(2 * CLI_STEPS)
                     / "state.pt").is_file())
    del runs

    t = time.perf_counter()
    args = ec.parse_args([
        "--checkpoint", str(run_dir), "--fake-env", "--num-sequences", "1",
        "--ep-len", str(EVAL_EP_LEN), "--image-size", str(TRAIN_IMG),
        "--bf16", "--serving-mode", "parity", "--num-videos", "0",
        "--log-dir", str(root / "cli_eval")])
    with eval_probe() as rec:
        zero_launches()
        ev = ec.evaluate(args)
        torch.cuda.synchronize()
        counts = launches_of()
    chunks = len(rec["chunk_ms"])
    per_chunk = ev.agent.cfg.n_layers * ev.agent.cfg.num_sampling_steps
    layer = counts.pop("fused_layer_q8c")
    out["evaluate"] = {"chunks": chunks, "fused_layer_q8c": layer,
                       "per_chunk": layer / max(chunks, 1),
                       "other_launches": counts,
                       "avg_seq_len": ev.ranking["avg_seq_len"],
                       "chunk_ms_median": statistics.median(rec["chunk_ms"])
                       if chunks else None}
    eval_ok = (chunks > 0 and layer == per_chunk * chunks == 120 * chunks
               and not any(counts.values()))
    del ev
    phase("phase 24e: evaluate_calvin restores the run directory (parity)",
          t)
    leftover = sorted(glob.glob(f"/dev/shm/{SEGMENT_PREFIX}*"))
    out["shm_leftover"] = leftover
    out["phase_s"] = time.perf_counter() - t_phase
    loader = out["loader"]
    print(f"  store: {out['store_bytes'] / 1e6:.1f} MB of npz in "
          f"{out['store_s']:.2f} s, extraction {out['extract_s']:.2f} s, shm "
          f"cache {out['shm_cache_s']:.2f} s (setup with minus without)",
          flush=True)
    for key, r in loader.items():
        print(f"  loader {key}: {r['batch_ms_median']:.2f} ms per batch of "
              f"{TRAIN_B} (median of {LOADER_BATCHES}, "
              f"{r['batch_ms_spread'][0]:.2f}-{r['batch_ms_spread'][1]:.2f});"
              f" first batch {r['first_batch_ms']:.1f} ms; setup "
              f"{r['setup_s']:.2f} s", flush=True)
    print(f"  first 3 batches, 4 workers + shm cache == inline: "
          f"{first3_equal}", flush=True)
    for name, r in out["runs"].items():
        print(f"  {name} run: resumed {r['resumed']}, steps {r['start_step']}"
              f" -> {r['end_step']}, losses "
              f"{[round(x, 4) for x in r['losses']]}, {r['run_s']:.1f} s",
              flush=True)
    p = out["profiled_step"]
    print(f"  train step through the CLI: {out['cli_step_ms_median_3_8']:.1f}"
          f" ms (median of steps 3-8, loader wait and copy included; the "
          f"step alone {out['cli_step_alone_ms_median_3_8']:.1f} ms) vs "
          f"phase 22's {train_step_ms:.1f} ms on batches already on the "
          f"card; one profiled CLI step (resumed run, step "
          f"{p['step']}): {p['interval_ms']} ms, device busy "
          f"{p['device_busy_ms']} ms, idle share {p['idle_share']} ({smi})",
          flush=True)
    e = out["evaluate"]
    print(f"  evaluate_calvin on the run directory: {e['chunks']} chunks, "
          f"{e['fused_layer_q8c']} fused_layer_q8c launches "
          f"({e['per_chunk']:.0f} per chunk), others {e['other_launches']}; "
          f"shm segments left {leftover}; phase {out['phase_s']:.1f} s",
          flush=True)
    ok = (len(losses) == 2 * CLI_STEPS
          and all(math.isfinite(x) for x in losses)
          and first3_equal and files_ok and eval_ok
          and not out["runs"]["fresh"]["resumed"]
          and out["runs"]["fresh"]["start_step"] == 0
          and out["runs"]["fresh"]["end_step"] == CLI_STEPS
          and out["runs"]["resumed"]["resumed"]
          and out["runs"]["resumed"]["start_step"] == CLI_STEPS
          and out["runs"]["resumed"]["end_step"] == 2 * CLI_STEPS
          and not leftover)
    if not ok:
        raise SystemExit(f"phase 24: the CLI failed its gates: "
                         f"{json.dumps(out, default=str)[:2000]}")
    return out

# ---------------------------------------------------------------------------
# phase 25: the LIBERO slice (the datamodule, training_libero,
# evaluate_libero) and the single-task evaluator and determinism check
# ---------------------------------------------------------------------------

# LIBERO-10's ten task files, named in LIBERO's <SCENE>_<instruction>_demo
# convention, at LIBERO's frame sizes (agentview_rgb and eye_in_hand_rgb
# 128 x 128 x 3 uint8, 7 joint_states, 2 gripper_states, 7 actions), drawn
# from LIBERO_SEED; the scale cut to 3 demos of 64 frames per task
# (LIBERO ships 50 demos of a few hundred frames per task), ~190 MB
LIBERO_TASKS = (
    "LIVING_ROOM_SCENE2_put_both_the_alphabet_soup_and_the_tomato_sauce_in_"
    "the_basket",
    "LIVING_ROOM_SCENE2_put_both_the_cream_cheese_box_and_the_butter_in_the_"
    "basket",
    "KITCHEN_SCENE3_turn_on_the_stove_and_put_the_moka_pot_on_it",
    "KITCHEN_SCENE4_put_the_black_bowl_in_the_bottom_drawer_of_the_cabinet_"
    "and_close_it",
    "LIVING_ROOM_SCENE5_put_the_white_mug_on_the_left_plate_and_put_the_"
    "yellow_and_white_mug_on_the_right_plate",
    "STUDY_SCENE1_pick_up_the_book_and_place_it_in_the_back_compartment_of_"
    "the_caddy",
    "LIVING_ROOM_SCENE6_put_the_white_mug_on_the_plate_and_put_the_chocolate_"
    "pudding_to_the_right_of_the_plate",
    "LIVING_ROOM_SCENE1_put_both_the_alphabet_soup_and_the_cream_cheese_box_"
    "in_the_basket",
    "KITCHEN_SCENE8_put_both_moka_pots_on_the_stove",
    "KITCHEN_SCENE6_put_the_yellow_and_white_mug_in_the_microwave_and_close_"
    "it")
LIBERO_DEMOS, LIBERO_DEMO_LEN, LIBERO_HW, LIBERO_SEED = 3, 64, 128, 0
LIBERO_B = 128            # conf/config_libero.yaml's batch_size
LIBERO_LOADER_BATCHES = 8
LIBERO_STEPS = 8
# evaluate_libero on the fake env: 2 tasks x 2 rollouts at 224 px, each
# solved after 5 warm-up and 25 policy steps (three chunks)
LIBERO_EVAL_TASKS, LIBERO_EVAL_N = 2, 2
LIBERO_STEPS_TO_SUCCESS, LIBERO_MAX_STEPS = 30, 60
LIBERO_POLICY_STEPS = LIBERO_STEPS_TO_SUCCESS - 5
# the single-task evaluator: 3 validation windows, 4 fake-solvable tasks
# (each solved at its first step, so one chunk per rollout)
SINGLE_TASKS = ("open_drawer", "turn_on_led", "move_slider_left",
                "lift_red_block_table")
SINGLE_SEQUENCES = 3


def write_libero_store(store):
    """The ten task files under ``<store>/libero_10``: hdf5 through h5py
    when it is importable; without it, the same arrays as ``.npy`` files
    (``<task>_demo/<demo>/<key>.npy``) whose memory maps go to the
    datasets through ``task_arrays`` / ``demo_arrays``, as hdf5 datasets
    are read: a window at a time. Returns (bytes written, the task arrays
    or None)."""
    import pathlib
    try:
        import h5py
    except ImportError:
        h5py = None
    r = np.random.default_rng(LIBERO_SEED)
    d = pathlib.Path(store) / "libero_10"
    d.mkdir(parents=True)
    n, hw = LIBERO_DEMO_LEN, LIBERO_HW
    nbytes, arrays = 0, (None if h5py else {})
    for name in LIBERO_TASKS:
        demos = {f"demo_{i}": {
            "actions": r.uniform(-1, 1, (n, 7)).astype(np.float32),
            "agentview_rgb": r.integers(0, 256, (n, hw, hw, 3), np.uint8),
            "eye_in_hand_rgb": r.integers(0, 256, (n, hw, hw, 3), np.uint8),
            "joint_states": r.standard_normal((n, 7)).astype(np.float32),
            "gripper_states": r.standard_normal((n, 2)).astype(np.float32)}
            for i in range(LIBERO_DEMOS)}
        path = d / f"{name}_demo.hdf5"
        if h5py:
            with h5py.File(path, "w") as f:
                for demo, keys in demos.items():
                    g = f.create_group(f"data/{demo}")
                    for k, v in keys.items():
                        (g if k == "actions" else g.require_group("obs")
                         ).create_dataset(k, data=v)
            nbytes += path.stat().st_size
            continue
        task = arrays[str(path)] = {}
        for demo, keys in demos.items():
            dd = d / path.stem / demo
            dd.mkdir(parents=True)
            task[demo] = {}
            for k, v in keys.items():
                np.save(dd / f"{k}.npy", v)
                nbytes += (dd / f"{k}.npy").stat().st_size
                task[demo][k] = np.load(dd / f"{k}.npy", mmap_mode="r")
    return nbytes, arrays


@contextlib.contextmanager
def libero_source(arrays):
    """Without h5py (``arrays`` not None): every ``LiberoDataModule`` set
    up inside reads the store's arrays (``task_arrays``) instead of
    discovering task files. The original is restored on exit."""
    from mode_diffusion_policy_tpu_torch.data import libero
    setup = libero.LiberoDataModule.setup

    def with_arrays(self):
        self.task_arrays = arrays
        return setup(self)

    if arrays is not None:
        libero.LiberoDataModule.setup = with_arrays
    try:
        yield
    finally:
        libero.LiberoDataModule.setup = setup


def libero_loader(store, arrays, lang_cache):
    """The CLI's datamodule (``build_libero_datamodule`` on the shipped
    config at batch 128, the tower's cache on the card as the embedder)
    without and with ``cache_all``: setup seconds, the first batch's ms,
    the host ms per batch after it (median of LIBERO_LOADER_BATCHES) and
    the first 3 batches."""
    from mode_diffusion_policy_tpu_torch.config.builders import \
        build_libero_datamodule
    from mode_diffusion_policy_tpu_torch.config.loader import load_config
    from mode_diffusion_policy_tpu_torch.training_calvin import CONF_DIR
    cfg = load_config(CONF_DIR, "config_libero", overrides=[
        f"root_data_dir={store}", f"batch_size={LIBERO_B}"])
    out = {}
    for cache_all in (False, True):
        t0 = time.perf_counter()
        with libero_source(arrays):
            dm = build_libero_datamodule(cfg["datamodule"],
                                         lang_embed=lang_cache,
                                         cache_all=cache_all).setup()
        setup_s = time.perf_counter() - t0
        try:
            it = dm.train_batches(epoch=0)
            t = time.perf_counter()
            first = [next(it)]
            first_ms = (time.perf_counter() - t) * 1e3
            ms = []
            for _ in range(LIBERO_LOADER_BATCHES):
                t = time.perf_counter()
                batch = next(it)
                ms.append((time.perf_counter() - t) * 1e3)
                if len(first) < 3:
                    first.append(batch)
        finally:
            dm.close()
        out["cache_all" if cache_all else "lazy"] = {
            "setup_s": setup_s, "first_batch_ms": first_ms,
            "batch_ms_median": statistics.median(ms),
            "batch_ms_spread": [min(ms), max(ms)], "first3": first,
            "sequences": len(dm.full), "train_batches": len(dm._train_idx)
            // LIBERO_B}
    return out


def libero_cli_argv(store, log_dir, batch):
    """training_libero's argv: the shipped config with only these
    overrides (the fake env's rollouts: 2 tasks, one rollout each, one
    chunk)."""
    return [f"root_data_dir={store}", f"log_dir={log_dir}",
            f"batch_size={batch}", "device=cuda", "trainer.max_epochs=1",
            f"trainer.limit_train_batches={LIBERO_STEPS}",
            "trainer.limit_val_batches=1",
            "callbacks.rollout_lh.fake_env=true",
            f"callbacks.rollout_lh.fake_hw={LIBERO_HW}",
            "callbacks.rollout_lh.fake_tasks=2",
            "callbacks.rollout_lh.n_eval=1",
            "callbacks.rollout_lh.fake_steps_to_success=15",
            "callbacks.rollout_lh.max_steps=20",
            "callbacks.rollout_lh.rollout_freq=1"]


def libero_train(store, arrays, log_dir):
    """``training_libero.main`` at the shipped batch of 128 (64 if 128 does
    not fit, said so), with step CLI_PROFILED_STEP profiled; returns the
    TrainingRun and the probe's record (with the run's seconds, its peak
    device memory and the batch)."""
    import gc

    import torch
    from mode_diffusion_policy_tpu_torch import training_libero
    refused = None
    for batch in (LIBERO_B, LIBERO_B // 2):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with libero_source(arrays), cli_probe(profile_fresh=True) as runs:
                run = training_libero.main(
                    libero_cli_argv(store, log_dir / f"b{batch}", batch))
        except torch.cuda.OutOfMemoryError as e:
            refused = f"B={batch}: {str(e).splitlines()[0]}"
            print(f"  training_libero does not fit at {refused}",
                  flush=True)
            continue
        rec = runs[-1]
        rec.update(run_s=time.perf_counter() - t0, batch=batch,
                   refused=refused, peak_gib=torch.cuda.max_memory_allocated()
                   / 2 ** 30)
        return run, rec
    raise SystemExit("phase 25c: training_libero fits neither at B=128 nor "
                     "at 64")


def libero_eval_run(run_dir, root, mode, zero_launches, launches_of):
    """``evaluate_libero`` (``evaluate(parse_args(argv))``) on the training
    run's directory under ``mode``, on the fake env at 224 px, every
    kernel's launches counted from 0 over the whole run."""
    import torch
    from mode_diffusion_policy_tpu_torch.evaluation import \
        evaluate_libero as el
    from mode_diffusion_policy_tpu_torch.rollout.libero_rollout import (
        FakeLiberoEnv, LiberoEvaluator)
    args = el.parse_args([
        "--checkpoint", str(run_dir), "--fake-env",
        "--fake-tasks", str(LIBERO_EVAL_TASKS),
        "--n-eval", str(LIBERO_EVAL_N),
        "--fake-steps-to-success", str(LIBERO_STEPS_TO_SUCCESS),
        "--max-steps", str(LIBERO_MAX_STEPS), "--img-size", str(TRAIN_IMG),
        "--bf16", "--serving-mode", mode,
        "--log-dir", str(root / f"libero_eval_{mode}")])
    t0 = time.perf_counter()
    with eval_probe(FakeLiberoEnv, (LiberoEvaluator, "evaluate_task")) as rec:
        zero_launches()
        ev = el.evaluate(args)
        torch.cuda.synchronize()
        counts = launches_of()
    rec["run_s"] = time.perf_counter() - t0
    with open(f"{args.log_dir}/results_libero.json") as f:
        rec["results"] = json.load(f)
    rec["counts"] = counts
    return ev, rec


def libero_eval(run_dir, root, zero_launches, launches_of, dev):
    """Phase 25d: evaluate_libero under parity, reference and b1-latency:
    launches per chunk, env steps per second, the chunk's ms in the loop,
    seconds outside it; each kernel preset's actions within max(1e-3, 2 x
    the b=1 floor) of reference's over every env step."""
    import gc

    import torch
    from mode_diffusion_policy_tpu_torch.rollout.libero_rollout import (
        FakeLiberoEnv, translate_obs)
    rollouts = LIBERO_EVAL_TASKS * LIBERO_EVAL_N
    chunks_want = rollouts * -(-LIBERO_POLICY_STEPS // 10)
    raw = translate_obs(FakeLiberoEnv(hw=TRAIN_IMG, seed=1).reset())
    runs = {}
    for mode in ("parity", "reference", "b1-latency"):
        ev, rec = libero_eval_run(run_dir, root, mode, zero_launches,
                                  launches_of)
        counts = dict(rec["counts"])
        acfg = ev.agent.cfg
        want = {"parity": ("fused_layer_q8c",
                           acfg.n_layers * acfg.num_sampling_steps),
                "b1-latency": ("fused_dit_q8c",
                               acfg.num_sampling_steps)}.get(mode)
        launches = counts.pop(want[0]) if want else 0
        chunks, steps = len(rec["chunk_ms"]), len(rec["step_ms"])
        loop_s = sum(rec["loop_s"])
        r = {"chunks": chunks, "policy_steps": steps,
             "env_steps": len(rec["env_ms"]), "launches": launches,
             "launches_per_chunk": launches / max(chunks, 1),
             "other_launches": counts, "results": rec["results"],
             "env_steps_per_s": steps / loop_s, "loop_s": loop_s,
             "outside_loop_s": rec["run_s"] - loop_s, "run_s": rec["run_s"],
             "chunk_ms_median": statistics.median(rec["chunk_ms"]),
             "chunk_ms_first": rec["chunk_ms"][0],
             "tower_calls": len(rec["tower_ms"]),
             "cache_encoder_calls": ev.lang_cache.encoder_calls}
        ok = (chunks == chunks_want
              and steps == rollouts * LIBERO_POLICY_STEPS
              and rec["results"]["eval/avg_success_rate"] == 1.0
              and not any(counts.values())
              and launches == (want[1] * chunks if want else 0)
              and ev.lang_cache.encoder_calls == len(rec["tower_ms"])
              == LIBERO_EVAL_TASKS
              and all(np.isfinite(a).all() for a in rec["actions"]))
        if want:
            r["floor_b1"], r["kernel_vs_plain_b1"] = eval_floor(
                ev.policy, raw["rgb_obs"], mode, dev)
        runs[mode] = (r, np.stack(rec["actions"]))
        print(f"  evaluate_libero {mode}: {chunks} chunks, {steps} policy "
              f"steps, {r['env_steps_per_s']:.1f} env steps/s; {launches} "
              f"{want[0] if want else 'kernel'} launches "
              f"({r['launches_per_chunk']:.0f} per chunk), others {counts}; "
              f"chunk in the loop {r['chunk_ms_median']:.2f} ms (median; "
              f"first {r['chunk_ms_first']:.1f}); {loop_s:.2f} s in the loop"
              f", {r['outside_loop_s']:.2f} s outside it; results "
              f"{rec['results']}", flush=True)
        if not ok:
            raise SystemExit(f"phase 25d: evaluate_libero {mode} failed its "
                             f"gates: {r}")
        del ev
        gc.collect()
        torch.cuda.empty_cache()
    ref = runs["reference"][1]
    for mode in ("parity", "b1-latency"):
        r, actions = runs[mode]
        r["action_mae_vs_reference"] = float(np.abs(actions - ref).mean())
        r["tol"] = max(CHUNK_MAE_TOL, CHUNK_FLOOR_FACTOR * r["floor_b1"])
        print(f"  evaluate_libero {mode} vs reference over {len(actions)} "
              f"env steps: MAE {r['action_mae_vs_reference']:.3e} (tol "
              f"{r['tol']:.3e}, floor at b=1 {r['floor_b1']:.3e}, "
              f"kernel-vs-plain at b=1 {r['kernel_vs_plain_b1']:.3e})",
              flush=True)
        if r["action_mae_vs_reference"] > r["tol"]:
            raise SystemExit(f"phase 25d: {mode} disagrees with reference")
    return {mode: r for mode, (r, _) in runs.items()}


def single_task_and_determinism(root, dev, zero_launches, launches_of):
    """Phase 25e: ``SingleTaskEvaluator`` over the fake CALVIN env on phase
    22's trained EMA weights under parity (its task dict from the
    windows' start and end states, one rollout per task and window), and
    ``determinism_check --fake-env`` twice."""
    import io

    import torch
    from mode_diffusion_policy_tpu_torch.data.calvin_dataset import (
        DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
    from mode_diffusion_policy_tpu_torch.evaluation import \
        determinism_check
    from mode_diffusion_policy_tpu_torch.evaluation import \
        evaluate_calvin as ec
    from mode_diffusion_policy_tpu_torch.models.encoders.clip_text import \
        LangClip
    from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import \
        LangEmbeddingCache
    from mode_diffusion_policy_tpu_torch.rollout.env import (
        CalvinEnvWrapper, FakeCalvinEnv)
    from mode_diffusion_policy_tpu_torch.rollout.rollout_single_task import \
        SingleTaskEvaluator
    agent = ec.build_agent(ec.parse_args([
        "--checkpoint", f"{root}/bf16", "--bf16", "--serving-mode",
        "parity"]))
    policy = ec.PreprocPolicy(
        agent, LangEmbeddingCache(LangClip.initialize_random(0, device=dev)),
        sizes={c: TRAIN_IMG for c in CAMS})
    raw = FakeCalvinEnv(hw=STATIC_HW, solvable_tasks=set(SINGLE_TASKS),
                        steps_to_success=0)
    env = CalvinEnvWrapper(raw, DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
    r = np.random.default_rng(LIBERO_SEED)
    seqs = [{"state_info": {"robot_obs": r.standard_normal((8, 15)),
                            "scene_obs": r.standard_normal((8, 24))}}
            for _ in range(SINGLE_SEQUENCES)]
    evaluator = SingleTaskEvaluator(env, raw.make_oracle(),
                                    ec.load_val_annotations(),
                                    ep_len=EVAL_EP_LEN)
    with eval_probe(CalvinEnvWrapper, (SingleTaskEvaluator, "evaluate")) \
            as rec:
        zero_launches()
        metrics = evaluator.evaluate(policy, seqs)
        torch.cuda.synchronize()
        counts = launches_of()
    chunks = len(rec["chunk_ms"])
    layer = counts.pop("fused_layer_q8c")
    rollouts = len(SINGLE_TASKS) * SINGLE_SEQUENCES
    out = {"task_dict": evaluator.task_to_sequences, "metrics": metrics,
           "chunks": chunks, "fused_layer_q8c": layer,
           "per_chunk": layer / max(chunks, 1), "other_launches": counts,
           "loop_s": rec["loop_s"][0],
           "chunk_ms_median": statistics.median(rec["chunk_ms"])}
    hashes = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            determinism_check.main(["--fake-env"])
        hashes.append(buf.getvalue())
    out["determinism_equal"] = hashes[0] == hashes[1]
    out["determinism_lines"] = hashes[0].strip().splitlines()[-4:]
    print(f"  SingleTaskEvaluator (parity, phase 22's EMA weights): task "
          f"dict {evaluator.task_to_sequences}; metrics {metrics}; {chunks}"
          f" chunks, {layer} fused_layer_q8c launches ({out['per_chunk']:.0f}"
          f" per chunk), others {counts}", flush=True)
    print(f"  determinism_check --fake-env twice: equal "
          f"{out['determinism_equal']}; {out['determinism_lines'][-1]}",
          flush=True)
    per_chunk = agent.cfg.n_layers * agent.cfg.num_sampling_steps
    ok = (chunks == rollouts and layer == per_chunk * chunks
          and not any(counts.values())
          and metrics.get("tasks/average_sr") == 1.0
          and len(metrics) == len(SINGLE_TASKS) + 1
          and out["determinism_equal"] and "hash(obs)" in hashes[0])
    if not ok:
        raise SystemExit(f"phase 25e: failed its gates: {out}")
    return out


def libero_phase(smi, zero_launches, launches_of, root, dev=None):
    """Phase 25: the LIBERO store, its datamodule, ``training_libero`` at
    the shipped batch, ``evaluate_libero`` on that run under three
    presets, the single-task evaluator and the determinism check."""
    import gc
    import pathlib

    import torch
    with torch.enable_grad():
        gc.collect()
        torch.cuda.empty_cache()
        return _libero_phase(smi, zero_launches, launches_of,
                             pathlib.Path(root),
                             dev or torch.device("cuda", 0))


def _libero_phase(smi, zero_launches, launches_of, root, dev):
    import gc
    import glob

    import torch
    from mode_diffusion_policy_tpu_torch.data.shm_cache import SEGMENT_PREFIX
    from mode_diffusion_policy_tpu_torch.evaluation.evaluate_calvin import \
        find_train_config
    from mode_diffusion_policy_tpu_torch.models.encoders.clip_text import \
        LangClip
    from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import \
        LangEmbeddingCache
    from mode_diffusion_policy_tpu_torch.training_common import \
        parse_camera_pipelines
    t_phase = t = time.perf_counter()
    store = root / "libero"

    out = {"card": smi, "tasks": len(LIBERO_TASKS), "demos": LIBERO_DEMOS,
           "demo_len": LIBERO_DEMO_LEN, "hw": LIBERO_HW}
    out["store_bytes"], arrays = write_libero_store(store)
    out["store_s"] = time.perf_counter() - t
    out["hdf5_reader"] = arrays is None
    print(f"  LIBERO store: {len(LIBERO_TASKS)} tasks x {LIBERO_DEMOS} demos "
          f"x {LIBERO_DEMO_LEN} frames at {LIBERO_HW} px (cut from LIBERO's "
          f"50 demos per task), {out['store_bytes'] / 1e6:.1f} MB in "
          f"{out['store_s']:.2f} s", flush=True)
    if arrays is not None:
        print("  the hdf5 reader was not exercised on this machine: h5py is "
              "not importable here, so the store is .npy files read through "
              "LiberoDataModule(task_arrays=) / LiberoSequenceDataset("
              "demo_arrays=) (memory maps; the hdf5 read is held against "
              "the JAX package on the CPU only)", flush=True)
    phase("phase 25a: the LIBERO store", t_phase)

    t = time.perf_counter()
    lang_cache = LangEmbeddingCache(LangClip.initialize_random(0, device=dev))
    loaders = libero_loader(store, arrays, lang_cache)
    out["first3_equal"] = same_batches(loaders["lazy"]["first3"],
                                       loaders["cache_all"]["first3"])
    out["loader"] = {k: {kk: v for kk, v in r.items() if kk != "first3"}
                     for k, r in loaders.items()}
    del loaders, lang_cache
    for key, r in out["loader"].items():
        print(f"  LIBERO loader ({key}): {r['batch_ms_median']:.2f} ms per "
              f"batch of {LIBERO_B} (median of {LIBERO_LOADER_BATCHES}, "
              f"{r['batch_ms_spread'][0]:.2f}-{r['batch_ms_spread'][1]:.2f})"
              f"; first batch {r['first_batch_ms']:.1f} ms; setup "
              f"{r['setup_s']:.2f} s; {r['sequences']} sequences, "
              f"{r['train_batches']} train batches ({smi})", flush=True)
    print(f"  first 3 batches, cache_all == lazy (lang_emb on the card "
          f"included): {out['first3_equal']}", flush=True)
    phase("phase 25b: the LIBERO datamodule without and with cache_all", t)

    t = time.perf_counter()
    run, rec = libero_train(store, arrays, root / "libero_runs")
    run_dir = run.run_dir
    cams = {cam: p["size"] for cam, p in parse_camera_pipelines(
        find_train_config(run_dir)["datamodule"]["transforms"]).items()
        if cam in CAMS}
    steps = [s for s in range(3, LIBERO_STEPS + 1) if s != CLI_PROFILED_STEP]
    iv = dict(zip(range(2, LIBERO_STEPS + 1), rec["interval_ms"]))
    alone = dict(zip(range(1, LIBERO_STEPS + 1), rec["step_ms"]))
    busy = rec.get("device_busy_ms")
    metrics = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    out["train"] = {
        "batch": rec["batch"], "refused": rec["refused"],
        "cameras": cams,
        "losses": rec["loss"], "step_ms": rec["step_ms"],
        "interval_ms": rec["interval_ms"], "run_s": rec["run_s"],
        "step_ms_median_3_8": statistics.median(iv[s] for s in steps),
        "step_alone_ms_median_3_8": statistics.median(alone[s]
                                                      for s in steps),
        "median_of_steps": steps, "peak_gib": rec["peak_gib"],
        "profiled_step": {
            "step": CLI_PROFILED_STEP,
            "interval_ms": rec.get("profiled_interval_ms"),
            "device_busy_ms": busy, "idle_share": None if busy is None else
            1.0 - busy / rec["profiled_interval_ms"]},
        "rollout_hook": {k: v for k, v in metrics[-1].items()
                         if k.startswith("eval/")},
        "resumed": rec["trainer"].resumed, "end_step": run.state.step}
    tr = out["train"]
    files_ok = ((run_dir / ".hydra" / "config.yaml").is_file()
                and (run_dir / "saved_models" / str(LIBERO_STEPS)
                     / "state.pt").is_file())
    del run, rec
    gc.collect()
    torch.cuda.empty_cache()
    p = tr["profiled_step"]
    print(f"  training_libero at B={tr['batch']} (static "
          f"{cams['rgb_static']} px, gripper {cams['rgb_gripper']} px): "
          f"losses "
          f"{[round(x, 4) for x in tr['losses']]}; "
          f"{tr['step_ms_median_3_8']:.1f} ms per step (median of steps "
          f"{steps}, loader and copy included; the step alone "
          f"{tr['step_alone_ms_median_3_8']:.1f} ms); peak "
          f"{tr['peak_gib']:.2f} GiB; profiled step {p['step']}: "
          f"{p['interval_ms']} ms, device busy {p['device_busy_ms']} ms, "
          f"idle share {p['idle_share']}; rollout hook "
          f"{tr['rollout_hook']}; run {tr['run_s']:.1f} s ({smi})",
          flush=True)
    if not (len(tr["losses"]) == LIBERO_STEPS and files_ok
            and all(math.isfinite(x) for x in tr["losses"])
            and not tr["resumed"] and tr["end_step"] == LIBERO_STEPS
            and "eval/avg_success_rate" in tr["rollout_hook"]):
        raise SystemExit(f"phase 25c: training_libero failed its gates: "
                         f"{json.dumps(tr, default=str)[:2000]}")
    phase(f"phase 25c: training_libero at B={tr['batch']}", t)

    t = time.perf_counter()
    out["evaluate"] = libero_eval(run_dir, root, zero_launches, launches_of,
                                  dev)
    phase("phase 25d: evaluate_libero under parity, reference, b1-latency",
          t)
    t = time.perf_counter()
    out["single_task"] = single_task_and_determinism(root, dev, zero_launches,
                                                     launches_of)
    phase("phase 25e: SingleTaskEvaluator (parity) and determinism_check", t)
    out["shm_leftover"] = sorted(glob.glob(f"/dev/shm/{SEGMENT_PREFIX}*"))
    out["phase_s"] = time.perf_counter() - t_phase
    if not out["first3_equal"] or out["shm_leftover"]:
        raise SystemExit(f"phase 25: the loader failed its gates: "
                         f"{json.dumps(out, default=str)[:2000]}")
    return out


# ---------------------------------------------------------------------------
# phase 26: the remaining modules (log_likelihood, the CLIP visual towers,
# VLMEmbeddingCache, export, verify_checkpoint's rungs, the native hashers,
# auto_annotate) at full width on the card
# ---------------------------------------------------------------------------

# the flagship denoiser under log_likelihood: f32 under ``reference`` (plain
# modules) and the same weights in float64; B=4 samples of the chunk shape
LL_MODEL = dict(latent_dim=1024, n_layers=12, n_heads=8, cond_dim=512,
                resnet_type="50", num_experts=4, top_k=2)
LL_B = 4
# the gate on the relative f32-vs-f64 gap of the log-likelihood: ten times
# the 1.958e-4 measured on the CPU at embed 64, 2 layers
# (tests/test_torch_loglik.py), the factor for the width (D 64 -> 1024:
# sums 16x longer, rounding ~4x) and the depth (2 -> 12 layers, ~2.4x)
LL_GAP_TOL = 10 * 1.958e-4
# the CLIP towers: ViT-B/32 and RN50 in the published layouts, B=8 on the
# card against the CPU in f32 (TF32 off) on the first 2 samples; the gate
# is relative to the output's largest magnitude: two f32 evaluations that
# sum in other orders over 12 layers or 16 bottlenecks
CLIP_TOWERS = {
    "ViT-B/32": ("vit", dict(input_resolution=224, patch_size=32, width=768,
                             layers=12, heads=12, output_dim=512)),
    "RN50": ("resnet", dict(layers=(3, 4, 6, 3), output_dim=1024, heads=32,
                            input_resolution=224, width=64)),
}
CLIP_B, CLIP_REL_TOL = 8, 1e-4
# verify_checkpoint's rungs: B=2 (the CLI's default batch) at 224 px
VCK_B, VCK_IMG = 2, 224


def loglik_check(dev):
    """26a: the flagship denoiser's log-likelihood in f32 and float64 (same
    weights, embedding, goal, samples and Rademacher draw), and the refusal
    of a ``parity`` denoiser (its off-schedule evaluations launch
    ``fused_attn_block``) under the JVP."""
    import dataclasses

    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig, RolloutPolicy)
    from mode_diffusion_policy_tpu_torch.models.edm import log_likelihood
    cfg = MoDEAgentConfig(**LL_MODEL)
    gen = torch.Generator(device=dev).manual_seed(26)
    agent = MoDEAgent(cfg, device=dev).eval()
    emb = torch.randn(LL_B, 2, cfg.obs_dim, generator=gen, device=dev)
    goal = torch.randn(LL_B, 1, cfg.cond_dim, generator=gen, device=dev)
    x = torch.randn(LL_B, cfg.act_window_size, cfg.action_dim,
                    generator=gen, device=dev)
    v = torch.randint(0, 2, x.shape, generator=gen, device=dev).float() * 2 - 1
    out = {"B": LL_B, "sigma": [cfg.sigma_min, cfg.sigma_max],
           "tol_rel": LL_GAP_TOL}
    runs = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        ag = agent
        if dt == torch.float64:
            ag = MoDEAgent(dataclasses.replace(cfg, dtype=dt), device=dev)
            ag.load_state_dict(agent.state_dict())
            ag = ag.double().eval()
        den = ag.make_denoiser({"state_images": emb.to(dt)}, goal.to(dt))
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ll = log_likelihood(den, x.to(dt), cfg.sigma_min, cfg.sigma_max,
                            v=v, stats=stats)
        torch.cuda.synchronize()
        runs[name] = ll.double().cpu()
        out[name] = {"ll": ll.tolist(), "s": time.perf_counter() - t0,
                     **stats}
        del ag, den
    gap = float(((runs["f32"] - runs["f64"]).abs()
                 / runs["f64"].abs()).max())
    out["gap_rel"] = gap
    print(f"  log_likelihood, flagship denoiser (reference), B={LL_B}: f32 "
          f"{out['f32']['ll']} ({out['f32']['evaluations']} evaluations, "
          f"{out['f32']['accepted']} accepted / {out['f32']['rejected']} "
          f"rejected steps, {out['f32']['s']:.2f} s); f64 {out['f64']['ll']} "
          f"({out['f64']['evaluations']} evaluations, "
          f"{out['f64']['accepted']} accepted, {out['f64']['s']:.2f} s); "
          f"relative gap {gap:.3e} (tol {LL_GAP_TOL:.3e})", flush=True)
    ok = gap <= LL_GAP_TOL and all(
        bool(torch.isfinite(r).all()) for r in runs.values())
    # a served preset's denoiser reaches a kernel under the JVP: refused
    policy = RolloutPolicy.with_serving_mode(
        MoDEAgent(dataclasses.replace(cfg, dtype=torch.bfloat16),
                  device=dev), mode="parity")
    den = policy.agent.make_denoiser({"state_images": emb}, goal)
    try:
        log_likelihood(den, x, cfg.sigma_min, cfg.sigma_max, v=v)
        out["parity_refused"] = "no error"
    except RuntimeError as e:
        out["parity_refused"] = str(e).split(";")[0]
    refused = "the CUDA kernel has no derivative" in out["parity_refused"]
    print(f"  log_likelihood on a parity denoiser: {out['parity_refused']}",
          flush=True)
    del policy, den, agent
    if not (ok and refused):
        raise SystemExit(f"phase 26a: log_likelihood failed its gates: {out}")
    return out


def clip_check(dev):
    """26b: ViT-B/32 and RN50 from random OpenAI-layout state dicts through
    ``infer_visual_config`` and ``convert_clip_visual``: B=8 on the card,
    the first 2 samples on the CPU in f32; and ``VLMEmbeddingCache`` over
    card tensors equal to the same cache over CPU tensors."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.encoders import clip_visual
    from mode_diffusion_policy_tpu_torch.models.encoders.clip_text import \
        LangClip
    from mode_diffusion_policy_tpu_torch.models.encoders.lang_cache import \
        VLMEmbeddingCache
    from mode_diffusion_policy_tpu_torch.models.encoders.tokenizer import \
        tokenize
    out = {"tf32": bool(torch.backends.cuda.matmul.allow_tf32
                        or torch.backends.cudnn.allow_tf32),
           "B": CLIP_B, "tol_rel": CLIP_REL_TOL}
    ok = True
    for label, (kind, dims) in CLIP_TOWERS.items():
        cfg_cls = (clip_visual.CLIPViTConfig if kind == "vit"
                   else clip_visual.ModifiedResNetConfig)
        sd = clip_visual.random_visual_state_dict(kind, cfg_cls(**dims),
                                                  seed=0, device=dev)
        k2, cfg, port_sd = clip_visual.convert_clip_visual(sd)
        assert k2 == kind and cfg == cfg_cls(**dims), (k2, cfg)
        gpu = clip_visual.build_visual(kind, cfg, port_sd, device=dev)
        cpu = clip_visual.build_visual(kind, cfg, port_sd, device="cpu")
        gen = torch.Generator(device=dev).manual_seed(3)
        res = cfg.input_resolution
        img = torch.randn(CLIP_B, res, res, 3, generator=gen, device=dev)
        feats = clip_visual.encode_image(gpu, img)
        want = clip_visual.encode_image(cpu, img[:2].cpu())
        err = float((feats[:2].cpu() - want).abs().max())
        scale = float(want.abs().max())
        ms = cuda_time_ms(lambda: clip_visual.encode_image(gpu, img), 10)
        out[label] = {"shape": list(feats.shape), "max_abs_err": err,
                      "max_abs_out": scale, "ms": ms}
        ok &= bool(torch.isfinite(feats).all()) and \
            err <= CLIP_REL_TOL * scale
        print(f"  {label}: encode_image {tuple(feats.shape)} at B={CLIP_B} "
              f"{ms:.3f} ms; card vs CPU (f32, TF32 {'on' if out['tf32'] else 'off'}) "
              f"max abs {err:.3e} of max |out| {scale:.3e} (tol "
              f"{CLIP_REL_TOL:g} relative)", flush=True)
        del gpu, cpu, sd
    # per-token embeddings of varying length: the token embedding rows of
    # a text tower, on its device
    texts = ["open the drawer", "push the red block to the left",
             "go", "open the drawer", "turn on the led light"]
    caches = {}
    towers = {"cpu": LangClip.initialize_random(0, device="cpu")}
    towers[dev.type] = LangClip.from_state_dict(
        towers["cpu"].model.state_dict(), towers["cpu"].cfg, device=dev)
    for d in (dev, torch.device("cpu")):
        lang = towers[d.type]

        def per_token(batch, lang=lang):
            ids = torch.from_numpy(tokenize(batch).astype("int64"))
            return [lang.model.token_embedding[row[:int(row.argmax()) + 1]
                                               .to(lang.device)]
                    for row in ids]
        cache = VLMEmbeddingCache(per_token, max_length=12, device=d)
        caches[d.type] = (cache(texts), cache)
    (ge, gm), gcache = caches["cuda"] if "cuda" in caches else caches[dev.type]
    (ce, cm), _ = caches["cpu"]
    same = (ge.device.type == dev.type and torch.equal(ge.cpu(), ce)
            and torch.equal(gm.cpu(), cm) and gcache.encoder_calls == 1
            and gcache.encoded_texts == 4)
    out["vlm_cache"] = {"shape": list(ge.shape), "tokens": gm.sum(1).tolist(),
                        "device": str(ge.device),
                        "encoder_calls": gcache.encoder_calls,
                        "card_equals_cpu": same}
    print(f"  VLMEmbeddingCache over card tensors: {tuple(ge.shape)} on "
          f"{ge.device}, tokens {gm.sum(1).tolist()}, "
          f"{gcache.encoder_calls} encoder call for "
          f"{gcache.encoded_texts} distinct texts, equal to the CPU cache: "
          f"{same}", flush=True)
    if not (ok and same):
        raise SystemExit(f"phase 26b: the CLIP towers failed their gates: "
                         f"{out}")
    return out


def export_check(run_dir, root, zero_launches, launches_of, dev):
    """26c: the export CLI on a run directory, the safetensors back through
    ``load_torch_checkpoint`` + ``convert_modedit`` into a new agent (its
    encoders from the run), served by ``parity`` at b=128 against the same
    run restored directly: bit-equal actions with the same noise, 120
    ``fused_layer_q8c`` launches. Returns the exported flat state dict."""
    from pathlib import Path

    import torch
    from mode_diffusion_policy_tpu_torch.evaluation.evaluate_calvin import \
        restore_trained
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig, RolloutPolicy)
    from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera
    from mode_diffusion_policy_tpu_torch.utils import export
    from mode_diffusion_policy_tpu_torch.utils.checkpoint_convert import (
        convert_modedit, detect_layout, load_torch_checkpoint)
    from mode_diffusion_policy_tpu_torch.utils.weights import load_dit_state_
    out_dir = f"{root}/export"
    t0 = time.perf_counter()
    export.main(["--run-dir", run_dir, "--out-dir", out_dir])
    export_s = time.perf_counter() - t0
    flat = load_torch_checkpoint(out_dir)
    n_layers, n_experts, prefix = detect_layout(flat)
    cfg = MoDEAgentConfig(dtype=torch.bfloat16, **TRAIN_MODEL)
    direct = MoDEAgent(cfg, device=dev)
    step = restore_trained(direct, Path(run_dir))
    via = MoDEAgent(cfg, device=dev)
    via.load_state_dict({k: v for k, v in direct.state_dict().items()
                         if not k.startswith("inner_model.")}, strict=False)
    load_dit_state_(via.inner_model, convert_modedit(flat, n_layers,
                                                     n_experts, prefix))
    gen = torch.Generator(device=dev).manual_seed(11)
    B = 128
    obs = {k: preprocess_camera(torch.randint(
        0, 256, (B, 1, hw, hw, 3), generator=gen, device=dev,
        dtype=torch.uint8), size=TRAIN_IMG)
        for k, hw in (("rgb_static", STATIC_HW), ("rgb_gripper", GRIPPER_HW))}
    goal = {"lang_emb": torch.randn(B, 1, 512, generator=gen, device=dev)}
    noise = torch.randn(B, 10, 7, generator=gen, device=dev)
    chunks, counts = {}, {}
    for name, ag in (("direct", direct), ("exported", via)):
        policy = RolloutPolicy.with_serving_mode(ag, mode="parity", seed=0)
        zero_launches()
        chunks[name] = policy.predict_chunk(obs, goal, noise)
        torch.cuda.synchronize()
        counts[name] = launches_of()
        del policy
    equal = torch.equal(chunks["direct"], chunks["exported"])
    launches = counts["exported"].pop("fused_layer_q8c")
    out = {"step": step, "tensors": len(flat), "layers": n_layers,
           "experts": n_experts, "export_s": export_s,
           "bytes": sum(t.numel() * t.element_size() for t in flat.values()),
           "dtypes": sorted({str(t.dtype) for t in flat.values()}),
           "bit_equal": equal, "fused_layer_q8c_launches": launches,
           "other_launches": counts["exported"]}
    print(f"  export CLI on the bf16 run (step {step}): {len(flat)} tensors "
          f"({out['bytes'] / 1e6:.1f} MB, {out['dtypes']}) in {export_s:.2f} "
          f"s; parity b={B} on the exported DiT: {launches} fused_layer_q8c "
          f"launches (others {counts['exported']}), actions bit-equal to "
          f"the run served directly: {equal}", flush=True)
    del direct, via
    if not (equal and launches == 120
            and not any(counts["exported"].values())):
        raise SystemExit(f"phase 26c: the export round trip failed: {out}")
    return out, flat


def verify_check(flat, dev):
    """26d: verify_checkpoint's rungs that need no reference repo, at full
    width: a random timm-layout FiLM-ResNet-50 pair and the exported DiT
    (reference layout); the encoder rung in f32 and with int8 encoders, the
    routing-precompute rung in f32 and under ``parity``."""
    import torch
    from mode_diffusion_policy_tpu_torch.utils import verify_checkpoint as vck
    from mode_diffusion_policy_tpu_torch.utils.checkpoint_convert import \
        detect_layout
    from mode_diffusion_policy_tpu_torch.utils.torch_oracles import \
        TorchFiLMResNetPolicy
    sd = dict(flat)
    n_layers, n_experts, prefix = detect_layout(sd)
    shape = vck.infer_dit_shape(sd, prefix)
    g = torch.Generator().manual_seed(12)
    torch.manual_seed(12)
    for enc in vck.ENCODERS:
        tenc = TorchFiLMResNetPolicy(shape["goal_dim"], depth=50)
        with torch.no_grad():
            for m in tenc.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.5, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
        sd.update({f"{enc}.{k}": v for k, v in tenc.state_dict().items()})
    depth = vck.infer_resnet_depth(sd)
    agent = vck.build_agent(sd, n_layers, n_experts, prefix, shape, depth,
                            device=dev)
    gen = torch.Generator().manual_seed(13)
    goal = torch.randn(VCK_B, 1, shape["goal_dim"], generator=gen)
    images = {enc: torch.randn(VCK_B, 3, VCK_IMG, VCK_IMG, generator=gen)
              * 0.3 for enc in vck.ENCODERS}
    report = vck.Report(vck.GATE_DEFAULT)
    t0 = time.perf_counter()
    with vck.no_tf32():
        feats = vck.check_encoders(report, sd, depth, goal, images, dev,
                                   agent=agent)
        emb = {"state_images": torch.stack([feats[e] for e in vck.ENCODERS],
                                           1)}
        noise = torch.randn(VCK_B, shape["action_seq_len"],
                            shape["action_dim"], generator=gen).to(dev)
        vck.check_routing(report, agent, emb, goal.to(dev), noise)
    # a report-only row's gate is infinite: null in the JSON line
    rows = [dict(r, gate=r["gate"] if math.isfinite(r["gate"]) else None)
            for r in report.rows]
    out = {"shape": shape, "depth": depth, "B": VCK_B, "img": VCK_IMG,
           "rows": rows, "pass": report.ok,
           "s": time.perf_counter() - t0}
    del agent
    if not report.ok:
        raise SystemExit(f"phase 26d: verify_checkpoint's rungs failed: "
                         f"{out}")
    return out


def hash_check():
    """26e: the C hashers built with ``cc`` here, against the 4800 golden
    vectors."""
    import gzip
    from pathlib import Path

    from mode_diffusion_policy_tpu_torch.utils import hashing
    t0 = time.perf_counter()
    lib = hashing.build_native()
    build_s = time.perf_counter() - t0
    hashing.load_native()
    pool = bytes((i * 131 + 7) & 0xFF for i in range(1200))
    n = ok = 0
    algos = set()
    path = Path(__file__).resolve().parent / "tests" / "data" / \
        "hash_vectors.jsonl.gz"
    with gzip.open(path, "rt") as f:
        for line in f:
            rec = json.loads(line)
            algo, (slo, shi) = rec["algo"], rec["seed"]
            want = sum(w << (64 * i) for i, w in enumerate(rec["val"]))
            h = getattr(hashing, algo)()
            data = pool[:rec["len"]]
            got = h(data) if "fingerprint" in algo else \
                h(data, seed=slo | (shi << 64))
            n += 1
            ok += got == want
            algos.add(algo)
    out = {"library": lib.name, "build_s": build_s, "vectors": n,
           "matched": ok, "algorithms": len(algos)}
    print(f"  native hashers: {lib.name} built in {build_s:.2f} s; golden "
          f"vectors matched {ok} / {n} over {len(algos)} algorithms",
          flush=True)
    if not (n == ok == 4800):
        raise SystemExit(f"phase 26e: hash vectors failed: {out}")
    return out


def annotate_check(dev):
    """26f: ``auto_annotate`` over the fake CALVIN env with the card's
    ``LangClip`` (random weights) on a handful of windows."""
    import numpy as np
    import torch
    from mode_diffusion_policy_tpu_torch.data.calvin_dataset import (
        DEFAULT_OBS_SPACE, DEFAULT_PROPRIO)
    from mode_diffusion_policy_tpu_torch.models.encoders.clip_text import \
        LangClip
    from mode_diffusion_policy_tpu_torch.rollout.env import (
        CalvinEnvWrapper, FakeCalvinEnv)
    from mode_diffusion_policy_tpu_torch.utils.lang_annotators import \
        auto_annotate

    class Oracle:
        def get_task_info_for_set(self, start, cur, task_set):
            done = set()
            if cur["scene_obs"][1] > start["scene_obs"][1] + 0.1:
                done.add("open_drawer")
            if cur["scene_obs"][5] > start["scene_obs"][5]:
                done.add("turn_on_led")
            return done & task_set

    annotations = {"open_drawer": ["open the drawer", "pull the drawer open"],
                   "turn_on_led": ["turn on the led", "switch on the light"]}
    windows = []
    for i, (idx, delta) in enumerate([(1, 0.22), (5, 1.0), (3, 0.01),
                                      (1, 0.3), (5, 2.0), (2, 0.5),
                                      (1, 0.15), (5, 0.5)]):
        scene = np.zeros((8, 24))
        scene[-1, idx] = delta
        windows.append({"state_info": {"robot_obs": np.zeros((8, 15)),
                                       "scene_obs": scene},
                        "indx": (8 * i, 8 * i + 8)})
    lang = LangClip.initialize_random(0, device=dev)
    env = CalvinEnvWrapper(FakeCalvinEnv(hw=200), DEFAULT_OBS_SPACE,
                           DEFAULT_PROPRIO)
    t0 = time.perf_counter()
    res = auto_annotate(windows, env, Oracle(), annotations,
                        lang_encoder=lang)
    s = time.perf_counter() - t0
    emb = res["language"]["emb"]
    same = np.array_equal(emb, lang(res["language"]["ann"]).cpu().numpy())
    out = {"windows": len(windows), "labelled": len(res["language"]["ann"]),
           "tasks": res["language"]["task"], "emb_shape": list(emb.shape),
           "emb_equals_tower": same, "s": s}
    print(f"  auto_annotate on the fake env with the card's LangClip: "
          f"{out['labelled']} of {len(windows)} windows labelled "
          f"{out['tasks']}, embeddings {tuple(emb.shape)} equal to the "
          f"tower's: {same} ({s:.2f} s)", flush=True)
    if not (out["labelled"] == 6 and same and emb.shape == (6, 1, 512)):
        raise SystemExit(f"phase 26f: auto_annotate failed: {out}")
    return out


def modules_phase(zero_launches, launches_of, run_dir, root, dev=None):
    """Phase 26: log_likelihood, the CLIP visual towers and the VLM cache,
    the export round trip on ``run_dir`` (phase 22's bf16 run),
    verify_checkpoint's rungs, the native hashers, auto_annotate."""
    import gc

    import torch
    dev = dev or torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    t_phase = t = time.perf_counter()
    out["loglik"] = loglik_check(dev)
    phase("phase 26a: log_likelihood (f32, float64; parity refused)", t)
    t = time.perf_counter()
    out["clip"] = clip_check(dev)
    phase("phase 26b: the CLIP visual towers, VLMEmbeddingCache", t)
    t = time.perf_counter()
    out["export"], flat = export_check(run_dir, root, zero_launches,
                                       launches_of, dev)
    phase("phase 26c: export round trip served by parity", t)
    t = time.perf_counter()
    out["verify"] = verify_check(flat, dev)
    phase("phase 26d: verify_checkpoint's rungs", t)
    t = time.perf_counter()
    out["hash"] = hash_check()
    phase("phase 26e: the native hashers", t)
    t = time.perf_counter()
    out["annotate"] = annotate_check(dev)
    phase("phase 26f: auto_annotate", t)
    out["phase_s"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 27: data-parallel training on the card
# ---------------------------------------------------------------------------

# The ranks are processes of this script (``--dp-rank``) in a gloo group
# on cuda:0: NCCL refuses two ranks on one card. 27a-27d run in one pair
# of ranks, in order; 27e runs training_calvin under torchrun (NCCL, a
# world of 1). With two cards or more, 27b also runs on NCCL, one rank per
# card.
DP_WORLD, DP_STEPS = 2, 3
DP_TIMEOUT_S = 420
# 27b: the 2-rank parameters' update may lie no further from the 1-rank
# run's than this many times the 1-rank run's own distance from its
# f32-compute run (the floor rule)
DP_FLOOR_FACTOR = 2.0
# 27b's first step in f32 compute and state: the 2-rank averaged
# gradient's relative L2 distance from the 1-rank run's over the DiT (f32
# rounding of the reductions; a draw taken at a rank's own shape is O(1));
# the encoders' by the floor rule of phase 22d (their fast variance gives
# f32 gradients a spread of a few 1e-2, phase 22d and 27a)
DP_F32_GATE = 1e-3


def kernel_counters():
    """(zero, read) over the seven wrappers' launch counts."""
    from mode_diffusion_policy_tpu_torch.ops.kernels.attn_kernel import (
        fused_attn_block, fused_attn_block_q8)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c, fused_layer_q8c)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp, fused_top2_mlp_q8, fused_top2_mlp_q8c)
    counters = (fused_attn_block_q8, fused_top2_mlp_q8c, fused_layer_q8c,
                fused_dit_q8c, fused_attn_block, fused_top2_mlp,
                fused_top2_mlp_q8)

    def zero():
        for k in counters:
            k.launches = 0

    def read():
        return {k.__name__: k.launches for k in counters}
    return zero, read


def dp_digest(flats):
    """Two int64 sums of each buffer's bit patterns (plain and weighted by
    position): equal on two ranks when the buffers are, bit for bit."""
    import torch
    out = []
    for f in flats:
        w = f.detach().reshape(-1)
        w = w.view({2: torch.int16, 4: torch.int32,
                    8: torch.int64}[w.element_size()])
        s = a = 0
        for lo in range(0, w.numel(), 1 << 26):
            c = w[lo:lo + (1 << 26)].to(torch.int64)
            idx = torch.arange(lo, lo + c.numel(), device=c.device) \
                % 1000003 + 1
            s += int(c.sum())
            a += int((c * idx).sum())
        out.append((s, a))
    return out


def dp_same_on_ranks(obj, mesh):
    """Whether every rank holds the same (picklable) ``obj``."""
    import torch.distributed as dist
    got = [None] * mesh.size
    dist.all_gather_object(got, obj, group=mesh.host_group or mesh.group)
    return all(g == got[0] for g in got)


def dp_rel_update(a, b, p0=None):
    """Relative L2 distance of ``a - p0`` from ``b - p0`` (of ``a`` from
    ``b`` without ``p0``), tensors by name, f32 sums: over the DiT's
    leaves, the encoders' and all."""
    sq = {"dit": [0.0, 0.0], "encoders": [0.0, 0.0]}
    for n, x in a.items():
        ux, uy = x.float(), b[n].float()
        if p0 is not None:
            ux, uy = ux - p0[n].float(), uy - p0[n].float()
        part = sq["dit" if n.startswith("inner_model.") else "encoders"]
        part[0] += float(((ux - uy) ** 2).sum())
        part[1] += float((uy ** 2).sum())
    out = {k: (v[0] / v[1]) ** 0.5 for k, v in sq.items()}
    out["all"] = ((sq["dit"][0] + sq["encoders"][0])
                  / (sq["dit"][1] + sq["encoders"][1])) ** 0.5
    return out


def dp_params(state):
    """A copy of the state's parameters, by name."""
    return {n: t.detach().clone() for n, t in state.params.items()}


@contextlib.contextmanager
def dp_timed_collectives(dev):
    """While open, every ``torch.distributed`` collective the port calls is
    timed, the card synchronised before and after it; yields the running
    ``{"calls": n, "ms": t}``."""
    import torch
    import torch.distributed as dist
    names = ("all_reduce", "broadcast", "all_gather", "all_gather_single",
             "all_gather_into_tensor")
    originals = {n: getattr(dist, n) for n in names if hasattr(dist, n)}
    coll = {"calls": 0, "ms": 0.0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        def call(*a, **k):
            sync()
            t = time.perf_counter()
            out = fn(*a, **k)
            sync()
            coll["ms"] += (time.perf_counter() - t) * 1e3
            coll["calls"] += 1
            return out
        return call

    for n, f in originals.items():
        setattr(dist, n, timed(f))
    try:
        yield coll
    finally:
        for n, f in originals.items():
            setattr(dist, n, f)


def dp_grad(mesh, dev):
    """27a: phase 22d's B=8 batch and draws through one ``make_train_step``
    on 2 ranks x 4 rows (f32 compute and state, TF32 off): the step's
    global loss and the averaged gradient it leaves in ``state.grads``
    (``loop.average_gradients``), against rank 0's float64 gradient of the
    whole batch, under phase 22d's f32 gates."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig)
    from mode_diffusion_policy_tpu_torch.parallel.mesh import (
        batch_sharding, replicate)
    from mode_diffusion_policy_tpu_torch.training.loop import make_train_step
    from mode_diffusion_policy_tpu_torch.training.optim import make_optimizer
    from mode_diffusion_policy_tpu_torch.training.state import TrainState
    batch, model, draws, gen = grad_inputs(dev)
    Bg = len(batch["actions"])
    agent = MoDEAgent(MoDEAgentConfig(dtype=torch.float32, **model),
                      device=dev)
    draws["sigma"] = agent.sample_density(gen, (Bg,), dev)
    replicate([p.data for p in agent.parameters()] + list(agent.buffers()),
              mesh)
    # the step updates the weights in place: rank 0's float64 copy first
    a64 = None
    if mesh.rank == 0:
        a64 = MoDEAgent(MoDEAgentConfig(dtype=torch.float64, **model),
                        device=dev)
        a64.load_state_dict(agent.state_dict())
        a64 = a64.double()
    opt, _ = make_optimizer(dict(agent.named_parameters()), **TRAIN_OPT)
    state = TrainState.create(agent, opt,
                              torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(agent, opt, ema_kwargs=TRAIN_EMA,
                           log_grad_norms=False, device=dev, mesh=mesh)
    rows = batch_sharding(mesh, Bg)
    b = {k: v[rows].float() if v.is_floating_point() else v[rows]
         for k, v in batch.items()}
    d = {"sigma": draws["sigma"][rows], "noise": draws["noise"][rows],
         "gumbel": [g[rows] for g in draws["gumbel"]]}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    with dp_timed_collectives(dev) as coll:
        _, m = step(state, b, draws=d)
    sync()
    grads = dict(state.grads)
    loss = float(m["train/total_loss"])
    out = {"loss": loss, "step_s": time.perf_counter() - t0,
           "collectives": coll, "grad_bytes": sum(
               g.numel() * g.element_size() for g in grads.values())}
    if a64 is not None:
        l64, _ = a64.training_loss(
            {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}, None,
            sigma=draws["sigma"].double(), noise=draws["noise"].double(),
            gumbel=[g.double() for g in draws["gumbel"]])
        l64.backward()
        g64 = {n: p.grad for n, p in a64.named_parameters()}
        res = grad_errors(loss, grads, float(l64.detach()), g64)
        out.update(res, f64_loss=float(l64.detach()),
                   gates={k: {"value": v, "gate": g}
                          for k, (v, g) in f32_grad_gates(res).items()})
        del a64, g64
    del agent, state, grads
    return out


def dp_run(mesh, dev, *, zero1=False, dtype=None, f32_state=False,
           steps=DP_STEPS, time_collectives=False):
    """``steps`` train steps at the global batch TRAIN_B with the shipped
    settings (dropouts, augmentation from uint8 frames, the bf16
    stochastic-rounding state, or with ``f32_state`` the f32 one) on
    ``mesh`` (this rank's rows), replicated or ZeRO-1, compute dtype
    ``dtype`` (default bf16). The state, the initial parameters (by
    name) and the record: ms per step, the parameters' digests and the
    generator's state after each step, the losses, peak memory, digests of
    each row of the first step's augmented frames; with ``f32_state`` also
    a copy of the first step's averaged gradient (``grads1``, by name);
    with ``time_collectives`` the last step also times every
    collective."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig)
    from mode_diffusion_policy_tpu_torch.parallel.mesh import (replicate,
                                                               shard_batch)
    from mode_diffusion_policy_tpu_torch.training.loop import make_train_step
    from mode_diffusion_policy_tpu_torch.training.optim import make_optimizer
    from mode_diffusion_policy_tpu_torch.training.state import TrainState
    from mode_diffusion_policy_tpu_torch.training_common import (
        make_train_preprocess, parse_camera_pipelines)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    agent = MoDEAgent(MoDEAgentConfig(dtype=dtype or torch.bfloat16,
                                      **TRAIN_MODEL), device=dev)
    replicate([p.data for p in agent.parameters()] + list(agent.buffers()),
              mesh)
    sr = {} if f32_state else dict(stochastic_round=True, sr_noise="hw")
    opt, _ = make_optimizer(dict(agent.named_parameters()), **TRAIN_OPT,
                            **sr)
    bf16 = {} if f32_state else dict(param_dtype=torch.bfloat16,
                                     ema_dtype=torch.bfloat16)
    state = TrainState.create(
        agent, opt, torch.Generator(device=dev).manual_seed(0),
        zero1=mesh if zero1 else None, **bf16)
    p0 = dp_params(state)
    rec = {"step_ms": [], "digests": [], "rng": [], "loss": [],
           "rows": None, "frame_rows": None}
    augment = make_train_preprocess(parse_camera_pipelines(TRAIN_TRANSFORMS))

    def preprocess(batch, gen):
        out = augment(batch, gen)
        if rec["frame_rows"] is None:
            rec["frame_rows"] = [dp_digest([x]) for cam in (
                "rgb_static", "rgb_gripper") for x in out[cam]]
        return out

    step = make_train_step(agent, opt, ema_kwargs=TRAIN_EMA,
                           preprocess_fn=preprocess, device=dev, mesh=mesh)
    batches = train_batches(torch.Generator(device=dev).manual_seed(7),
                            steps, TRAIN_B, dev)
    for i, b in enumerate(batches):
        b = shard_batch(b, mesh) if mesh.size > 1 else b
        rec["rows"] = len(b["actions"])
        last = time_collectives and i == len(batches) - 1
        with (dp_timed_collectives(dev) if last
              else contextlib.nullcontext()) as coll:
            sync()
            t = time.perf_counter()
            _, m = step(state, b)
            sync()
            ms = (time.perf_counter() - t) * 1e3
        if last:
            rec["timed_step_ms"] = [ms]
            rec["collectives"] = coll
        else:
            rec["step_ms"].append(ms)
        rec["loss"].append(float(m["train/total_loss"]))
        rec["digests"].append(dp_digest(state.params.flats))
        rec["rng"].append(state.rng.get_state().tolist())
        if f32_state and i == 0:
            rec["grads1"] = {n: g.clone() for n, g in state.grads.items()}
    rec["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if cuda else None)
    return agent, state, p0, rec


def dp_sr_bits_ms(state, dev, reps=3):
    """The stochastic-rounding bits of one update, drawn as the ZeRO-1
    update draws them (every chunk of the whole buffer, each rank keeping
    its share) against the chunks of this rank's share alone (the most a
    skip-ahead in the generator could save), ms on the card."""
    import torch
    from mode_diffusion_policy_tpu_torch.training.optim import (
        CHUNK, draw_sr_bits)
    mu = state.opt_state.mu
    gen = torch.Generator(device=dev).manual_seed(1)

    def draw(share):
        for gi, g in enumerate(mu.layout.groups):
            lo, hi = mu.span(gi) if share else (0, g.numel)
            for c_lo in range(0, g.numel, CHUNK):
                c_hi = min(c_lo + CHUNK, g.numel)
                if c_hi > lo and c_lo < hi:
                    draw_sr_bits((c_hi - c_lo,), gen, "hw", dev)

    out = {}
    for name, share in (("whole_buffer", False), ("share_only", True)):
        draw(share)
        torch.cuda.synchronize(dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            draw(share)
        t1.record()
        torch.cuda.synchronize(dev)
        out[name] = t0.elapsed_time(t1) / reps
    return out


def dp_serve(mesh, dev, ema, batch_stats):
    """27d: the gathered EMA and the running statistics in a new agent,
    served by ``parity`` at b=128 on this rank: the same observation and
    noise on every rank (seeded), the launch counts of one chunk and the
    actions' digest."""
    import torch
    from mode_diffusion_policy_tpu_torch.models.agent import (
        MoDEAgent, MoDEAgentConfig, RolloutPolicy)
    from mode_diffusion_policy_tpu_torch.ops.image import preprocess_camera
    zero, read = kernel_counters()
    agent = MoDEAgent(MoDEAgentConfig(dtype=torch.bfloat16, **TRAIN_MODEL),
                      device=dev)
    sd = {n: t.float() for n, t in ema.items()}
    sd.update({n: t.float() for n, t in batch_stats.items()})
    agent.load_state_dict(sd)
    with torch.no_grad():
        policy = RolloutPolicy.with_serving_mode(agent, mode="parity",
                                                 seed=0)
        gen = torch.Generator(device=dev).manual_seed(9)
        B = 128
        obs = {k: preprocess_camera(torch.randint(
            0, 256, (B, 1, hw, hw, 3), generator=gen, device=dev,
            dtype=torch.uint8), size=TRAIN_IMG)
            for k, hw in (("rgb_static", STATIC_HW),
                          ("rgb_gripper", GRIPPER_HW))}
        goal = {"lang_emb": torch.randn(B, 1, 512, generator=gen,
                                        device=dev)}
        noise = torch.randn(B, 10, 7, generator=gen, device=dev)
        zero()
        actions = policy.predict_chunk(obs, goal, noise)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        counts = read()
    return {"launches": counts.pop("fused_layer_q8c"), "others": counts,
            "finite": bool(torch.isfinite(actions).all()),
            "digest": dp_digest([actions.float()]),
            "shape": list(actions.shape)}


def dp_rank_cases(mesh, dev, cases):
    """A rank's sub-phases (``cases`` of grad, train, zero1, serve), in
    order; returns their results."""
    import gc

    import torch
    import torch.distributed as dist
    from mode_diffusion_policy_tpu_torch.parallel.mesh import barrier
    out = {"rank": mesh.rank, "world": mesh.size, "backend": mesh.backend,
           "device": str(dev)}
    cuda = dev.type == "cuda"

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def mark(name, t):
        print(f"  rank {mesh.rank}: {name} ({time.perf_counter() - t:.1f} "
              "s)", flush=True)

    if "grad" in cases:
        t = time.perf_counter()
        with torch.enable_grad():
            out["grad"] = dp_grad(mesh, dev)
        free()
        mark("27a", t)
    if "train" in cases:
        t = time.perf_counter()
        agent, state, p0, rec = dp_run(mesh, dev, time_collectives=True)
        rec["same_on_ranks"] = [dp_same_on_ranks(d, mesh)
                                for d in rec["digests"]]
        p2 = dp_params(state)
        held = {k: sum(t.numel() * t.element_size() for t in x.flats)
                for k, x in (("mu", state.opt_state.mu),
                             ("nu", state.opt_state.nu),
                             ("ema", state.ema_params))}
        rec["state_bytes"] = held
        del agent, state
        free()
        out["train"] = rec
        # the first step in f32 compute and state (TF32 off): its draws and
        # reductions checked to f32 rounding against one rank's
        agent, state, q0, rf = dp_run(mesh, dev, dtype=torch.float32,
                                      f32_state=True, steps=1)
        rf["same_on_ranks"] = [dp_same_on_ranks(d, mesh)
                               for d in rf["digests"]]
        q2, g2 = dp_params(state), rf.pop("grads1")
        del agent, state
        free()
        rec["f32"] = rf
        frames = [None] * mesh.size
        dist.all_gather_object(frames, rec["frame_rows"],
                               group=mesh.host_group or mesh.group)
        if mesh.rank == 0:
            from mode_diffusion_policy_tpu_torch.parallel.mesh import Mesh

            def one_rank(**kw):
                agent, state, _, r = dp_run(Mesh(device=dev), dev, **kw)
                params = dp_params(state)
                del agent, state
                free()
                return params, r

            p1, r1 = one_rank()
            pf, _ = one_rank(dtype=torch.float32)
            rec["vs_one_rank"] = dp_rel_update(p2, p1, p0)["all"]
            rec["one_rank_vs_f32_compute"] = dp_rel_update(p1, pf, p0)["all"]
            rec["rng_as_one_rank"] = rec["rng"] == r1["rng"]
            # each camera's rows: rank 0's, then rank 1's, as one rank's
            half = rec["rows"]
            rec["frames_as_one_rank"] = all(
                sum((f[c * half:(c + 1) * half] for f in frames), [])
                == r1["frame_rows"][c * TRAIN_B:(c + 1) * TRAIN_B]
                for c in range(2))
            rec["one_rank"] = {k: r1[k] for k in ("step_ms", "loss",
                                                  "peak_gib")}
            del p1, pf
            q1, rq = one_rank(dtype=torch.float32, f32_state=True, steps=1)
            rf["vs_one_rank"] = dp_rel_update(q2, q1, q0)
            rf["grads1_vs_one_rank"] = dp_rel_update(g2, rq.pop("grads1"))
            rf["rng_as_one_rank"] = rf["rng"] == rq["rng"]
            rf["one_rank_step_ms"] = rq["step_ms"]
            del q1
        del p2, p0, q2, q0, g2
        free()
        barrier(mesh)
        mark("27b", t)
    if "zero1" in cases:
        t = time.perf_counter()
        agent, state, p0, rec = dp_run(mesh, dev, zero1=True)
        rec["same_as_replicated"] = (
            "train" in out and rec["digests"] == out["train"]["digests"])
        held = {k: x.nbytes() for k, x in (("mu", state.opt_state.mu),
                                            ("nu", state.opt_state.nu),
                                            ("ema", state.ema_params))}
        rec["state_bytes"] = held
        if cuda and mesh.rank == 0:
            rec["sr_bits_ms"] = dp_sr_bits_ms(state, dev)
        ema = state.full_ema()
        stats = {n: b.detach().clone() for n, b in state.batch_stats.items()}
        del agent, state, p0
        free()
        out["zero1"] = rec
        mark("27c", t)
        if "serve" in cases:
            t = time.perf_counter()
            s = dp_serve(mesh, dev, ema, stats)
            s["same_on_ranks"] = dp_same_on_ranks(s["digest"], mesh)
            s["ema_same_on_ranks"] = dp_same_on_ranks(
                dp_digest(list(ema.flats)), mesh)
            out["serve"] = s
            del ema, stats
            free()
            mark("27d", t)
    return out


def dp_rank(argv):
    """One rank of phase 27 (``chip_smoke.py --dp-rank <cases> <rank>
    <world> <port> <out_dir> <backend> <device>``): the torchrun variables
    set, the group started by ``init_distributed``, the cases run, the
    results written to ``<out_dir>/rank<r>.pt``."""
    cases, rank, world, port, out_dir, backend, device = argv
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                      LOCAL_WORLD_SIZE=world, MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    import torch
    from mode_diffusion_policy_tpu_torch.parallel.mesh import (
        destroy_distributed, init_distributed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = None if device == "auto" else torch.device(device)
    mesh = init_distributed(backend, device=dev)
    try:
        out = dp_rank_cases(mesh, mesh.device, cases.split(","))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        destroy_distributed()


def dp_spawn(cases, backend, device, out_dir):
    """Run DP_WORLD ranks of this script (``--dp-rank``) and wait for them
    (DP_TIMEOUT_S seconds at most); returns each rank's results and its
    output. Every rank is stopped before it returns; a failed rank is a
    SystemExit with the ranks' output."""
    import socket

    import torch
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([here, env.get("PYTHONPATH", "")])
    procs = []
    for r in range(DP_WORLD):
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", cases,
             str(r), str(DP_WORLD), str(port), out_dir, backend, device],
            env=env, cwd=here, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + DP_TIMEOUT_S
    failed = None
    try:
        for r, (p, _) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed = f"rank {r} still ran after {DP_TIMEOUT_S} s"
                break
            if rc != 0:
                failed = f"rank {r} exited with {rc}"
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = [open(os.path.join(out_dir, f"rank{r}.log")).read()
            for r in range(DP_WORLD)]
    if failed:
        raise SystemExit(f"phase 27: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{lg[-4000:]}" for r, lg in enumerate(logs)))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(DP_WORLD)], logs


def dp_cli(argv):
    """27e inside torchrun (``chip_smoke.py --dp-cli <store> <log_dir>
    <out.json>``): ``training_calvin.main`` on the store for one capped
    epoch with phase 24's arguments but no rollout hook, probed as phase
    24's runs; its world and ms per step to ``out.json``."""
    store, log_dir, out_json = argv
    from mode_diffusion_policy_tpu_torch import training_calvin
    t0 = time.perf_counter()
    with cli_probe() as runs:
        run = training_calvin.main(cli_argv(store, log_dir, 1) + [
            "callbacks.rollout_lh.fake_env=false"])
    rec = runs[-1]
    mesh = rec["trainer"].mesh
    out = {"world": mesh.size, "rank": mesh.rank, "device": str(mesh.device),
           "end_step": run.state.step, "losses": rec["loss"],
           "step_ms": rec["step_ms"], "interval_ms": rec["interval_ms"],
           "cli_step_ms_median_3_8": statistics.median(
               rec["interval_ms"][1:]),
           "run_s": time.perf_counter() - t0,
           "files": sorted(os.listdir(run.run_dir))}
    with open(out_json, "w") as f:
        json.dump(out, f)


def dp_phase(smi, root, phase24_step_ms=None):
    """Phase 27: data-parallel training of the flagship on the card:
    27a-27d in two gloo ranks on cuda:0 (NCCL refuses two ranks on one
    card), 27b again on NCCL with one rank per card where there are two
    cards or more, 27e training_calvin under torchrun (NCCL, a world of
    1) on phase 24's store under ``root`` (written and extracted here when
    it is missing: phase 27 alone). Returns the phase's results; a failed
    gate is a SystemExit."""
    import pathlib

    import torch
    root = pathlib.Path(root)
    t_phase = time.perf_counter()
    if not (root / "calvin").exists():
        from mode_diffusion_policy_tpu_torch.data import preprocess
        write_store(root / "calvin")
        for split in CLI_EPISODES:
            preprocess.main(["--in-root", str(root / "calvin" / split)])
    n_cards = torch.cuda.device_count()
    print(f"  phase 27 ranks: {DP_WORLD} processes on cuda:0 with the gloo "
          "backend, named: NCCL takes one card per rank and refuses two "
          f"ranks on one card ({n_cards} card(s) visible)", flush=True)
    ranks, logs = dp_spawn("grad,train,zero1,serve", "gloo", "cuda:0",
                           str(root / "dp_gloo"))
    for line in logs[0].splitlines():
        if line.startswith("  rank"):
            print(line, flush=True)
    out = {"card": smi, "world": DP_WORLD, "backend": "gloo",
           "device": "cuda:0", "cards": n_cards}
    r0, r1 = ranks
    g = r0["grad"]
    out["27a"] = {k: g[k] for k in ("loss", "f64_loss", "gates",
                                    "dit_worst_leaf", "encoders_worst_leaf",
                                    "dit_total_rel", "encoders_total_rel",
                                    "step_s", "collectives", "grad_bytes")}
    print("  27a: make_train_step's averaged gradient over 2 ranks x 4 rows "
          "vs float64 (B=8, f32 compute and state, TF32 off): "
          + "; ".join(f"{k} {v['value']:.2e} (gate {v['gate']:.2e})"
                      for k, v in g["gates"].items())
          + f"; losses equal on both ranks {g['loss'] == r1['grad']['loss']}"
          f"; the step {g['step_s']:.2f} s, of it "
          f"{g['collectives']['ms'] / 1e3:.2f} s in "
          f"{g['collectives']['calls']} collectives (the gradient "
          f"{g['grad_bytes'] / 1e9:.2f} GB) ({smi})", flush=True)
    tr, tf = r0["train"], r0["train"]["f32"]
    same = all(tr["same_on_ranks"]) and all(r1["train"]["same_on_ranks"])
    fsame = all(tf["same_on_ranks"]) and all(
        r1["train"]["f32"]["same_on_ranks"])
    gate = DP_FLOOR_FACTOR * tr["one_rank_vs_f32_compute"]
    out["27b"] = {
        "step_ms": [r["train"]["step_ms"] for r in ranks],
        "timed_step_ms": [r["train"]["timed_step_ms"] for r in ranks],
        "collectives": [r["train"]["collectives"] for r in ranks],
        "peak_gib": [r["train"]["peak_gib"] for r in ranks],
        "rows": [r["train"]["rows"] for r in ranks],
        "losses": tr["loss"], "params_same_on_ranks": same,
        "vs_one_rank": tr["vs_one_rank"],
        "one_rank_vs_f32_compute": tr["one_rank_vs_f32_compute"],
        "gate": gate, "one_rank": tr["one_rank"],
        "rng_as_one_rank": tr["rng_as_one_rank"],
        "frames_as_one_rank": tr["frames_as_one_rank"],
        "state_bytes": tr["state_bytes"],
        "f32": {"vs_one_rank": tf["vs_one_rank"],
                "gates": [DP_F32_GATE, GRAD_F32_ENC_TOTAL_REL],
                "grads1_vs_one_rank": tf["grads1_vs_one_rank"],
                "rng_as_one_rank": tf["rng_as_one_rank"],
                "params_same_on_ranks": fsame, "step_ms": tf["step_ms"],
                "one_rank_step_ms": tf["one_rank_step_ms"],
                "peak_gib": [r["train"]["f32"]["peak_gib"] for r in ranks]}}
    print(f"  27b: {DP_STEPS} steps at global B={TRAIN_B} (2 ranks x "
          f"{tr['rows']}), bf16 state, dropouts and augmentation on: "
          f"parameters bit-equal on both ranks after every step {same}; "
          f"update vs the 1-rank run {tr['vs_one_rank']:.3e} (gate "
          f"{gate:.3e} = {DP_FLOOR_FACTOR} x the 1-rank run's distance "
          f"from its f32-compute run {tr['one_rank_vs_f32_compute']:.3e}); "
          f"ms per step 2 ranks {[round(x, 1) for x in tr['step_ms']]} "
          f"(rank 0; steps 1-2), 1 rank at B={TRAIN_B} "
          f"{[round(x, 1) for x in tr['one_rank']['step_ms']]}; the last "
          f"step with every collective timed "
          f"{tr['timed_step_ms'][0]:.1f} ms, of it "
          f"{tr['collectives']['ms']:.1f} ms in "
          f"{tr['collectives']['calls']} collectives (rank 0); peak "
          f"{[round(r['train']['peak_gib'], 2) for r in ranks]} GiB per "
          f"rank, 1 rank {tr['one_rank']['peak_gib']:.2f} GiB; generator "
          f"states after each step as the 1-rank run's "
          f"{tr['rng_as_one_rank']}; step 1's augmented frames, row for "
          f"row, bit-equal to the 1-rank run's {tr['frames_as_one_rank']} "
          f"({smi})", flush=True)
    print(f"  27b's first step in f32 compute and state, TF32 off, vs the "
          "1-rank run (relative L2, DiT / encoders): the averaged gradient "
          f"{tf['grads1_vs_one_rank']['dit']:.3e} / "
          f"{tf['grads1_vs_one_rank']['encoders']:.3e} (gates "
          f"{DP_F32_GATE:.0e} / {GRAD_F32_ENC_TOTAL_REL:.2e}), the update "
          f"{tf['vs_one_rank']['dit']:.3e} / "
          f"{tf['vs_one_rank']['encoders']:.3e}; "
          f"generator states as the 1-rank run's {tf['rng_as_one_rank']}; "
          f"parameters bit-equal on both ranks {fsame}; ms per step 2 "
          f"ranks {[round(x, 1) for x in tf['step_ms']]}, 1 rank "
          f"{[round(x, 1) for x in tf['one_rank_step_ms']]}; peak "
          f"{[round(r['train']['f32']['peak_gib'], 2) for r in ranks]} GiB "
          f"per rank ({smi})", flush=True)
    z = r0["zero1"]
    zsame = z["same_as_replicated"] and r1["zero1"]["same_as_replicated"]
    rep_b, z_b = sum(tr["state_bytes"].values()), \
        sum(z["state_bytes"].values())
    out["27c"] = {"same_as_replicated": zsame,
                  "state_bytes": {"zero1": [r["zero1"]["state_bytes"]
                                            for r in ranks],
                                  "replicated": tr["state_bytes"]},
                  "share": z_b / rep_b,
                  "peak_gib": [r["zero1"]["peak_gib"] for r in ranks],
                  "step_ms": [r["zero1"]["step_ms"] for r in ranks],
                  "sr_bits_ms": z["sr_bits_ms"]}
    print(f"  27c: ZeRO-1 on 2 ranks, the same {DP_STEPS} steps: parameters "
          f"bit-equal to 27b's replicated run after every step {zsame}; "
          f"moments and EMA held per rank {z_b / 1e9:.3f} GB vs "
          f"{rep_b / 1e9:.3f} GB replicated ({z_b / rep_b:.3f}); peak "
          f"{[round(r['zero1']['peak_gib'], 2) for r in ranks]} GiB per "
          f"rank; ms per step {[round(x, 1) for x in z['step_ms']]}; the "
          f"SR bits of one update: whole buffer "
          f"{z['sr_bits_ms']['whole_buffer']:.3f} ms, this rank's share "
          f"alone {z['sr_bits_ms']['share_only']:.3f} ms ({smi})",
          flush=True)
    s0, s1 = r0["serve"], r1["serve"]
    out["27d"] = {"launches": [s0["launches"], s1["launches"]],
                  "others": s0["others"], "actions_equal": s0["digest"]
                  == s1["digest"] and s0["same_on_ranks"],
                  "ema_same_on_ranks": s0["ema_same_on_ranks"]}
    print(f"  27d: the gathered EMA served by parity at b=128 on each rank: "
          f"fused_layer_q8c launches {out['27d']['launches']} per chunk, "
          f"others {s0['others']}; actions bit-equal on both ranks "
          f"{out['27d']['actions_equal']}, the EMA too "
          f"{s0['ema_same_on_ranks']}", flush=True)
    phase("phase 27a-d: the gradient, the replicated and ZeRO-1 steps and "
          "the served EMA on 2 gloo ranks", t_phase)

    if n_cards >= 2:
        t = time.perf_counter()
        nccl, _ = dp_spawn("train", "nccl", "auto",
                           str(root / "dp_nccl"))
        n0 = nccl[0]["train"]
        out["27b_nccl"] = {
            "step_ms": n0["step_ms"], "collectives": n0["collectives"],
            "params_same_on_ranks": all(n0["same_on_ranks"]),
            "vs_one_rank": n0["vs_one_rank"], "peak_gib": n0["peak_gib"]}
        print(f"  27b on NCCL, one rank per card: ms per step "
              f"{[round(x, 1) for x in n0['step_ms']]}, collectives "
              f"{n0['collectives']['ms']:.1f} ms in "
              f"{n0['collectives']['calls']} calls; parameters bit-equal "
              f"on both ranks {all(n0['same_on_ranks'])}; vs the 1-rank "
              f"run {n0['vs_one_rank']:.3e} ({smi})", flush=True)
        phase("phase 27b: NCCL, one rank per card", t)
    else:
        print("  27b on NCCL: not run (one card; NCCL takes one card per "
              "rank)", flush=True)

    t = time.perf_counter()
    out_json = str(root / "dp_cli.json")
    t_cli = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", os.path.abspath(__file__), "--dp-cli",
         str(root / "calvin"), str(root / "dp_cli_runs"), out_json],
        cwd=here, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    if proc.returncode != 0:
        raise SystemExit(f"phase 27e: torchrun training_calvin failed "
                         f"({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                         f"{proc.stderr[-3000:]}")
    with open(out_json) as f:
        cli = json.load(f)
    cli["torchrun_s"] = time.perf_counter() - t_cli
    backend = re.findall(r"data parallel: rank (\d+) of (\d+), (\w+) backend",
                         proc.stderr + proc.stdout)
    cli["logged"] = backend
    out["27e"] = cli
    print(f"  27e: torchrun --standalone --nproc_per_node=1 training_calvin:"
          f" {backend or 'no data-parallel line logged'}, world "
          f"{cli['world']}, {cli['end_step']} steps in "
          f"{cli['run_s']:.1f} s of the CLI ({cli['torchrun_s']:.1f} s with "
          f"the launcher), ms per step "
          f"{cli['cli_step_ms_median_3_8']:.1f} (median of steps 3-8, "
          f"loader included) beside phase 24's "
          f"{'(not run)' if phase24_step_ms is None else phase24_step_ms}"
          f" ({smi})", flush=True)
    phase("phase 27e: training_calvin under torchrun (NCCL, world of 1)", t)
    out["phase_s"] = time.perf_counter() - t_phase
    bad = [k for k, ok in (
        ("27a gates", all(v["value"] <= v["gate"]
                          for v in g["gates"].values())),
        ("27a loss on ranks", g["loss"] == r1["grad"]["loss"]),
        ("27b ranks", same),
        ("27b vs one rank", tr["vs_one_rank"] <= gate),
        ("27b f32 vs one rank", fsame
         and tf["grads1_vs_one_rank"]["dit"] <= DP_F32_GATE
         and tf["grads1_vs_one_rank"]["encoders"]
         <= GRAD_F32_ENC_TOTAL_REL),
        ("27b generator", tr["rng_as_one_rank"] and tf["rng_as_one_rank"]),
        ("27b frames", tr["frames_as_one_rank"]),
        ("27b losses", all(math.isfinite(x) for x in tr["loss"])),
        ("27c", zsame and z_b < 0.51 * rep_b),
        ("27d", s0["launches"] == s1["launches"] == 120
         and not any(s0["others"].values()) and s0["finite"]
         and out["27d"]["actions_equal"] and s0["ema_same_on_ranks"]),
        ("27b nccl", "27b_nccl" not in out
         or out["27b_nccl"]["params_same_on_ranks"]),
        ("27e", cli["world"] == 1 and cli["end_step"] == CLI_STEPS
         and backend and backend[0][2] == "nccl"
         and all(math.isfinite(x) for x in cli["losses"]))) if not ok]
    if bad:
        raise SystemExit(f"phase 27 failed its gates: {bad}: "
                         f"{json.dumps(out, default=str)[:3000]}")
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
        fused_attn_block, fused_attn_block_q8)
    from mode_diffusion_policy_tpu_torch.ops.kernels.layer_kernel import (
        fused_dit_q8c, fused_layer_q8c, fused_layer_q8c_ref)
    from mode_diffusion_policy_tpu_torch.ops.kernels.moe_kernel import (
        fused_top2_mlp, fused_top2_mlp_q8, fused_top2_mlp_q8c)
    # every kernel's launch count; each served path is driven with all of
    # them set to 0 just before and read just after
    zero_launches, launches_of = kernel_counters()
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
                    not np.isfinite(act).all():
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
        plain, exact = plain_evals(
            dit, lambda: policy.predict_chunk(obs, goal, noise), 2)

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
                    not np.isfinite(act).all():
                raise SystemExit(f"{mode}: bad action {tuple(act.shape)}")
        if launches != want_launches or any(counts.values()):
            raise SystemExit(
                f"{mode}: {launches} megakernel launches (expected "
                f"{want_launches}), other kernels {counts} (expected 0)")
        kern = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
        again = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
        plain, exact, exact_all = plain_evals(
            dit, lambda: policy.predict_chunk(r["obs"], r["goal"],
                                              r["noise"]))

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
                not np.isfinite(act).all():
            raise SystemExit(f"max-throughput: bad action {tuple(act.shape)}")
    if mt_launches != {**dict.fromkeys(mt_launches, 0),
                       "fused_attn_block_q8": want_launches,
                       "fused_top2_mlp_q8c": want_launches}:
        raise SystemExit(f"max-throughput b=128, one chunk: launches "
                         f"{mt_launches}, expected {want_launches} attention "
                         f"and MoE, 0 layer and 0 megakernel")
    kern = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
    again = policy.predict_chunk(r["obs"], r["goal"], r["noise"])
    evals = dict(zip(("plain", "exact", "exact_all"), plain_evals(
        dit, lambda: policy.predict_chunk(r["obs"], r["goal"], r["noise"]))))

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

    # ---- phase 22: training -------------------------------------------------
    # the serving agents are freed first: the training state takes ~20 B per
    # parameter, and the f64 gradient check a float64 copy of the model
    del agent, policy, policies, dit, pdit, blk, a, deq, deq_layers
    import gc
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the variants phase: every model option, served through the
    # kernels at the flagship widths ------------------------------------
    t = time.perf_counter()
    variants = variants_phase(zero_launches, launches_of, dev)
    phase("variants: goal_routing_r34 (parity, b1-latency, b1-latency-max, "
          "max-throughput), shared_r18 (trained, parity), identity_cross, "
          "plain_paths", t)

    # ---- the long-token phase: more than 16 tokens per sample ------------
    t = time.perf_counter()
    long_tokens = long_tokens_phase(zero_launches, launches_of, dev)
    phase("long tokens: more than 16 tokens per sample", t)
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train = train_phase(smi, zero_launches, launches_of, root)
        # ---- phase 23: evaluation on the trained weights -------------------
        evaluation = eval_phase(smi, zero_launches, launches_of, root,
                                timing[1]["chunk_ms"])
        # ---- phase 24: the training CLI on an episode store on disk ------
        cli = cli_phase(smi, zero_launches, launches_of, root,
                        train["bf16_full_state"]["step_ms_median_3_8"])
        # ---- phase 25: LIBERO, the single-task evaluator ------------------
        libero = libero_phase(smi, zero_launches, launches_of, root)
        # ---- phase 26: the remaining modules ------------------------------
        modules = modules_phase(zero_launches, launches_of, f"{root}/bf16",
                                root)
        # ---- phase 27: data-parallel training -----------------------------
        dp = dp_phase(smi, root, cli["cli_step_ms_median_3_8"])
    finally:
        shutil.rmtree(root, ignore_errors=True)

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
        "eval": {k: evaluation["parity"][k] for k in (
            "launches", "launches_per_chunk", "chunks",
            "action_mae_vs_reference", "tol")},
        "eval_is": "evaluate_calvin --serving-mode parity, b=1, "
                   f"{EVAL_SEQUENCES} chains on the fake env, phase 22's "
                   "trained EMA weights",
        "libero_eval": {k: libero["evaluate"]["parity"][k] for k in (
            "launches", "launches_per_chunk", "chunks",
            "action_mae_vs_reference", "tol")},
        "chunk_split_b128": split_b128,
        "per_sample_cond": variants["cond_rows"]["fused_layer_q8c"],
        "dp_serve": {"launches_per_rank": dp["27d"]["launches"],
                     "is": "phase 27d: the EMA trained by 2 ZeRO-1 ranks, "
                           "served by parity at b=128 on each rank"},
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
        "per_sample_cond": variants["cond_rows"]["fused_dit_q8c"],
        "eval": {k: evaluation["b1-latency"][k] for k in (
            "launches", "launches_per_chunk", "chunks",
            "action_mae_vs_reference", "tol")},
        "eval_is": "evaluate_calvin --serving-mode b1-latency, b=1, "
                   f"{EVAL_SEQUENCES} chains on the fake env, phase 22's "
                   "trained EMA weights",
        "libero_eval": {k: libero["evaluate"]["b1-latency"][k] for k in (
            "launches", "launches_per_chunk", "chunks",
            "action_mae_vs_reference", "tol")},
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
    # the long-token phase's launchers at T in LONG_T and served cells at
    # T=20, on the entries of the five attention-bearing kernels
    for k in kernels:
        names, cells = {
            "fused_layer_q8c": (("fused_layer_q8c", "fused_layer_q8c_qattn"),
                                ("parity/b128", "parity/b1")),
            "fused_dit_q8c": (("fused_dit_q8c", "fused_dit_q8c_int8"),
                              ("b1-latency/b1", "b1-latency-max/b1")),
            "fused_attn_block_q8": (("fused_attn_block_q8",),
                                    ("max-throughput/b128",)),
            "fused_attn_block": (("fused_attn_block",),
                                 (f"{BF16_CONFIG}/b128",)),
        }.get(k["name"], ((), ()))
        if names:
            k["long_tokens"] = {
                "tokens": LONG_T, "cell_tokens": long_tokens["tokens"],
                "launchers": {n: long_tokens["kernels"][n] for n in names},
                "cells": {n: long_tokens["cells"][n] for n in cells}}
    phase("done", T0)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"eval": evaluation}), flush=True)
    print(json.dumps({"cli": cli}), flush=True)
    print(json.dumps({"libero": libero}, default=str), flush=True)
    print(json.dumps({"variants": variants}), flush=True)
    print(json.dumps({"long_tokens": long_tokens}), flush=True)
    print(json.dumps({"modules": modules}), flush=True)
    print(json.dumps({"dp": dp}, default=str), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    return {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}


def descendants():
    """Pids of the live processes below this one, read from /proc
    (zombies left out: they hold nothing and vanish with their parent)."""
    kids = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if state != "Z":
            kids.setdefault(int(ppid), []).append(int(d))
    out, todo = [], [os.getpid()]
    while todo:
        for pid in kids.get(todo.pop(), ()):
            out.append(pid)
            todo.append(pid)
    return out


def stop_children(timeout=10.0):
    """Stop every process this script started that still runs, and wait
    until none is left: the loader's fork server and multiprocessing's
    resource tracker (which would otherwise outlive the script by a
    moment), then anything else below this process, killed. Raises
    SystemExit if a process survives ``timeout`` seconds."""
    for p in multiprocessing.active_children():
        p.terminate()
        p.join(timeout=5)
    try:
        from mode_diffusion_policy_tpu_torch.data.datamodule import \
            stop_helper_processes
    except ImportError:
        pass
    else:
        stop_helper_processes()
    killed = descendants()
    for pid in killed:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + timeout
    while True:
        for pid in killed:  # reap the ones that were this script's children
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, os.WNOHANG)
        left = descendants()
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if killed:
        print(f"chip_smoke: killed {len(killed)} leftover processes at exit: "
              f"{killed}", file=sys.stderr, flush=True)
    if left:
        raise SystemExit(f"chip_smoke: processes {left} outlived the script")


if __name__ == "__main__":
    # the ranks of phase 27 are processes of this script
    workers = {"--dp-rank": dp_rank, "--dp-cli": dp_cli}
    if sys.argv[1:2] and sys.argv[1] in workers:
        try:
            workers[sys.argv[1]](sys.argv[2:])
        finally:
            stop_children()
        sys.exit(0)
    try:
        result = main()
    finally:
        stop_children()
    print(json.dumps(result), flush=True)
