"""Where the DiT megakernel (``fused_dit_q8c``) spends one step, on one NVIDIA GPU.

    python3 scripts/dit_stage_variants_torch.py

Builds edited copies of ``mode_diffusion_policy_tpu_torch/csrc/fused_dit_q8c.cu``
under ``build/dit_variants/<VARIANT>`` (listed in .gitignore), one ``nvcc``
per variant, all started together, and times one 12-layer launch (the
kernel bench's seeded layer, stacked 12 times: bf16 projections) at b=1 and
b=128 x 14 tokens under each:

- ``base``: the kernel as it is, with a device switch that skips the work
  of chosen stages (their grid barriers stay): ``skip_<stage>`` is the step
  without that stage's work, ``barriers`` the step with none (the grid
  barriers alone), so ``base - skip_<stage>`` is the stage's share;
- ``prefetch``: the producer thread, once it has issued a GEMM stage's
  loads, prefetches into L2 (``cp.async.bulk.prefetch.tensor``) the weight
  boxes of its tiles of the next GEMM stage, before the grid barrier;
- ``noepi``: the GEMM stages' epilogues skipped (their loads and products
  alone);
- ``noprod``: the GEMM stages' products skipped (their loads and epilogues
  alone);
- ``trace``: the kernel as it is, with clock reads in the GEMM stages of
  two CTAs (0, which has QKV, c_proj and MoE tiles at b=1, and 100, which
  has MoE tiles only): for each stage of one step, the us from its start
  to the column operands staged, the first and the last k-step's data
  arrived, the products done and the epilogue done (SM clock, scaled by
  %globaltimer), averaged over the 12 layers.

The skips and the noepi / noprod variants compute wrong results: they only
split the step's time. ``prefetch`` and ``trace`` compute the kernel's
result, which is checked bit for bit against ``base``. Prints one JSON line with the card's
name and power limit; needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("ln1", "qkv", "attn", "o_quant", "c_proj", "ln2_quant", "moe_up",
          "act_quant", "moe_down", "moe_sum")
# the statement of each stage's work in the consumer (and, for the GEMM
# stages, the producer) that the skip switch guards, by stage bit
SKIPS = {
    0: ["    for (int i = team; i < M; i += teams) {\n      if constexpr (Q8)"],
    1: ["    wg::consume<typename O::Qkv>", "      wg::produce<typename O::Qkv>"],
    2: ["    for (int i = team; i < n_attn; i += teams) {"],
    3: ["      for (int i = team; i < M; i += teams) {\n        quant_f32_row"],
    4: ["    wg::consume<typename O::Out>", "      wg::produce<typename O::Out>"],
    5: ["    for (int i = team; i < M; i += teams) {\n      ln2_quant_row"],
    6: ["    wg::consume<typename O::Up>", "      wg::produce<typename O::Up>"],
    7: ["    for (int i = team * 4"],
    8: ["    wg::consume<typename O::Down>", "      wg::produce<typename O::Down>"],
    9: ["      moe_sum_elems("],
}
# the L2 prefetch: a helper, each Op's boxes, and the producer's calls
PREFETCH_HEADER = [
    ("__device__ __forceinline__ void wgmma_fence() {",
     "__device__ __forceinline__ void prefetch_3d(const CUtensorMap* map, "
     "int c0, int c1, int c2) {\n"
     "  asm volatile(\"cp.async.bulk.prefetch.tensor.3d.L2.global.tile "
     "[%0, {%1, %2, %3}];\\n\" ::\"l\"(reinterpret_cast<uint64_t>(map)), "
     "\"r\"(c0), \"r\"(c1), \"r\"(c2) : \"memory\");\n}\n\n"
     "__device__ __forceinline__ void wgmma_fence() {"),
    ("// ---- host side",
     "template <class Op>\n"
     "__device__ __forceinline__ void prefetch(const CUtensorMap* tb, "
     "const typename Op::Args& a) {\n"
     "  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {\n"
     "    const Tile tl = Op::tile(a, t);\n"
     "    if (tl.m0 != 0) continue;\n"
     "    for (int z = 0; z < Op::passes(a); ++z)\n"
     "      for (int kt = 0; kt < Op::nk(a); ++kt)\n"
     "        Op::for_b(a, tl, z, kt, [&](int, int col, int k0, int ex) {\n"
     "          if constexpr (Op::S8) prefetch_3d(tb, k0, col, ex);\n"
     "          else prefetch_3d(tb, col, k0, ex);\n"
     "        });\n  }\n}\n\n// ---- host side"),
]
PREFETCH_CALLS = [
    ("    sync(false);                                   // ln1",
     "    if (lead && l == 0) wg::prefetch<typename O::Qkv>(&m.w_qkv, la.qkv);\n"
     "    sync(false);                                   // ln1"),
    ("      wg::produce<typename O::Qkv>(r, &m.a_qkv, &m.w_qkv, la.qkv, it);",
     "      wg::produce<typename O::Qkv>(r, &m.a_qkv, &m.w_qkv, la.qkv, it);\n"
     "      wg::prefetch<typename O::Out>(&m.w_out, la.out);"),
    ("      wg::produce<typename O::Out>(r, &m.a_out, &m.w_out, la.out, it);",
     "      wg::produce<typename O::Out>(r, &m.a_out, &m.w_out, la.out, it);\n"
     "      wg::prefetch<typename O::Up>(&m.w1, la.up);"),
    ("      wg::produce<typename O::Up>(r, &m.a_up, &m.w1, la.up, it);",
     "      wg::produce<typename O::Up>(r, &m.a_up, &m.w1, la.up, it);\n"
     "      wg::prefetch<typename O::Down>(&m.w2, la.down);"),
    ("      wg::produce<typename O::Down>(r, &m.a_down, &m.w2, la.down, it);",
     "      wg::produce<typename O::Down>(r, &m.a_down, &m.w2, la.down, it);\n"
     "      if (l + 1 < a.L) wg::prefetch<typename O::Qkv>(&m.w_qkv, "
     "layer_args<WG, Q8>(a, rt, l + 1).qkv);"),
]
# the same prefetches issued while the producer waits out the row stages:
# the layer's expert weights at the start of attention, the next layer's
# projection weights at the start of ln2
PREFETCH_EARLY = [
    ("    sync(false);                                   // ln1",
     "    if (lead && l == 0) { wg::prefetch<typename O::Qkv>(&m.w_qkv, la.qkv);"
     " wg::prefetch<typename O::Out>(&m.w_out, la.out); }\n"
     "    sync(false);                                   // ln1"),
    ("    sync(false);                                   // attention",
     "    if (lead) { wg::prefetch<typename O::Up>(&m.w1, la.up); "
     "wg::prefetch<typename O::Down>(&m.w2, la.down); }\n"
     "    sync(false);                                   // attention"),
    ("    sync(false);                                   // ln2 + quant",
     "    if (lead && l + 1 < a.L) { const LayerArgs<WG, Q8> nx = "
     "layer_args<WG, Q8>(a, rt, l + 1); wg::prefetch<typename O::Qkv>(&m.w_qkv, "
     "nx.qkv); wg::prefetch<typename O::Out>(&m.w_out, nx.out); }\n"
     "    sync(false);                                   // ln2 + quant"),
]
# the trace: per consume<Op> call of a traced CTA, eight u64 in g_trace:
# clock at entry, operands staged, first and last k-step data, products
# done, epilogue done; %globaltimer at entry and at the end
TRACE_HEADER = [
    ("namespace wg {\n",
     "namespace wg {\n__device__ unsigned long long g_trace[2][512][8];\n"
     "__device__ int g_calls[2];\n"),
    ("""  const int nk = Op::nk(a), passes = Op::passes(a);
  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
    const Tile tl = Op::tile(a, t);
    // the previous tile's epilogue""",
     """  const int nk = Op::nk(a), passes = Op::passes(a);
  const int cta = blockIdx.x == 0 ? 0 : blockIdx.x == 100 ? 1 : -1;
  unsigned long long* T = nullptr;
  if (cta >= 0 && threadIdx.x == 0) {
    T = g_trace[cta][g_calls[cta]++ % 512];
    for (int i = 0; i < 8; ++i) T[i] = 0;
    T[0] = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(T[6]));
  }
  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
    const Tile tl = Op::tile(a, t);
    // the previous tile's epilogue"""),
    ("""    Op::seed(sum, a, tl, rw);
    for (int z = 0; z < passes; ++z) {""",
     """    Op::seed(sum, a, tl, rw);
    if (T && !T[1]) T[1] = clock64();
    for (int z = 0; z < passes; ++z) {"""),
    ("""        mbar_wait(r.full + 8 * s, (it / r.n) & 1);
        const uint32_t b""",
     """        mbar_wait(r.full + 8 * s, (it / r.n) & 1);
        if (T) { if (!T[2]) T[2] = clock64(); T[3] = clock64(); }
        const uint32_t b"""),
    ("""      if (z == 0) wg_barrier(wg);   // the staged columns are in place""",
     """      if (T) T[4] = clock64();
      if (z == 0) wg_barrier(wg);   // the staged columns are in place"""),
    ("""    Op::finish(sum, a, tl, rw);
  }
}""",
     """    Op::finish(sum, a, tl, rw);
    if (T) {
      T[5] = clock64();
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(T[7]));
    }
  }
}"""),
]
TRACE_EXPORT = """
extern "C" int dit_trace(unsigned long long* out, int* calls, int reset) {
  if (reset) {
    const int z[2] = {0, 0};
    return (int)cudaMemcpyToSymbol(wg::g_calls, z, sizeof(z));
  }
  cudaMemcpyFromSymbol(out, wg::g_trace, sizeof(wg::g_trace));
  return (int)cudaMemcpyFromSymbol(calls, wg::g_calls, 2 * sizeof(int));
}
"""
GEMM_STAGES = ("qkv", "c_proj", "moe_up", "moe_down")
PHASES = ("operands", "first_data", "last_data", "products", "epilogue")
VARIANTS = {
    "base": ([], []),
    "prefetch": (PREFETCH_CALLS, PREFETCH_HEADER),
    "prefetch_early": (PREFETCH_EARLY, PREFETCH_HEADER),
    "noepi": ([], [("Op::store(d, a, tl, rw, cols, z, sum);",
                    "if (a.M < 0) Op::store(d, a, tl, rw, cols, z, sum);")]),
    "noprod": ([], [("Op::mma(d, st, b, wg);", "")]),
    "trace": ([], TRACE_HEADER),
}


def edit(text, edits, name):
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"the edit target is not unique in {name}: {old}")
        text = text.replace(old, new)
    return text


def build_all(build_dir, nvcc, flags, csrc):
    """Write and compile every variant; returns {variant: library path}."""
    procs = {}
    for name, (dit_edits, header_edits) in VARIANTS.items():
        work = build_dir / name
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(csrc, work / "csrc")
        src = work / "csrc" / "fused_dit_q8c.cu"
        text = src.read_text()
        text = text.replace("namespace {\n", "namespace {\n__device__ int "
                            "g_skip;\n", 1)
        text = text.replace(
            "  cg::grid_group grid = cg::this_grid();\n",
            "  cg::grid_group grid = cg::this_grid();\n  const int sk = "
            "g_skip;\n")
        text = edit(text, dit_edits, src.name)
        for bit, anchors in SKIPS.items():
            for anchor in anchors:
                body = anchor.lstrip()
                text = edit(text, [(anchor, anchor.replace(
                    body, f"if (!(sk >> {bit} & 1)) {body}"))], src.name)
        text += ('\nextern "C" int dit_set_skip(int v) {\n  return (int)'
                 'cudaMemcpyToSymbol(g_skip, &v, sizeof(int));\n}\n')
        if name == "trace":
            text += TRACE_EXPORT
        src.write_text(text)
        header = work / "csrc" / "wgmma_stages.cuh"
        header.write_text(edit(header.read_text(), header_edits,
                               header.name))
        lib = work / "libfused_dit_q8c.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-I", str(work / "csrc"), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log[-4000:]}")
        libs[name] = lib
    return libs


def read_trace(trace_fn):
    """{cta: {stage: {phase: us from the stage's start}}}, averaged over
    the layers; a CTA without tiles in a stage has none."""
    buf = (ctypes.c_ulonglong * (2 * 512 * 8))()
    calls = (ctypes.c_int * 2)()
    trace_fn(buf, calls, 0)
    out = {}
    for cta, label in ((0, "cta0"), (1, "cta100")):
        rows = [buf[(cta * 512 + i) * 8:(cta * 512 + i + 1) * 8]
                for i in range(calls[cta])]
        done = [(i, r) for i, r in enumerate(rows) if r[5]]  # had tiles
        # the SM clock's ns over all traced stages (%globaltimer ticks
        # coarsely; the clock does not)
        ns_per_clock = (sum(r[7] - r[6] for _, r in done)
                        / max(1, sum(r[5] - r[0] for _, r in done)))
        stages = {}
        for i, r in done:
            stages.setdefault(GEMM_STAGES[i % 4], []).append(
                [(r[j] - r[0]) * ns_per_clock / 1e3 for j in range(1, 6)])
        out[label] = {k: dict(zip(PHASES, (sum(c) / len(c)
                                           for c in zip(*v))))
                      for k, v in stages.items()}
    return out


def main():
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dit_stage_variants_torch: CUDA is not available")
    import bench_kernels_torch as bk
    from mode_diffusion_policy_tpu_torch.ops.kernels import _build
    from mode_diffusion_policy_tpu_torch.ops.kernels import layer_kernel as lk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build_all(ROOT / "build" / "dit_variants", _build.find_nvcc(),
                     _build.NVCC_FLAGS, _build.CSRC_DIR)
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.fused_dit_q8c_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dit_set_skip.argtypes = [ctypes.c_int]
        fns[name] = (fn, lib.dit_set_skip)
        if name == "trace":
            trace_fn = lib.dit_trace
            trace_fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int]
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    result = {}
    for B in (1, 128):
        w = bk.layer_inputs(B, dev)
        st = w["stackL"]
        L = st["wqkv"].shape[0]
        tabs = (w["idx"][None].expand(L, 1, 2).contiguous(),
                w["probs"][None].expand(L, 1, 2).contiguous())

        def step():
            return lk.fused_dit_q8c(w["x"], w["c"], st, *tabs)

        n = 20 if B == 1 else 5
        tile = 128 if B * bk.T > 256 else 64
        row_trace = None
        stages = [i for i, s in enumerate(STAGES)
                  if s != "o_quant" and (s != "moe_sum" or tile == 64)]
        row, ref = {}, None
        for name, (fn, set_skip) in fns.items():
            lk._dit_launcher = lambda fn=fn: fn
            set_skip(0)
            y = step()
            torch.cuda.synchronize()
            if name == "base":
                ref = y
            elif name.startswith("prefetch") or name == "trace":
                row[f"{name}_equal"] = bool(torch.equal(y, ref))
            if name == "trace":
                trace_fn(None, None, 1)
                step()
                torch.cuda.synchronize()
                row_trace = read_trace(trace_fn)
            row[name] = bk.cuda_time_ms(step, n)
            if name == "base":
                set_skip(sum(1 << i for i in stages))
                row["barriers"] = bk.cuda_time_ms(step, n)
                for i in stages:
                    set_skip(1 << i)
                    row[f"skip_{STAGES[i]}"] = bk.cuda_time_ms(step, n)
                set_skip(0)
                row["base_again"] = bk.cuda_time_ms(step, n)
        result[f"b{B}"] = dict(layers=L, ms=row, trace_us=row_trace)
    print(json.dumps({"bench": "dit_stage_variants", "card": card,
                      "result": result}))


if __name__ == "__main__":
    main()
