// The whole L-layer MoDE DiT stack of one denoise step in ONE cooperative
// launch on Hopper (sm_90a).
//
// Replaces the TPU kernel mode_diffusion_policy_tpu/ops/pallas/layer_kernel.py
// (_mega_kernel, launched by fused_dit_q8c) on the b1-latency and
// b1-latency-max serving paths: for l = 0 .. L-1,
//
//   x_mid = x + c_proj(attn(qk_norm(wqkv(rmsnorm(x)*g1 + c) + b)))
//   x     = ln2(x_mid) + sum_{e in top2(l, step)} p_e * W2_e q(act_e) s
//
// with the per-layer weights reached through the layer (or, for the
// experts, l * E + expert) coordinate of 3-D TMA maps over the stacked
// [L, ...] weights and the routing read from the [L, S, 2] tables at row
// `step`. With int8 attention projections (b1-latency-max) h = rmsnorm(x)
// *g1 + c is quantized per row in f32 (no bf16 cast), qkv = (hq wqkv_q) *
// (hs * sqkv) + b, and the f32 attention rows are re-quantized per row
// before the int8 c_proj with its column scales: the JAX kernel's
// int8_attn cast chain.
//
// Design. The TPU kernel walks a sequential (L, 2, n_h, token block) grid
// with the activation resident in VMEM. Here one persistent grid of one
// CTA per SM, co-resident under cudaLaunchCooperativeKernel, runs every
// stage of every layer, with a grid barrier (cooperative_groups grid.sync)
// between stages:
//   ln1 rows | [int8: ln1 + row quant] -> QKV (Proj) -> attention (query
//   rows of a head and sample) -> [int8: row quant of o] -> c_proj (Proj,
//   + residual) -> ln2 + row quant -> MoE up (Up) -> act quant -> MoE down
//   (Down) -> [64-row tiles: the ordered sum of the down partials]
// = 8 barriers per layer, one more with int8 projections and one more with
// 64-row tiles (120 per step at b=1 with int8 projections). A CTA
// is the per-layer kernels' wgmma CTA: kWG consumer warpgroups and one
// producer warpgroup (kWG = 2, 128 x 128 tiles, above 256 token rows; kWG
// = 1, 64 x 64 tiles, below: the plan of attn_kernel.proj_tile_plan and
// moe_kernel.moe_tile_plan). The GEMM stages are the wgmma/TMA stages of
// wgmma_stages.cuh (Proj in bf16 or int8, Up and Down in int8, Down summing
// its passes in registers at 128 x 128), on ONE ring of shared-memory
// stages whose mbarrier phases run on across stages and layers; the warp
// roles and the register split (setmaxnreg) hold for the whole launch.
// The row, attention, quantization and sum stages run on each consumer
// warpgroup as a Team of 128 threads on its own named barrier, the order of
// the per-layer kernels' 128-thread CTAs, in shared memory that the ring
// lends them between GEMM stages. So the megakernel runs the per-layer
// kernels' stages, tiles and k order: with bf16 projections it equals L
// chained fused_layer_q8c launches bit for bit, with int8 projections L
// chained fused_layer_q8c(qattn=) launches.
//   Between stages: after a row stage every thread fences its generic
// stores against the async proxy before the barrier (the next GEMM stage's
// TMA reads them, and the ring's TMA writes reuse the row stages' shared
// memory; the GEMM stages' outputs are read by generic loads), and
// activations of this launch are read through L2 (__ldcg), never a stale
// L1 line.
//   The producer thread issues a stage's loads once the barrier before the
// stage has passed: prefetching the next GEMM stage's weights into L2 ahead
// of the barrier (cp.async.bulk.prefetch.tensor) made the step slower on
// the H100, at b=1 and at b=128 (PERF.md, PR 11), because the stages are
// bound by latency, not by the weights' bytes, and the prefetches delay the
// producer's CTA at the barrier.
//   With a `times` buffer, thread 0 of CTA 0 reads %globaltimer and its
// clock after every barrier: the device time of each stage of the step.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 1979 TOP/s int8,
// 3.35 TB/s), flagship stack (12 layers, D = 1024, 8 heads, hidden 4096,
// top-2 of 4 experts, 14 tokens per sample):
//   b=1: bytes. Each layer reads two experts' int8 weights (25.2 MB) and
//   8.4 MB of bf16 attention weights: 12 x 33.6 MB = 402.6 MB, 0.120 ms per
//   step; with int8 projections 12 x 29.4 MB = 352 MB, 0.105 ms.
//   b=128: operations, 12 x 0.0608 ms = 0.730 ms per step (bf16 attention).
// At b=1 the QKV stage has 48 tiles of 64 x 64 and c_proj 16, so most SMs
// idle there; narrower column tiles (or split-K for the exact int8 sums)
// are work for a later change.

#include <cooperative_groups.h>

#include <initializer_list>

#include "layer_stages.cuh"
#include "wgmma_stages.cuh"

using namespace mdp;
namespace cg = cooperative_groups;

namespace {

// The TMA maps of one launch: the A operands over the per-layer scratch,
// the B operands over the stacked weights.
struct DitMaps {
  CUtensorMap a_qkv;    // h [M, D] bf16, or hq [M, D] int8
  CUtensorMap a_out;    // o [M, D] bf16, or oq [M, D] int8
  CUtensorMap a_up;     // xq [M, D] int8
  CUtensorMap a_down;   // aq [2, M, HH] int8
  CUtensorMap w_qkv;    // wqkv [L, D, 3D] bf16, or wqkv_t [L, 3D, D] int8
  CUtensorMap w_out;    // wout [L, D, D] bf16, or wout_t [L, D, D] int8
  CUtensorMap w1;       // w1_t [L E, 2HH, D] int8
  CUtensorMap w2;       // w2_t [L E, D, HH] int8
};

struct DitArgs {
  // inputs: activation, f32 cond rows (one shared row, one per sample or
  // one per token: row r's at c + (r / c_div) * c_stride, CondMap; every
  // layer reads them from this buffer), stacked vectors, routing
  const bf16* x;
  const float* c;
  const float* ln1;       // [L, D]
  const float* sqkv;      // [L, 3D] (int8 projections)
  const float* bqkv;      // [L, 3D]
  const float* q_g;       // [L, hd]
  const float* k_g;       // [L, hd]
  const float* sout;      // [L, D] (int8 projections)
  const float* ln2;       // [L, D]
  const float* w1_s;      // [L, E, 2HH]
  const float* b1;        // [L, E, 2HH]
  const float* w2_s;      // [L, E, D]
  const int* idx;         // [L, S, 2]
  const float* probs;     // [L, S, 2]
  // per-layer scratch, reused by every layer
  void* h;                // [M, D] bf16 h, or int8 hq
  float* hs;              // [M]    (int8 projections)
  float* qkv;             // [M, 3D]
  void* o;                // [M, D] bf16 o, or f32 o (int8 projections)
  int8_t* oq;             // [M, D] (int8 projections)
  float* os;              // [M]    (int8 projections)
  bf16* xmid;             // [M, D]
  bf16* xm;               // [M, D]
  int8_t* xq;             // [M, D]
  float* sx;              // [M]
  float* act;             // [2, M, HH]
  int8_t* aq;             // [2, M, HH]
  float* sa;              // [2, M, n_h]
  float* part;            // [2 n_h, M, D] (64-row tiles)
  bf16* tmp;              // [M, D]   ping-pong partner of out
  bf16* out;              // [M, D]
  unsigned long long* times;   // [marks, 2] (%globaltimer, clock), or null
  int S, step, L, B, T, D, H, HH, TH, E, c_div, c_stride;
  // the shared-memory plan: ring stages, ring bytes, each team's bytes
  // for the row and attention stages, the attention's key rows per block
  int n_slots, ring_bytes, team_bytes, attn_kb;
  float eps1, eps_qk, eps2, rs_D, rs_hd, scale;
};

// The GEMM stages of one layer under the plan of WG consumer warpgroups.
template <int WG, bool Q8>
struct Ops {
  static constexpr int kBN = 64 * WG;   // projection tiles: 64 WG x 64 WG
  static constexpr int kKind = Q8 ? wg::kS8 : wg::kBf16;
  using Qkv = wg::Proj<WG, kBN, 0, kKind>;
  using Out = wg::Proj<WG, kBN, 1, kKind>;
  using Up = wg::Up<WG, wg::kS8>;
  using Down = wg::Down<WG, wg::kS8, WG == 2>;
  // one ring for all four: the largest stage, the most staged columns
  static constexpr int kSlot =
      cmax(cmax(Qkv::kStage, Out::kStage), cmax(Up::kStage, Down::kStage));
  static constexpr int kCols =
      cmax(cmax(Qkv::kCols, Out::kCols), cmax(Up::kCols, Down::kCols));
  // row, attention, quantization and sum stages, then the GEMM stages:
  // the grid barriers of one layer
  static constexpr int kStages = 8 + Q8 + (WG == 1);
  static_assert(kSlot % 1024 == 0, "ring stages stay 1024-aligned");
};

template <int WG, bool Q8>
struct LayerArgs {
  wg::ProjArgs qkv, out;
  wg::MoeArgs up, down;
  const bf16* src;   // the layer's input: x, or the previous layer's output
  bf16* dst;         // its output (the last layer's: out)
};

// The routing rows of this step, [L, 2] experts and probabilities, copied
// once per launch from the [L, S, 2] tables into shared memory: every GEMM
// stage of the MoE reads its layer's two experts before its first load.
struct Route {
  const int* idx;
  const float* probs;
};

template <int WG, bool Q8>
__device__ __forceinline__ LayerArgs<WG, Q8> layer_args(const DitArgs& a,
                                                        const Route& rt,
                                                        int l) {
  using O = Ops<WG, Q8>;
  const int M = a.B * a.T, D = a.D, D3 = 3 * D, H2 = 2 * a.HH;
  const int n_h = a.HH / a.TH, E = a.E;
  LayerArgs<WG, Q8> r;
  // x ping-pongs between tmp and out so that the last layer writes out
  r.src = l == 0 ? a.x : (((a.L - l) & 1) ? a.tmp : a.out);
  r.dst = ((a.L - 1 - l) & 1) ? a.tmp : a.out;
  r.qkv = wg::proj_args(M, D3, D, WG, O::kBN, a.hs,
                        Q8 ? a.sqkv + (size_t)l * D3 : nullptr,
                        a.bqkv + (size_t)l * D3, nullptr, a.qkv, l);
  r.out = wg::proj_args(M, D, D, WG, O::kBN, a.os,
                        Q8 ? a.sout + (size_t)l * D : nullptr, nullptr,
                        r.src, a.xmid, l);
  const int* idx = rt.idx + 2 * l;
  const float* probs = rt.probs + 2 * l;
  r.up = wg::stage_args(idx, probs, 0, M, D, a.HH, a.TH, E, WG,
                        O::Up::kNV, a.HH, 2, a.b1 + (size_t)l * E * H2, a.sx,
                        a.w1_s + (size_t)l * E * H2, nullptr, a.act, l * E);
  r.down = wg::stage_args(idx, probs, 0, M, D, a.HH, a.TH, E, WG,
                          O::Down::kN, D, WG == 2 ? 1 : 2 * n_h, nullptr,
                          a.sa, a.w2_s + (size_t)l * E * D, a.xm,
                          WG == 2 ? (void*)r.dst : (void*)a.part, l * E);
  return r;
}

// The producer warpgroup: its first thread issues every TMA load of the
// GEMM stages; the warpgroup meets every grid barrier of the consumers'
// stages.
template <int WG, bool Q8>
__device__ __forceinline__ void dit_producer(const DitMaps& m,
                                             const DitArgs& a,
                                             const wg::Ring& r,
                                             const Route& rt) {
  using O = Ops<WG, Q8>;
  cg::grid_group grid = cg::this_grid();
  const bool lead = threadIdx.x % 128 == 0;
  int it = 0;
  // the eight tensor maps into the TMA unit's descriptor cache
  if (lead)
    for (const CUtensorMap* t : {&m.a_qkv, &m.a_out, &m.a_up, &m.a_down,
                                 &m.w_qkv, &m.w_out, &m.w1, &m.w2})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(t)) : "memory");
  auto sync = [&](bool last) {
    if (!(last && !a.times)) grid.sync();
  };
  for (int l = 0; l < a.L; ++l) {
    const LayerArgs<WG, Q8> la = layer_args<WG, Q8>(a, rt, l);
    sync(false);                                   // ln1
    if (lead) {
      wg::fence_proxy_async();
      wg::produce<typename O::Qkv>(r, &m.a_qkv, &m.w_qkv, la.qkv, it);
    }
    sync(false);                                   // QKV
    sync(false);                                   // attention
    if (Q8) sync(false);                           // o quant
    if (lead) {
      wg::fence_proxy_async();
      wg::produce<typename O::Out>(r, &m.a_out, &m.w_out, la.out, it);
    }
    sync(false);                                   // c_proj
    sync(false);                                   // ln2 + quant
    if (lead) {
      wg::fence_proxy_async();
      wg::produce<typename O::Up>(r, &m.a_up, &m.w1, la.up, it);
    }
    sync(false);                                   // up
    sync(false);                                   // act quant
    if (lead) {
      wg::fence_proxy_async();
      wg::produce<typename O::Down>(r, &m.a_down, &m.w2, la.down, it);
    }
    sync(WG == 2 && l + 1 == a.L);                 // down
    if (WG == 1) sync(l + 1 == a.L);               // ordered sum
  }
}

// Consumer warpgroup wg: the products and epilogues of its 64 rows of
// every GEMM tile, and, as a Team of 128 threads, its share of the work
// items of the row, attention, quantization and sum stages. cols: its
// staged column operands; scratch: its shared memory for the row stages.
template <int WG, bool Q8>
__device__ __forceinline__ void dit_consumer(const DitArgs& a,
                                             const wg::Ring& r,
                                             const Route& rt, float* cols,
                                             unsigned char* scratch, int wg) {
  using O = Ops<WG, Q8>;
  cg::grid_group grid = cg::this_grid();
  const Team tm{static_cast<int>(threadIdx.x % 128), 1 + wg};
  const int team = blockIdx.x * WG + wg, teams = gridDim.x * WG;
  const int M = a.B * a.T, D = a.D, hd = D / a.H, n_h = a.HH / a.TH;
  const int n_attn = attn_items(a.B, a.H, a.T);
  int it = 0, n_mark = 0;
  auto mark = [&]() {
    if (a.times && blockIdx.x == 0 && threadIdx.x == 0) {
      unsigned long long g;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(g));
      a.times[2 * n_mark] = g;
      a.times[2 * n_mark + 1] = clock64();
    }
    ++n_mark;
  };
  // a row stage's stores (global and shared) before the next stage's TMA
  // (async proxy): `fence`
  auto end_stage = [&](bool last, bool fence) {
    if (fence) wg::fence_proxy_async();
    if (last && !a.times) return;
    grid.sync();
    mark();
  };
  mark();
  for (int l = 0; l < a.L; ++l) {
    const LayerArgs<WG, Q8> la = layer_args<WG, Q8>(a, rt, l);
    const float* ln1 = a.ln1 + (size_t)l * D;
    for (int i = team; i < M; i += teams) {
      if constexpr (Q8)
        ln1_quant_row(la.src, a.c, a.c_div, a.c_stride, ln1,
                      static_cast<int8_t*>(a.h), a.hs, D, a.rs_D, a.eps1, i,
                      scratch, tm);
      else
        ln1_row(la.src, a.c, a.c_div, a.c_stride, ln1,
                static_cast<bf16*>(a.h), D, a.rs_D, a.eps1, i, scratch, tm);
      tm.sync();
    }
    end_stage(false, true);
    wg::consume<typename O::Qkv>(r, la.qkv, cols, 0, wg, it);
    end_stage(false, false);
    for (int i = team; i < n_attn; i += teams) {
      attn_item(a.qkv, a.q_g + (size_t)l * hd, a.k_g + (size_t)l * hd,
                Q8 ? nullptr : static_cast<bf16*>(a.o),
                Q8 ? static_cast<float*>(a.o) : nullptr, a.B, a.T, D, a.H,
                hd, a.rs_hd, a.eps_qk, a.scale, a.attn_kb, i, scratch, tm);
      tm.sync();
    }
    end_stage(false, true);
    if constexpr (Q8) {
      for (int i = team; i < M; i += teams) {
        quant_f32_row(static_cast<const float*>(a.o), a.oq, a.os, D, i,
                      scratch, tm);
        tm.sync();
      }
      end_stage(false, true);
    }
    wg::consume<typename O::Out>(r, la.out, cols, 0, wg, it);
    end_stage(false, false);
    for (int i = team; i < M; i += teams) {
      ln2_quant_row(a.xmid, a.ln2 + (size_t)l * D, a.xm, a.xq, a.sx, D,
                    a.rs_D, a.eps2, i, scratch, tm);
      tm.sync();
    }
    end_stage(false, true);
    wg::consume<typename O::Up>(r, la.up, cols, 0, wg, it);
    end_stage(false, false);
    // one warp per item
    for (int i = team * 4 + tm.tid / 32; i < 2 * M * n_h; i += teams * 4)
      act_quant_warp(a.act, a.aq, a.sa, M, a.HH, a.TH, i, tm.tid % 32);
    end_stage(false, true);
    wg::consume<typename O::Down>(r, la.down, cols, 0, wg, it);
    end_stage(WG == 2 && l + 1 == a.L, false);
    if constexpr (WG == 1) {
      moe_sum_elems(a.xm, a.part, la.dst, M * D, 2 * n_h,
                    team * kThreads + tm.tid, teams * kThreads);
      end_stage(l + 1 == a.L, false);
    }
  }
}

template <int WG, bool Q8>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
fused_dit_kernel(const __grid_constant__ DitMaps m,
                 const __grid_constant__ DitArgs a) {
  using O = Ops<WG, Q8>;
  extern __shared__ unsigned char smem[];
  // [ring (1024-aligned), lent to the row stages | staged columns | bars |
  // the routing rows]
  const uint32_t s0 = wg::smem_u32(smem);
  const uint32_t base = (s0 + 1023u) & ~1023u;
  unsigned char* ring = smem + (base - s0);
  float* cols = reinterpret_cast<float*>(ring + a.ring_bytes);
  const uint32_t bars = base + a.ring_bytes + WG * O::kCols * 4;
  const wg::Ring r{base, bars, bars + 8 * a.n_slots, O::kSlot, a.n_slots};
  int* ridx = reinterpret_cast<int*>(smem + (bars - s0) + 16 * a.n_slots);
  float* rp = reinterpret_cast<float*>(ridx + 2 * a.L);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) wg::ring_init(r, WG);
  for (int i = threadIdx.x; i < 2 * a.L; i += blockDim.x) {
    const size_t at = ((size_t)(i / 2) * a.S + a.step) * 2 + i % 2;
    ridx[i] = a.idx[at];
    rp[i] = a.probs[at];
  }
  __syncthreads();
  const Route rt{ridx, rp};
  if (wg == WG) {
    if constexpr (WG > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    dit_producer<WG, Q8>(m, a, r, rt);
  } else {
    if constexpr (WG > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    dit_consumer<WG, Q8>(a, r, rt, cols + wg * O::kCols,
                         ring + wg * a.team_bytes, wg);
  }
}

// The named slots of the launcher's pointer, int and float arrays
// (ops/kernels/layer_kernel.py DIT_PTRS, DIT_INTS, DIT_FLOATS).
enum Ptr {
  kX, kC, kLn1, kWqkv, kSqkv, kBqkv, kQg, kKg, kWout, kSout, kLn2, kW1t,
  kW1s, kB1, kW2t, kW2s, kIdx, kProbs, kH, kHs, kQkv, kO, kOq, kOs, kXmid,
  kXm, kXq, kSx, kAct, kAq, kSa, kPart, kTmp, kOut, kNumPtr
};
enum Int {
  iS, iStep, iL, iB, iT, iD, iH, iHH, iTH, iE, iInt8Attn, iTile, iCRows,
  kNumInt
};
enum Flt { fEps1, fEpsQk, fEps2, fRsD, fRsHd, fScale, kNumFlt };

constexpr int kMaxSmem = 232448;   // a CTA's shared memory on the H100

template <int WG, bool Q8>
int launch(const DitMaps& m, DitArgs a, int* info, cudaStream_t st) {
  using O = Ops<WG, Q8>;
  const auto kernel = fused_dit_kernel<WG, Q8>;
  const int cols = WG * O::kCols * 4, route = 16 * a.L;
  const int avail = kMaxSmem - 1024 - cols - 16 * wg::kMaxStages - route;
  // the row and attention stages' shared memory per team, lent by the
  // ring: a team's share of it at most, where a long sample streams its
  // keys in blocks (attn_kb)
  const int hd = a.D / a.H, rows = attn_rows(a.B, a.H, a.T);
  a.attn_kb = attn_kb(a.T, hd, rows, avail / WG / 1024 * 1024);
  if (a.attn_kb < 1) return (int)cudaErrorInvalidValue;
  a.team_bytes = (cmax(smem_row(a.D), smem_attn(a.T, hd, rows, a.attn_kb)) +
                  1023) / 1024 * 1024;
  a.n_slots = std::min(wg::kMaxStages, avail / O::kSlot);
  a.ring_bytes = std::max(a.n_slots * O::kSlot, WG * a.team_bytes);
  if (a.n_slots < 2 || a.ring_bytes > avail)
    return (int)cudaErrorInvalidValue;
  const int dyn = 1024 + a.ring_bytes + cols + 16 * a.n_slots + route;

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = wg::grant_smem(reinterpret_cast<const void*>(kernel), dyn);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    128 * (WG + 1), dyn);
  if (e != cudaSuccess) return (int)e;
  // one CTA per SM, all co-resident: a grid that does not fit is refused
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const int grid = sms;
  info[0] = grid;
  info[1] = per_sm;
  info[2] = dyn;
  info[3] = (int)fa.sharedSizeBytes;
  info[4] = a.n_slots;
  info[5] = WG;
  info[6] = fa.numRegs;
  info[7] = (int)fa.localSizeBytes;
  info[8] = a.attn_kb;
  void* args[] = {const_cast<DitMaps*>(&m), &a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(128 * (WG + 1)), args,
                                  (size_t)dyn, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// p: kNumPtr device addresses (the Ptr slots; the unused ones of a
// projection kind may be 0), n: kNumInt ints (n[iCRows]: the count of cond
// rows, 1, B or B T), f: kNumFlt floats, each count checked; info (host
// memory, 9 ints) receives the grid size, the CTAs per SM, the dynamic and
// the static shared memory per CTA, the ring stages, the consumer
// warpgroups, the registers per thread, the local (spill) bytes per thread
// and the attention's key rows per block (T: one pass); times: null, or
// device memory for 2 x (1 + L x barriers per layer) u64 (%globaltimer ns
// and SM clock after each barrier). The int8 weights are the K-major stacked copies (w1_t [L, E,
// 2HH, D], w2_t [L, E, D, HH] and, with int8 projections, wqkv_t [L, 3D,
// D], wout_t [L, D, D]); bf16 projections are read as stored ([L, D, 3D],
// [L, D, D]). n[iTile]: 128 (128 x 128 tiles) or 64. Returns a CUDA error
// code, or wg::kErrNoEncode / kErrEncode when a TMA tensor map cannot be
// made; the kernel does not run unless it is 0.
extern "C" int fused_dit_q8c_launch(const unsigned long long* p, int n_p,
                                    const int* n, int n_n, const float* f,
                                    int n_f, int* info, void* times,
                                    void* stream) {
  if (n_p != kNumPtr || n_n != kNumInt || n_f != kNumFlt)
    return (int)cudaErrorInvalidValue;
  auto ptr = [&](int i) { return reinterpret_cast<void*>(p[i]); };
  DitArgs a;
  a.x = (const bf16*)ptr(kX); a.c = (const float*)ptr(kC);
  a.ln1 = (const float*)ptr(kLn1); a.sqkv = (const float*)ptr(kSqkv);
  a.bqkv = (const float*)ptr(kBqkv); a.q_g = (const float*)ptr(kQg);
  a.k_g = (const float*)ptr(kKg); a.sout = (const float*)ptr(kSout);
  a.ln2 = (const float*)ptr(kLn2); a.w1_s = (const float*)ptr(kW1s);
  a.b1 = (const float*)ptr(kB1); a.w2_s = (const float*)ptr(kW2s);
  a.idx = (const int*)ptr(kIdx); a.probs = (const float*)ptr(kProbs);
  a.h = ptr(kH); a.hs = (float*)ptr(kHs); a.qkv = (float*)ptr(kQkv);
  a.o = ptr(kO); a.oq = (int8_t*)ptr(kOq); a.os = (float*)ptr(kOs);
  a.xmid = (bf16*)ptr(kXmid); a.xm = (bf16*)ptr(kXm);
  a.xq = (int8_t*)ptr(kXq); a.sx = (float*)ptr(kSx);
  a.act = (float*)ptr(kAct); a.aq = (int8_t*)ptr(kAq);
  a.sa = (float*)ptr(kSa); a.part = (float*)ptr(kPart);
  a.tmp = (bf16*)ptr(kTmp); a.out = (bf16*)ptr(kOut);
  a.times = static_cast<unsigned long long*>(times);
  a.S = n[iS]; a.step = n[iStep]; a.L = n[iL]; a.B = n[iB]; a.T = n[iT];
  a.D = n[iD]; a.H = n[iH]; a.HH = n[iHH]; a.TH = n[iTH]; a.E = n[iE];
  CondMap cm;
  if (!cond_map(n[iCRows], a.B, a.T, a.D, &cm))
    return (int)cudaErrorInvalidValue;
  a.c_div = cm.div;
  a.c_stride = cm.stride;
  a.eps1 = f[fEps1]; a.eps_qk = f[fEpsQk]; a.eps2 = f[fEps2];
  a.rs_D = f[fRsD]; a.rs_hd = f[fRsHd]; a.scale = f[fScale];
  const bool q8 = n[iInt8Attn] != 0;
  const int tile = n[iTile];
  if (tile != 64 && tile != 128) return (int)cudaErrorInvalidValue;

  const uint64_t M = (uint64_t)a.B * a.T, D = a.D, HH = a.HH;
  const uint64_t L = a.L, LE = (uint64_t)a.L * a.E;
  const int ae = q8 ? 1 : 2;   // the projections' element size
  const uint64_t d_row[2] = {D, M};
  const uint64_t d_aq[3] = {HH, M, 2};
  const uint64_t d_qkv[3] = {q8 ? D : 3 * D, q8 ? 3 * D : D, L};
  const uint64_t d_out[3] = {D, D, L};
  const uint64_t d_w1[3] = {D, 2 * HH, LE};
  const uint64_t d_w2[3] = {HH, D, LE};
  DitMaps m;
  for (const int e :
       {wg::cached_map(&m.a_qkv, ptr(kH), ae, 2, d_row),
        wg::cached_map(&m.a_out, ptr(q8 ? kOq : kO), ae, 2, d_row),
        wg::cached_map(&m.a_up, ptr(kXq), 1, 2, d_row),
        wg::cached_map(&m.a_down, ptr(kAq), 1, 3, d_aq),
        wg::cached_map(&m.w_qkv, ptr(kWqkv), ae, 3, d_qkv),
        wg::cached_map(&m.w_out, ptr(kWout), ae, 3, d_out),
        wg::cached_map(&m.w1, ptr(kW1t), 1, 3, d_w1),
        wg::cached_map(&m.w2, ptr(kW2t), 1, 3, d_w2)})
    if (e) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 128)
    return q8 ? launch<2, true>(m, a, info, st)
              : launch<2, false>(m, a, info, st);
  return q8 ? launch<1, true>(m, a, info, st)
            : launch<1, false>(m, a, info, st);
}
