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
// with the per-layer weights reached by offsets into the stacked [L, ...]
// tensors and the routing read from the [L, S, 2] tables at row `step`.
// With int8 attention projections (b1-latency-max) h = rmsnorm(x)*g1 + c is
// quantized per row in f32 (no bf16 cast), qkv = (hq wqkv_q) * (hs * sqkv)
// + b, and the f32 attention rows are re-quantized per row before the int8
// c_proj with its column scales: the JAX kernel's int8_attn cast chain.
//
// Design. The TPU kernel walks a sequential (L, 2, n_h, token block) grid
// with the activation resident in VMEM. Here one persistent grid (every SM
// times the occupancy the kernel's registers and shared memory allow,
// capped at the largest stage's work-item count, co-resident under
// cudaLaunchCooperativeKernel) runs every stage of every layer as a
// grid-stride loop over that stage's work items, with a grid barrier
// (cooperative_groups grid.sync) between stages:
//   ln1 (rows) | [int8: ln1 + row quant] -> QKV tiles -> attention (query
//   rows of a head and sample) -> [int8: row quant of o] -> c_proj tiles
//   (+ residual) ->
//   ln2 + row quant -> MoE up tiles -> act quant -> MoE down partials ->
//   ordered sum into the layer's output
// = 9 barriers per layer (10 with int8 projections). The stage bodies are
// those of the per-layer kernel (layer_stages.cuh): the same tiles in the
// same k order, so with bf16 projections this kernel equals L chained
// fused_layer_q8c launches bit for bit. The per-layer scratch is allocated
// once by the wrapper and reused by every layer; x ping-pongs between two
// bf16 buffers so that the last layer writes the output; the kernel
// allocates nothing. CTAs left without a work item in a stage (c_proj has
// 16 tiles at b=1) go straight to the barrier.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 1979 TOP/s int8,
// 3.35 TB/s), flagship stack (12 layers, D = 1024, 8 heads, hidden 4096,
// top-2 of 4 experts, 14 tokens per sample):
//   b=1: bytes. Each layer reads two experts' int8 weights (25.2 MB) and
//   8.4 MB of bf16 attention weights: 12 x 33.6 MB = 402.6 MB, 0.120 ms per
//   step; with int8 projections 12 x 29.4 MB = 352 MB, 0.105 ms.
//   b=128: operations, 12 x 0.0608 ms = 0.730 ms per step (bf16 attention).
// What the persistent grid does about b=1: the per-layer kernel pulled the
// expert weights with 16-64 CTAs per stage and paid nine launches per layer
// (1,080 per 10-step chunk); here every CTA of the resident grid takes part
// in every stage that has work for it, and a chunk is 10 launches. The
// tiles are still 64 x 64 with M = 14 of 64 rows live at b=1, so the MoE
// stages have 128 work items (the grid is capped there) and the QKV and
// c_proj stages 48 and 16, each a chain of dependent k-steps: splitting k,
// wgmma/TMA and fusing stages are work for later changes.

#include <cooperative_groups.h>

#include "layer_stages.cuh"

using namespace mdp;
namespace cg = cooperative_groups;

namespace {

struct DitArgs {
  // inputs: activation, shared cond row, stacked weights, routing tables
  const bf16* x;
  const float* c;
  const float* ln1;       // [L, D]
  const void* wqkv;       // [L, D, 3D] bf16, or int8 with sqkv
  const float* sqkv;      // [L, 3D] (int8 projections)
  const float* bqkv;      // [L, 3D]
  const float* q_g;       // [L, hd]
  const float* k_g;       // [L, hd]
  const void* wout;       // [L, D, D] bf16, or int8 with sout
  const float* sout;      // [L, D] (int8 projections)
  const float* ln2;       // [L, D]
  const int8_t* w1_q;     // [L, E, D, 2HH]
  const float* w1_s;      // [L, E, 2HH]
  const float* b1;        // [L, E, 2HH]
  const int8_t* w2_q;     // [L, E, HH, D]
  const float* w2_s;      // [L, E, D]
  const int* idx;         // [L, S, 2]
  const float* probs;     // [L, S, 2]
  // per-layer scratch, reused by every layer
  bf16* h;                // [M, D]   bf16 projections
  int8_t* hq;             // [M, D]   int8 projections
  float* hs;              // [M]
  float* qkv;             // [M, 3D]
  bf16* o;                // [M, D]   bf16 projections
  float* o32;             // [M, D]   int8 projections
  int8_t* oq;             // [M, D]
  float* os;              // [M]
  bf16* xmid;             // [M, D]
  bf16* xm;               // [M, D]
  int8_t* xq;             // [M, D]
  float* sx;              // [M]
  float* act;             // [2, M, HH]
  int8_t* aq;             // [2, M, HH]
  float* sa;              // [2, M, n_h]
  float* part;            // [2 n_h, M, D]
  bf16* tmp;              // [M, D]   ping-pong partner of out
  bf16* out;              // [M, D]
  int S, step, L, B, T, D, H, HH, TH, E, int8_attn;
  float eps1, eps_qk, eps2, rs_D, rs_hd, scale;
};

__global__ void __launch_bounds__(kThreads) fused_dit_kernel(DitArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int M = a.B * a.T, D = a.D, D3 = 3 * D, hd = D / a.H;
  const int HH = a.HH, H2 = 2 * HH, E = a.E, n_h = HH / a.TH;
  const int n_mt = (M + BM - 1) / BM;
  const int g0 = blockIdx.x, gs = gridDim.x;

  const bf16* src = a.x;
  for (int l = 0; l < a.L; ++l) {
    bf16* dst = ((a.L - 1 - l) & 1) ? a.tmp : a.out;
    const float* ln1 = a.ln1 + (size_t)l * D;
    const float* bqkv = a.bqkv + (size_t)l * D3;
    const float* qg = a.q_g + (size_t)l * hd;
    const float* kg = a.k_g + (size_t)l * hd;
    const float* ln2 = a.ln2 + (size_t)l * D;
    const int8_t* w1_q = a.w1_q + (size_t)l * E * D * H2;
    const float* w1_s = a.w1_s + (size_t)l * E * H2;
    const float* b1 = a.b1 + (size_t)l * E * H2;
    const int8_t* w2_q = a.w2_q + (size_t)l * E * HH * D;
    const float* w2_s = a.w2_s + (size_t)l * E * D;
    const int* idx = a.idx + (size_t)l * a.S * 2;
    const float* probs = a.probs + (size_t)l * a.S * 2;

    // ---- attention sub-block -------------------------------------------
    if (a.int8_attn) {
      for (int i = g0; i < M; i += gs) {
        ln1_quant_row(src, a.c, a.T, 0, ln1, a.hq, a.hs, D, a.rs_D, a.eps1, i,
                      smem);
        __syncthreads();
      }
      grid.sync();
      const int8_t* w = (const int8_t*)a.wqkv + (size_t)l * D * D3;
      for (int i = g0; i < n_tiles(M, D3); i += gs) {
        gemm_i8_tile<0>(a.hq, a.hs, w, a.sqkv + (size_t)l * D3, M, D3, D,
                        bqkv, a.qkv, nullptr, nullptr, i, smem);
        __syncthreads();
      }
    } else {
      for (int i = g0; i < M; i += gs) {
        ln1_row(src, a.c, a.T, 0, ln1, a.h, D, a.rs_D, a.eps1, i, smem);
        __syncthreads();
      }
      grid.sync();
      const bf16* w = (const bf16*)a.wqkv + (size_t)l * D * D3;
      for (int i = g0; i < n_tiles(M, D3); i += gs) {
        gemm_bf16_tile<0>(a.h, w, M, D3, D, bqkv, a.qkv, nullptr, nullptr, i,
                          smem);
        __syncthreads();
      }
    }
    grid.sync();
    for (int i = g0; i < attn_items(a.B, a.H, a.T); i += gs) {
      attn_item(a.qkv, qg, kg, a.o, a.int8_attn ? a.o32 : nullptr, a.B, a.T,
                D, a.H, hd, a.rs_hd, a.eps_qk, a.scale, i, smem);
      __syncthreads();
    }
    grid.sync();
    if (a.int8_attn) {
      for (int i = g0; i < M; i += gs) {
        quant_f32_row(a.o32, a.oq, a.os, D, i, smem);
        __syncthreads();
      }
      grid.sync();
      const int8_t* w = (const int8_t*)a.wout + (size_t)l * D * D;
      for (int i = g0; i < n_tiles(M, D); i += gs) {
        gemm_i8_tile<1>(a.oq, a.os, w, a.sout + (size_t)l * D, M, D, D,
                        nullptr, nullptr, src, a.xmid, i, smem);
        __syncthreads();
      }
    } else {
      const bf16* w = (const bf16*)a.wout + (size_t)l * D * D;
      for (int i = g0; i < n_tiles(M, D); i += gs) {
        gemm_bf16_tile<1>(a.o, w, M, D, D, nullptr, nullptr, src, a.xmid, i,
                          smem);
        __syncthreads();
      }
    }
    grid.sync();

    // ---- ln2 + int8 top-2 MoE --------------------------------------------
    for (int i = g0; i < M; i += gs) {
      ln2_quant_row(a.xmid, ln2, a.xm, a.xq, a.sx, D, a.rs_D, a.eps2, i, smem);
      __syncthreads();
    }
    grid.sync();
    for (int i = g0; i < 2 * n_mt * (HH / BN); i += gs) {
      moe_up_tile(a.xq, a.sx, w1_q, w1_s, b1, idx, a.step, a.act, M, D, HH, E,
                  i, smem);
      __syncthreads();
    }
    grid.sync();
    for (int i = g0; i < 2 * M * n_h; i += gs) {
      act_quant_item(a.act, a.aq, a.sa, M, HH, a.TH, i, smem);
      __syncthreads();
    }
    grid.sync();
    for (int i = g0; i < 2 * n_h * n_mt * (D / BN); i += gs) {
      moe_down_tile(a.aq, a.sa, w2_q, w2_s, idx, probs, a.step, a.part, M, D,
                    HH, a.TH, E, i, smem);
      __syncthreads();
    }
    grid.sync();
    moe_sum_elems(a.xm, a.part, dst, M * D, 2 * n_h,
                  blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
    src = dst;
    if (l + 1 < a.L) grid.sync();
  }
}

}  // namespace

// info (host memory, 3 ints) receives the grid size, the CTAs per SM and
// the dynamic shared memory per CTA. Returns a CUDA error code; the kernel
// does not run unless it is 0.
extern "C" int fused_dit_q8c_launch(
    const void* x, const void* c, const void* ln1, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* q_g, const void* k_g,
    const void* wout, const void* sout, const void* ln2, const void* w1_q,
    const void* w1_s, const void* b1, const void* w2_q, const void* w2_s,
    const void* idx, const void* probs, int S, int step, void* h, void* hq,
    void* hs, void* qkv, void* o, void* o32, void* oq, void* os, void* xmid,
    void* xm, void* xq, void* sx, void* act, void* aq, void* sa, void* part,
    void* tmp, void* out, int L, int B, int T, int D, int H, int HH, int TH,
    int E, int int8_attn, float eps1, float eps_qk, float eps2, float rs_D,
    float rs_hd, float scale, int* info, void* stream) {
  DitArgs a;
  a.x = (const bf16*)x; a.c = (const float*)c; a.ln1 = (const float*)ln1;
  a.wqkv = wqkv; a.sqkv = (const float*)sqkv; a.bqkv = (const float*)bqkv;
  a.q_g = (const float*)q_g; a.k_g = (const float*)k_g; a.wout = wout;
  a.sout = (const float*)sout; a.ln2 = (const float*)ln2;
  a.w1_q = (const int8_t*)w1_q; a.w1_s = (const float*)w1_s;
  a.b1 = (const float*)b1; a.w2_q = (const int8_t*)w2_q;
  a.w2_s = (const float*)w2_s; a.idx = (const int*)idx;
  a.probs = (const float*)probs;
  a.h = (bf16*)h; a.hq = (int8_t*)hq; a.hs = (float*)hs; a.qkv = (float*)qkv;
  a.o = (bf16*)o; a.o32 = (float*)o32; a.oq = (int8_t*)oq; a.os = (float*)os;
  a.xmid = (bf16*)xmid; a.xm = (bf16*)xm; a.xq = (int8_t*)xq;
  a.sx = (float*)sx; a.act = (float*)act; a.aq = (int8_t*)aq;
  a.sa = (float*)sa; a.part = (float*)part; a.tmp = (bf16*)tmp;
  a.out = (bf16*)out;
  a.S = S; a.step = step; a.L = L; a.B = B; a.T = T; a.D = D; a.H = H;
  a.HH = HH; a.TH = TH; a.E = E; a.int8_attn = int8_attn;
  a.eps1 = eps1; a.eps_qk = eps_qk; a.eps2 = eps2; a.rs_D = rs_D;
  a.rs_hd = rs_hd; a.scale = scale;

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int smem = cmax(cmax(cmax(kSmemUp, kSmemGemm16), kSmemGemm8),
                        cmax(smem_row(D), smem_attn(T, D / H)));
  e = cudaFuncSetAttribute(fused_dit_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_dit_kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // no more CTAs than the largest stage has work items: at b=1 that is 128
  // (the MoE tiles), and every CTA beyond it would only add to the cost of
  // each grid barrier
  const int M = B * T, n_mt = (M + BM - 1) / BM, n_h = HH / TH;
  int items = cmax(M, attn_items(B, H, T));
  items = cmax(items, cmax(n_tiles(M, 3 * D), n_tiles(M, D)));
  items = cmax(items, cmax(2 * n_mt * (HH / BN), 2 * M * n_h));
  items = cmax(items, 2 * n_h * n_mt * (D / BN));
  items = cmax(items, (M * D + kThreads - 1) / kThreads);
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  info[0] = grid;
  info[1] = per_sm;
  info[2] = smem;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)fused_dit_kernel, dim3(grid),
                                  dim3(kThreads), args, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
