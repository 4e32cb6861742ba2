// The launch sequences of the wgmma layer stages on Hopper (sm_90a), shared
// by the launchers that run them: the attention sub-block with int8
// projections (fused_attn_block_q8.cu, and fused_layer_q8c.cu's
// int8-projection launcher), the int8 x int8 top-2 MoE
// (fused_top2_mlp_q8c.cu and both of fused_layer_q8c.cu's launchers), and
// the bf16 projections of the attention sub-block (fused_attn_block.cu and
// fused_layer_q8c.cu's bf16-projection launcher: proj_stage<EPI, kBf16>).
// So the two-kernel path (attention kernel, then MoE kernel) and the
// whole-layer kernel run the same stages with the same tiles and give the
// same bits.
//
//   attn_q8_stages  1 ln1_quant_kernel  per row: f32 h = rmsnorm(x)*g1 + c,
//                                       int8 row + scale
//                   2 qkv_wg_kernel     qkv = (hq wqkv) * (hs * sqkv) + bqkv
//                   3 attn_kernel       QK-RMSNorm, causal softmax, P V; o f32
//                   4 quant_f32_kernel  per row: int8 row + scale of o
//                   5 cproj_wg_kernel   out = bf16(x + (oq wout) * (os * sout))
//   moe_q8c_stages  6 moe_up_wg_kernel  value/gate = xq W1_e (s8), act
//                   7 act_quant_kernel  int8 rows of act per block_hidden block
//                   8 moe_down_wg_kernel  out = bf16(((seed + c[0,0]) + c[0,1])
//                                       + ...) in registers (128 x 128 tiles),
//                                       or f32 partials (64 x 64) that
//                   9 moe_sum_kernel    adds in the same order
// with the row, attention and sum stages of layer_stages.cuh (one work item
// per CTA of 128 threads, the megakernel's team of one consumer
// warpgroup, so their reductions add in the megakernel's order) and the
// products on wgmma fed by TMA (wgmma_stages.cuh: Proj, Up, Down), each
// stage one __global__ launch on the caller's stream; nothing is
// allocated. The int8 products read the K-major copies of the weights
// (ops/quant.py kmajor_attn, kmajor_experts): s8 wgmma takes both operands
// K-major; the bf16 projections read their weights MN-major, as stored.
// The s32 sums are exact, the bf16 ones run in the tensor core's order
// under the same tile plan as the megakernel's, and the epilogues run the
// same f32 operations in the same order, so the results equal the
// megakernel's (fused_dit_q8c.cu) bit for bit.
#pragma once

#include <initializer_list>
#include <type_traits>

#include "layer_stages.cuh"
#include "wgmma_stages.cuh"

// every library keeps its own copy of the __global__ wrappers, in the
// anonymous namespace that its launcher's own stages use too
namespace {

using namespace mdp;

// c: f32 cond rows (x's dtype widened), row r's at c + (r / c_div) *
// c_stride (layer_stages.cuh CondMap)
__global__ void __launch_bounds__(kThreads)
ln1_kernel(const bf16* x, const float* c, int c_div, int c_stride,
           const float* g, bf16* h, int D, float rs_D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln1_row(x, c, c_div, c_stride, g, h, D, rs_D, eps, blockIdx.x, smem);
}

// c: the cond rows in bf16, x's dtype, as the JAX kernel takes them (the
// caller converts nothing on the served path, where they are bf16 already);
// the row's cond (as in ln1_kernel) is widened into shared memory after
// the row stage's own
__global__ void __launch_bounds__(kThreads)
ln1_quant_kernel(const bf16* x, const bf16* c, int c_div, int c_stride,
                 const float* g, int8_t* hq, float* hs, int D, float rs_D,
                 float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cond = reinterpret_cast<float*>(smem + smem_row(D));
  const bf16* cr = c + (size_t)(blockIdx.x / c_div) * c_stride;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    cond[d] = __bfloat162float(cr[d]);
  __syncthreads();
  ln1_quant_row(x, cond, 1, 0, g, hq, hs, D, rs_D, eps, blockIdx.x, smem);
}

// WG consumer warpgroups, tiles of 64 WG rows x BN columns; KIND wg::kS8
// (int8 projections) or wg::kBf16
template <int WG, int BN, int KIND>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
qkv_wg_kernel(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ wg::ProjArgs a) {
  wg::gemm<wg::Proj<WG, BN, 0, KIND>>(&ta, &tb, a);
}

template <int WG, int BN, int KIND>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
cproj_wg_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ wg::ProjArgs a) {
  wg::gemm<wg::Proj<WG, BN, 1, KIND>>(&ta, &tb, a);
}

// O = float: o stays f32 for the re-quantization (int8 projections);
// O = bf16: o rounded to bf16 (bf16 projections); kb key rows per block.
// MINB: the CTAs an SM is to hold (attn_plan): 4 caps the registers at
// 128, for many small items; 1 leaves the stage its registers. The same
// code either way, so the same bits.
template <typename O, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
attn_kernel(const float* qkv, const float* qg, const float* kg, O* o, int B,
            int T, int D, int H, int hd, float rs_hd, float eps_qk,
            float scale, int kb) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (std::is_same<O, float>::value)
    attn_item(qkv, qg, kg, nullptr, o, B, T, D, H, hd, rs_hd, eps_qk, scale,
              kb, blockIdx.x, smem);
  else
    attn_item(qkv, qg, kg, o, nullptr, B, T, D, H, hd, rs_hd, eps_qk, scale,
              kb, blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads)
quant_f32_kernel(const float* src, int8_t* q, float* s, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  quant_f32_row(src, q, s, D, blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads)
ln2_quant_kernel(const bf16* x, const float* g, bf16* xm, int8_t* xq,
                 float* sx, int D, float rs_D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln2_quant_row(x, g, xm, xq, sx, D, rs_D, eps, blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads)
quant_row_kernel(const bf16* x, int8_t* xq, float* sx, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  quant_bf16_row(x, xq, sx, D, blockIdx.x, smem);
}

template <int WG>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
moe_up_wg_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ wg::MoeArgs a) {
  wg::gemm<wg::Up<WG, wg::kS8>>(&ta, &tb, a);
}

// one warp per item: items 4 blockIdx.x .. 4 blockIdx.x + 3 of 2 M H / TH
__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const float* act, int8_t* aq, float* sa, int M, int HH,
                 int TH) {
  const int item = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (item < 2 * M * (HH / TH))
    act_quant_warp(act, aq, sa, M, HH, TH, item, threadIdx.x % 32);
}

template <int WG>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
moe_down_wg_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ wg::MoeArgs a) {
  wg::gemm<wg::Down<WG, wg::kS8, WG == 2>>(&ta, &tb, a);
}

__global__ void __launch_bounds__(kThreads)
moe_sum_kernel(const bf16* seed, const float* part, bf16* out, int MD,
               int n_part) {
  moe_sum_elems(seed, part, out, MD, n_part,
                blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

// the shared-memory grant of a stage beyond the default 48 KB
template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return wg::grant_smem(reinterpret_cast<const void*>(kernel), bytes);
}

// The attention kernel's shared memory per CTA: all of a sample's keys
// where they fit kAttnSmemAll (k^ and v loaded once; two CTAs an SM at
// the flagship widths up to T = 176), else blocks of keys within
// kAttnSmem, the default grant, so that several CTAs share an SM while
// each pass streams its blocks (attn_kb).
constexpr int kAttnSmemAll = 112 * 1024;
constexpr int kAttnSmem = 48 * 1024;
constexpr int kSmemPerSm = 228 * 1024;   // an H100 SM's shared memory

// The attention stage's launch plan: the cond rows' map from their count
// c_rows (1, B or B T), the key rows per block, the CTA's shared memory
// and whether four CTAs are to share an SM (many items, each of them
// small enough: their registers, not their shared memory, would cap the
// CTAs an SM holds; at b=1 the stage is bound by one item's latency,
// which spilled registers lengthen); cudaErrorInvalidValue for another
// count of cond rows.
struct AttnPlan {
  CondMap cond;
  int kb, smem;
  bool four;
};

inline cudaError_t attn_plan(int c_rows, int B, int T, int D, int H,
                             AttnPlan* p) {
  const int hd = D / H, rows = attn_rows(B, H, T);
  if (!cond_map(c_rows, B, T, D, &p->cond)) return cudaErrorInvalidValue;
  p->kb = smem_attn(hd, rows, round16(T)) <= kAttnSmemAll
              ? round16(T)
              : attn_kb(T, hd, rows,
                        cmax(kAttnSmem, smem_attn(hd, rows, kAttnTile)));
  if (p->kb < 1) return cudaErrorInvalidValue;
  p->smem = smem_attn(hd, rows, p->kb);
  p->four = B * H >= 128 && 4 * (p->smem + 1024) <= kSmemPerSm;
  return cudaSuccess;
}

template <typename O>
using AttnKernel = void (*)(const float*, const float*, const float*, O*, int,
                            int, int, int, int, float, float, float, int);

// The attention stage's kernel under the plan.
template <typename O>
AttnKernel<O> attn_stage(const AttnPlan& ap) {
  return ap.four ? attn_kernel<O, 4> : attn_kernel<O, 1>;
}

template <int WG, int BN, int EPI, int KIND>
int run_proj(const CUtensorMap& ma, const CUtensorMap& mw,
             const wg::ProjArgs& a, int ctas, cudaStream_t st) {
  using Op = wg::Proj<WG, BN, EPI, KIND>;
  if constexpr (EPI == 0)
    return (int)wg::run<Op>(qkv_wg_kernel<WG, BN, KIND>, ma, mw, a, ctas, st);
  else
    return (int)wg::run<Op>(cproj_wg_kernel<WG, BN, KIND>, ma, mw, a, ctas,
                            st);
}

// One projection of M rows a [M, K] by the weight [K, N], EPI 0 with the
// bias into f32 out, EPI 1 added to resid into bf16 out, in tiles of tm
// (64 or 128) rows x tn (64 or 128) columns on at most `ctas` persistent
// CTAs. KIND wg::kS8: int8 rows (row scales sa) and the K-major int8
// weight w [N, K] (column scales sb); wg::kBf16: bf16 rows and the bf16
// weight w [K, N] as it is stored (sa, sb unused).
template <int EPI, int KIND = wg::kS8>
int proj_stage(const void* a, const void* sa, const void* w, const void* sb,
               const void* bias, const void* resid, void* out, int M, int N,
               int K, int tm, int tn, int ctas, cudaStream_t st) {
  constexpr int esz = KIND == wg::kS8 ? 1 : 2;
  CUtensorMap ma, mw;
  const uint64_t da[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t dw[3] = {KIND == wg::kS8 ? (uint64_t)K : (uint64_t)N,
                          KIND == wg::kS8 ? (uint64_t)N : (uint64_t)K, 1};
  for (const int e : {wg::cached_map(&ma, a, esz, 2, da),
                      wg::cached_map(&mw, w, esz, 3, dw)})
    if (e) return e;
  const wg::ProjArgs pa =
      wg::proj_args(M, N, K, tm / 64, tn, sa, sb, bias, resid, out);
  if (tm == 128 && tn == 128)
    return run_proj<2, 128, EPI, KIND>(ma, mw, pa, ctas, st);
  if (tm == 128 && tn == 64)
    return run_proj<2, 64, EPI, KIND>(ma, mw, pa, ctas, st);
  if (tm == 64 && tn == 128)
    return run_proj<1, 128, EPI, KIND>(ma, mw, pa, ctas, st);
  if (tm == 64 && tn == 64)
    return run_proj<1, 64, EPI, KIND>(ma, mw, pa, ctas, st);
  return (int)cudaErrorInvalidValue;
}

// Stages 1-5: the attention sub-block with int8 projections, out = x +
// attn(...) (the layer's x_mid). c: c_rows bf16 cond rows, one shared by
// every token (1), one per sample (B) or one per token (B T). tiles: the
// (rows, columns) of the QKV tiles, then of the c_proj tiles.
inline int attn_q8_stages(
    const void* x, const void* c, int c_rows, const void* ln1_g,
    const void* wqkv_t, const void* wqkv_s, const void* bqkv, const void* q_g,
    const void* k_g, const void* wout_t, const void* wout_s, void* hq,
    void* hs, void* qkv, void* o, void* oq, void* os, void* out, int B,
    int T, int D, int H, float eps1, float eps_qk, float rs_D, float rs_hd,
    float scale, const int (&tiles)[4], int ctas, cudaStream_t st) {
  const int M = B * T, hd = D / H;
  AttnPlan ap;
  if (const cudaError_t e = attn_plan(c_rows, B, T, D, H, &ap)) return (int)e;
  const AttnKernel<float> attn = attn_stage<float>(ap);
  if (const cudaError_t e = set_smem(attn, ap.smem)) return (int)e;
  ln1_quant_kernel<<<M, kThreads, smem_row(D) + 4 * D, st>>>(
      (const bf16*)x, (const bf16*)c, ap.cond.div, ap.cond.stride,
      (const float*)ln1_g, (int8_t*)hq, (float*)hs, D, rs_D, eps1);
  if (const int e = proj_stage<0>(hq, hs, wqkv_t, wqkv_s, bqkv, nullptr, qkv,
                                  M, 3 * D, D, tiles[0], tiles[1], ctas, st))
    return e;
  attn<<<attn_items(B, H, T), kThreads, ap.smem, st>>>(
      (const float*)qkv, (const float*)q_g, (const float*)k_g, (float*)o, B,
      T, D, H, hd, rs_hd, eps_qk, scale, ap.kb);
  quant_f32_kernel<<<M, kThreads, smem_row(D), st>>>(
      (const float*)o, (int8_t*)oq, (float*)os, D);
  return proj_stage<1>(oq, os, wout_t, wout_s, nullptr, x, out, M, D, D,
                       tiles[2], tiles[3], ctas, st);
}

// The attention sub-block with bf16 projections, out = x + attn(...) (the
// layer's x_mid): ln1, the QKV projection on wgmma bf16, attention with o
// rounded to bf16, c_proj on wgmma bf16 added to x. c: c_rows f32 cond
// rows (as in attn_q8_stages). tiles: the (rows, columns) of the QKV
// tiles, then of the c_proj tiles.
inline int attn_bf16_stages(
    const void* x, const void* c, int c_rows, const void* ln1_g,
    const void* wqkv, const void* bqkv, const void* q_g, const void* k_g,
    const void* wout, void* h, void* qkv, void* o, void* out, int B, int T,
    int D, int H, float eps1, float eps_qk, float rs_D, float rs_hd,
    float scale, const int (&tiles)[4], int ctas, cudaStream_t st) {
  const int M = B * T, hd = D / H;
  AttnPlan ap;
  if (const cudaError_t e = attn_plan(c_rows, B, T, D, H, &ap)) return (int)e;
  const AttnKernel<bf16> attn = attn_stage<bf16>(ap);
  if (const cudaError_t e = set_smem(attn, ap.smem)) return (int)e;
  ln1_kernel<<<M, kThreads, smem_row(D), st>>>(
      (const bf16*)x, (const float*)c, ap.cond.div, ap.cond.stride,
      (const float*)ln1_g, (bf16*)h, D, rs_D, eps1);
  if (const int e = proj_stage<0, wg::kBf16>(
          h, nullptr, wqkv, nullptr, bqkv, nullptr, qkv, M, 3 * D, D,
          tiles[0], tiles[1], ctas, st))
    return e;
  attn<<<attn_items(B, H, T), kThreads, ap.smem, st>>>(
      (const float*)qkv, (const float*)q_g, (const float*)k_g, (bf16*)o, B,
      T, D, H, hd, rs_hd, eps_qk, scale, ap.kb);
  return proj_stage<1, wg::kBf16>(o, nullptr, wout, nullptr, nullptr, x, out,
                                  M, D, D, tiles[2], tiles[3], ctas, st);
}

// Stages 6-9: the int8 expert products on wgmma around the act
// re-quantization, WG consumer warpgroups per CTA (tiles of 64 * WG rows);
// the down stage adds its passes to the sum seeded with `seed` (nullptr:
// 0) and writes out.
template <int WG>
int moe_stages(const void* xq, const void* sx, const void* w1_t,
               const void* w1_s, const void* b1, const void* w2_t,
               const void* w2_s, const void* idx, const void* probs, int step,
               void* act, void* aq, void* sa, void* part, const void* seed,
               void* out, int M, int D, int HH, int TH, int E, int ctas,
               cudaStream_t st) {
  using Up = wg::Up<WG, wg::kS8>;
  using Down = wg::Down<WG, wg::kS8, WG == 2>;
  const int n_h = HH / TH;
  CUtensorMap m_xq, m_w1, m_aq, m_w2;
  const uint64_t d_xq[2] = {(uint64_t)D, (uint64_t)M};
  const uint64_t d_aq[3] = {(uint64_t)HH, (uint64_t)M, 2};
  for (const int e : {wg::cached_map(&m_xq, xq, 1, 2, d_xq),
                      wg::weight_map(&m_w1, w1_t, 1, D, 2 * HH, E),
                      wg::cached_map(&m_aq, aq, 1, 3, d_aq),
                      wg::weight_map(&m_w2, w2_t, 1, HH, D, E)})
    if (e) return e;
  const wg::MoeArgs up = wg::stage_args(
      idx, probs, step, M, D, HH, TH, E, WG, Up::kNV, HH, 2, b1, sx, w1_s,
      nullptr, act);
  const wg::MoeArgs down = wg::stage_args(
      idx, probs, step, M, D, HH, TH, E, WG, Down::kN, D,
      WG == 2 ? 1 : 2 * n_h, nullptr, sa, w2_s, seed, WG == 2 ? out : part);
  cudaError_t e = wg::run<Up>(moe_up_wg_kernel<WG>, m_xq, m_w1, up, ctas, st);
  if (e != cudaSuccess) return (int)e;
  act_quant_kernel<<<(2 * M * n_h + kThreads / 32 - 1) / (kThreads / 32),
                     kThreads, 0, st>>>(
      (const float*)act, (int8_t*)aq, (float*)sa, M, HH, TH);
  e = wg::run<Down>(moe_down_wg_kernel<WG>, m_aq, m_w2, down, ctas, st);
  if (WG == 1 && e == cudaSuccess) {
    const int MD = M * D;
    moe_sum_kernel<<<(MD + 4 * kThreads - 1) / (4 * kThreads), kThreads, 0,
                     st>>>((const bf16*)seed, (const float*)part, (bf16*)out,
                           MD, 2 * n_h);
    e = cudaGetLastError();
  }
  return (int)e;
}

// The MoE stages under the tile plan: tile 128 (128 x 128 tiles, the down
// stage summing in registers; part unused) or 64 (64 x 64, part [2 H / TH,
// M, D] f32 for the ordered-sum stage).
inline int moe_q8c_stages(int tile, const void* xq, const void* sx,
                          const void* w1_t, const void* w1_s, const void* b1,
                          const void* w2_t, const void* w2_s, const void* idx,
                          const void* probs, int step, void* act, void* aq,
                          void* sa, void* part, const void* seed, void* out,
                          int M, int D, int HH, int TH, int E, int ctas,
                          cudaStream_t st) {
  return tile == 128
             ? moe_stages<2>(xq, sx, w1_t, w1_s, b1, w2_t, w2_s, idx, probs,
                             step, act, aq, sa, part, seed, out, M, D, HH, TH,
                             E, ctas, st)
             : moe_stages<1>(xq, sx, w1_t, w1_s, b1, w2_t, w2_s, idx, probs,
                             step, act, aq, sa, part, seed, out, M, D, HH, TH,
                             E, ctas, st);
}

}  // namespace
