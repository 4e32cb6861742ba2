// One whole NoiseBlockMoE inference layer on Hopper (sm_90a).
//
// Replaces the TPU kernel mode_diffusion_policy_tpu/ops/pallas/layer_kernel.py
// (_kernel, launched by fused_layer_q8c) on the `parity` serving path:
//
//   x_mid = x + c_proj(attn(qk_norm(wqkv(rmsnorm(x)*g1 + c) + b)))  (bf16 dots)
//   out   = ln2(x_mid) + sum_{e in top2} p_e * W2_e q(act_e) s       (int8 dots)
//   act_e = value * silu(gate),  [value | gate] = q(ln2(x_mid)) W1_e s + b1
//
// Design. One launcher, fused_layer_q8c_launch, runs a fixed sequence of
// eight or nine __global__ kernels on the caller's stream and allocates
// nothing. The row, attention and sum stages live in layer_stages.cuh,
// shared with the DiT megakernel (fused_dit_q8c.cu); the two expert
// products run on Hopper's wgmma fed by TMA (wgmma_stages.cuh):
//   1 ln1_kernel          per row: h = bf16(rmsnorm(x)*g1 + c)
//   2 gemm_bf16_kernel    qkv = h @ wqkv + b       (wmma bf16, f32 accum)
//   3 attn_kernel         one CTA per (query rows, head, sample): QK-RMSNorm,
//                         causal softmax over T <= 16 tokens, P V (f32 FMA)
//   4 gemm_bf16_kernel    x_mid = bf16(x + o @ wout) (wmma bf16, f32 accum)
//   5 ln2_quant_kernel    xm = bf16(rmsnorm(x_mid)*g2); int8 rows of xm
//   6 moe_up_wg_kernel    value/gate = xq @ W1_e (wgmma s8, s32 accum), act
//   7 act_quant_kernel    int8 rows of act, one scale per block_hidden columns
//   8 moe_down_wg_kernel  out = bf16(((xm + c[0,0]) + c[0,1]) + ...),
//                         c[e, k] = p_e * (aq_k W2_e,k) * scales: one
//                         product pass per (expert slot, hidden block) in
//                         the JAX kernel's order, summed in registers
//                         (128 x 128 tiles); or (64 x 64 tiles, few token
//                         rows) one tile per pass, written as f32 partials
//   9 moe_sum_kernel      that this stage adds in the same order
// The row and attention stages run 128 threads, the megakernel's block size,
// so that the row reductions add in the same order in both kernels; stages
// 2 and 4 use the legacy wmma tiles (64 x 64, a two-stage cp.async
// pipeline: kPipe). Stages 6 and 8 run persistent CTAs of one TMA producer
// warpgroup and one or two wgmma consumer warpgroups on 128 x 128 output
// tiles (64 x 64 for at most 256 token rows: the plan `tile`, `ctas` that
// the wrapper passes in). s8 wgmma takes both operands K-major, so they
// read a K-major copy of the int8 experts (w1_t [E, 2H, D], w2_t [E, D,
// H]) that the model makes once per quantization; the JAX-layout w1_q and
// w2_q stay beside it for the plain versions and the other kernels. The
// s32 sums are exact and the epilogues keep the wmma stages' f32
// operations in order (the down stage's sum too: the same additions in
// the same order as the ordered sum over f32 partials in memory that the
// other kernels run), so the layer gives the same bits as the two-kernel
// composition (fused_attn_block, then fused_top2_mlp_q8c) and as the
// megakernel's layers.
// The TPU kernel keeps x_mid and the quantized rows in VMEM between its
// attention and MoE grid visits; here they pass through device memory (and
// mostly L2) between launches. The cast chain and the rounding match the
// JAX kernel: reciprocal-multiply quantization with round-half-even (rintf),
// act re-quantized per row within each block_hidden column block, the
// accumulator seeded with ln2(x_mid), and the separate multiplies and adds
// of the scale epilogues kept unfused (__fmul_rn/__fadd_rn).
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 1979 TOP/s int8,
// 3.35 TB/s) at the flagship layer, b=128 (N = 1792 rows, D = 1024,
// HH = 4096, top-2): bf16 products 2*N*D*4D + attention = 15.1 GFLOP
// (15.3 us), int8 products 2*N*D*2HH*2 + 2*N*HH*D*2 = 90.2 GOP (45.6 us),
// bytes 41 MB (12 us): compute-bound, a floor of 61 us per launch with the
// two tensor-core rates not overlapped, three quarters of it the int8
// expert products that stages 6 and 8 put on wgmma (the legacy wmma tiles
// ran them at 6% of the int8 rate). At b=1 (N = 14) the bound is the
// bytes of the two selected experts, 25 MB (7.5 us); the 64 x 64 tiles
// spread them over 128 CTAs.

#include <initializer_list>

#include "layer_stages.cuh"
#include "wgmma_stages.cuh"

using namespace mdp;

namespace {

// ---- one work item per CTA of each stage ---------------------------------
__global__ void __launch_bounds__(kThreads)
ln1_kernel(const bf16* x, const float* c, const float* g, bf16* h, int D,
           float rs_D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln1_row(x, c, 1, 0, g, h, D, rs_D, eps, blockIdx.x, smem);
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* A, const bf16* B, int M, int N, int K,
                 const float* bias, float* out_f32, const bf16* resid,
                 bf16* out_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm_bf16_tile<EPI>(A, B, M, N, K, bias, out_f32, resid, out_bf16,
                      blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads)
attn_kernel(const float* qkv, const float* qg, const float* kg, bf16* o,
            int B, int T, int D, int H, int hd, float rs_hd, float eps_qk,
            float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn_item(qkv, qg, kg, o, nullptr, B, T, D, H, hd, rs_hd, eps_qk, scale,
            blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads)
ln2_quant_kernel(const bf16* xmid, const float* g, bf16* xm, int8_t* xq,
                 float* sx, int D, float rs_D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln2_quant_row(xmid, g, xm, xq, sx, D, rs_D, eps, blockIdx.x, smem);
}

template <int WG>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
moe_up_wg_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ wg::MoeArgs a) {
  wg::gemm<wg::Up<WG, wg::kS8>>(&ta, &tb, a);
}

__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const float* act, int8_t* aq, float* sa, int M, int HH,
                 int TH) {
  __shared__ __align__(128) unsigned char smem[kSmemRed];
  act_quant_item(act, aq, sa, M, HH, TH, blockIdx.x, smem);
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

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Stages 6-8: the int8 expert products on wgmma around the act
// re-quantization, WG consumer warpgroups per CTA (tiles of 64 * WG rows);
// the down stage adds its passes to the sum seeded with xm and writes out.
template <int WG>
int moe_stages(const void* xq, const void* sx, const void* w1_t,
               const void* w1_s, const void* b1, const void* w2_t,
               const void* w2_s, const void* idx, const void* probs, int step,
               void* act, void* aq, void* sa, void* part, const void* xm,
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
      WG == 2 ? 1 : 2 * n_h, nullptr, sa, w2_s, xm, WG == 2 ? out : part);
  cudaError_t e = wg::run<Up>(moe_up_wg_kernel<WG>, m_xq, m_w1, up, ctas, st);
  if (e != cudaSuccess) return (int)e;
  act_quant_kernel<<<2 * M * n_h, kThreads, 0, st>>>(
      (const float*)act, (int8_t*)aq, (float*)sa, M, HH, TH);
  e = wg::run<Down>(moe_down_wg_kernel<WG>, m_aq, m_w2, down, ctas, st);
  if (WG == 1 && e == cudaSuccess) {
    const int MD = M * D;
    moe_sum_kernel<<<(MD + 4 * kThreads - 1) / (4 * kThreads), kThreads, 0,
                     st>>>((const bf16*)xm, (const float*)part, (bf16*)out,
                           MD, 2 * n_h);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // namespace

// The int8 experts as the K-major copy w1_t [E, 2H, D], w2_t [E, D, H]
// with their scales w1_s [E, 2H], w2_s [E, D] and f32 b1 [E, 2H]. tile:
// 128 (128 x 128 MoE output tiles, the down stage summing in registers) or
// 64 (64 x 64, the down stage writing part [2 H / TH, M, D] f32 for the
// ordered-sum stage; part is unused for 128); ctas: the most CTAs an MoE
// stage runs at once (one per SM). Returns a CUDA error code, or
// wg::kErrNoEncode / kErrEncode when a TMA tensor map cannot be made;
// nothing runs unless it is 0.
extern "C" int fused_layer_q8c_launch(
    const void* x, const void* c, const void* ln1_g, const void* wqkv,
    const void* bqkv, const void* q_g, const void* k_g, const void* wout,
    const void* ln2_g, const void* w1_t, const void* w1_s, const void* b1,
    const void* w2_t, const void* w2_s, const void* idx, const void* probs,
    int step, void* h, void* qkv, void* o,
    void* xmid, void* xm, void* xq, void* sx, void* act, void* aq, void* sa,
    void* part, void* out, int B, int T, int D, int H, int HH, int TH, int E,
    float eps1, float eps_qk, float eps2, float rs_D, float rs_hd,
    float scale, int tile, int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T, hd = D / H;

  const int attn_smem = smem_attn(T, hd);
  // the GEMM stages' pipelines (and long attention rows) need more than the
  // default 48 KB of dynamic shared memory
  for (const cudaError_t e : {set_smem(attn_kernel, attn_smem),
                              set_smem(gemm_bf16_kernel<0>, kSmemGemm16),
                              set_smem(gemm_bf16_kernel<1>, kSmemGemm16)})
    if (e != cudaSuccess) return (int)e;
  ln1_kernel<<<M, kThreads, smem_row(D), st>>>(
      (const bf16*)x, (const float*)c, (const float*)ln1_g, (bf16*)h, D, rs_D,
      eps1);
  gemm_bf16_kernel<0><<<n_tiles(M, 3 * D), kThreads, kSmemGemm16, st>>>(
      (const bf16*)h, (const bf16*)wqkv, M, 3 * D, D, (const float*)bqkv,
      (float*)qkv, nullptr, nullptr);
  attn_kernel<<<attn_items(B, H, T), kThreads, attn_smem, st>>>(
      (const float*)qkv, (const float*)q_g, (const float*)k_g, (bf16*)o, B, T,
      D, H, hd, rs_hd, eps_qk, scale);
  gemm_bf16_kernel<1><<<n_tiles(M, D), kThreads, kSmemGemm16, st>>>(
      (const bf16*)o, (const bf16*)wout, M, D, D, nullptr, nullptr,
      (const bf16*)x, (bf16*)xmid);
  ln2_quant_kernel<<<M, kThreads, smem_row(D), st>>>(
      (const bf16*)xmid, (const float*)ln2_g, (bf16*)xm, (int8_t*)xq,
      (float*)sx, D, rs_D, eps2);
  return tile == 128
             ? moe_stages<2>(xq, sx, w1_t, w1_s, b1, w2_t, w2_s, idx, probs,
                             step, act, aq, sa, part, xm, out, M, D, HH, TH,
                             E, ctas, st)
             : moe_stages<1>(xq, sx, w1_t, w1_s, b1, w2_t, w2_s, idx, probs,
                             step, act, aq, sa, part, xm, out, M, D, HH, TH,
                             E, ctas, st);
}
