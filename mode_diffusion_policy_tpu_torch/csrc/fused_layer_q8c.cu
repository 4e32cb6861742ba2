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
// nine __global__ kernels on the caller's stream and allocates nothing. The
// stage bodies live in layer_stages.cuh, shared with the DiT megakernel
// (fused_dit_q8c.cu); each kernel here runs one work item per CTA:
//   1 ln1_kernel        per row: h = bf16(rmsnorm(x)*g1 + c)
//   2 gemm_bf16_kernel  qkv = h @ wqkv + b           (wmma bf16, f32 accum)
//   3 attn_kernel       one CTA per (query rows, head, sample): QK-RMSNorm,
//                       causal softmax over T <= 16 tokens, P V  (f32 FMA)
//   4 gemm_bf16_kernel  x_mid = bf16(x + o @ wout)   (wmma bf16, f32 accum)
//   5 ln2_quant_kernel  xm = bf16(rmsnorm(x_mid)*g2); int8 rows of xm
//   6 moe_up_kernel     value/gate = xq @ W1_e (wmma s8, s32 accum), act
//   7 act_quant_kernel  int8 rows of act, one scale per block_hidden columns
//   8 moe_down_kernel   part[e, k] = p_e * (aq_k W2_e,k) * scales, one CTA
//                       column per (expert slot, hidden block)
//   9 moe_sum_kernel    out = bf16(xm + part[0,0] + part[0,1] + ...), the
//                       partial sums added in the JAX kernel's order
// Every stage runs 128 threads, the megakernel's block size, so that the
// row reductions add in the same order in both kernels.
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
// HH = 4096, top-2): bf16 products 2*N*D*4D + attention ~ 15.1 GFLOP
// (15 us), int8 products 2*N*D*2HH*2 + 2*N*HH*D*2 = 90.2 GOP (46 us), bytes
// ~ 41 MB (12 us); compute-bound, so the floor is ~61 us per launch with the
// two tensor-core rates not overlapped. This first version uses the legacy
// wmma (mma.sync) path on 64 x 64 tiles, with a 3-stage cp.async pipeline;
// wgmma/TMA are work for a later change.

#include <initializer_list>

#include "layer_stages.cuh"

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

__global__ void __launch_bounds__(kThreads)
moe_up_kernel(const int8_t* xq, const float* sx, const int8_t* w1_q,
              const float* w1_s, const float* b1, const int* idx, int step,
              float* act, int M, int D, int HH, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  moe_up_tile(xq, sx, w1_q, w1_s, b1, idx, step, act, M, D, HH, E,
              blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const float* act, int8_t* aq, float* sa, int M, int HH,
                 int TH) {
  __shared__ __align__(128) unsigned char smem[kSmemRed];
  act_quant_item(act, aq, sa, M, HH, TH, blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const int8_t* aq, const float* sa, const int8_t* w2_q,
                const float* w2_s, const int* idx, const float* probs,
                int step, float* part, int M, int D, int HH, int TH, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  moe_down_tile(aq, sa, w2_q, w2_s, idx, probs, step, part, M, D, HH, TH, E,
                blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads)
moe_sum_kernel(const bf16* xm, const float* part, bf16* out, int MD,
               int n_part) {
  moe_sum_elems(xm, part, out, MD, n_part, blockIdx.x * blockDim.x + threadIdx.x,
                gridDim.x * blockDim.x);
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" int fused_layer_q8c_launch(
    const void* x, const void* c, const void* ln1_g, const void* wqkv,
    const void* bqkv, const void* q_g, const void* k_g, const void* wout,
    const void* ln2_g, const void* w1_q, const void* w1_s, const void* b1,
    const void* w2_q, const void* w2_s, const void* idx, const void* probs,
    int step, void* h, void* qkv, void* o, void* xmid, void* xm, void* xq,
    void* sx, void* act, void* aq, void* sa, void* part, void* out, int B,
    int T, int D,
    int H, int HH, int TH, int E, float eps1, float eps_qk, float eps2,
    float rs_D, float rs_hd, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T, hd = D / H, n_h = HH / TH;
  const int n_mt = (M + BM - 1) / BM;

  const int attn_smem = smem_attn(T, hd);
  // the GEMM stages' pipelines (and long attention rows) need more than the
  // default 48 KB of dynamic shared memory
  for (const cudaError_t e : {set_smem(attn_kernel, attn_smem),
                              set_smem(gemm_bf16_kernel<0>, kSmemGemm16),
                              set_smem(gemm_bf16_kernel<1>, kSmemGemm16),
                              set_smem(moe_up_kernel, kSmemUp),
                              set_smem(moe_down_kernel, kSmemGemm8)})
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
  moe_up_kernel<<<2 * n_mt * (HH / BN), kThreads, kSmemUp, st>>>(
      (const int8_t*)xq, (const float*)sx, (const int8_t*)w1_q,
      (const float*)w1_s, (const float*)b1, (const int*)idx, step, (float*)act,
      M, D, HH, E);
  act_quant_kernel<<<2 * M * n_h, kThreads, 0, st>>>(
      (const float*)act, (int8_t*)aq, (float*)sa, M, HH, TH);
  moe_down_kernel<<<2 * n_h * n_mt * (D / BN), kThreads, kSmemGemm8, st>>>(
      (const int8_t*)aq, (const float*)sa, (const int8_t*)w2_q,
      (const float*)w2_s, (const int*)idx, (const float*)probs, step,
      (float*)part, M, D, HH, TH, E);
  const int MD = M * D;
  moe_sum_kernel<<<(MD + 4 * kThreads - 1) / (4 * kThreads), kThreads, 0, st>>>(
      (const bf16*)xm, (const float*)part, (bf16*)out, MD, 2 * n_h);
  return (int)cudaGetLastError();
}
