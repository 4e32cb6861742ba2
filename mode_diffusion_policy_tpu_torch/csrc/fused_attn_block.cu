// The attention sub-block of one NoiseBlockMoE inference layer with bf16
// projections, on Hopper (sm_90a).
//
// Replaces the TPU kernel mode_diffusion_policy_tpu/ops/pallas/attn_kernel.py
// (_kernel, launched by fused_attn_block) on the paths that run the
// attention sub-block on its own: the samplers' off-schedule evaluations
// under `parity` and `b1-latency` (one cond row per sample), and int8
// experts outside the whole-layer kernel (one shared cond row):
//
//   h   = bf16(rmsnorm(x) * g1 + c)
//   qkv = h @ wqkv + bqkv                             (bf16 dots, f32 accum)
//   o   = bf16(attn(qk_norm(q), qk_norm(k), v))       (causal per sample)
//   out = bf16(x + o @ wout)                          (bf16 dots, f32 accum)
//
// Design. One launcher, fused_attn_block_launch, runs four __global__
// kernels on the caller's stream and allocates nothing. They are the first
// four stages of fused_layer_q8c.cu, over the same stage bodies of
// layer_stages.cuh, one work item per CTA of 128 threads: the output is
// that kernel's x_mid bit for bit, so this kernel followed by
// fused_top2_mlp_q8c (ln_2 fused, the normed input as the residual seed)
// equals one fused_layer_q8c launch.
//   1 ln1_kernel          per row: h = bf16(rmsnorm(x)*g1 + c)
//   2 gemm_bf16_kernel<0> qkv = h @ wqkv + b           (wmma bf16)
//   3 attn_kernel         one CTA per (query rows, head, sample): QK-RMSNorm,
//                         causal softmax over T <= 16 tokens, P V, o in bf16
//   4 gemm_bf16_kernel<1> out = bf16(x + o @ wout)     (wmma bf16)
// The TPU kernel keeps h, qkv and o in VMEM inside one grid step of 16
// whole samples; here they pass through device memory (mostly L2) between
// launches, and attention runs on exactly B*T rows (no padding of the batch
// to whole blocks, no block-diagonal mask).
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s) at the
// flagship width (D = 1024, 8 heads of 128, 14 tokens per sample):
//   b=128 (N = 1792 rows): operations, 2*N*D*4D = 15.0 GFLOP -> 15.2 us
//   (bytes: 8.4 MB of bf16 weights + 7.3 MB of activations, 4.7 us);
//   b=1 (N = 14): bytes, 8.4 MB of weights -> 2.5 us.
// This first version uses the legacy wmma (mma.sync) bf16 tiles of the
// shared stages on 64 x 64 output tiles; wgmma/TMA are work for later.

#include <initializer_list>

#include "layer_stages.cuh"

using namespace mdp;

namespace {

__global__ void __launch_bounds__(kThreads)
ln1_kernel(const bf16* x, const float* c, int T, int c_stride, const float* g,
           bf16* h, int D, float rs_D, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln1_row(x, c, T, c_stride, g, h, D, rs_D, eps, blockIdx.x, smem);
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

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// c_stride: 0 for one cond row shared by every sample, D for one row per
// sample. Returns a CUDA error code; nothing runs unless it is 0.
extern "C" int fused_attn_block_launch(
    const void* x, const void* c, const void* ln1_g, const void* wqkv,
    const void* bqkv, const void* q_g, const void* k_g, const void* wout,
    void* h, void* qkv, void* o, void* out, int B, int T, int D, int H,
    int c_stride, float eps1, float eps_qk, float rs_D, float rs_hd,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T, hd = D / H;
  const int attn_smem = smem_attn(T, hd);
  for (const cudaError_t e : {set_smem(attn_kernel, attn_smem),
                              set_smem(gemm_bf16_kernel<0>, kSmemGemm16),
                              set_smem(gemm_bf16_kernel<1>, kSmemGemm16)})
    if (e != cudaSuccess) return (int)e;
  ln1_kernel<<<M, kThreads, smem_row(D), st>>>(
      (const bf16*)x, (const float*)c, T, c_stride, (const float*)ln1_g,
      (bf16*)h, D, rs_D, eps1);
  gemm_bf16_kernel<0><<<n_tiles(M, 3 * D), kThreads, kSmemGemm16, st>>>(
      (const bf16*)h, (const bf16*)wqkv, M, 3 * D, D, (const float*)bqkv,
      (float*)qkv, nullptr, nullptr);
  attn_kernel<<<attn_items(B, H, T), kThreads, attn_smem, st>>>(
      (const float*)qkv, (const float*)q_g, (const float*)k_g, (bf16*)o, B, T,
      D, H, hd, rs_hd, eps_qk, scale);
  gemm_bf16_kernel<1><<<n_tiles(M, D), kThreads, kSmemGemm16, st>>>(
      (const bf16*)o, (const bf16*)wout, M, D, D, nullptr, nullptr,
      (const bf16*)x, (bf16*)out);
  return (int)cudaGetLastError();
}
