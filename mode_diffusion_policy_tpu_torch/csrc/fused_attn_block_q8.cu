// The attention sub-block of one NoiseBlockMoE inference layer with int8
// projections, on Hopper (sm_90a).
//
// Replaces the TPU kernel mode_diffusion_policy_tpu/ops/pallas/attn_kernel.py
// (_kernel_q8, launched by fused_attn_block_q8) on the `max-throughput`
// serving path:
//
//   hq, hs = q(rmsnorm(x) * g1 + c)                  (f32, no bf16 cast)
//            c one row shared by every sample, or one row per sample
//   qkv    = dot_i8(hq, wqkv_q) * (hs * sqkv) + bqkv
//   o      = attn(qk_norm(q), qk_norm(k), v)         (causal per sample)
//   out    = bf16(x + dot_i8(q(o), wout_q) * (os * sout))
//
// Design. One launcher, fused_attn_block_q8_launch, runs five __global__
// kernels on the caller's stream and allocates nothing. Their bodies are
// the stage functions of layer_stages.cuh that the DiT megakernel
// (fused_dit_q8c.cu) runs on its int8-projection path, one work item per
// CTA of 128 threads, so the result equals one layer of that kernel bit
// for bit:
//   1 ln1_quant_kernel  per row: f32 h = rmsnorm(x)*g1 + c, int8 row + scale
//   2 gemm_i8_kernel<0> qkv = (hq wqkv_q) * (hs * sqkv) + bqkv  (wmma s8)
//   3 attn_kernel       one CTA per (query rows, head, sample): QK-RMSNorm,
//                       causal softmax over T <= 16 tokens, P V, o in f32
//   4 quant_f32_kernel  per row: int8 row + scale of o
//   5 gemm_i8_kernel<1> out = bf16(x + (oq wout_q) * (os * sout))
// The TPU kernel keeps h, qkv and o in VMEM inside one grid step of 16
// whole samples; here they pass through device memory (mostly L2) between
// launches, and attention is computed on exactly B*T rows (no padding of
// the batch to whole blocks, no block-diagonal mask).
//
// Bound on this card (H100 SXM, 1979 TOP/s int8, 3.35 TB/s) at the
// flagship width (D = 1024, 8 heads of 128, 14 tokens per sample):
//   b=128 (N = 1792 rows): operations, 2*N*D*4D = 15.0 GOP int8 -> 7.6 us
//   (bytes: 4.2 MB of int8 weights + 7.3 MB of activations, 3.4 us);
//   b=1 (N = 14): bytes, 4.2 MB of weights -> 1.3 us.
// This first version uses the legacy wmma (mma.sync) int8 tiles of the
// shared stages on 64 x 64 output tiles; wgmma/TMA are work for later.

#include <initializer_list>

#include "layer_stages.cuh"

using namespace mdp;

namespace {

__global__ void __launch_bounds__(kThreads)
ln1_quant_kernel(const bf16* x, const float* c, int T, int c_stride,
                 const float* g, int8_t* hq, float* hs, int D, float rs_D,
                 float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln1_quant_row(x, c, T, c_stride, g, hq, hs, D, rs_D, eps, blockIdx.x,
                smem);
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_i8_kernel(const int8_t* A, const float* sa, const int8_t* B,
               const float* sb, int M, int N, int K, const float* bias,
               float* out_f32, const bf16* resid, bf16* out_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm_i8_tile<EPI>(A, sa, B, sb, M, N, K, bias, out_f32, resid, out_bf16,
                    blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads)
attn_kernel(const float* qkv, const float* qg, const float* kg, float* o,
            int B, int T, int D, int H, int hd, float rs_hd, float eps_qk,
            float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn_item(qkv, qg, kg, nullptr, o, B, T, D, H, hd, rs_hd, eps_qk, scale,
            blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads)
quant_f32_kernel(const float* src, int8_t* q, float* s, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  quant_f32_row(src, q, s, D, blockIdx.x, smem);
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// c_stride: 0 for one cond row shared by every sample, D for one row per
// sample. Returns a CUDA error code; nothing runs unless it is 0.
extern "C" int fused_attn_block_q8_launch(
    const void* x, const void* c, const void* ln1_g, const void* wqkv_q,
    const void* wqkv_s, const void* bqkv, const void* q_g, const void* k_g,
    const void* wout_q, const void* wout_s, void* hq, void* hs, void* qkv,
    void* o, void* oq, void* os, void* out, int B, int T, int D, int H,
    int c_stride, float eps1, float eps_qk, float rs_D, float rs_hd,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T, hd = D / H;
  const int attn_smem = smem_attn(T, hd);
  for (const cudaError_t e : {set_smem(attn_kernel, attn_smem),
                              set_smem(gemm_i8_kernel<0>, kSmemGemm8),
                              set_smem(gemm_i8_kernel<1>, kSmemGemm8)})
    if (e != cudaSuccess) return (int)e;
  ln1_quant_kernel<<<M, kThreads, smem_row(D), st>>>(
      (const bf16*)x, (const float*)c, T, c_stride, (const float*)ln1_g,
      (int8_t*)hq, (float*)hs, D, rs_D, eps1);
  gemm_i8_kernel<0><<<n_tiles(M, 3 * D), kThreads, kSmemGemm8, st>>>(
      (const int8_t*)hq, (const float*)hs, (const int8_t*)wqkv_q,
      (const float*)wqkv_s, M, 3 * D, D, (const float*)bqkv, (float*)qkv,
      nullptr, nullptr);
  attn_kernel<<<attn_items(B, H, T), kThreads, attn_smem, st>>>(
      (const float*)qkv, (const float*)q_g, (const float*)k_g, (float*)o, B,
      T, D, H, hd, rs_hd, eps_qk, scale);
  quant_f32_kernel<<<M, kThreads, smem_row(D), st>>>(
      (const float*)o, (int8_t*)oq, (float*)os, D);
  gemm_i8_kernel<1><<<n_tiles(M, D), kThreads, kSmemGemm8, st>>>(
      (const int8_t*)oq, (const float*)os, (const int8_t*)wout_q,
      (const float*)wout_s, M, D, D, nullptr, nullptr, (const bf16*)x,
      (bf16*)out);
  return (int)cudaGetLastError();
}
