// The int8 x int8 top-2 SwishGLU MoE of one NoiseBlockMoE inference layer,
// with its optional fused prenorm (the block's ln_2) and residual seed, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel mode_diffusion_policy_tpu/ops/pallas/moe_kernel.py
// (_kernel_q8c, launched by fused_top2_mlp_q8c) on the `max-throughput`
// serving path:
//
//   xm     = bf16(rmsnorm(x) * g2)   with ln_g, else x
//   out    = bf16(seed + sum_{e in top2} p_e * W2_e q(act_e) s)
//   act_e  = value * silu(gate),  [value | gate] = q(xm) W1_e s + b1
//   seed   = xm with residual, else 0
//
// Design. One launcher, fused_top2_mlp_q8c_launch, runs five __global__
// kernels on the caller's stream and allocates nothing. Their bodies are
// the MoE stages of layer_stages.cuh that the per-layer kernel
// (fused_layer_q8c.cu) and the DiT megakernel run, one work item per CTA
// of 128 threads, so that attention kernel -> this kernel equals one
// layer of those kernels bit for bit:
//   1 ln2_quant_kernel  per row: xm = bf16(rmsnorm(x)*g2), int8 row of xm
//     (quant_row_kernel without ln_g: int8 row of x)
//   2 moe_up_kernel     value/gate = xq @ W1_e (wmma s8, s32 accum), act
//   3 act_quant_kernel  int8 rows of act, one scale per block_hidden columns
//   4 moe_down_kernel   part[e, k] = p_e * (aq_k W2_e,k) * scales, one CTA
//                       column per (expert slot, hidden block)
//   5 moe_sum_kernel    out = bf16(seed + part[0,0] + part[0,1] + ...), the
//                       partial sums added in the JAX kernel's order
// The TPU kernel keeps the f32 accumulator and the quantized rows in VMEM
// over its (2 slots x hidden blocks) grid revisits and reads the expert
// indices by scalar prefetch; here every (slot, hidden block) partial is
// written to device memory and summed in order by the last stage, and the
// tiles read the indices from the [S, 2] routing tables at row `step`.
// Any token count N = B*T is taken: the last 64-row tile is masked.
//
// Bound on this card (H100 SXM, 1979 TOP/s int8, 3.35 TB/s) at the
// flagship width (D = 1024, hidden 4096, top-2 of 4 experts):
//   b=128 (N = 1792 rows): operations, 2*N*D*3H*2 = 90.2 GOP int8 ->
//   45.6 us (bytes: 25.2 MB for two experts + 7.3 MB of activations,
//   9.7 us); b=1 (N = 14): bytes, 25.2 MB -> 7.5 us.
// This first version uses the legacy wmma (mma.sync) int8 tiles of the
// shared stages on 64 x 64 output tiles; wgmma/TMA are work for later.

#include <initializer_list>

#include "layer_stages.cuh"

using namespace mdp;

namespace {

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

}  // namespace

// ln_g == nullptr: no prenorm (xm is x itself and the xm buffer is not
// written); residual == 0: the sum is seeded with 0. Returns a CUDA error
// code; nothing runs unless it is 0.
extern "C" int fused_top2_mlp_q8c_launch(
    const void* x, const void* ln_g, const void* w1_q, const void* w1_s,
    const void* b1, const void* w2_q, const void* w2_s, const void* idx,
    const void* probs, int step, void* xm, void* xq, void* sx, void* act,
    void* aq, void* sa, void* part, void* out, int M, int D, int HH, int TH,
    int E, int residual, float eps, float rs_D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_h = HH / TH, n_mt = (M + BM - 1) / BM;
  for (const cudaError_t e : {set_smem(moe_up_kernel, kSmemUp),
                              set_smem(moe_down_kernel, kSmemGemm8)})
    if (e != cudaSuccess) return (int)e;
  const bf16* seed = (const bf16*)x;
  if (ln_g) {
    ln2_quant_kernel<<<M, kThreads, smem_row(D), st>>>(
        (const bf16*)x, (const float*)ln_g, (bf16*)xm, (int8_t*)xq,
        (float*)sx, D, rs_D, eps);
    seed = (const bf16*)xm;
  } else {
    quant_row_kernel<<<M, kThreads, smem_row(D), st>>>(
        (const bf16*)x, (int8_t*)xq, (float*)sx, D);
  }
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
      residual ? seed : nullptr, (const float*)part, (bf16*)out, MD, 2 * n_h);
  return (int)cudaGetLastError();
}
