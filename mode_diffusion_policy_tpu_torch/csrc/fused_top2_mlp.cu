// The bf16-compute top-2 SwishGLU MoE of one NoiseBlockMoE inference layer,
// with its optional fused prenorm (the block's ln_2) and residual seed, on
// Hopper (sm_90a), for bf16 expert weights and for int8 expert weights.
//
// Replaces the TPU kernels of mode_diffusion_policy_tpu/ops/pallas/
// moe_kernel.py: fused_top2_mlp (moe_kernel.py:97, _kernel), the MoE of the
// bf16 kernel configuration (use_pallas_moe without use_int8_moe), and
// fused_top2_mlp_q8 (moe_kernel.py:216, _kernel_q8), its int8-weight
// variant:
//
//   xm     = bf16(rmsnorm(x) * g2)   with ln_g, else x
//   out    = bf16(seed + sum_{e in top2} sum_k p_e * act_e,k W2_e,k (* s2))
//   act_e  = bf16(value * silu(gate)),
//   [value | gate] = xm W1_e (* s1) + b1             (bf16 dots, f32 accum)
//   seed   = xm with residual, else 0
//
// (the scales s1, s2 only for int8 weights, each applied after its dot).
//
// Design. Two launchers, fused_top2_mlp_launch (bf16 weights, bf16 b1) and
// fused_top2_mlp_q8_launch (int8 weights with their f32 scales, f32 b1),
// instantiate one set of __global__ kernels over the bf16 MoE stages of
// layer_stages.cuh and run them on the caller's stream; nothing is
// allocated. One work item per CTA of 128 threads:
//   1 ln2_kernel           per row: xm = bf16(rmsnorm(x)*g2)  (with ln_g)
//   2 moe_up_bf16_kernel   value/gate = xm W1_e (wmma bf16, f32 accum),
//                          act = bf16(value * silu(gate))
//   3 moe_down_bf16_kernel part[e, k] = p_e * (act_k W2_e,k), one CTA column
//                          per (expert slot, block_hidden block)
//   4 moe_sum_kernel       out = bf16(seed + part[0,0] + part[0,1] + ...),
//                          the partials added in the JAX kernel's order
// The two weight types differ only in the weight loader (an int8 tile is
// copied as it is and widened to bf16 in shared memory, which is exact) and
// in the scale epilogues: with unit scales and int8-valued bf16 weights the
// two launchers give the same bits. The TPU kernel keeps its f32
// accumulator in VMEM over its (2 slots x hidden blocks) grid revisits;
// here every (slot, hidden block) partial is written to device memory and
// summed in order by the last stage. Any token count N = B*T is taken: the
// last 64-row tile is masked.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s) per launch at
// the flagship width (D = 1024, hidden 4096, top-2 of 4 experts):
//   fused_top2_mlp:    b=128 (N = 1792 rows): operations, 2*N*D*3H*2 =
//                      90.2 GFLOP bf16 -> 0.0912 ms; b=1 (N = 14): bytes,
//                      50.3 MB of two bf16 experts -> 0.0150 ms.
//   fused_top2_mlp_q8: b=128 the same 0.0912 ms (the products are bf16);
//                      b=1: 25.2 MB of two int8 experts -> 0.0075 ms.
// This first version uses the legacy wmma (mma.sync) bf16 tiles on 64 x 64
// output tiles with a two-stage cp.async pipeline; wgmma/TMA are work for
// later.

#include <initializer_list>

#include "layer_stages.cuh"

using namespace mdp;

namespace {

__global__ void __launch_bounds__(kThreads)
ln2_kernel(const bf16* x, const float* g, bf16* xm, int D, float rs_D,
           float eps) {
  __shared__ __align__(128) unsigned char smem[kSmemRed];
  ln2_row(x, g, xm, D, rs_D, eps, blockIdx.x, smem);
}

template <typename W, typename Bias>
__global__ void __launch_bounds__(kThreads)
moe_up_bf16_kernel(const bf16* xm, const W* w1, const float* w1_s,
                   const Bias* b1, const int* idx, int step, bf16* act, int M,
                   int D, int HH, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  moe_up16_tile<W, Bias>(xm, w1, w1_s, b1, idx, step, act, M, D, HH, E,
                         blockIdx.x, smem);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
moe_down_bf16_kernel(const bf16* act, const W* w2, const float* w2_s,
                     const int* idx, const float* probs, int step, float* part,
                     int M, int D, int HH, int TH, int E) {
  extern __shared__ __align__(128) unsigned char smem[];
  moe_down16_tile<W>(act, w2, w2_s, idx, probs, step, part, M, D, HH, TH, E,
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

template <typename W, typename Bias>
int launch(const void* x, const void* ln_g, const void* w1, const void* w1_s,
           const void* b1, const void* w2, const void* w2_s, const void* idx,
           const void* probs, int step, void* xm, void* act, void* part,
           void* out, int M, int D, int HH, int TH, int E, int residual,
           float eps, float rs_D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_h = HH / TH, n_mt = (M + BM - 1) / BM;
  constexpr int kUp = smem_moe16<W, 2>(), kDown = smem_moe16<W, 1>();
  for (const cudaError_t e : {set_smem(moe_up_bf16_kernel<W, Bias>, kUp),
                              set_smem(moe_down_bf16_kernel<W>, kDown)})
    if (e != cudaSuccess) return (int)e;
  const bf16* seed = (const bf16*)x;
  if (ln_g) {
    ln2_kernel<<<M, kThreads, 0, st>>>((const bf16*)x, (const float*)ln_g,
                                       (bf16*)xm, D, rs_D, eps);
    seed = (const bf16*)xm;
  }
  moe_up_bf16_kernel<W, Bias><<<2 * n_mt * (HH / BN), kThreads, kUp, st>>>(
      seed, (const W*)w1, (const float*)w1_s, (const Bias*)b1,
      (const int*)idx, step, (bf16*)act, M, D, HH, E);
  moe_down_bf16_kernel<W><<<2 * n_h * n_mt * (D / BN), kThreads, kDown, st>>>(
      (const bf16*)act, (const W*)w2, (const float*)w2_s, (const int*)idx,
      (const float*)probs, step, (float*)part, M, D, HH, TH, E);
  const int MD = M * D;
  moe_sum_kernel<<<(MD + 4 * kThreads - 1) / (4 * kThreads), kThreads, 0, st>>>(
      residual ? seed : nullptr, (const float*)part, (bf16*)out, MD, 2 * n_h);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 expert weights w1 [E, D, 2H], b1 [E, 2H], w2 [E, H, D]. ln_g ==
// nullptr: no prenorm (xm is x itself and the xm buffer is not written);
// residual == 0: the sum is seeded with 0. Returns a CUDA error code;
// nothing runs unless it is 0.
extern "C" int fused_top2_mlp_launch(
    const void* x, const void* ln_g, const void* w1, const void* b1,
    const void* w2, const void* idx, const void* probs, int step, void* xm,
    void* act, void* part, void* out, int M, int D, int HH, int TH, int E,
    int residual, float eps, float rs_D, void* stream) {
  return launch<bf16, bf16>(x, ln_g, w1, nullptr, b1, w2, nullptr, idx, probs,
                            step, xm, act, part, out, M, D, HH, TH, E,
                            residual, eps, rs_D, stream);
}

// int8 expert weights w1_q [E, D, 2H] with f32 scales w1_s [E, 2H], f32 b1
// [E, 2H], w2_q [E, H, D] with w2_s [E, D]; otherwise as above.
extern "C" int fused_top2_mlp_q8_launch(
    const void* x, const void* ln_g, const void* w1_q, const void* w1_s,
    const void* b1, const void* w2_q, const void* w2_s, const void* idx,
    const void* probs, int step, void* xm, void* act, void* part, void* out,
    int M, int D, int HH, int TH, int E, int residual, float eps, float rs_D,
    void* stream) {
  return launch<int8_t, float>(x, ln_g, w1_q, w1_s, b1, w2_q, w2_s, idx,
                               probs, step, xm, act, part, out, M, D, HH, TH,
                               E, residual, eps, rs_D, stream);
}
