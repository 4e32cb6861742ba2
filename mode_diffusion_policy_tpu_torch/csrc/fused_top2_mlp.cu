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
// Design. Two launchers run on the caller's stream and allocate nothing,
// fused_top2_mlp_launch (bf16 weights, bf16 b1) and fused_top2_mlp_q8_launch
// (int8 weights with their f32 scales, f32 b1), over the same stages,
// the expert products on Hopper's wgmma fed by TMA (wgmma_stages.cuh):
//   1 ln2_kernel              per row: xm = bf16(rmsnorm(x)*g2)  (with ln_g)
//   2 moe_up_bf16_wg_kernel   value/gate = xm W1_e (wgmma bf16, f32 accum),
//                             act = bf16(value * silu(gate))
//   3 moe_down_bf16_wg_kernel out = bf16(((seed + c[0,0]) + c[0,1]) + ...),
//                             c[e, k] = p_e * (act_k W2_e,k): one product
//                             pass per (expert slot, block_hidden block) in
//                             the JAX kernel's order, summed in registers
//                             (128 x 128 tiles); or (64 x 64 tiles) one
//                             tile per pass, writing c[e, k] as f32
//                             partials that
//   4 moe_sum_kernel          adds in the same order (the same bits)
// on persistent CTAs of one TMA producer and one or two consumer
// warpgroups (128 x 128 output tiles, or 64 x 64 for at most 256 token
// rows: the plan `tile`, `ctas` that the wrapper passes in). bf16 weights
// are read MN-major, as they are stored. An int8 weight box lands in
// shared memory as it is and the consumers widen it to bf16 (exact) into
// the swizzled layout that the products read, so both weight types run the
// same products in the same order: with unit scales and int8-valued bf16
// weights the two launchers give the same bits. The scales come after each
// product, the bias after that, as the JAX _kernel_q8 orders them. The TPU
// kernel keeps its f32 accumulator in VMEM over its (2 slots x hidden
// blocks) grid revisits; here a CTA of the down stage keeps it in
// registers over its passes, or, where the token rows are few, the passes
// run on CTAs of their own, so that the weights stream through about 128
// CTAs, and their f32 partials go through memory. Any token count N = B*T
// is taken: TMA zero-fills the rows past N, which are not written.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s) per launch at
// the flagship width (D = 1024, hidden 4096, top-2 of 4 experts):
//   fused_top2_mlp:    b=128 (N = 1792 rows): operations, 2*N*D*3H*2 =
//                      90.2 GFLOP bf16 -> 0.0912 ms; b=1 (N = 14): bytes,
//                      50.3 MB of two bf16 experts -> 0.0150 ms.
//   fused_top2_mlp_q8: b=128 the same 0.0912 ms (the products are bf16);
//                      b=1: 25.2 MB of two int8 experts -> 0.0075 ms.
// At b=128 the products are the whole bound, and only wgmma reaches the
// tensor cores' bf16 rate; the legacy wmma tiles ran them at about 15% of
// it. At b=1 the bound is the expert bytes: the up stage's 64 x 64 tiles
// spread them over 128 CTAs, each streaming its weight boxes through an
// 8-deep ring.

#include <initializer_list>

#include "layer_stages.cuh"
#include "wgmma_stages.cuh"

using namespace mdp;

namespace {

__global__ void __launch_bounds__(kThreads)
ln2_kernel(const bf16* x, const float* g, bf16* xm, int D, float rs_D,
           float eps) {
  __shared__ __align__(128) unsigned char smem[kSmemRed];
  ln2_row(x, g, xm, D, rs_D, eps, blockIdx.x, smem);
}

// KIND: wg::kBf16 (bf16 weights) or wg::kW8 (int8 weights)
template <int WG, int KIND>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
moe_up_bf16_wg_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ wg::MoeArgs a) {
  wg::gemm<wg::Up<WG, KIND>>(&ta, &tb, a);
}

template <int WG, int KIND>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
moe_down_bf16_wg_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ wg::MoeArgs a) {
  wg::gemm<wg::Down<WG, KIND, WG == 2>>(&ta, &tb, a);
}

__global__ void __launch_bounds__(kThreads)
moe_sum_kernel(const bf16* seed, const float* part, bf16* out, int MD,
               int n_part) {
  moe_sum_elems(seed, part, out, MD, n_part,
                blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

// ln_2 (with ln_g) into xm, then the products from the MoE input seeded
// with it (residual) or with 0: products(x_in, seed) returns an error code.
template <typename Products>
int launch(const void* x, const void* ln_g, void* xm, int M, int D,
           int residual, float eps, float rs_D, cudaStream_t st,
           Products products) {
  const bf16* in = (const bf16*)x;
  if (ln_g) {
    ln2_kernel<<<M, kThreads, 0, st>>>((const bf16*)x, (const float*)ln_g,
                                       (bf16*)xm, D, rs_D, eps);
    in = (const bf16*)xm;
  }
  return products(in, residual ? in : nullptr);
}

// The bf16 products on wgmma, of bf16 weights (KIND wg::kBf16: w1_s, w2_s
// unused) or of int8 weights widened in shared memory (wg::kW8): WG
// consumer warpgroups per CTA (tiles of 64 * WG rows), at most `ctas`
// persistent CTAs per stage.
template <int WG, int KIND>
int wg_products(const bf16* in, const bf16* seed, const void* w1,
                const void* w1_s, const void* b1, const void* w2,
                const void* w2_s, const void* idx, const void* probs,
                int step, void* act, void* part, void* out, int M, int D,
                int HH, int TH, int E, int ctas, cudaStream_t st) {
  using Up = wg::Up<WG, KIND>;
  using Down = wg::Down<WG, KIND, WG == 2>;
  const int n_part = 2 * (HH / TH);
  constexpr bool w8 = KIND == wg::kW8;
  constexpr int esz = w8 ? 1 : 2;
  CUtensorMap m_x, m_w1, m_act, m_w2;
  const uint64_t d_x[2] = {(uint64_t)D, (uint64_t)M};
  const uint64_t d_act[3] = {(uint64_t)HH, (uint64_t)M, 2};
  for (const int e : {wg::cached_map(&m_x, in, 2, 2, d_x),
                      wg::weight_map(&m_w1, w1, esz, 2 * HH, D, E, w8),
                      wg::cached_map(&m_act, act, 2, 3, d_act),
                      wg::weight_map(&m_w2, w2, esz, D, HH, E, w8)})
    if (e) return e;
  const wg::MoeArgs up = wg::stage_args(
      idx, probs, step, M, D, HH, TH, E, WG, Up::kNV, HH, 2, b1, nullptr,
      w1_s, nullptr, act);
  const wg::MoeArgs down = wg::stage_args(
      idx, probs, step, M, D, HH, TH, E, WG, Down::kN, D,
      WG == 2 ? 1 : n_part, nullptr, nullptr, w2_s, seed,
      WG == 2 ? out : part);
  cudaError_t e = wg::run<Up>(moe_up_bf16_wg_kernel<WG, KIND>, m_x, m_w1, up,
                              ctas, st);
  if (e == cudaSuccess)
    e = wg::run<Down>(moe_down_bf16_wg_kernel<WG, KIND>, m_act, m_w2, down,
                      ctas, st);
  if (WG == 1 && e == cudaSuccess) {
    const int MD = M * D;
    moe_sum_kernel<<<(MD + 4 * kThreads - 1) / (4 * kThreads), kThreads, 0,
                     st>>>(seed, (const float*)part, (bf16*)out, MD, n_part);
    e = cudaGetLastError();
  }
  return (int)e;
}

template <int KIND>
int products(int tile, const bf16* in, const bf16* seed, const void* w1,
             const void* w1_s, const void* b1, const void* w2,
             const void* w2_s, const void* idx, const void* probs, int step,
             void* act, void* part, void* out, int M, int D, int HH, int TH,
             int E, int ctas, cudaStream_t st) {
  if (tile == 128)
    return wg_products<2, KIND>(in, seed, w1, w1_s, b1, w2, w2_s, idx, probs,
                                step, act, part, out, M, D, HH, TH, E, ctas,
                                st);
  return wg_products<1, KIND>(in, seed, w1, w1_s, b1, w2, w2_s, idx, probs,
                              step, act, part, out, M, D, HH, TH, E, ctas,
                              st);
}

}  // namespace

// bf16 expert weights w1 [E, D, 2H], b1 [E, 2H], w2 [E, H, D]. ln_g ==
// nullptr: no prenorm (xm is x itself and the xm buffer is not written);
// residual == 0: the sum is seeded with 0. Scratch: act [2, M, H] bf16,
// and for tile 64 part [2 H / TH, M, D] f32 (tile 128 sums in registers:
// part unused). tile: 128 (128 x 128 output tiles) or 64 (64 x 64); ctas:
// the most CTAs a stage runs at once (one per SM). Returns a CUDA error code, or
// wg::kErrNoEncode / kErrEncode when a TMA tensor map cannot be made;
// nothing runs unless it is 0.
extern "C" int fused_top2_mlp_launch(
    const void* x, const void* ln_g, const void* w1, const void* b1,
    const void* w2, const void* idx, const void* probs, int step, void* xm,
    void* act, void* part, void* out, int M, int D, int HH, int TH, int E,
    int residual, float eps, float rs_D, int tile, int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(x, ln_g, xm, M, D, residual, eps, rs_D, st,
                [&](const bf16* in, const bf16* seed) {
                  return products<wg::kBf16>(tile, in, seed, w1, nullptr, b1,
                                             w2, nullptr, idx, probs, step,
                                             act, part, out, M, D, HH, TH, E,
                                             ctas, st);
                });
}

// int8 expert weights w1_q [E, D, 2H] with f32 scales w1_s [E, 2H], f32 b1
// [E, 2H], w2_q [E, H, D] with w2_s [E, D]; otherwise as above.
extern "C" int fused_top2_mlp_q8_launch(
    const void* x, const void* ln_g, const void* w1_q, const void* w1_s,
    const void* b1, const void* w2_q, const void* w2_s, const void* idx,
    const void* probs, int step, void* xm, void* act, void* part, void* out,
    int M, int D, int HH, int TH, int E, int residual, float eps, float rs_D,
    int tile, int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(x, ln_g, xm, M, D, residual, eps, rs_D, st,
                [&](const bf16* in, const bf16* seed) {
                  return products<wg::kW8>(tile, in, seed, w1_q, w1_s, b1,
                                           w2_q, w2_s, idx, probs, step, act,
                                           part, out, M, D, HH, TH, E, ctas,
                                           st);
                });
}
