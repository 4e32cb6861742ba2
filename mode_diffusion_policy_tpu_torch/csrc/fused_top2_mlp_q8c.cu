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
// Design. One launcher, fused_top2_mlp_q8c_launch, runs four or five __global__
// kernels on the caller's stream and allocates nothing: a row stage of
// layer_stages.cuh, then the MoE stages of int8_stages.cuh
// (moe_q8c_stages), which the whole-layer kernel (fused_layer_q8c.cu) runs
// after its attention, so that attention kernel -> this kernel equals one
// layer of that kernel and of the DiT megakernel bit for bit:
//   1 ln2_quant_kernel    per row: xm = bf16(rmsnorm(x)*g2), int8 row of xm
//     (quant_row_kernel without ln_g: int8 row of x)
//   2 moe_up_wg_kernel    value/gate = xq @ W1_e (wgmma s8, s32 accum), act
//   3 act_quant_kernel    int8 rows of act, one scale per block_hidden columns
//   4 moe_down_wg_kernel  out = bf16(((seed + c[0,0]) + c[0,1]) + ...),
//                         c[e, k] = p_e * (aq_k W2_e,k) * scales: one
//                         product pass per (expert slot, hidden block) in
//                         the JAX kernel's order, summed in registers
//                         (128 x 128 tiles); or (64 x 64 tiles, at most
//                         256 token rows) one tile per pass, written as f32
//                         partials that
//   5 moe_sum_kernel      adds in the same order (the same bits)
// The expert products run on Hopper's wgmma fed by TMA (wgmma_stages.cuh):
// persistent CTAs of one TMA producer warpgroup and one or two consumer
// warpgroups (the plan `tile`, `ctas` that the wrapper passes in), reading
// the K-major copy of the int8 experts (w1_t [E, 2H, D], w2_t [E, D, H],
// made once per quantization: ops/quant.py kmajor_experts), because s8
// wgmma takes both operands K-major. The TPU kernel keeps the f32
// accumulator and the quantized rows in VMEM over its (2 slots x hidden
// blocks) grid revisits and reads the expert indices by scalar prefetch;
// here a down CTA keeps the sum in registers over its passes, and the
// stages read the expert indices from the [S, 2] routing tables at row
// `step`, on the device. Any token count N = B*T is taken: TMA zero-fills
// the rows past N of the last row tile, which are not written.
//
// Bound on this card (H100 SXM, 1979 TOP/s int8, 3.35 TB/s) at the
// flagship width (D = 1024, hidden 4096, top-2 of 4 experts):
//   b=128 (N = 1792 rows): operations, 2*N*D*3H*2 = 90.2 GOP int8 ->
//   45.6 us (bytes: 25.2 MB for two experts + 7.3 MB of activations,
//   9.7 us); b=1 (N = 14): bytes, 25.2 MB -> 7.5 us.
// The legacy wmma int8 tiles that this launcher ran before reached 7-9% of
// the int8 rate in the expert products.

#include "int8_stages.cuh"

using namespace mdp;

// The int8 experts as the K-major copy w1_t [E, 2H, D], w2_t [E, D, H]
// with their scales w1_s [E, 2H], w2_s [E, D] and f32 b1 [E, 2H].
// ln_g == nullptr: no prenorm (xm is x itself and the xm buffer is not
// written); residual == 0: the sum is seeded with 0. tile: 128 (128 x 128
// output tiles, the down stage summing in registers; part unused) or 64
// (64 x 64, part [2 H / TH, M, D] f32 for the ordered-sum stage); ctas: the
// most CTAs an MoE stage runs at once. Returns a CUDA error code, or
// wg::kErrNoEncode / kErrEncode when a TMA tensor map cannot be made;
// nothing runs unless it is 0.
extern "C" int fused_top2_mlp_q8c_launch(
    const void* x, const void* ln_g, const void* w1_t, const void* w1_s,
    const void* b1, const void* w2_t, const void* w2_s, const void* idx,
    const void* probs, int step, void* xm, void* xq, void* sx, void* act,
    void* aq, void* sa, void* part, void* out, int M, int D, int HH, int TH,
    int E, int residual, float eps, float rs_D, int tile, int ctas,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* seed = x;
  if (ln_g) {
    ln2_quant_kernel<<<M, kThreads, smem_row(D), st>>>(
        (const bf16*)x, (const float*)ln_g, (bf16*)xm, (int8_t*)xq,
        (float*)sx, D, rs_D, eps);
    seed = xm;
  } else {
    quant_row_kernel<<<M, kThreads, smem_row(D), st>>>(
        (const bf16*)x, (int8_t*)xq, (float*)sx, D);
  }
  return moe_q8c_stages(tile, xq, sx, w1_t, w1_s, b1, w2_t, w2_s, idx, probs,
                        step, act, aq, sa, part, residual ? seed : nullptr,
                        out, M, D, HH, TH, E, ctas, st);
}
