// One whole NoiseBlockMoE inference layer on Hopper (sm_90a).
//
// Replaces the TPU kernel mode_diffusion_policy_tpu/ops/pallas/layer_kernel.py
// (_kernel, launched by fused_layer_q8c) on the `parity` serving path, and
// its int8-projection variant (int8_attn=: the JAX block's use_fused_layer
// with use_int8_attn, the megakernel off):
//
//   x_mid = x + c_proj(attn(qk_norm(wqkv(rmsnorm(x)*g1 + c) + b)))  (bf16 dots)
//   out   = ln2(x_mid) + sum_{e in top2} p_e * W2_e q(act_e) s       (int8 dots)
//   act_e = value * silu(gate),  [value | gate] = q(ln2(x_mid)) W1_e s + b1
//
// Design. Two launchers run a fixed sequence of __global__ kernels on the
// caller's stream and allocate nothing. The row, attention and sum stages
// live in layer_stages.cuh, shared with the DiT megakernel
// (fused_dit_q8c.cu); every product runs on Hopper's wgmma fed by TMA
// (wgmma_stages.cuh: Proj, Up, Down), and the launch sequences are those
// of the two-kernel paths (int8_stages.cuh). fused_layer_q8c_launch, bf16
// projections, eight or nine kernels:
//   1 ln1_kernel          per row: h = bf16(rmsnorm(x)*g1 + c)
//   2 qkv_wg_kernel       qkv = h @ wqkv + b       (wgmma bf16, f32 accum)
//   3 attn_kernel         one CTA per (query rows, head, sample): QK-RMSNorm,
//                         causal softmax over any T tokens, P V (f32 FMA)
//   4 cproj_wg_kernel     x_mid = bf16(x + o @ wout) (wgmma bf16, f32 accum)
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
// Stages 1-4 are fused_attn_block's (int8_stages.cuh attn_bf16_stages).
// The row and attention stages run 128 threads, the megakernel's team of
// one consumer warpgroup, so that the row reductions add in the same order
// in both kernels. The wgmma stages run persistent CTAs of one TMA producer
// warpgroup and one or two wgmma consumer warpgroups on 128 x 128 output
// tiles (64 x 64 for at most 256 token rows: the plans that the wrapper
// passes in, `tile` and the projections' tiles, and `ctas`). The bf16
// projections read their weights MN-major as stored; s8 wgmma takes both
// operands K-major, so the MoE stages read a K-major copy of the int8
// experts (w1_t [E, 2H, D], w2_t [E, D, H]) that the model makes once per
// quantization; the JAX-layout w1_q and w2_q stay beside it for the plain
// versions and the other kernels. The s32 sums are exact, the bf16 ones run
// in the tensor core's order under the megakernel's plan, and the
// epilogues keep the JAX cast chain's f32 operations in order (the down
// stage's sum too: the same additions in the same order as the ordered
// sum over f32 partials in memory that the other kernels run), so the
// layer gives the same bits as the two-kernel composition
// (fused_attn_block, then fused_top2_mlp_q8c) and as the megakernel's
// layers.
// fused_layer_q8c_q8_launch, int8 projections: stages 1-4 become the five
// stages of fused_attn_block_q8.cu (ln1_quant, the QKV projection on
// wgmma s8, attention with f32 o, o re-quantized, c_proj on wgmma s8 into
// x_mid), reading a K-major copy of the projections (ops/quant.py
// kmajor_attn); then stages 5-9. It equals fused_attn_block_q8 followed by
// fused_top2_mlp_q8c bit for bit: the same stages in the same order.
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
// expert products. At b=1 (N = 14) the bound is the bytes of the two
// selected experts, 25 MB (7.5 us); the 64 x 64 tiles spread them over 128
// CTAs.

#include "int8_stages.cuh"

using namespace mdp;

// The int8 experts as the K-major copy w1_t [E, 2H, D], w2_t [E, D, H]
// with their scales w1_s [E, 2H], w2_s [E, D] and f32 b1 [E, 2H]; c the
// c_rows f32 cond rows: one [D] shared by every token (1), one per sample
// (B: the JAX kernel's c of [B, 1, D]) or one per token (B T: [B, T, D]).
// qkv_tm, qkv_tn, out_tm, out_tn: the (rows, columns) of the two
// projections' tiles (64 or 128 each). tile:
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
    int c_rows, float eps1, float eps_qk, float eps2, float rs_D,
    float rs_hd, float scale, int qkv_tm, int qkv_tn, int out_tm, int out_tn,
    int tile, int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const int tiles[4] = {qkv_tm, qkv_tn, out_tm, out_tn};
  if (const int e = attn_bf16_stages(x, c, c_rows, ln1_g, wqkv, bqkv, q_g, k_g,
                                     wout, h, qkv, o, xmid, B, T, D, H, eps1,
                                     eps_qk, rs_D, rs_hd, scale, tiles, ctas,
                                     st))
    return e;
  ln2_quant_kernel<<<M, kThreads, smem_row(D), st>>>(
      (const bf16*)xmid, (const float*)ln2_g, (bf16*)xm, (int8_t*)xq,
      (float*)sx, D, rs_D, eps2);
  return moe_q8c_stages(tile, xq, sx, w1_t, w1_s, b1, w2_t, w2_s, idx, probs,
                        step, act, aq, sa, part, xm, out, M, D, HH, TH, E,
                        ctas, st);
}

// The layer with int8 attention projections (the JAX kernel's int8_attn
// variant): the attention stages of fused_attn_block_q8.cu into x_mid,
// then ln2_quant and the MoE stages as above. The projections read the
// K-major int8 copy wqkv_t [3D, D], wout_t [D, D] with their column scales
// wqkv_s [3D], wout_s [D]; qkv_tiles and out_tiles are the (rows, columns)
// of their output tiles (64 or 128 each); c holds the cond rows in bf16
// (c_rows as above); the other arguments are those of
// fused_layer_q8c_launch. The result equals fused_attn_block_q8 followed by
// fused_top2_mlp_q8c (ln_2, residual) bit for bit: the same stages.
extern "C" int fused_layer_q8c_q8_launch(
    const void* x, const void* c, const void* ln1_g, const void* wqkv_t,
    const void* wqkv_s, const void* bqkv, const void* q_g, const void* k_g,
    const void* wout_t, const void* wout_s, const void* ln2_g,
    const void* w1_t, const void* w1_s, const void* b1, const void* w2_t,
    const void* w2_s, const void* idx, const void* probs, int step, void* hq,
    void* hs, void* qkv, void* o, void* oq, void* os, void* xmid, void* xm,
    void* xq, void* sx, void* act, void* aq, void* sa, void* part, void* out,
    int B, int T, int D, int H, int HH, int TH, int E, int c_rows,
    float eps1, float eps_qk, float eps2, float rs_D, float rs_hd,
    float scale, int qkv_tm, int qkv_tn, int out_tm, int out_tn, int tile,
    int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const int tiles[4] = {qkv_tm, qkv_tn, out_tm, out_tn};
  if (const int e = attn_q8_stages(
          x, c, c_rows, ln1_g, wqkv_t, wqkv_s, bqkv, q_g, k_g, wout_t, wout_s, hq,
          hs, qkv, o, oq, os, xmid, B, T, D, H, eps1, eps_qk, rs_D, rs_hd,
          scale, tiles, ctas, st))
    return e;
  ln2_quant_kernel<<<M, kThreads, smem_row(D), st>>>(
      (const bf16*)xmid, (const float*)ln2_g, (bf16*)xm, (int8_t*)xq,
      (float*)sx, D, rs_D, eps2);
  return moe_q8c_stages(tile, xq, sx, w1_t, w1_s, b1, w2_t, w2_s, idx, probs,
                        step, act, aq, sa, part, xm, out, M, D, HH, TH, E,
                        ctas, st);
}
