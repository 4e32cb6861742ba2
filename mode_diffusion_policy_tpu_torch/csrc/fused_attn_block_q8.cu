// The attention sub-block of one NoiseBlockMoE inference layer with int8
// projections, on Hopper (sm_90a).
//
// Replaces the TPU kernel mode_diffusion_policy_tpu/ops/pallas/attn_kernel.py
// (_kernel_q8, launched by fused_attn_block_q8) on the `max-throughput`
// serving path:
//
//   hq, hs = q(rmsnorm(x) * g1 + c)                  (f32, no bf16 cast)
//            c one row shared by every token, one per sample or one
//            per token
//   qkv    = dot_i8(hq, wqkv_q) * (hs * sqkv) + bqkv
//   o      = attn(qk_norm(q), qk_norm(k), v)         (causal per sample)
//   out    = bf16(x + dot_i8(q(o), wout_q) * (os * sout))
//
// Design. One launcher, fused_attn_block_q8_launch, runs five __global__
// kernels on the caller's stream and allocates nothing: the stages of
// int8_stages.cuh (attn_q8_stages), which the int8-projection launcher of
// the whole-layer kernel (fused_layer_q8c.cu) runs too:
//   1 ln1_quant_kernel  per row: f32 h = rmsnorm(x)*g1 + c, int8 row + scale
//   2 qkv_wg_kernel     qkv = (hq wqkv) * (hs * sqkv) + bqkv  (wgmma s8)
//   3 attn_kernel       one CTA per (query rows, head, sample): QK-RMSNorm,
//                       causal softmax over any T tokens, P V, o in f32
//   4 quant_f32_kernel  per row: int8 row + scale of o
//   5 cproj_wg_kernel   out = bf16(x + (oq wout) * (os * sout))  (wgmma s8)
// The row and attention stages are the megakernel's (fused_dit_q8c.cu) on
// its int8-projection path, one work item per CTA of 128 threads. The two
// projections run on Hopper's wgmma fed by TMA (wgmma_stages.cuh, Proj):
// persistent CTAs of one TMA producer warpgroup and one or two wgmma
// consumer warpgroups over output tiles of 64 or 128 rows x 64 or 128
// columns (the plan `tiles`, `ctas` that the wrapper passes in), reading
// the weights from their K-major copy (wqkv_t [3D, D], wout_t [D, D],
// made once per quantization: ops/quant.py kmajor_attn) because s8 wgmma
// takes both operands K-major. The s32 sums are exact and the megakernel
// runs the same stages, so the result equals one layer of the megakernel's
// attention, bit for bit. The TPU
// kernel keeps h, qkv and o in VMEM inside one grid step of 16 whole
// samples; here they pass through device memory (mostly L2) between
// launches, and attention is computed on exactly B*T rows (no padding of
// the batch to whole blocks, no block-diagonal mask). TMA zero-fills the
// rows past B*T of the last row tile, which are not written.
//
// Bound on this card (H100 SXM, 1979 TOP/s int8, 3.35 TB/s) at the
// flagship width (D = 1024, 8 heads of 128, 14 tokens per sample):
//   b=128 (N = 1792 rows): operations, 2*N*D*4D = 15.0 GOP int8 -> 7.6 us
//   (bytes: 4.2 MB of int8 weights + 7.3 MB of activations, 3.4 us);
//   b=1 (N = 14): bytes, 4.2 MB of weights -> 1.3 us.
// The legacy wmma int8 tiles ran the two projections at about 90 TOP/s
// (0.166 ms at b=128). The attention stage (attn_item, on mma.sync) is the
// largest: 0.033 ms at b=128 against 0.021 for the QKV projection on an
// H100 at 700 W; it reads the f32 qkv rows and recomputes the scores in
// each of its three passes.

#include "int8_stages.cuh"

using namespace mdp;

// c: c_rows cond rows in bf16: one shared by every token (1), one per
// sample (B) or one per token (B T). tiles: rows and columns of the QKV
// tiles, then of the c_proj tiles (64 or 128 each); ctas: the most CTAs a projection runs at once.
// Returns a CUDA error code, or wg::kErrNoEncode / kErrEncode when a TMA
// tensor map cannot be made; nothing runs unless it is 0.
extern "C" int fused_attn_block_q8_launch(
    const void* x, const void* c, const void* ln1_g, const void* wqkv_t,
    const void* wqkv_s, const void* bqkv, const void* q_g, const void* k_g,
    const void* wout_t, const void* wout_s, void* hq, void* hs, void* qkv,
    void* o, void* oq, void* os, void* out, int B, int T, int D, int H,
    int c_rows, float eps1, float eps_qk, float rs_D, float rs_hd,
    float scale, int qkv_tm, int qkv_tn, int out_tm, int out_tn, int ctas,
    void* stream) {
  const int tiles[4] = {qkv_tm, qkv_tn, out_tm, out_tn};
  return attn_q8_stages(x, c, c_rows, ln1_g, wqkv_t, wqkv_s, bqkv, q_g, k_g,
                        wout_t, wout_s, hq, hs, qkv, o, oq, os, out, B, T, D,
                        H, eps1, eps_qk, rs_D, rs_hd, scale, tiles, ctas,
                        static_cast<cudaStream_t>(stream));
}
