// The attention sub-block of one NoiseBlockMoE inference layer with bf16
// projections, on Hopper (sm_90a).
//
// Replaces the TPU kernel mode_diffusion_policy_tpu/ops/pallas/attn_kernel.py
// (_kernel, launched by fused_attn_block) on the paths that run the
// attention sub-block on its own: the samplers' off-schedule evaluations
// under `parity` and `b1-latency` (one cond row per sample), and the bf16
// kernel configuration (one shared cond row):
//
//   h   = bf16(rmsnorm(x) * g1 + c)
//   qkv = h @ wqkv + bqkv                             (bf16 dots, f32 accum)
//   o   = bf16(attn(qk_norm(q), qk_norm(k), v))       (causal per sample)
//   out = bf16(x + o @ wout)                          (bf16 dots, f32 accum)
//
// Design. One launcher, fused_attn_block_launch, runs the four stages of
// int8_stages.cuh attn_bf16_stages on the caller's stream and allocates
// nothing:
//   1 ln1_kernel          per row: h = bf16(rmsnorm(x)*g1 + c)
//   2 qkv_wg_kernel       qkv = h @ wqkv + b   (wgmma bf16 fed by TMA)
//   3 attn_kernel         one CTA per (query rows, head, sample): QK-RMSNorm,
//                         causal softmax over any T tokens, P V, o in bf16
//   4 cproj_wg_kernel     out = bf16(x + o @ wout)   (wgmma bf16)
// The projections run on the wgmma stage Proj (wgmma_stages.cuh): persistent
// CTAs of one TMA producer warpgroup and one or two wgmma consumer
// warpgroups, the bf16 weights read MN-major as they are stored, in tiles
// of 128 x 128 above 256 token rows and 64 x 64 below (the plan that the
// wrapper passes in, attn_kernel.proj_tile_plan). fused_layer_q8c.cu's
// bf16-projection launcher and the DiT megakernel run the same stages
// under the same plan, so the output is that kernel's x_mid bit for bit,
// and this kernel followed by fused_top2_mlp_q8c (ln_2 fused, the normed
// input as the residual seed) equals one fused_layer_q8c launch. The TPU
// kernel keeps h, qkv and o in VMEM inside one grid step of 16 whole
// samples; here they pass through device memory (mostly L2) between
// launches, and attention runs on exactly B*T rows (no padding of the batch
// to whole blocks, no block-diagonal mask).
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s) at the
// flagship width (D = 1024, 8 heads of 128, 14 tokens per sample):
//   b=128 (N = 1792 rows): operations, 2*N*D*4D = 15.0 GFLOP -> 15.2 us
//   (bytes: 8.4 MB of bf16 weights + 7.3 MB of activations, 4.7 us);
//   b=1 (N = 14): bytes, 8.4 MB of weights -> 2.5 us.
// The legacy wmma tiles that this kernel ran before (64 x 64, a two-stage
// cp.async pipeline) took 0.090 + 0.047 ms for the two projections at
// b=128. The attention stage (attn_item, both products on mma.sync) is
// still the largest, though close to the QKV projection at 14 tokens
// (0.033 against 0.028 ms at b=128 on an H100 at 700 W), and the more so
// as T grows (0.41 of the launch's 0.87 ms at 160 tokens): it reads the
// f32 qkv rows and recomputes the scores in each of its three passes.

#include "int8_stages.cuh"

using namespace mdp;

// c: c_rows f32 cond rows: one shared by every token (1), one per sample
// (B) or one per token (B T). qkv_tm, qkv_tn, out_tm, out_tn: the (rows,
// columns) of the two projections' tiles (64 or 128 each); ctas: the most
// CTAs a projection runs at once. Returns a CUDA error code, or
// wg::kErrNoEncode / kErrEncode when a TMA tensor map cannot be made;
// nothing runs unless it is 0.
extern "C" int fused_attn_block_launch(
    const void* x, const void* c, const void* ln1_g, const void* wqkv,
    const void* bqkv, const void* q_g, const void* k_g, const void* wout,
    void* h, void* qkv, void* o, void* out, int B, int T, int D, int H,
    int c_rows, float eps1, float eps_qk, float rs_D, float rs_hd,
    float scale, int qkv_tm, int qkv_tn, int out_tm, int out_tn, int ctas,
    void* stream) {
  const int tiles[4] = {qkv_tm, qkv_tn, out_tm, out_tn};
  return attn_bf16_stages(x, c, c_rows, ln1_g, wqkv, bqkv, q_g, k_g, wout,
                          h, qkv, o, out, B, T, D, H, eps1, eps_qk, rs_D,
                          rs_hd, scale, tiles, ctas,
                          static_cast<cudaStream_t>(stream));
}
