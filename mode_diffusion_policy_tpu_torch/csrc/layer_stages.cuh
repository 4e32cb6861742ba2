// Stage bodies of one NoiseBlockMoE inference layer other than its
// weight products: the row, attention, quantization and sum stages, shared
// by the per-layer kernel (fused_layer_q8c.cu: one __global__ launch per
// stage), the DiT megakernel (fused_dit_q8c.cu: every stage of every layer
// in one cooperative launch, a grid-stride loop per stage), the attention
// kernels (fused_attn_block.cu, fused_attn_block_q8.cu), the int8 MoE
// kernel (fused_top2_mlp_q8c.cu) and the row stages of the bf16-compute MoE
// (fused_top2_mlp.cu). The projections and expert products run on wgmma
// (wgmma_stages.cuh); the attention stage's two products (q^ k^T and P V)
// run here on mma.sync.
//
// Every stage is a __device__ function that computes ONE work item (a row,
// query rows of a (head, sample), a block of a row) with a Team of
// kThreads threads: one CTA of kThreads threads in the per-layer kernels,
// one consumer warpgroup on its own named barrier in the megakernel. So
// every kernel reduces in the same order and gives the same bits.
//
// Memory rules for the megakernel: activations and scratch written by one
// stage are read by another stage of the same launch, so they are read
// with ld.global.cg (__ldcg: served from L2, never a stale L1 line) and are
// never passed as __restrict__; only the weights, read-only for the whole
// launch, may take the read-only path.
//
// Rounding follows the JAX kernels (mode_diffusion_policy_tpu/ops/pallas/
// layer_kernel.py, quant_math.py): reciprocal-multiply quantization with
// round-half-even (rintf), every cast a bf16 round, and the separate
// multiplies and adds of the scale epilogues kept unfused (__fmul_rn /
// __fadd_rn) so that nvcc cannot contract them into FMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdp {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // threads of a Team: 4 warps

// The kThreads threads that compute one work item: a whole CTA of
// kThreads (bar 0, __syncthreads' barrier) or one consumer warpgroup of
// the megakernel (bar 1 + its index).
struct Team {
  int tid;   // 0 .. kThreads - 1
  int bar;   // the named barrier of the team
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kThreads) : "memory");
  }
};

__device__ __forceinline__ Team cta_team() {
  return Team{static_cast<int>(threadIdx.x), 0};
}

// ---- shared-memory sizes of the stages (bytes) ----------------------------
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kSmemRed = 32 * 4;
// the row stages stage one row of D floats after the 32-float reduction
__host__ __device__ inline int smem_row(int D) { return kSmemRed + D * 4; }
// The attention stage's shared memory (smem_attn) is defined with it.

// ---- helpers ----------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Team-wide sum / max, warps added in order; every thread of the team gets
// the result. `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red,
                                           const Team& tm) {
  const int lane = tm.tid & 31, warp = tm.tid >> 5;
  v = warp_sum(v);
  tm.sync();
  if (lane == 0) red[warp] = v;
  tm.sync();
  float t = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red,
                                           const Team& tm) {
  const int lane = tm.tid & 31, warp = tm.tid >> 5;
  v = warp_max(v);
  tm.sync();
  if (lane == 0) red[warp] = v;
  tm.sync();
  float t = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) t = fmaxf(t, red[i]);
  return t;
}

// quant_math.quant_rows: s = max(amax, 1e-6) / 127, q = clip(rint(x * (1/s)))
__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
}

__device__ __forceinline__ int8_t quant_one(float x, float inv) {
  float q = rintf(__fmul_rn(x, inv));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(q);
}

// Quantize one row of n floats held in shared memory (quant_rows).
__device__ __forceinline__ void quant_row(const float* buf, int n,
                                          int8_t* q, float* s_out,
                                          float* red, const Team& tm) {
  float amax = 0.f;
  for (int d = tm.tid; d < n; d += kThreads) amax = fmaxf(amax, fabsf(buf[d]));
  amax = block_max(amax, red, tm);
  const float s = quant_scale(amax);
  const float inv = __fdiv_rn(1.0f, s);
  for (int d = tm.tid; d < n; d += kThreads) q[d] = quant_one(buf[d], inv);
  if (tm.tid == 0) *s_out = s;
}

__device__ __forceinline__ float silu(float g) {
  return __fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
}

__device__ __forceinline__ float ldf(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldb(const bf16* p) {
  return __bfloat162float(__ldcg(p));
}

__device__ __forceinline__ int expert_of(const int* idx, int step, int slot,
                                         int E) {
  const int e = idx[step * 2 + slot];
  if (e < 0 || e >= E) __trap();   // routing tables come from top-k: never
  return e;
}

// This thread's elements d = tid, tid + kThreads, ... of a row into buf,
// with kRowLoads loads in flight at a time (the row stages are bound by
// the latency of their loads, not by bytes); returns their sum of squares,
// added in that order.
constexpr int kRowLoads = 8;

__device__ __forceinline__ float row_to_smem(const bf16* xr, float* buf,
                                             int D, const Team& tm) {
  float ss = 0.f;
  for (int d0 = tm.tid; d0 < D; d0 += kRowLoads * kThreads) {
    float v[kRowLoads];
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int d = d0 + u * kThreads;
      v[u] = d < D ? ldb(xr + d) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int d = d0 + u * kThreads;
      if (d < D) {
        buf[d] = v[u];
        ss += v[u] * v[u];
      }
    }
  }
  return ss;
}

__device__ __forceinline__ void row_to_smem(const float* xr, float* buf,
                                            int D, const Team& tm) {
  for (int d0 = tm.tid; d0 < D; d0 += kRowLoads * kThreads) {
    float v[kRowLoads];
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int d = d0 + u * kThreads;
      v[u] = d < D ? ldf(xr + d) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u)
      if (d0 + u * kThreads < D) buf[d0 + u * kThreads] = v[u];
  }
}

// This thread's elements d0, d0 + kThreads, ... (kRowLoads of them) of a
// weight vector, loaded together.
__device__ __forceinline__ void vec_regs(const float* p, int d0, int D,
                                         float (&v)[kRowLoads]) {
#pragma unroll
  for (int u = 0; u < kRowLoads; ++u) {
    const int d = d0 + u * kThreads;
    v[u] = d < D ? p[d] : 0.f;
  }
}

// ---- the cond rows of x's rows --------------------------------------------
// c holds c_rows rows of D: one row shared by every token (c_rows == 1),
// one per sample (c_rows == B: x's row r reads row r / T) or one per token
// (c_rows == B T: row r). The row stages read c + (r / div) * stride.
struct CondMap {
  int div, stride;
};

// false where c_rows is none of 1, B and B T
__host__ __device__ inline bool cond_map(int c_rows, int B, int T, int D,
                                         CondMap* m) {
  if (c_rows == B * T) *m = CondMap{1, D};
  else if (c_rows == B) *m = CondMap{T, D};
  else if (c_rows == 1) *m = CondMap{1, 0};
  else return false;
  return true;
}

// ---- ln1: h = bf16(rmsnorm(x) * g1 + c), one row -----------------------
// The cond row of x's row `row` is c + (row / c_div) * c_stride (CondMap).
__device__ __forceinline__ void ln1_row(const bf16* x, const float* c,
                                        int c_div, int c_stride,
                                        const float* g, bf16* h, int D,
                                        float rs_D, float eps,
                                        int row, unsigned char* smem,
                                        const Team& tm = cta_team()) {
  float* red = reinterpret_cast<float*>(smem);
  float* buf = red + 32;
  c += (size_t)(row / c_div) * c_stride;
  float ss = row_to_smem(x + (size_t)row * D, buf, D, tm);
  ss = block_sum(ss, red, tm);
  const float den = fmaxf(__fmul_rn(sqrtf(ss), rs_D), eps);
  for (int d0 = tm.tid; d0 < D; d0 += kRowLoads * kThreads) {
    float gv[kRowLoads], cv[kRowLoads];
    vec_regs(g, d0, D, gv);
    vec_regs(c, d0, D, cv);
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int d = d0 + u * kThreads;
      if (d >= D) continue;
      float v = __fdiv_rn(buf[d], den);
      v = __fadd_rn(__fmul_rn(v, gv[u]), cv[u]);
      h[(size_t)row * D + d] = __float2bfloat16_rn(v);
    }
  }
}

// ---- ln1, int8 projections: hq, hs = quant_rows(rmsnorm(x) * g1 + c) in
// f32 (no bf16 cast of h), one row; the cond row as in ln1_row -----------
__device__ __forceinline__ void ln1_quant_row(const bf16* x, const float* c,
                                              int c_div, int c_stride,
                                              const float* g, int8_t* hq,
                                              float* hs, int D, float rs_D,
                                              float eps, int row,
                                              unsigned char* smem,
                                              const Team& tm = cta_team()) {
  float* red = reinterpret_cast<float*>(smem);
  float* buf = red + 32;
  c += (size_t)(row / c_div) * c_stride;
  float ss = row_to_smem(x + (size_t)row * D, buf, D, tm);
  ss = block_sum(ss, red, tm);
  const float den = fmaxf(__fmul_rn(sqrtf(ss), rs_D), eps);
  for (int d0 = tm.tid; d0 < D; d0 += kRowLoads * kThreads) {
    float gv[kRowLoads], cv[kRowLoads];
    vec_regs(g, d0, D, gv);
    vec_regs(c, d0, D, cv);
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int d = d0 + u * kThreads;
      if (d < D)
        buf[d] = __fadd_rn(__fmul_rn(__fdiv_rn(buf[d], den), gv[u]), cv[u]);
    }
  }
  quant_row(buf, D, hq + (size_t)row * D, hs + row, red, tm);
}

// ---- attention, one (query-row block, head, sample) item ----------------
// QK-RMSNorm per head, causal softmax over any number T of tokens per
// sample, P V; both products on the tensor cores (mma.sync m16n8k16, bf16
// operands from ldmatrix, f32 sums). An item takes query rows [i0, i1) of
// one (head, sample), at most kAttnRows, and the key and value rows
// 0 .. i1-1 they attend to. Shared memory holds bf16 rows of attn_ld(hd)
// elements (the 8 rows of an ldmatrix land on distinct banks): the item's
// q^ rows and a block of kb key rows k^ and value rows v, kb a multiple of
// 16 (all of the item's keys where they fit: attn_kb). The cast chain is
// the JAX kernel's (attn_kernel.py _kernel): q and k normed per row from
// the f32 qkv and rounded to bf16, v rounded to bf16; each score the f32
// product times `scale` (unfused), the causal mask, an f32 softmax over
// the whole causal row with p = bf16(exp(s - m) / den) rounded after the
// division, P V summed in f32, o rounded to bf16 or kept f32. No running
// rescale: three passes over the key tiles recompute the scores on the
// tensor cores, (1) the row max, (2) den, (3) P V; where the keys do not
// fit at once, each pass reloads the k^ blocks (and pass 3 the v blocks).
//   Work split: warp w takes one unit, a tile of 16 query rows of the item
// and a share of the output columns: one tile per warp where the item has
// 3 or 4 tiles, else each tile's columns split over 2 or 4 warps (the b=1
// items of one tile: every warp runs passes 1 and 2 of the tile and P V
// of its quarter of the columns), the columns in P V passes of at most
// COLS (the f32 sums stay in registers; kAttnCols in the per-layer
// kernels).
//   Invariants, so that neither the query rows of an item (attn_rows), nor
// the key rows of a block (attn_kb), nor the column split changes a bit:
// query and key tiles are 16 rows aligned at row 0 (i0 and kb multiples of
// 16), every pass takes the key tiles in ascending order, and an mma
// output element depends on its own row and column only. den is each
// lane's running f32 sum over the tiles of its four columns of a tile
// (n8 tile 0 then 1, the lower column first), then the quad's sum by xor
// shuffles (1, then 2); a P V element is the tensor core's f32 sum over
// the tiles in ascending order; a head norm's sum of squares is each
// lane's fmaf chain over its 16 columns and a xor-shuffle tree over the
// row's lanes (attn_load). So every kernel gives the same bits.
// item -> (blk, h, b) = (item % n_blk, (item / n_blk) % H, item / (n_blk H)).
// o_f32 != nullptr (int8 projections): o stays f32 for the per-row
// re-quantization; else o is rounded to bf16 into o_bf16.
constexpr int kAttnTile = 16;    // rows of a query tile and of a key tile
constexpr int kAttnRows = 64;    // query rows of an item at most: 4 tiles
constexpr int kAttnCols = 128;   // output columns of one P V pass

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// the row stride (bf16 elements) of the stage's tiles in shared memory
__host__ __device__ inline int attn_ld(int hd) { return hd + 8; }

__host__ __device__ inline int attn_rows(int B, int H, int T) {
  // one query tile per item while the (head, sample) pairs alone would
  // leave most SMs idle (b=1: 8 pairs); blocks of up to kAttnRows query
  // rows of a sample otherwise
  const int t = round16(T);
  return B * H < 128 ? kAttnTile : (t < kAttnRows ? t : kAttnRows);
}

__host__ __device__ inline int attn_items(int B, int H, int T) {
  const int rows = attn_rows(B, H, T);
  return B * H * ((T + rows - 1) / rows);
}

// an item's shared memory: `rows` q^ rows, kb k^ rows and kb v rows
__host__ __device__ inline int smem_attn(int hd, int rows, int kb) {
  return 2 * attn_ld(hd) * (rows + 2 * kb);
}

// The key rows per block that fit `budget` bytes of an item's shared
// memory: all of a sample's (T rounded up to 16) where they fit, else the
// most whole tiles that fit; 0 where not one tile does.
__host__ __device__ inline int attn_kb(int T, int hd, int rows, int budget) {
  const int fit =
      (budget / (2 * attn_ld(hd)) - rows) / 2 / kAttnTile * kAttnTile;
  return fit >= round16(T) ? round16(T) : (fit > 0 ? fit : 0);
}

// A run of rows for attn_load: rows [r0, r0 + live) of one head's q, k or
// v columns (src: the head's first column in the sample's row 0) into the
// bf16 rows dst[0 ..], rows live .. n-1 zero; with the gain g (q, k) the
// QK-RMSNorm bf16(a_r * inv_r * g), inv_r = 1 / max(|a_r| / sqrt(hd),
// eps), without (v, g null) bf16(a_r).
struct AttnRows {
  const float* src;
  const float* g;
  bf16* dst;
  int r0, live, n;
};

// Three runs of rows, one after the other (n = 0: none), into shared
// memory (row stride ld). LPR lanes take a row (8 where hd <= 128, else
// 32), lane l of its group the float4 columns l, l + LPR, l + 2 LPR,
// l + 3 LPR (16 B loads through L2: in the megakernel this launch's QKV
// stage wrote them), so a warp takes 32 / LPR rows at once, two such sets
// in flight. The head norm's sum of squares: each lane's fmaf chain over
// its columns in that order, then a xor-shuffle tree over the group (1,
// 2, ...). The sets go through a loop that is not unrolled: in the
// megakernel this stage's code runs cold once a layer, and a short body
// costs the instruction cache less.
template <int LPR>
__device__ __forceinline__ void attn_load_lpr(AttnRows a, AttnRows b,
                                              AttnRows c, int D3, int hd,
                                              int ld, float rs_hd, float eps,
                                              int tid) {
  constexpr int kRows = 32 / LPR, kSets = 2;
  const int lane = tid & 31, warp = tid >> 5, nw = kThreads / 32;
  const int gl = lane % LPR, gr = lane / LPR;
  const int nv = hd / 4, n_all = a.n + b.n + c.n, step = nw * kRows;
  for (int r0 = 0; r0 < n_all; r0 += step * kSets) {
    float4 v[kSets][4];
#pragma unroll
    for (int s = 0; s < kSets; ++s) {
      // row t of the runs: row tt of run k (fields picked one by one, so
      // that the runs stay in registers)
      const int t = r0 + (s * nw + warp) * kRows + gr;
      const int k = t < a.n ? 0 : t < a.n + b.n ? 1 : 2;
      const int tt = t - (k == 0 ? 0 : k == 1 ? a.n : a.n + b.n);
      const int live = k == 0 ? a.live : k == 1 ? b.live : c.live;
      const float* row =
          (k == 0 ? a.src : k == 1 ? b.src : c.src) +
          (size_t)((k == 0 ? a.r0 : k == 1 ? b.r0 : c.r0) + tt) * D3;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = gl + LPR * u;
        v[s][u] = t < n_all && tt < live && col < nv
                      ? __ldcg(reinterpret_cast<const float4*>(row) + col)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll 1
    for (int s = 0; s < kSets; ++s) {
      // set s from v[0], the sets after it moved down
      float4 cur[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) cur[u] = v[0][u];
#pragma unroll
      for (int q = 0; q + 1 < kSets; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) v[q][u] = v[q + 1][u];
      if (r0 + (s * nw + warp) * kRows >= n_all) break;
      const int t = r0 + (s * nw + warp) * kRows + gr;
      const int k = t < a.n ? 0 : t < a.n + b.n ? 1 : 2;
      const int tt = t - (k == 0 ? 0 : k == 1 ? a.n : a.n + b.n);
      const int live = k == 0 ? a.live : k == 1 ? b.live : c.live;
      const float* g = k == 0 ? a.g : k == 1 ? b.g : c.g;
      bf16* dst = (k == 0 ? a.dst : k == 1 ? b.dst : c.dst) + (size_t)tt * ld;
      float ss = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ss = __fmaf_rn(cur[u].x, cur[u].x, ss);
        ss = __fmaf_rn(cur[u].y, cur[u].y, ss);
        ss = __fmaf_rn(cur[u].z, cur[u].z, ss);
        ss = __fmaf_rn(cur[u].w, cur[u].w, ss);
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1)
        ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
      const float inv =
          __fdiv_rn(1.0f, fmaxf(__fmul_rn(sqrtf(ss), rs_hd), eps));
      if (t >= n_all) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = gl + LPR * u;
        if (col >= nv) continue;
        float e[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          e[q] = tt >= live ? 0.f
                 : g        ? __fmul_rn(__fmul_rn(e[q], inv),
                                        __ldg(g + 4 * col + q))
                            : e[q];
        const __nv_bfloat162 lo = __floats2bfloat162_rn(e[0], e[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(e[2], e[3]);
        *reinterpret_cast<uint2*>(dst + 4 * col) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  }
}

__device__ __forceinline__ void attn_load(AttnRows a, AttnRows b, AttnRows c,
                                          int D3, int hd, int ld, float rs_hd,
                                          float eps, int tid) {
  if (hd <= 128) attn_load_lpr<8>(a, b, c, D3, hd, ld, rs_hd, eps, tid);
  else attn_load_lpr<32>(a, b, c, D3, hd, ld, rs_hd, eps, tid);
}

// four 8 x 8 bf16 matrices from shared memory (lanes 8 i .. 8 i + 7 give
// matrix i's row addresses), as they are or transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// d += a b, one m16n8k16 tile: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// s = q^ k^T of one tile of 16 query rows (qs) and 16 key rows (ks), rows
// ld apart, over hd in steps of 16. s[n][e]: n8 tile n of the mma
// accumulator, row lane / 4 + 8 (e / 2), column 8 n + 2 (lane % 4) + e % 2.
__device__ __forceinline__ void attn_scores(float (&s)[2][4], const bf16* qs,
                                            const bf16* ks, int ld, int hd,
                                            int lane) {
  const int mi = lane >> 3, r = lane & 7;
  const bf16* qa = qs + ((mi & 1) * 8 + r) * ld + (mi >> 1) * 8;
  const bf16* kr = ks + ((mi >> 1) * 8 + r) * ld + (mi & 1) * 8;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  for (int k0 = 0; k0 < hd; k0 += 16) {
    uint32_t a[4], b[4];
    ldsm_x4(a, qa + k0);
    ldsm_x4(b, kr + k0);
    mma_bf16(s[0], a, b[0], b[1]);
    mma_bf16(s[1], a, b[2], b[3]);
  }
}

template <int COLS = kAttnCols>
__device__ __forceinline__ void attn_item(const float* qkv,
                                          const float* __restrict__ qg,
                                          const float* __restrict__ kg,
                                          bf16* o_bf16, float* o_f32, int B,
                                          int T, int D, int H, int hd,
                                          float rs_hd, float eps_qk,
                                          float scale, int kb, int item,
                                          unsigned char* smem,
                                          const Team& tm = cta_team()) {
  const int rows = attn_rows(B, H, T), n_blk = (T + rows - 1) / rows;
  const int ld = attn_ld(hd), D3 = 3 * D;
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [rows, ld]: q^
  bf16* ks = qs + rows * ld;                  // [kb, ld]: k^
  bf16* vs = ks + kb * ld;                    // [kb, ld]: v

  const int blk = item % n_blk, h = (item / n_blk) % H, b = item / (n_blk * H);
  const int i0 = blk * rows, i1 = min(T, i0 + rows), nq = i1 - i0;
  const int lane = tm.tid & 31, warp = tm.tid >> 5;
  const int g = lane >> 2, qd = lane & 3;    // accumulator row, column pair
  const size_t row0 = (size_t)b * T;
  const float* src = qkv + row0 * D3 + h * hd;
  // every key row of the item in one block: k^ and v come in once
  const bool one = i1 <= kb;
  // this warp's unit: query tile qt (rows q0 ..), columns [c0, c0 + cw)
  const int n_qt = (nq + kAttnTile - 1) / kAttnTile;
  int ns = n_qt >= 3 ? 1 : 4 / n_qt;
  while ((hd / ns) % 16) ns >>= 1;
  const int cw = hd / ns, qt = warp / ns, c0 = (warp % ns) * cw;
  const bool busy = qt < n_qt;
  const int q0 = i0 + kAttnTile * qt;

  // q^ rows, and where they fit the k^ and v rows, in one pass of loads
  const AttnRows none{nullptr, nullptr, nullptr, 0, 0, 0};
  const int nk = one ? i1 : 0;
  attn_load(AttnRows{src, qg, qs, i0, nq, round16(nq)},
            AttnRows{src + D, kg, ks, 0, nk, round16(nk)},
            AttnRows{src + 2 * D, nullptr, vs, 0, nk, round16(nk)}, D3, hd,
            ld, rs_hd, eps_qk, tm.tid);
  tm.sync();

  const float ninf = -__int_as_float(0x7f800000);
  float m[2] = {ninf, ninf}, den[2] = {0.f, 0.f};
  float acc[COLS / 8][4];
  const int n_pv = (cw + COLS - 1) / COLS;
  for (int pass = 0; pass < 2 + n_pv; ++pass) {
    // P V passes: columns [p0, p0 + pw)
    const int p0 = c0 + (pass - 2) * COLS;
    const int pw = min(COLS, c0 + cw - p0);
#pragma unroll
    for (int n = 0; n < COLS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int j0 = 0; j0 < i1; j0 += kb) {
      const int j1 = min(i1, j0 + kb);
      if (!one) {
        tm.sync();   // every unit is done with the block before
        const int nb = j1 - j0, nv = pass >= 2 ? nb : 0;
        attn_load(none, AttnRows{src + D, kg, ks, j0, nb, round16(nb)},
                  AttnRows{src + 2 * D, nullptr, vs, j0, nv, round16(nv)}, D3,
                  hd, ld, rs_hd, eps_qk, tm.tid);
        tm.sync();
      }
      if (!busy) continue;
      // the key tiles of the block up to the unit's diagonal tile
      for (int t0 = j0; t0 < j1 && t0 <= q0; t0 += kAttnTile) {
        float s[2][4];
        attn_scores(s, qs + (q0 - i0) * ld, ks + (t0 - j0) * ld, ld, hd,
                    lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = t0 + 8 * n + 2 * qd + (e & 1);
            const int i = q0 + g + 8 * (e >> 1);
            // masked: exp gives 0, which adds nothing to den and P V
            s[n][e] = j <= i ? __fmul_rn(s[n][e], scale) : ninf;
          }
        if (pass == 0) {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              m[e >> 1] = fmaxf(m[e >> 1], s[n][e]);
          continue;
        }
        // exp(s - m): den's terms, then P's numerators (one copy of the
        // code for both passes)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - m[e >> 1]);
        if (pass == 1) {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              den[e >> 1] = __fadd_rn(den[e >> 1], s[n][e]);
        } else {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = __fdiv_rn(s[n][e], den[e >> 1]);
          // the probabilities as the A operand: the accumulator's layout
          const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]),
                                 pack_bf16(s[0][2], s[0][3]),
                                 pack_bf16(s[1][0], s[1][1]),
                                 pack_bf16(s[1][2], s[1][3])};
          const bf16* vb = vs + (t0 - j0 + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * ld + p0 + (lane >> 4) * 8;
#pragma unroll
          for (int n = 0; n < COLS / 8; n += 2) {
            if (8 * n >= pw) break;
            uint32_t bv[4];
            ldsm_x4_t(bv, vb + 8 * n);
            mma_bf16(acc[n], a, bv[0], bv[1]);
            mma_bf16(acc[n + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
      }
    } else if (pass == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        den[r] = __fadd_rn(den[r], __shfl_xor_sync(0xffffffffu, den[r], 1));
        den[r] = __fadd_rn(den[r], __shfl_xor_sync(0xffffffffu, den[r], 2));
      }
    } else if (busy) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {   // rows g and g + 8
        const int i = q0 + g + 4 * e;
        if (i >= i1) continue;
        const size_t at = (row0 + i) * D + h * hd + p0 + 2 * qd;
#pragma unroll
        for (int n = 0; n < COLS / 8; ++n) {
          if (8 * n >= pw) break;
          if (o_f32)
            *reinterpret_cast<float2*>(o_f32 + at + 8 * n) =
                make_float2(acc[n][e], acc[n][e + 1]);
          else
            *reinterpret_cast<__nv_bfloat162*>(o_bf16 + at + 8 * n) =
                __floats2bfloat162_rn(acc[n][e], acc[n][e + 1]);
        }
      }
    }
  }
}

// ---- int8 projections: oq, os = quant_rows(o) of the f32 attention rows --
__device__ __forceinline__ void quant_f32_row(const float* src, int8_t* q,
                                              float* s, int D, int row,
                                              unsigned char* smem,
                                              const Team& tm = cta_team()) {
  float* red = reinterpret_cast<float*>(smem);
  float* buf = red + 32;
  row_to_smem(src + (size_t)row * D, buf, D, tm);
  tm.sync();
  quant_row(buf, D, q + (size_t)row * D, s + row, red, tm);
}

// ---- ln2: xm = bf16(rmsnorm(x_mid) * g2); xq, sx = quant_rows(xm) -------
__device__ __forceinline__ void ln2_quant_row(const bf16* xmid,
                                              const float* __restrict__ g,
                                              bf16* xm, int8_t* xq, float* sx,
                                              int D, float rs_D, float eps,
                                              int row, unsigned char* smem,
                                              const Team& tm = cta_team()) {
  float* red = reinterpret_cast<float*>(smem);
  float* buf = red + 32;
  float ss = row_to_smem(xmid + (size_t)row * D, buf, D, tm);
  ss = block_sum(ss, red, tm);
  const float den = fmaxf(__fmul_rn(sqrtf(ss), rs_D), eps);
  for (int d0 = tm.tid; d0 < D; d0 += kRowLoads * kThreads) {
    float gv[kRowLoads];
    vec_regs(g, d0, D, gv);
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int d = d0 + u * kThreads;
      if (d >= D) continue;
      const bf16 r =
          __float2bfloat16_rn(__fmul_rn(__fdiv_rn(buf[d], den), gv[u]));
      xm[(size_t)row * D + d] = r;
      buf[d] = __bfloat162float(r);
    }
  }
  quant_row(buf, D, xq + (size_t)row * D, sx + row, red, tm);
}

// ---- MoE input without a prenorm: xq, sx = quant_rows(x), one row ------
__device__ __forceinline__ void quant_bf16_row(const bf16* x, int8_t* xq,
                                               float* sx, int D, int row,
                                               unsigned char* smem,
                                               const Team& tm = cta_team()) {
  float* red = reinterpret_cast<float*>(smem);
  float* buf = red + 32;
  row_to_smem(x + (size_t)row * D, buf, D, tm);
  tm.sync();
  quant_row(buf, D, xq + (size_t)row * D, sx + row, red, tm);
}

// ---- act quant: aq, sa = quant_rows(act) per block_hidden column block --
// One WARP per item: the block's max is exact in any order and every
// element is quantized on its own, so a warp gives the bits of a team;
// kRowLoads float4 loads in flight per lane, kept in registers for the
// second pass where the block fits (TH <= 1024).
// item -> (kb, r, slot) = (item % n_h, (item / n_h) % M, item / (n_h * M)).
__device__ __forceinline__ void act_quant_warp(const float* act, int8_t* aq,
                                               float* sa, int M, int HH,
                                               int TH, int item, int lane) {
  const int n_h = HH / TH;
  const int kb = item % n_h, r = (item / n_h) % M, slot = item / (n_h * M);
  const size_t base = ((size_t)slot * M + r) * HH + (size_t)kb * TH;
  const float4* src = reinterpret_cast<const float4*>(act + base);
  char4* dst = reinterpret_cast<char4*>(aq + base);
  const int n4 = TH / 4, chunk = kRowLoads * 32;
  float4 v[kRowLoads];
  auto load = [&](int j0) {
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int j = j0 + 32 * u;
      v[u] = j < n4 ? __ldcg(src + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float amax = 0.f;
  for (int j0 = lane; j0 < n4; j0 += chunk) {
    load(j0);
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u)
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[u].x), fabsf(v[u].y)),
                               fmaxf(fabsf(v[u].z), fabsf(v[u].w))));
  }
  amax = warp_max(amax);
  const float s = quant_scale(amax);
  const float inv = __fdiv_rn(1.0f, s);
  for (int j0 = lane; j0 < n4; j0 += chunk) {
    if (n4 > chunk) load(j0);
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int j = j0 + 32 * u;
      if (j < n4)
        dst[j] = make_char4(quant_one(v[u].x, inv), quant_one(v[u].y, inv),
                            quant_one(v[u].z, inv), quant_one(v[u].w, inv));
    }
  }
  if (lane == 0) sa[((size_t)slot * M + r) * n_h + kb] = s;
}

// ---- ordered sum: out = bf16(((xm + part[0]) + part[1]) + ...) ----------
// elements first, first + stride, ...; xm == nullptr seeds with 0 (the MoE
// kernel without its residual)
__device__ __forceinline__ void moe_sum_elems(const bf16* xm, const float* part,
                                              bf16* out, int MD, int n_part,
                                              int first, int stride) {
  for (int i = first; i < MD; i += stride) {
    float acc = xm ? ldb(xm + i) : 0.f;
    for (int z = 0; z < n_part; ++z)
      acc = __fadd_rn(acc, ldf(part + (size_t)z * MD + i));
    out[i] = __float2bfloat16_rn(acc);
  }
}

// ---- the bf16-compute MoE (fused_top2_mlp.cu) --------------------------------
// ln2 without quantization: xm = bf16(rmsnorm(x_mid) * g2), one row --
__device__ __forceinline__ void ln2_row(const bf16* xmid,
                                        const float* __restrict__ g, bf16* xm,
                                        int D, float rs_D, float eps, int row,
                                        unsigned char* smem,
                                        const Team& tm = cta_team()) {
  float* red = reinterpret_cast<float*>(smem);
  const bf16* xr = xmid + (size_t)row * D;
  float ss = 0.f;
  for (int d = tm.tid; d < D; d += kThreads) {
    const float v = ldb(xr + d);
    ss += v * v;
  }
  ss = block_sum(ss, red, tm);
  const float den = fmaxf(__fmul_rn(sqrtf(ss), rs_D), eps);
  for (int d = tm.tid; d < D; d += kThreads)
    xm[(size_t)row * D + d] =
        __float2bfloat16_rn(__fmul_rn(__fdiv_rn(ldb(xr + d), den), g[d]));
}

}  // namespace mdp
