// Stage bodies of one NoiseBlockMoE inference layer other than its
// products: the row, attention, quantization and sum stages, shared by the
// per-layer kernel (fused_layer_q8c.cu: one __global__ launch per stage),
// the DiT megakernel (fused_dit_q8c.cu: every stage of every layer in one
// cooperative launch, a grid-stride loop per stage), the attention kernels
// (fused_attn_block.cu, fused_attn_block_q8.cu), the int8 MoE kernel
// (fused_top2_mlp_q8c.cu) and the row stages of the bf16-compute MoE
// (fused_top2_mlp.cu). Every product of those kernels runs on wgmma
// (wgmma_stages.cuh).
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
// The attention stage (attn_item): `rows` query rows of hd floats, a block
// of kb key rows and kb value rows, their inverse norms, and the f32 score
// row of each query row over the sample's T tokens
__host__ __device__ inline int smem_attn(int T, int hd, int rows, int kb) {
  return 4 * (rows * hd + 2 * kb * hd + rows + kb + rows * T);
}

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
// sample, P V; f32 FMA. An item takes query rows [i0, i1) of one (head,
// sample) and the key and value rows 0 .. i1-1 they attend to, in blocks
// of kb rows through shared memory. Where kb >= i1 (a short sample) q, k
// and v come in at once and each step runs once. Else two passes run over
// the key blocks: (1) each block's scores into the [rows, T] score tile,
// then the f32 softmax over each whole causal row; (2) each block's P V
// into f32 sums that wait in the q buffer. No running rescale: q and k are
// normed in f32 and rounded to bf16, the scores are f32 times the scale,
// the probabilities are rounded to bf16 and P V sums in f32, the JAX
// kernel's cast chain (attn_kernel.py _kernel). Every score is one warp's
// lane-strided dot product, every softmax row one thread's sums in key
// order, and every output element one thread's sum over j = 0 .. i in
// order, whatever the item's rows or kb: so neither the query block
// (attn_rows) nor the key block (attn_kb) changes the result.
// item -> (blk, h, b) = (item % n_blk, (item / n_blk) % H, item / (n_blk H)).
// o_f32 != nullptr (int8 projections): o stays f32 for the per-row
// re-quantization; else o is rounded to bf16 into o_bf16.
constexpr int kAttnRows = 16;   // query rows of an item at most

__host__ __device__ inline int attn_rows(int B, int H, int T) {
  // one query row per item while the (head, sample) pairs alone would
  // leave most SMs idle (b=1: 8 pairs, 112 rows); blocks of up to
  // kAttnRows query rows of a sample otherwise
  return B * H < 128 ? 1 : (T < kAttnRows ? T : kAttnRows);
}

__host__ __device__ inline int attn_items(int B, int H, int T) {
  const int rows = attn_rows(B, H, T);
  return B * H * ((T + rows - 1) / rows);
}

// The key rows per block that fit `budget` bytes of an item's shared
// memory (smem_attn): all T where they fit (one pass), else the most that
// fit; 0 where none does.
__host__ __device__ inline int attn_kb(int T, int hd, int rows, int budget) {
  if (smem_attn(T, hd, rows, T) <= budget) return T;
  const int kb = (budget / 4 - rows * hd - rows - rows * T) / (2 * hd + 1);
  return kb > 0 ? kb : 0;
}

// Rows [r0, r1) of one head of one sample's qkv rows (src: the head's
// first column in the sample's first row) into shared memory, kRowLoads
// elements of each in flight per thread: the q rows at or after q0 into
// qs at row r - q0 (where qs != nullptr), the k rows into ks and the v
// rows, rounded to bf16, into vs at row r - r0 (each where non-null).
__device__ __forceinline__ void attn_load(const float* src, int D, int hd,
                                          int r0, int r1, int q0, float* qs,
                                          float* ks, float* vs,
                                          const Team& tm) {
  const int n = (r1 - r0) * hd, D3 = 3 * D;
  for (int e0 = tm.tid; e0 < n; e0 += kRowLoads * kThreads) {
    float q[kRowLoads], k[kRowLoads], v[kRowLoads];
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int e = e0 + u * kThreads, t = r0 + e / hd;
      const float* r = src + (size_t)t * D3 + e % hd;
      const bool in = e < n;
      q[u] = qs && in && t >= q0 ? ldf(r) : 0.f;
      k[u] = ks && in ? ldf(r + D) : 0.f;
      v[u] = vs && in ? ldf(r + 2 * D) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const int e = e0 + u * kThreads, t = r0 + e / hd;
      if (e >= n) continue;
      if (qs && t >= q0) qs[(t - q0) * hd + e % hd] = q[u];
      if (ks) ks[e] = k[u];
      if (vs) vs[e] = __bfloat162float(__float2bfloat16_rn(v[u]));
    }
  }
}

// 1 / max(|a_r| / sqrt(hd), eps) of rows [0, n) of a [n, hd] into inv, one
// warp per row
__device__ __forceinline__ void head_inv_norms(const float* a, int n, int hd,
                                               float rs_hd, float eps,
                                               float* inv, const Team& tm) {
  const int lane = tm.tid & 31, nw = kThreads >> 5;
  for (int r = tm.tid >> 5; r < n; r += nw) {
    float s = 0.f;
    for (int d = lane; d < hd; d += 32) s += a[r * hd + d] * a[r * hd + d];
    s = warp_sum(s);
    if (lane == 0)
      inv[r] = __fdiv_rn(1.0f, fmaxf(__fmul_rn(sqrtf(s), rs_hd), eps));
  }
}

// a_r * inv_r * g rounded to bf16, in place, rows [0, n) of a [n, hd]
__device__ __forceinline__ void head_norm_rows(float* a, int n, int hd,
                                               const float* inv,
                                               const float* __restrict__ g,
                                               const Team& tm) {
  for (int e = tm.tid; e < n * hd; e += kThreads)
    a[e] = __bfloat162float(__float2bfloat16_rn(
        __fmul_rn(__fmul_rn(a[e], inv[e / hd]), g[e % hd])));
}

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
  float* qs = reinterpret_cast<float*>(smem);   // [rows, hd]: q, then P V
  float* ks = qs + rows * hd;                   // [kb, hd]
  float* vs = ks + kb * hd;                     // [kb, hd]
  float* inv_q = vs + kb * hd;                  // [rows]
  float* inv_k = inv_q + rows;                  // [kb]
  float* pr = inv_k + kb;                       // [rows, T]

  const int blk = item % n_blk, h = (item / n_blk) % H, b = item / (n_blk * H);
  const int i0 = blk * rows, i1 = min(T, i0 + rows), nq = i1 - i0;
  const int tid = tm.tid, lane = tid & 31, warp = tid >> 5;
  const int nw = kThreads >> 5;
  const size_t row0 = (size_t)b * T;
  const float* src = qkv + row0 * 3 * D + h * hd;
  // every key row of the item in one block: q, k and v come in together
  const bool one = i1 <= kb;

  attn_load(src, D, hd, one ? 0 : i0, i1, i0, qs, one ? ks : nullptr,
            one ? vs : nullptr, tm);
  tm.sync();
  head_inv_norms(qs, nq, hd, rs_hd, eps_qk, inv_q, tm);
  if (one) head_inv_norms(ks, i1, hd, rs_hd, eps_qk, inv_k, tm);
  tm.sync();
  head_norm_rows(qs, nq, hd, inv_q, qg, tm);
  if (one) head_norm_rows(ks, i1, hd, inv_k, kg, tm);
  tm.sync();
  // pass 1: the causal scores, block by block; warp w takes the block's
  // pairs (i, j <= i) round-robin
  for (int j0 = 0; j0 < i1; j0 += kb) {
    const int j1 = min(i1, j0 + kb);
    if (!one) {
      attn_load(src, D, hd, j0, j1, 0, nullptr, ks, nullptr, tm);
      tm.sync();
      head_inv_norms(ks, j1 - j0, hd, rs_hd, eps_qk, inv_k, tm);
      tm.sync();
      head_norm_rows(ks, j1 - j0, hd, inv_k, kg, tm);
      tm.sync();
    }
    int p = 0;
    for (int i = i0; i < i1; ++i) {
      for (int j = j0; j < min(j1, i + 1); ++j, ++p) {
        if (p % nw != warp) continue;
        float s = 0.f;
        for (int e = lane; e < hd; e += 32)
          s += qs[(i - i0) * hd + e] * ks[(j - j0) * hd + e];
        s = warp_sum(s);
        if (lane == 0) pr[(i - i0) * T + j] = __fmul_rn(s, scale);
      }
    }
    tm.sync();
  }
  // the f32 softmax over each whole causal row, probabilities rounded to
  // bf16
  for (int il = tid; il < nq; il += kThreads) {
    const int i = i0 + il;
    float* row = pr + il * T;
    float m = row[0];
    for (int j = 1; j <= i; ++j) m = fmaxf(m, row[j]);
    float den = 0.f;
    for (int j = 0; j <= i; ++j) {
      const float e = expf(row[j] - m);
      row[j] = e;
      den += e;
    }
    for (int j = 0; j <= i; ++j)
      row[j] = __bfloat162float(__float2bfloat16_rn(__fdiv_rn(row[j], den)));
  }
  tm.sync();
  // pass 2: P V, block by block; a row's sums wait in qs until the block
  // that holds its last key (j = i) writes them out
  for (int j0 = 0; j0 < i1; j0 += kb) {
    const int j1 = min(i1, j0 + kb);
    if (!one) {
      attn_load(src, D, hd, j0, j1, 0, nullptr, nullptr, vs, tm);
      tm.sync();
    }
    for (int e = tid; e < nq * hd; e += kThreads) {
      const int il = e / hd, i = i0 + il, d = e % hd;
      if (j0 > i) continue;
      const int je = min(j1, i + 1);
      float acc = j0 ? qs[e] : 0.f;
      for (int j = j0; j < je; ++j)
        acc += pr[il * T + j] * vs[(j - j0) * hd + d];
      if (je <= i) {
        qs[e] = acc;
        continue;
      }
      const size_t at = (row0 + i) * D + h * hd + d;
      if (o_f32) o_f32[at] = acc;
      else o_bf16[at] = __float2bfloat16_rn(acc);
    }
    if (!one) tm.sync();
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
