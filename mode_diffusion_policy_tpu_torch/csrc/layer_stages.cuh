// Stage bodies of one NoiseBlockMoE inference layer, shared by the
// per-layer kernel (fused_layer_q8c.cu: one __global__ launch per stage),
// the DiT megakernel (fused_dit_q8c.cu: every stage of every layer in one
// cooperative launch, a grid-stride loop per stage) and the two halves of
// the layer's two-kernel path (fused_attn_block_q8.cu, fused_top2_mlp_q8c.cu:
// one __global__ launch per stage), and the bf16-compute MoE of the bf16
// kernel configuration (fused_top2_mlp.cu, bf16 or int8 expert weights).
//
// Every stage is a __device__ function that computes ONE work item (a row,
// a 64 x 64 output tile, query rows of a (head, sample)) with
// blockDim.x == kThreads
// threads and the shared memory it is handed. Both kernels therefore run
// the same tiles in the same k order, and give bit-identical results.
//
// Memory rules for the megakernel: activations and scratch written by one
// stage are read by another stage of the same launch, so they are read
// with ld.global.cg (__ldcg) or cp.async.cg (both served from L2, never a
// stale L1 line) and are never passed as __restrict__; only the weights,
// read-only for the whole launch, may take the read-only path.
//
// Rounding follows the JAX kernels (mode_diffusion_policy_tpu/ops/pallas/
// layer_kernel.py, quant_math.py): reciprocal-multiply quantization with
// round-half-even (rintf), every cast a bf16 round, and the separate
// multiplies and adds of the scale epilogues kept unfused (__fmul_rn /
// __fadd_rn) so that nvcc cannot contract them into FMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mdp {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps, 2 x 2 over a 64 x 64 output tile
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK16 = 64;       // bf16 k-tile
constexpr int BK8 = 128;       // int8 k-tile
constexpr int kMaxT = 16;      // tokens per sample held by the attention stage
constexpr int kPipe = 2;       // k-tiles of every GEMM in shared memory: one
                               // in flight while the other is multiplied

// ---- shared-memory sizes of the stages (bytes) ----------------------------
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kTileA8 = BM * BK8;
constexpr int kTileB8 = BK8 * BN;
constexpr int kLDC = BN + 4;
constexpr int kSmemGemm16 = cmax(kPipe * (BM * (BK16 + 8) * 2 + BK16 * (BN + 8) * 2),
                                 BM * kLDC * 4);
constexpr int kSmemGemm8 = cmax(kPipe * (kTileA8 + kTileB8), BM * kLDC * 4);
constexpr int kSmemUp = cmax(kPipe * (kTileA8 + 2 * kTileB8), 2 * BM * kLDC * 4);
constexpr int kSmemRed = 32 * 4;
// the row stages stage one row of D floats after the 32-float reduction
__host__ __device__ inline int smem_row(int D) { return kSmemRed + D * 4; }
// q, k, v rows of one (head, sample) plus the reductions and probabilities
__host__ __device__ inline int smem_attn(int T, int hd) {
  return 3 * T * hd * 4 + 2 * kMaxT * 4 + kMaxT * kMaxT * 4;
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

// Block-wide sum / max; every thread gets the result. `red` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t = fmaxf(t, red[i]);
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
                                          float* red) {
  float amax = 0.f;
  for (int d = threadIdx.x; d < n; d += blockDim.x)
    amax = fmaxf(amax, fabsf(buf[d]));
  amax = block_max(amax, red);
  const float s = quant_scale(amax);
  const float inv = __fdiv_rn(1.0f, s);
  for (int d = threadIdx.x; d < n; d += blockDim.x) q[d] = quant_one(buf[d], inv);
  if (threadIdx.x == 0) *s_out = s;
}

__device__ __forceinline__ float silu(float g) {
  return __fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
}

__device__ __forceinline__ float ldf(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldb(const bf16* p) {
  return __bfloat162float(__ldcg(p));
}

// 16-byte asynchronous copy global -> shared through L2; copies nothing
// and zero-fills the 16 bytes when !pred (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The k loop of every GEMM tile: nk k-steps through kPipe shared-memory
// stages. load(stage, it) issues the asynchronous copies of k-step it into
// a stage (without committing them); compute(stage) multiplies a stage that
// has landed. k-steps are multiplied in order 0, 1, ..., nk - 1, whatever
// the depth of the pipeline. Ends with every copy landed and the block
// synchronized, so the caller may reuse the shared memory.
template <typename Load, typename Compute>
__device__ __forceinline__ void k_pipeline(int nk, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < kPipe - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    // refill the stage multiplied in the previous k-step (every thread is
    // past it: the barrier that ended that step), then wait for this one
    const int next = it + kPipe - 1;
    if (next < nk) load(next % kPipe, next);
    cp_async_commit();
    cp_async_wait<kPipe - 1>();
    __syncthreads();
    compute(it % kPipe);
    __syncthreads();
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ int expert_of(const int* idx, int step, int slot,
                                         int E) {
  const int e = idx[step * 2 + slot];
  if (e < 0 || e >= E) __trap();   // routing tables come from top-k: never
  return e;
}

// ---- ln1: h = bf16(rmsnorm(x) * g1 + c), one row -----------------------
// The cond row of x's row `row` is c + (row / T) * c_stride: c_stride == 0
// for one row shared by every sample, D for one row per sample.
__device__ __forceinline__ void ln1_row(const bf16* x, const float* c,
                                        int T, int c_stride, const float* g,
                                        bf16* h, int D, float rs_D, float eps,
                                        int row, unsigned char* smem) {
  float* red = reinterpret_cast<float*>(smem);
  const bf16* xr = x + (size_t)row * D;
  c += (size_t)(row / T) * c_stride;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = ldb(xr + d);
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float den = fmaxf(__fmul_rn(sqrtf(ss), rs_D), eps);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float v = __fdiv_rn(ldb(xr + d), den);
    v = __fadd_rn(__fmul_rn(v, g[d]), c[d]);
    h[(size_t)row * D + d] = __float2bfloat16_rn(v);
  }
}

// ---- ln1, int8 projections: hq, hs = quant_rows(rmsnorm(x) * g1 + c) in
// f32 (no bf16 cast of h), one row; the cond row as in ln1_row -----------
__device__ __forceinline__ void ln1_quant_row(const bf16* x, const float* c,
                                              int T, int c_stride,
                                              const float* g, int8_t* hq,
                                              float* hs, int D, float rs_D,
                                              float eps, int row,
                                              unsigned char* smem) {
  float* red = reinterpret_cast<float*>(smem);
  float* buf = red + 32;
  const bf16* xr = x + (size_t)row * D;
  c += (size_t)(row / T) * c_stride;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = ldb(xr + d);
    buf[d] = v;
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float den = fmaxf(__fmul_rn(sqrtf(ss), rs_D), eps);
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    buf[d] = __fadd_rn(__fmul_rn(__fdiv_rn(buf[d], den), g[d]), c[d]);
  quant_row(buf, D, hq + (size_t)row * D, hs + row, red);
}

// ---- bf16 GEMM tile: C = A[M,K] @ B[K,N], f32 accumulate -----------------
// Epilogue 0: out_f32[r, n] = acc + bias[n]
// Epilogue 1: out_bf16[r, n] = bf16(float(resid[r, n]) + acc)
// item -> (n tile, m tile) = (item % (N / BN), item / (N / BN)).
template <int EPI>
__device__ __forceinline__ void gemm_bf16_tile(
    const bf16* A, const bf16* __restrict__ B, int M, int N, int K,
    const float* __restrict__ bias, float* out_f32, const bf16* resid,
    bf16* out_bf16, int item, unsigned char* smem) {
  constexpr int LDA = BK16 + 8;   // padded rows keep wmma pointers 32B-aligned
  constexpr int LDB = BN + 8;
  constexpr int kABytes = BM * LDA * 2;
  constexpr int kStage = kABytes + BK16 * LDB * 2;
  float* Cs = reinterpret_cast<float*>(smem);   // reused after the k loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n_tiles = N / BN;
  const int m0 = (item / n_tiles) * BM, n0 = (item % n_tiles) * BN;

  auto load = [&](int stage, int it) {
    const int k0 = it * BK16;
    bf16* As = reinterpret_cast<bf16*>(smem + stage * kStage);
    bf16* Bs = reinterpret_cast<bf16*>(smem + stage * kStage + kABytes);
    for (int ch = tid; ch < BM * BK16 / 8; ch += kThreads) {
      const int r = ch / (BK16 / 8), kc = (ch % (BK16 / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async16(As + r * LDA + kc,
                 A + (size_t)(ok ? m0 + r : 0) * K + k0 + kc, ok);
    }
    for (int ch = tid; ch < BK16 * BN / 8; ch += kThreads) {
      const int r = ch / (BN / 8), nc = (ch % (BN / 8)) * 8;
      cp_async16(Bs + r * LDB + nc, B + (size_t)(k0 + r) * N + n0 + nc, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  k_pipeline(K / BK16, load, [&](int stage) {
    const bf16* As = reinterpret_cast<const bf16*>(smem + stage * kStage);
    const bf16* Bs =
        reinterpret_cast<const bf16*>(smem + stage * kStage + kABytes);
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  });
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kLDC + wn + 16 * j,
                              acc[i][j], kLDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, n = e % BN;
    const int gr = m0 + r, gn = n0 + n;
    if (gr >= M) continue;
    const float a = Cs[r * kLDC + n];
    if (EPI == 0) {
      out_f32[(size_t)gr * N + gn] = __fadd_rn(a, bias[gn]);
    } else {
      const float v = __fadd_rn(ldb(resid + (size_t)gr * N + gn), a);
      out_bf16[(size_t)gr * N + gn] = __float2bfloat16_rn(v);
    }
  }
}

// ---- attention, one (query-row block, head, sample) item ----------------
// QK-RMSNorm per head, causal softmax over T <= 16 tokens, P V; f32 FMA.
// An item takes query rows [i0, i1) of one (head, sample) and the key and
// value rows 0 .. i1-1 they attend to; every row's norm, scores, softmax
// and P V are computed the same way whatever the block, so the block size
// (attn_rows) does not change the result.
// item -> (blk, h, b) = (item % n_blk, (item / n_blk) % H, item / (n_blk H)).
// o_f32 != nullptr (int8 projections): o stays f32 for the per-row
// re-quantization; else o is rounded to bf16 into o_bf16.
__host__ __device__ inline int attn_rows(int B, int H, int T) {
  // one query row per item while the (head, sample) pairs alone would
  // leave most SMs idle (b=1: 8 pairs, 112 rows); whole samples otherwise
  return B * H < 128 ? 1 : T;
}

__host__ __device__ inline int attn_items(int B, int H, int T) {
  const int rows = attn_rows(B, H, T);
  return B * H * ((T + rows - 1) / rows);
}

__device__ __forceinline__ void attn_item(const float* qkv,
                                          const float* __restrict__ qg,
                                          const float* __restrict__ kg,
                                          bf16* o_bf16, float* o_f32, int B,
                                          int T, int D, int H, int hd,
                                          float rs_hd, float eps_qk,
                                          float scale, int item,
                                          unsigned char* smem) {
  float* qs = reinterpret_cast<float*>(smem);   // [i1 - i0, hd]
  float* ks = qs + T * hd;                      // [i1, hd]
  float* vs = ks + T * hd;                      // [i1, hd]
  float* inv_q = vs + T * hd;                   // [kMaxT]
  float* inv_k = inv_q + kMaxT;                 // [kMaxT]
  float* pr = inv_k + kMaxT;                    // [kMaxT, kMaxT]

  const int rows = attn_rows(B, H, T), n_blk = (T + rows - 1) / rows;
  const int blk = item % n_blk, h = (item / n_blk) % H, b = item / (n_blk * H);
  const int i0 = blk * rows, i1 = min(T, i0 + rows), nq = i1 - i0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const size_t row0 = (size_t)b * T;
  const int D3 = 3 * D;

  for (int e = tid; e < i1 * hd; e += blockDim.x) {
    const int t = e / hd, d = e % hd;
    const float* r = qkv + (row0 + t) * D3 + h * hd + d;
    if (t >= i0) qs[e - i0 * hd] = ldf(r);
    ks[e] = ldf(r + D);
    vs[e] = __bfloat162float(__float2bfloat16_rn(ldf(r + 2 * D)));
  }
  __syncthreads();
  // per-row sums of squares of q and k within this head: warp w takes rows
  // w, w + nw, ... of q, then of k
  for (int rr = warp; rr < nq + i1; rr += nw) {
    const float* a = rr < nq ? qs + rr * hd : ks + (rr - nq) * hd;
    float s = 0.f;
    for (int d = lane; d < hd; d += 32) s += a[d] * a[d];
    s = warp_sum(s);
    if (lane == 0) {
      const float inv = __fdiv_rn(1.0f, fmaxf(__fmul_rn(sqrtf(s), rs_hd), eps_qk));
      if (rr < nq) inv_q[rr] = inv; else inv_k[rr - nq] = inv;
    }
  }
  __syncthreads();
  for (int e = tid; e < nq * hd; e += blockDim.x)
    qs[e] = __bfloat162float(__float2bfloat16_rn(
        __fmul_rn(__fmul_rn(qs[e], inv_q[e / hd]), qg[e % hd])));
  for (int e = tid; e < i1 * hd; e += blockDim.x)
    ks[e] = __bfloat162float(__float2bfloat16_rn(
        __fmul_rn(__fmul_rn(ks[e], inv_k[e / hd]), kg[e % hd])));
  __syncthreads();
  // causal scores: warp w takes pairs (i, j <= i) round-robin
  int p = 0;
  for (int i = i0; i < i1; ++i) {
    for (int j = 0; j <= i; ++j, ++p) {
      if (p % nw != warp) continue;
      float s = 0.f;
      for (int e = lane; e < hd; e += 32)
        s += qs[(i - i0) * hd + e] * ks[j * hd + e];
      s = warp_sum(s);
      if (lane == 0) pr[(i - i0) * kMaxT + j] = __fmul_rn(s, scale);
    }
  }
  __syncthreads();
  // f32 softmax per row, probabilities rounded to bf16
  if (tid < nq) {
    const int i = i0 + tid;
    float* row = pr + tid * kMaxT;
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
  __syncthreads();
  for (int e = tid; e < nq * hd; e += blockDim.x) {
    const int il = e / hd, i = i0 + il, d = e % hd;
    float acc = 0.f;
    for (int j = 0; j <= i; ++j) acc += pr[il * kMaxT + j] * vs[j * hd + d];
    const size_t at = (row0 + i) * D + h * hd + d;
    if (o_f32) o_f32[at] = acc;
    else o_bf16[at] = __float2bfloat16_rn(acc);
  }
}

// ---- int8 projections: oq, os = quant_rows(o) of the f32 attention rows --
__device__ __forceinline__ void quant_f32_row(const float* src, int8_t* q,
                                              float* s, int D, int row,
                                              unsigned char* smem) {
  float* red = reinterpret_cast<float*>(smem);
  float* buf = red + 32;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    buf[d] = ldf(src + (size_t)row * D + d);
  __syncthreads();
  quant_row(buf, D, q + (size_t)row * D, s + row, red);
}

// ---- ln2: xm = bf16(rmsnorm(x_mid) * g2); xq, sx = quant_rows(xm) -------
__device__ __forceinline__ void ln2_quant_row(const bf16* xmid,
                                              const float* __restrict__ g,
                                              bf16* xm, int8_t* xq, float* sx,
                                              int D, float rs_D, float eps,
                                              int row, unsigned char* smem) {
  float* red = reinterpret_cast<float*>(smem);
  float* buf = red + 32;
  const bf16* xr = xmid + (size_t)row * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = ldb(xr + d);
    buf[d] = v;
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float den = fmaxf(__fmul_rn(sqrtf(ss), rs_D), eps);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const bf16 r = __float2bfloat16_rn(__fmul_rn(__fdiv_rn(buf[d], den), g[d]));
    xm[(size_t)row * D + d] = r;
    buf[d] = __bfloat162float(r);
  }
  quant_row(buf, D, xq + (size_t)row * D, sx + row, red);
}

// ---- MoE input without a prenorm: xq, sx = quant_rows(x), one row ------
__device__ __forceinline__ void quant_bf16_row(const bf16* x, int8_t* xq,
                                               float* sx, int D, int row,
                                               unsigned char* smem) {
  float* red = reinterpret_cast<float*>(smem);
  float* buf = red + 32;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    buf[d] = ldb(x + (size_t)row * D + d);
  __syncthreads();
  quant_row(buf, D, xq + (size_t)row * D, sx + row, red);
}

// int8 tiles live in shared memory as 16-byte-wide column strips
// ([k/16][rows][16] for A, [n/16][k][16] for B) so that every wmma fragment
// pointer is 32-byte aligned, as load_matrix_sync requires. The loads are
// asynchronous (cp.async); k_pipeline commits and waits.
__device__ __forceinline__ void load_a_i8(int8_t* As, const int8_t* A, int lda,
                                          int m0, int M, int k0) {
  for (int ch = threadIdx.x; ch < BM * BK8 / 16; ch += kThreads) {
    const int r = ch / (BK8 / 16), kc = ch % (BK8 / 16);
    const bool ok = m0 + r < M;
    cp_async16(As + (kc * BM + r) * 16,
               A + (size_t)(ok ? m0 + r : 0) * lda + k0 + kc * 16, ok);
  }
}

__device__ __forceinline__ void load_b_i8(int8_t* Bs, const int8_t* B, int ldb,
                                          int k0, int n0) {
  for (int ch = threadIdx.x; ch < BK8 * BN / 16; ch += kThreads) {
    const int r = ch / (BN / 16), nc = ch % (BN / 16);
    cp_async16(Bs + (nc * BK8 + r) * 16,
               B + (size_t)(k0 + r) * ldb + n0 + nc * 16, true);
  }
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> FragA8;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> FragB8;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragC32;

__device__ __forceinline__ void zero_i8(FragC32 (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
}

__device__ __forceinline__ void mma_tile_i8(FragC32 (&acc)[2][2],
                                            const int8_t* As, const int8_t* Bs,
                                            int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < BK8 / 16; ++kk) {
    FragA8 fa[2];
    FragB8 fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], As + (kk * BM + wm + 16 * i) * 16, 16);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(fb[j], Bs + ((wn / 16 + j) * BK8 + kk * 16) * 16, 16);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_i8(int* C, FragC32 (&acc)[2][2], int wm,
                                         int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(C + (wm + 16 * i) * kLDC + wn + 16 * j,
                              acc[i][j], kLDC, wmma::mem_row_major);
}

// ---- int8 GEMM tile for the attention projections: A[M,K] @ B[K,N] ------
// with B n-contiguous like the experts, s32 accumulate, and the scales
// applied as in the JAX kernel:
// Epilogue 0 (QKV):    out_f32[r, n] = acc * (sa[r] * sb[n]) + bias[n]
// Epilogue 1 (c_proj): out_bf16[r, n] = bf16(float(resid[r, n])
//                                            + acc * (sa[r] * sb[n]))
// item -> (n tile, m tile) = (item % (N / BN), item / (N / BN)).
template <int EPI>
__device__ __forceinline__ void gemm_i8_tile(
    const int8_t* A, const float* sa, const int8_t* __restrict__ B,
    const float* __restrict__ sb, int M, int N, int K,
    const float* __restrict__ bias, float* out_f32, const bf16* resid,
    bf16* out_bf16, int item, unsigned char* smem) {
  constexpr int kStage = kTileA8 + kTileB8;
  int* Ci = reinterpret_cast<int*>(smem);       // reused after the k loop
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n_tiles = N / BN;
  const int m0 = (item / n_tiles) * BM, n0 = (item % n_tiles) * BN;

  auto load = [&](int stage, int it) {
    int8_t* st = reinterpret_cast<int8_t*>(smem) + stage * kStage;
    load_a_i8(st, A, K, m0, M, it * BK8);
    load_b_i8(st + kTileA8, B, N, it * BK8, n0);
  };

  FragC32 ac[2][2];
  zero_i8(ac);
  k_pipeline(K / BK8, load, [&](int stage) {
    const int8_t* st = reinterpret_cast<const int8_t*>(smem) + stage * kStage;
    mma_tile_i8(ac, st, st + kTileA8, wm, wn);
  });
  store_i8(Ci, ac, wm, wn);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, n = e % BN;
    const int gr = m0 + r, gn = n0 + n;
    if (gr >= M) continue;
    const float y = __fmul_rn((float)Ci[r * kLDC + n],
                              __fmul_rn(ldf(sa + gr), sb[gn]));
    if (EPI == 0) {
      out_f32[(size_t)gr * N + gn] = __fadd_rn(y, bias[gn]);
    } else {
      const float v = __fadd_rn(ldb(resid + (size_t)gr * N + gn), y);
      out_bf16[(size_t)gr * N + gn] = __float2bfloat16_rn(v);
    }
  }
}

// ---- MoE up: act[slot, r, j] = value * silu(gate), one tile -------------
// item -> (n tile over HH, m tile, slot):
//   nt = item % (HH / BN), mt = (item / (HH / BN)) % n_mt, slot = rest.
__device__ __forceinline__ void moe_up_tile(
    const int8_t* xq, const float* sx, const int8_t* __restrict__ w1_q,
    const float* __restrict__ w1_s, const float* __restrict__ b1,
    const int* __restrict__ idx, int step, float* act, int M, int D, int HH,
    int E, int item, unsigned char* smem) {
  constexpr int kStage = kTileA8 + 2 * kTileB8;
  const int n_nt = HH / BN, n_mt = (M + BM - 1) / BM;
  const int slot = item / (n_nt * n_mt);
  const int m0 = ((item / n_nt) % n_mt) * BM, n0 = (item % n_nt) * BN;
  const int ex = expert_of(idx, step, slot, E);
  const int H2 = 2 * HH;
  const int8_t* W = w1_q + (size_t)ex * D * H2;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  auto load = [&](int stage, int it) {
    int8_t* st = reinterpret_cast<int8_t*>(smem) + stage * kStage;
    load_a_i8(st, xq, D, m0, M, it * BK8);
    load_b_i8(st + kTileA8, W, H2, it * BK8, n0);
    load_b_i8(st + kTileA8 + kTileB8, W, H2, it * BK8, HH + n0);
  };

  FragC32 av[2][2], ag[2][2];
  zero_i8(av);
  zero_i8(ag);
  k_pipeline(D / BK8, load, [&](int stage) {
    const int8_t* st = reinterpret_cast<const int8_t*>(smem) + stage * kStage;
    mma_tile_i8(av, st, st + kTileA8, wm, wn);
    mma_tile_i8(ag, st, st + kTileA8 + kTileB8, wm, wn);
  });
  int* Cv = reinterpret_cast<int*>(smem);
  int* Cg = Cv + BM * kLDC;
  store_i8(Cv, av, wm, wn);
  store_i8(Cg, ag, wm, wn);
  __syncthreads();
  const float* sv = w1_s + (size_t)ex * H2;
  const float* bv = b1 + (size_t)ex * H2;
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, n = e % BN;
    const int gr = m0 + r, gn = n0 + n;
    if (gr >= M) continue;
    const float s = ldf(sx + gr);
    const float v = __fadd_rn(
        __fmul_rn((float)Cv[r * kLDC + n], __fmul_rn(s, sv[gn])), bv[gn]);
    const float g = __fadd_rn(
        __fmul_rn((float)Cg[r * kLDC + n], __fmul_rn(s, sv[HH + gn])),
        bv[HH + gn]);
    act[((size_t)slot * M + gr) * HH + gn] = __fmul_rn(v, silu(g));
  }
}

// ---- act quant: aq, sa = quant_rows(act) per block_hidden column block --
// item -> (kb, r, slot) = (item % n_h, (item / n_h) % M, item / (n_h * M)).
__device__ __forceinline__ void act_quant_item(const float* act, int8_t* aq,
                                               float* sa, int M, int HH,
                                               int TH, int item,
                                               unsigned char* smem) {
  float* red = reinterpret_cast<float*>(smem);
  const int n_h = HH / TH;
  const int kb = item % n_h, r = (item / n_h) % M, slot = item / (n_h * M);
  const size_t base = ((size_t)slot * M + r) * HH + (size_t)kb * TH;
  float amax = 0.f;
  for (int j = threadIdx.x; j < TH; j += blockDim.x)
    amax = fmaxf(amax, fabsf(ldf(act + base + j)));
  amax = block_max(amax, red);
  const float s = quant_scale(amax);
  const float inv = __fdiv_rn(1.0f, s);
  for (int j = threadIdx.x; j < TH; j += blockDim.x)
    aq[base + j] = quant_one(ldf(act + base + j), inv);
  if (threadIdx.x == 0) sa[((size_t)slot * M + r) * n_h + kb] = s;
}

// ---- MoE down: part[z] = p * (aq W2) * (sa * s2), z = (slot, hidden block)
// item -> (n tile over D, m tile, z):
//   nt = item % (D / BN), mt = (item / (D / BN)) % n_mt, z = rest.
__device__ __forceinline__ void moe_down_tile(
    const int8_t* aq, const float* sa, const int8_t* __restrict__ w2_q,
    const float* __restrict__ w2_s, const int* __restrict__ idx,
    const float* __restrict__ probs, int step, float* part, int M, int D,
    int HH, int TH, int E, int item, unsigned char* smem) {
  constexpr int kStage = kTileA8 + kTileB8;
  int* Ci = reinterpret_cast<int*>(smem);       // reused after the k loop
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n_nt = D / BN, n_mt = (M + BM - 1) / BM;
  const int m0 = ((item / n_nt) % n_mt) * BM, n0 = (item % n_nt) * BN;
  const int n_h = HH / TH, z = item / (n_nt * n_mt);
  const int slot = z / n_h, kb = z % n_h;
  const int ex = expert_of(idx, step, slot, E);
  const float p = probs[step * 2 + slot];
  const int8_t* W = w2_q + (size_t)ex * HH * D;
  const float* s2 = w2_s + (size_t)ex * D;
  const int8_t* A = aq + (size_t)slot * M * HH;

  const int k_begin = kb * TH;
  auto load = [&](int stage, int it) {
    int8_t* st = reinterpret_cast<int8_t*>(smem) + stage * kStage;
    load_a_i8(st, A, HH, m0, M, k_begin + it * BK8);
    load_b_i8(st + kTileA8, W, D, k_begin + it * BK8, n0);
  };

  FragC32 ac[2][2];
  zero_i8(ac);
  k_pipeline(TH / BK8, load, [&](int stage) {
    const int8_t* st = reinterpret_cast<const int8_t*>(smem) + stage * kStage;
    mma_tile_i8(ac, st, st + kTileA8, wm, wn);
  });
  store_i8(Ci, ac, wm, wn);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, n = e % BN;
    const int gr = m0 + r, gn = n0 + n;
    if (gr >= M) continue;
    const float s = __fmul_rn(ldf(sa + ((size_t)slot * M + gr) * n_h + kb), s2[gn]);
    part[((size_t)z * M + gr) * D + gn] =
        __fmul_rn(p, __fmul_rn((float)Ci[r * kLDC + n], s));
  }
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

// Work items of each stage for M = B * T rows.
__host__ __device__ inline int n_tiles(int M, int N) {
  return ((M + BM - 1) / BM) * (N / BN);
}

// ---- the bf16-compute top-2 MoE (fused_top2_mlp.cu) -------------------------
// bf16 activations times expert weights held in bf16 (W = bf16) or in int8
// (W = int8_t, per-output-channel scales applied after each product). The
// int8 weight tile lands in shared memory as it is and is widened to bf16
// there (exact: |q| <= 127), so both weight types run the same bf16 wmma
// fragments in the same k order: with unit scales the two give the same
// bits.

// ---- ln2 without quantization: xm = bf16(rmsnorm(x_mid) * g2), one row --
__device__ __forceinline__ void ln2_row(const bf16* xmid,
                                        const float* __restrict__ g, bf16* xm,
                                        int D, float rs_D, float eps, int row,
                                        unsigned char* smem) {
  float* red = reinterpret_cast<float*>(smem);
  const bf16* xr = xmid + (size_t)row * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = ldb(xr + d);
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float den = fmaxf(__fmul_rn(sqrtf(ss), rs_D), eps);
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    xm[(size_t)row * D + d] =
        __float2bfloat16_rn(__fmul_rn(__fdiv_rn(ldb(xr + d), den), g[d]));
}

constexpr int kLDA16 = BK16 + 8;            // padded rows, as gemm_bf16_tile
constexpr int kLDB16 = BN + 8;
constexpr int kTileA16 = BM * kLDA16 * 2;   // bytes of one bf16 A tile
constexpr int kTileB16 = BK16 * kLDB16 * 2; // bytes of one bf16 B tile

// bytes of one weight tile as it is copied: bf16 padded, or int8 dense
template <typename W>
__host__ __device__ constexpr int raw_tile_bytes() {
  return sizeof(W) == 2 ? kTileB16 : BK16 * BN;
}

// shared memory of the up (NB = 2 weight tiles: value, gate) and down
// (NB = 1) tiles: kPipe stages of A and the raw weight tiles, plus (int8)
// one widened bf16 copy of the NB weight tiles; the f32 epilogue reuses it
template <typename W, int NB>
__host__ __device__ constexpr int smem_moe16() {
  return cmax(kPipe * (kTileA16 + NB * raw_tile_bytes<W>())
                  + (sizeof(W) == 1 ? NB * kTileB16 : 0),
              NB * BM * kLDC * 4);
}

__device__ __forceinline__ float ldw(const float* p) { return *p; }
__device__ __forceinline__ float ldw(const bf16* p) {
  return __bfloat162float(*p);
}

// A tile: rows m0.. of A [M, lda] (bf16), columns k0 .. k0 + BK16; rows past
// M are zero-filled.
__device__ __forceinline__ void load_a_bf16(bf16* As, const bf16* A, int lda,
                                            int m0, int M, int k0) {
  for (int ch = threadIdx.x; ch < BM * BK16 / 8; ch += kThreads) {
    const int r = ch / (BK16 / 8), kc = (ch % (BK16 / 8)) * 8;
    const bool ok = m0 + r < M;
    cp_async16(As + r * kLDA16 + kc,
               A + (size_t)(ok ? m0 + r : 0) * lda + k0 + kc, ok);
  }
}

// Weight tile: rows k0 .. k0 + BK16, columns n0 .. n0 + BN of B [K, ldb].
__device__ __forceinline__ void load_w(bf16* Bs, const bf16* B, int ldb,
                                       int k0, int n0) {
  for (int ch = threadIdx.x; ch < BK16 * BN / 8; ch += kThreads) {
    const int r = ch / (BN / 8), nc = (ch % (BN / 8)) * 8;
    cp_async16(Bs + r * kLDB16 + nc, B + (size_t)(k0 + r) * ldb + n0 + nc,
               true);
  }
}

__device__ __forceinline__ void load_w(int8_t* Bs, const int8_t* B, int ldb,
                                       int k0, int n0) {
  for (int ch = threadIdx.x; ch < BK16 * BN / 16; ch += kThreads) {
    const int r = ch / (BN / 16), nc = (ch % (BN / 16)) * 16;
    cp_async16(Bs + r * BN + nc, B + (size_t)(k0 + r) * ldb + n0 + nc, true);
  }
}

// The int8 weight tile widened to a padded bf16 tile.
__device__ __forceinline__ void widen_w(bf16* dst, const int8_t* src) {
  for (int e = threadIdx.x; e < BK16 * BN / 4; e += kThreads) {
    const int r = (e * 4) / BN, n = (e * 4) % BN;
    const char4 v = *reinterpret_cast<const char4*>(src + r * BN + n);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + r * kLDB16 + n);
    d[0] = __floats2bfloat162_rn((float)v.x, (float)v.y);
    d[1] = __floats2bfloat162_rn((float)v.z, (float)v.w);
  }
}

// The bf16 weight tile(s) of a stage to multiply: the raw tiles themselves,
// or (int8) their widened copy in `wide`, written here; the caller's
// k_pipeline barriers keep every warp out of `wide` until all have
// finished the previous stage's products.
template <typename W, int NB>
__device__ __forceinline__ const bf16* stage_w(const unsigned char* raw,
                                               bf16* wide) {
  if constexpr (sizeof(W) == 2) {
    return reinterpret_cast<const bf16*>(raw);
  } else {
#pragma unroll
    for (int t = 0; t < NB; ++t)
      widen_w(wide + t * (BK16 * kLDB16),
              reinterpret_cast<const int8_t*>(raw) + t * raw_tile_bytes<W>());
    __syncthreads();
    return wide;
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC16;

__device__ __forceinline__ void zero_f32(FragC16 (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

__device__ __forceinline__ void mma_tile_bf16(FragC16 (&acc)[2][2],
                                              const bf16* As, const bf16* Bs,
                                              int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < BK16; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * kLDA16 + kk, kLDA16);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(fb[j], Bs + kk * kLDB16 + wn + 16 * j, kLDB16);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_f32(float* C, FragC16 (&acc)[2][2],
                                          int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(C + (wm + 16 * i) * kLDC + wn + 16 * j,
                              acc[i][j], kLDC, wmma::mem_row_major);
}

// ---- bf16 MoE up: act[slot, r, j] = bf16(value * silu(gate)), one tile --
//   value = xm W1v (* s1v) + b1v, gate likewise, in f32
// (the scales only for int8 weights; w1_s is not read for bf16 weights).
// item -> (n tile over HH, m tile, slot) as moe_up_tile.
template <typename W, typename Bias>
__device__ __forceinline__ void moe_up16_tile(
    const bf16* xm, const W* __restrict__ w1, const float* __restrict__ w1_s,
    const Bias* __restrict__ b1, const int* __restrict__ idx, int step,
    bf16* act, int M, int D, int HH, int E, int item, unsigned char* smem) {
  constexpr int kRaw = raw_tile_bytes<W>();
  constexpr int kStage = kTileA16 + 2 * kRaw;
  const int n_nt = HH / BN, n_mt = (M + BM - 1) / BM;
  const int slot = item / (n_nt * n_mt);
  const int m0 = ((item / n_nt) % n_mt) * BM, n0 = (item % n_nt) * BN;
  const int ex = expert_of(idx, step, slot, E);
  const int H2 = 2 * HH;
  const W* Wt = w1 + (size_t)ex * D * H2;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  bf16* wide = reinterpret_cast<bf16*>(smem + kPipe * kStage);

  auto load = [&](int stage, int it) {
    unsigned char* st = smem + stage * kStage;
    load_a_bf16(reinterpret_cast<bf16*>(st), xm, D, m0, M, it * BK16);
    load_w(reinterpret_cast<W*>(st + kTileA16), Wt, H2, it * BK16, n0);
    load_w(reinterpret_cast<W*>(st + kTileA16 + kRaw), Wt, H2, it * BK16,
           HH + n0);
  };

  FragC16 av[2][2], ag[2][2];
  zero_f32(av);
  zero_f32(ag);
  k_pipeline(D / BK16, load, [&](int stage) {
    const unsigned char* st = smem + stage * kStage;
    const bf16* As = reinterpret_cast<const bf16*>(st);
    const bf16* Bv = stage_w<W, 2>(st + kTileA16, wide);
    const bf16* Bg = Bv + BK16 * kLDB16;   // the gate tile follows
    mma_tile_bf16(av, As, Bv, wm, wn);
    mma_tile_bf16(ag, As, Bg, wm, wn);
  });
  float* Cv = reinterpret_cast<float*>(smem);
  float* Cg = Cv + BM * kLDC;
  store_f32(Cv, av, wm, wn);
  store_f32(Cg, ag, wm, wn);
  __syncthreads();
  const Bias* bv = b1 + (size_t)ex * H2;
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, n = e % BN;
    const int gr = m0 + r, gn = n0 + n;
    if (gr >= M) continue;
    float v = Cv[r * kLDC + n], g = Cg[r * kLDC + n];
    if constexpr (sizeof(W) == 1) {
      const float* sv = w1_s + (size_t)ex * H2;
      v = __fmul_rn(v, sv[gn]);
      g = __fmul_rn(g, sv[HH + gn]);
    }
    v = __fadd_rn(v, ldw(bv + gn));
    g = __fadd_rn(g, ldw(bv + HH + gn));
    act[((size_t)slot * M + gr) * HH + gn] =
        __float2bfloat16_rn(__fmul_rn(v, silu(g)));
  }
}

// ---- bf16 MoE down: part[z] = p * (act W2 (* s2)), z = (slot, hidden block)
// item -> (n tile over D, m tile, z) as moe_down_tile.
template <typename W>
__device__ __forceinline__ void moe_down16_tile(
    const bf16* act, const W* __restrict__ w2, const float* __restrict__ w2_s,
    const int* __restrict__ idx, const float* __restrict__ probs, int step,
    float* part, int M, int D, int HH, int TH, int E, int item,
    unsigned char* smem) {
  constexpr int kRaw = raw_tile_bytes<W>();
  constexpr int kStage = kTileA16 + kRaw;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n_nt = D / BN, n_mt = (M + BM - 1) / BM;
  const int m0 = ((item / n_nt) % n_mt) * BM, n0 = (item % n_nt) * BN;
  const int n_h = HH / TH, z = item / (n_nt * n_mt);
  const int slot = z / n_h, kb = z % n_h;
  const int ex = expert_of(idx, step, slot, E);
  const float p = probs[step * 2 + slot];
  const W* Wt = w2 + (size_t)ex * HH * D;
  const bf16* A = act + (size_t)slot * M * HH;
  const int k_begin = kb * TH;
  bf16* wide = reinterpret_cast<bf16*>(smem + kPipe * kStage);

  auto load = [&](int stage, int it) {
    unsigned char* st = smem + stage * kStage;
    load_a_bf16(reinterpret_cast<bf16*>(st), A, HH, m0, M,
                k_begin + it * BK16);
    load_w(reinterpret_cast<W*>(st + kTileA16), Wt, D, k_begin + it * BK16,
           n0);
  };

  FragC16 ac[2][2];
  zero_f32(ac);
  k_pipeline(TH / BK16, load, [&](int stage) {
    const unsigned char* st = smem + stage * kStage;
    mma_tile_bf16(ac, reinterpret_cast<const bf16*>(st),
                  stage_w<W, 1>(st + kTileA16, wide), wm, wn);
  });
  float* C = reinterpret_cast<float*>(smem);
  store_f32(C, ac, wm, wn);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, n = e % BN;
    const int gr = m0 + r, gn = n0 + n;
    if (gr >= M) continue;
    float y = C[r * kLDC + n];
    if constexpr (sizeof(W) == 1) y = __fmul_rn(y, w2_s[(size_t)ex * D + gn]);
    part[((size_t)z * M + gr) * D + gn] = __fmul_rn(p, y);
  }
}

}  // namespace mdp
