// One whole NoiseBlockMoE inference layer on Hopper (sm_90a).
//
// Replaces the TPU kernel mode_diffusion_policy_tpu/ops/pallas/layer_kernel.py
// (_kernel, launched by fused_layer_q8c) on the `parity` serving path:
//
//   x_mid = x + c_proj(attn(qk_norm(wqkv(rmsnorm(x)*g1 + c) + b)))  (bf16 dots)
//   out   = ln2(x_mid) + sum_{e in top2} p_e * W2_e q(act_e) s       (int8 dots)
//   act_e = value * silu(gate),  [value | gate] = q(ln2(x_mid)) W1_e s + b1
//
// Design. One launcher, fused_layer_q8c_launch, runs a fixed sequence of
// nine __global__ kernels on the caller's stream and allocates nothing:
//   1 ln1_kernel        per row: h = bf16(rmsnorm(x)*g1 + c)
//   2 gemm_bf16_kernel  qkv = h @ wqkv + b           (wmma bf16, f32 accum)
//   3 attn_kernel       one CTA per (head, sample): QK-RMSNorm, causal
//                       softmax over T <= 16 tokens, P V  (f32 FMA)
//   4 gemm_bf16_kernel  x_mid = bf16(x + o @ wout)   (wmma bf16, f32 accum)
//   5 ln2_quant_kernel  xm = bf16(rmsnorm(x_mid)*g2); int8 rows of xm
//   6 moe_up_kernel     value/gate = xq @ W1_e (wmma s8, s32 accum), act
//   7 act_quant_kernel  int8 rows of act, one scale per block_hidden columns
//   8 moe_down_kernel   part[e, k] = p_e * (aq_k W2_e,k) * scales, one CTA
//                       column per (expert slot, hidden block)
//   9 moe_sum_kernel    out = bf16(xm + part[0,0] + part[0,1] + ...), the
//                       partial sums added in the JAX kernel's order
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
// HH = 4096, top-2): bf16 products 2*N*D*4D + attention ~ 15.1 GFLOP
// (15 us), int8 products 2*N*D*2HH*2 + 2*N*HH*D*2 = 90.2 GOP (46 us), bytes
// ~ 41 MB (12 us); compute-bound, so the floor is ~61 us per launch with the
// two tensor-core rates not overlapped. This first version uses the legacy
// wmma (mma.sync) path on 64 x 64 tiles, double-buffered with cp.async;
// wgmma/TMA are work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;  // 4 warps, 2 x 2 over a 64 x 64 output tile
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK16 = 64;       // bf16 k-tile
constexpr int BK8 = 128;       // int8 k-tile
constexpr int kMaxD = 4096;    // row kernels stage one row in shared memory
constexpr int kMaxT = 16;      // tokens per sample held by attn_kernel

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

// Block-wide sum / max for blockDim.x a multiple of 32 (<= 1024); every
// thread gets the result. `red` holds >= 32 floats.
__device__ float block_sum(float v, float* red) {
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

__device__ float block_max(float v, float* red) {
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

__device__ __forceinline__ float silu(float g) {
  return __fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
}

// 16-byte asynchronous copy global -> shared; copies nothing and zero-fills
// the 16 bytes when !pred (src must still be a valid address).
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

// ---- 1: h = bf16(rmsnorm(x) * g1 + c) ------------------------------------
__global__ void ln1_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ c,
                           const float* __restrict__ g, bf16* __restrict__ h,
                           int D, float rs_D, float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const bf16* xr = x + row * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float v = __bfloat162float(xr[d]);
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float den = fmaxf(__fmul_rn(sqrtf(ss), rs_D), eps);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float v = __fdiv_rn(__bfloat162float(xr[d]), den);
    v = __fadd_rn(__fmul_rn(v, g[d]), c[d]);
    h[row * D + d] = __float2bfloat16_rn(v);
  }
}

// ---- 2, 4: C = A[M,K] @ B[K,N], bf16 in, f32 accumulate -----------------
// Epilogue 0: out_f32[r, n] = acc + bias[n]
// Epilogue 1: out_bf16[r, n] = bf16(float(resid[r, n]) + acc)
template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 int M, int N, int K, const float* __restrict__ bias,
                 float* __restrict__ out_f32, const bf16* __restrict__ resid,
                 bf16* __restrict__ out_bf16) {
  constexpr int LDA = BK16 + 8;   // padded rows keep wmma pointers 32B-aligned
  constexpr int LDB = BN + 8;
  constexpr int LDC = BN + 4;
  constexpr int kABytes = BM * LDA * 2;
  constexpr int kStage = kABytes + BK16 * LDB * 2;
  constexpr int kEpi = BM * LDC * 4;
  __shared__ __align__(128) unsigned char smem[2 * kStage > kEpi ? 2 * kStage : kEpi];
  float* Cs = reinterpret_cast<float*>(smem);   // reused after the k loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load = [&](int stage, int k0) {
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
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = K / BK16;
  load(0, 0);
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      load((it + 1) & 1, (it + 1) * BK16);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* As = reinterpret_cast<const bf16*>(smem + (it & 1) * kStage);
    const bf16* Bs = reinterpret_cast<const bf16*>(smem + (it & 1) * kStage + kABytes);
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
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, n = e % BN;
    const int gr = m0 + r, gn = n0 + n;
    if (gr >= M) continue;
    const float a = Cs[r * LDC + n];
    if (EPI == 0) {
      out_f32[(size_t)gr * N + gn] = __fadd_rn(a, bias[gn]);
    } else {
      const float v = __fadd_rn(__bfloat162float(resid[(size_t)gr * N + gn]), a);
      out_bf16[(size_t)gr * N + gn] = __float2bfloat16_rn(v);
    }
  }
}

// ---- 3: attention, one CTA per (head, sample), blockDim.x == hd ----------
__global__ void attn_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ qg,
                            const float* __restrict__ kg,
                            bf16* __restrict__ o, int T, int D, int hd,
                            float rs_hd, float eps_qk, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                 // [T, hd] bf16-rounded normed q
  float* ks = qs + T * hd;        // [T, hd] bf16-rounded normed k
  float* vs = ks + T * hd;        // [T, hd] bf16-rounded v
  __shared__ float red[kMaxT][32];
  __shared__ float inv_q[kMaxT], inv_k[kMaxT];
  __shared__ float pr[kMaxT][kMaxT];

  const int h = blockIdx.x, b = blockIdx.y;
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5, nw = hd >> 5;
  const size_t row0 = (size_t)b * T;
  const int D3 = 3 * D;

  float qv[kMaxT], kv[kMaxT];
  for (int t = 0; t < T; ++t) {
    const float* r = qkv + (row0 + t) * D3 + h * hd + d;
    qv[t] = r[0];
    kv[t] = r[D];
    vs[t * hd + d] = __bfloat162float(__float2bfloat16_rn(r[2 * D]));
  }
  // per-row sum of squares of q and k within this head
  for (int t = 0; t < T; ++t) {
    float sq = warp_sum(qv[t] * qv[t]);
    float sk = warp_sum(kv[t] * kv[t]);
    if (lane == 0) {
      red[t][warp] = sq;
      red[t][16 + warp] = sk;
    }
  }
  __syncthreads();
  if (d < T) {
    float sq = 0.f, sk = 0.f;
    for (int w = 0; w < nw; ++w) {
      sq += red[d][w];
      sk += red[d][16 + w];
    }
    inv_q[d] = __fdiv_rn(1.0f, fmaxf(__fmul_rn(sqrtf(sq), rs_hd), eps_qk));
    inv_k[d] = __fdiv_rn(1.0f, fmaxf(__fmul_rn(sqrtf(sk), rs_hd), eps_qk));
  }
  __syncthreads();
  const float gq = qg[d], gk = kg[d];
  for (int t = 0; t < T; ++t) {
    qs[t * hd + d] = __bfloat162float(
        __float2bfloat16_rn(__fmul_rn(__fmul_rn(qv[t], inv_q[t]), gq)));
    ks[t * hd + d] = __bfloat162float(
        __float2bfloat16_rn(__fmul_rn(__fmul_rn(kv[t], inv_k[t]), gk)));
  }
  __syncthreads();
  // causal scores: warp w takes pairs (i, j <= i) round-robin
  int p = 0;
  for (int i = 0; i < T; ++i) {
    for (int j = 0; j <= i; ++j, ++p) {
      if (p % nw != warp) continue;
      float s = 0.f;
      for (int e = lane; e < hd; e += 32) s += qs[i * hd + e] * ks[j * hd + e];
      s = warp_sum(s);
      if (lane == 0) pr[i][j] = __fmul_rn(s, scale);
    }
  }
  __syncthreads();
  // f32 softmax per row, probabilities rounded to bf16
  if (d < T) {
    const int i = d;
    float m = pr[i][0];
    for (int j = 1; j <= i; ++j) m = fmaxf(m, pr[i][j]);
    float den = 0.f;
    for (int j = 0; j <= i; ++j) {
      const float e = expf(pr[i][j] - m);
      pr[i][j] = e;
      den += e;
    }
    for (int j = 0; j <= i; ++j)
      pr[i][j] = __bfloat162float(__float2bfloat16_rn(__fdiv_rn(pr[i][j], den)));
  }
  __syncthreads();
  for (int i = 0; i < T; ++i) {
    float acc = 0.f;
    for (int j = 0; j <= i; ++j) acc += pr[i][j] * vs[j * hd + d];
    o[(row0 + i) * D + h * hd + d] = __float2bfloat16_rn(acc);
  }
}

// ---- 5: xm = bf16(rmsnorm(x_mid) * g2); xq, sx = quant_rows(xm) -----------
__global__ void ln2_quant_kernel(const bf16* __restrict__ xmid,
                                 const float* __restrict__ g,
                                 bf16* __restrict__ xm, int8_t* __restrict__ xq,
                                 float* __restrict__ sx, int D, float rs_D,
                                 float eps) {
  __shared__ float red[32];
  __shared__ float buf[kMaxD];
  const size_t row = blockIdx.x;
  const bf16* xr = xmid + row * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = __bfloat162float(xr[d]);
    buf[d] = v;
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float den = fmaxf(__fmul_rn(sqrtf(ss), rs_D), eps);
  float amax = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const bf16 r = __float2bfloat16_rn(__fmul_rn(__fdiv_rn(buf[d], den), g[d]));
    xm[row * D + d] = r;
    buf[d] = __bfloat162float(r);
    amax = fmaxf(amax, fabsf(buf[d]));
  }
  amax = block_max(amax, red);
  const float s = quant_scale(amax);
  const float inv = __fdiv_rn(1.0f, s);
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    xq[row * D + d] = quant_one(buf[d], inv);
  if (threadIdx.x == 0) sx[row] = s;
}

// int8 tiles live in shared memory as 16-byte-wide column strips
// ([k/16][rows][16] for A, [n/16][k][16] for B) so that every wmma fragment
// pointer is 32-byte aligned, as load_matrix_sync requires. The loads are
// asynchronous (cp.async); the caller commits and waits.
constexpr int kTileA8 = BM * BK8;
constexpr int kTileB8 = BK8 * BN;

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

__device__ __forceinline__ int expert_of(const int* idx, int step, int slot,
                                         int E) {
  const int e = idx[step * 2 + slot];
  if (e < 0 || e >= E) __trap();   // routing tables come from top-k: never
  return e;
}

// ---- 6: act[slot, r, j] = value * silu(gate) for one expert slot ---------
__global__ void __launch_bounds__(kThreads)
moe_up_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
              const int8_t* __restrict__ w1_q, const float* __restrict__ w1_s,
              const float* __restrict__ b1, const int* __restrict__ idx,
              int step, float* __restrict__ act, int M, int D, int HH, int E) {
  constexpr int LDC = BN + 4;
  constexpr int kStage = kTileA8 + 2 * kTileB8;
  constexpr int kEpiBytes = 2 * BM * LDC * 4;
  __shared__ __align__(128) unsigned char smem[2 * kStage > kEpiBytes ? 2 * kStage : kEpiBytes];

  const int slot = blockIdx.z;
  const int ex = expert_of(idx, step, slot, E);
  const int H2 = 2 * HH;
  const int8_t* W = w1_q + (size_t)ex * D * H2;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load = [&](int stage, int k0) {
    int8_t* st = reinterpret_cast<int8_t*>(smem) + stage * kStage;
    load_a_i8(st, xq, D, m0, M, k0);
    load_b_i8(st + kTileA8, W, H2, k0, n0);
    load_b_i8(st + kTileA8 + kTileB8, W, H2, k0, HH + n0);
    cp_async_commit();
  };

  FragC32 av[2][2], ag[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(av[i][j], 0);
      wmma::fill_fragment(ag[i][j], 0);
    }
  const int nk = D / BK8;
  load(0, 0);
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      load((it + 1) & 1, (it + 1) * BK8);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* st = reinterpret_cast<const int8_t*>(smem) + (it & 1) * kStage;
    mma_tile_i8(av, st, st + kTileA8, wm, wn);
    mma_tile_i8(ag, st, st + kTileA8 + kTileB8, wm, wn);
    __syncthreads();
  }
  int* Cv = reinterpret_cast<int*>(smem);
  int* Cg = Cv + BM * LDC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cv + (wm + 16 * i) * LDC + wn + 16 * j, av[i][j],
                              LDC, wmma::mem_row_major);
      wmma::store_matrix_sync(Cg + (wm + 16 * i) * LDC + wn + 16 * j, ag[i][j],
                              LDC, wmma::mem_row_major);
    }
  __syncthreads();
  const float* sv = w1_s + (size_t)ex * H2;
  const float* bv = b1 + (size_t)ex * H2;
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, n = e % BN;
    const int gr = m0 + r, gn = n0 + n;
    if (gr >= M) continue;
    const float s = sx[gr];
    const float v = __fadd_rn(
        __fmul_rn((float)Cv[r * LDC + n], __fmul_rn(s, sv[gn])), bv[gn]);
    const float g = __fadd_rn(
        __fmul_rn((float)Cg[r * LDC + n], __fmul_rn(s, sv[HH + gn])), bv[HH + gn]);
    act[((size_t)slot * M + gr) * HH + gn] = __fmul_rn(v, silu(g));
  }
}

// ---- 7: aq, sa = quant_rows(act) per block_hidden column block -----------
__global__ void act_quant_kernel(const float* __restrict__ act,
                                 int8_t* __restrict__ aq, float* __restrict__ sa,
                                 int M, int HH, int TH) {
  __shared__ float red[32];
  const int kb = blockIdx.x, r = blockIdx.y, slot = blockIdx.z;
  const int n_h = HH / TH;
  const size_t base = ((size_t)slot * M + r) * HH + (size_t)kb * TH;
  float amax = 0.f;
  for (int j = threadIdx.x; j < TH; j += blockDim.x)
    amax = fmaxf(amax, fabsf(act[base + j]));
  amax = block_max(amax, red);
  const float s = quant_scale(amax);
  const float inv = __fdiv_rn(1.0f, s);
  for (int j = threadIdx.x; j < TH; j += blockDim.x)
    aq[base + j] = quant_one(act[base + j], inv);
  if (threadIdx.x == 0) sa[((size_t)slot * M + r) * n_h + kb] = s;
}

// ---- 8: part[z] = p * (aq W2) * (sa * s2) for z = (slot, hidden block) --
__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const int8_t* __restrict__ aq, const float* __restrict__ sa,
                const int8_t* __restrict__ w2_q, const float* __restrict__ w2_s,
                const int* __restrict__ idx, const float* __restrict__ probs,
                int step, float* __restrict__ part, int M, int D, int HH,
                int TH, int E) {
  constexpr int LDC = BN + 4;
  constexpr int kStage = kTileA8 + kTileB8;
  constexpr int kEpiBytes = BM * LDC * 4;
  __shared__ __align__(128) unsigned char smem[2 * kStage > kEpiBytes ? 2 * kStage : kEpiBytes];
  int* Ci = reinterpret_cast<int*>(smem);       // reused after the k loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_h = HH / TH, z = blockIdx.z;
  const int slot = z / n_h, kb = z % n_h;
  const int ex = expert_of(idx, step, slot, E);
  const float p = probs[step * 2 + slot];
  const int8_t* W = w2_q + (size_t)ex * HH * D;
  const float* s2 = w2_s + (size_t)ex * D;
  const int8_t* A = aq + (size_t)slot * M * HH;

  auto load = [&](int stage, int k0) {
    int8_t* st = reinterpret_cast<int8_t*>(smem) + stage * kStage;
    load_a_i8(st, A, HH, m0, M, k0);
    load_b_i8(st + kTileA8, W, D, k0, n0);
    cp_async_commit();
  };

  FragC32 ac[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(ac[i][j], 0);
  const int nk = TH / BK8, k_begin = kb * TH;
  load(0, k_begin);
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      load((it + 1) & 1, k_begin + (it + 1) * BK8);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* st = reinterpret_cast<const int8_t*>(smem) + (it & 1) * kStage;
    mma_tile_i8(ac, st, st + kTileA8, wm, wn);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Ci + (wm + 16 * i) * LDC + wn + 16 * j,
                              ac[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, n = e % BN;
    const int gr = m0 + r, gn = n0 + n;
    if (gr >= M) continue;
    const float s = __fmul_rn(sa[((size_t)slot * M + gr) * n_h + kb], s2[gn]);
    part[((size_t)z * M + gr) * D + gn] =
        __fmul_rn(p, __fmul_rn((float)Ci[r * LDC + n], s));
  }
}

// ---- 9: out = bf16(((xm + part[0]) + part[1]) + ...) ----------------------
__global__ void moe_sum_kernel(const bf16* __restrict__ xm,
                               const float* __restrict__ part,
                               bf16* __restrict__ out, int MD, int n_part) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < MD;
       i += gridDim.x * blockDim.x) {
    float acc = __bfloat162float(xm[i]);
    for (int z = 0; z < n_part; ++z) acc = __fadd_rn(acc, part[(size_t)z * MD + i]);
    out[i] = __float2bfloat16_rn(acc);
  }
}

}  // namespace

extern "C" int fused_layer_q8c_launch(
    const void* x, const void* c, const void* ln1_g, const void* wqkv,
    const void* bqkv, const void* q_g, const void* k_g, const void* wout,
    const void* ln2_g, const void* w1_q, const void* w1_s, const void* b1,
    const void* w2_q, const void* w2_s, const void* idx, const void* probs,
    int step, void* h, void* qkv, void* o, void* xmid, void* xm, void* xq,
    void* sx, void* act, void* aq, void* sa, void* part, void* out, int B,
    int T, int D,
    int H, int HH, int TH, int E, float eps1, float eps_qk, float eps2,
    float rs_D, float rs_hd, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T, hd = D / H, n_h = HH / TH;
  const int mt = (M + BM - 1) / BM;
  const int rthreads = 256;

  ln1_kernel<<<M, rthreads, 0, st>>>(
      (const bf16*)x, (const float*)c, (const float*)ln1_g, (bf16*)h, D, rs_D,
      eps1);
  gemm_bf16_kernel<0><<<dim3(3 * D / BN, mt), kThreads, 0, st>>>(
      (const bf16*)h, (const bf16*)wqkv, M, 3 * D, D, (const float*)bqkv,
      (float*)qkv, nullptr, nullptr);
  attn_kernel<<<dim3(H, B), hd, 3 * T * hd * sizeof(float), st>>>(
      (const float*)qkv, (const float*)q_g, (const float*)k_g, (bf16*)o, T, D,
      hd, rs_hd, eps_qk, scale);
  gemm_bf16_kernel<1><<<dim3(D / BN, mt), kThreads, 0, st>>>(
      (const bf16*)o, (const bf16*)wout, M, D, D, nullptr, nullptr,
      (const bf16*)x, (bf16*)xmid);
  ln2_quant_kernel<<<M, rthreads, 0, st>>>(
      (const bf16*)xmid, (const float*)ln2_g, (bf16*)xm, (int8_t*)xq,
      (float*)sx, D, rs_D, eps2);
  moe_up_kernel<<<dim3(HH / BN, mt, 2), kThreads, 0, st>>>(
      (const int8_t*)xq, (const float*)sx, (const int8_t*)w1_q,
      (const float*)w1_s, (const float*)b1, (const int*)idx, step, (float*)act,
      M, D, HH, E);
  act_quant_kernel<<<dim3(n_h, M, 2), rthreads, 0, st>>>(
      (const float*)act, (int8_t*)aq, (float*)sa, M, HH, TH);
  moe_down_kernel<<<dim3(D / BN, mt, 2 * n_h), kThreads, 0, st>>>(
      (const int8_t*)aq, (const float*)sa, (const int8_t*)w2_q,
      (const float*)w2_s, (const int*)idx, (const float*)probs, step,
      (float*)part, M, D, HH, TH, E);
  const int MD = M * D;
  moe_sum_kernel<<<(MD + 4 * rthreads - 1) / (4 * rthreads), rthreads, 0, st>>>(
      (const bf16*)xm, (const float*)part, (bf16*)out, MD, 2 * n_h);
  return (int)cudaGetLastError();
}
