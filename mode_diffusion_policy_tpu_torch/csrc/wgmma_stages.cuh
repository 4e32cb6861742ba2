// Every product of the port's kernels on Hopper's warpgroup MMA (wgmma) fed
// by the Tensor Memory Accelerator (TMA): the expert products of the top-2
// MoE and the attention projections, for the bf16-compute MoE
// (fused_top2_mlp.cu: bf16 or int8 weights), the attention kernels and the
// layer (int8_stages.cuh: fused_attn_block.cu, fused_attn_block_q8.cu,
// fused_top2_mlp_q8c.cu, fused_layer_q8c.cu) and the DiT megakernel
// (fused_dit_q8c.cu). The other stages of those kernels stay in
// layer_stages.cuh.
//
// Routing depends only on sigma: each of the two selected experts of a
// routing row is a dense GEMM over all N = B*T token rows (no gather, no
// permutation). Two GEMM stages, each for three kinds of product (bf16,
// int8 x int8, int8 weights widened to bf16: Kind), share one mainloop,
// gemm<Op>:
//   Up    [N, D] x [D, value | gate] of one slot's expert; the tile holds
//         the value columns n0.. and the gate columns HH + n0.. side by
//         side, as the SwishGLU epilogue needs
//   Down  [N, TH] x [TH, D] per (slot, hidden block), added in the JAX
//         order to the residual seed in registers (128 x 128 tiles), or
//         written as the f32 partials that moe_sum_elems adds in the same
//         order (64 x 64 tiles).
// and the attention projections run on the same mainloop as one more stage:
//   Proj  [N, D] x [D, 3D] (QKV, f32 out with the bias) or [N, D] x [D, D]
//         (c_proj, added to the residual in bf16), bf16 or int8 x int8,
//         the weight map's outer coordinate the layer of a stacked weight
//         (0 for one layer) in place of the expert.
// Each stage is a pair of loops over one ring of shared-memory stages,
// produce<Op> (the TMA producer) and consume<Op> (the wgmma consumers):
// gemm<Op> runs one stage as a kernel of its own, and the DiT megakernel
// (fused_dit_q8c.cu) runs every GEMM stage of every layer on one ring.
//
// Design. A persistent CTA (one per SM at most) walks its tiles t =
// blockIdx.x, + gridDim.x, ... . Warpgroups 0 .. kWG-1 consume, warpgroup
// kWG produces: one of its threads keeps a ring of kStages shared-memory
// stages filled by TMA (each stage signalled through a "full" mbarrier with
// the byte count, and handed back through an "empty" mbarrier that each
// consumer warpgroup arrives on once its products have read the stage); the
// ring runs on across tiles, so the next tile's loads overlap this tile's
// epilogue. A consumer warpgroup owns 64 rows of the tile: per k-step it
// issues wgmma.mma_async on 128-byte-swizzled tiles (A K-major from the
// activations; B from the experts), keeps one group in flight, and applies
// the stage's epilogue to the f32 (bf16) or s32 (int8) accumulator in its
// fragment layout, straight to global memory. Every TMA box is 64 rows
// (8 KB swizzled, or 4 KB of raw int8 to widen), so one tensor map per
// tensor serves both tile sizes: kWG = 2 (128 x 128 output tiles, 64 x 128
// per warpgroup) where N is large and kWG = 1 (64 x 64) where it is small,
// so that b=1 still spreads the expert weights over about 128 CTAs. The
// expert index comes from the device routing table inside the kernel, as
// the third coordinate of a tensor map over [E, rows, cols]: no host sync.
//
// Layouts. bf16 B is read as the JAX weights hold it, [K, N] with N
// contiguous (the experts, and the projections wqkv [D, 3D], wout [D, D]):
// MN-major (the transpose bit), one 8 KB box per 64 output columns, LBO =
// 8 KB between them, SBO = 1 KB between 8-row groups of k. s8 wgmma takes
// B only K-major, so the int8 stages read K-major copies of the experts
// ([E, 2H, D] and [E, D, H]: ops/quant.py kmajor_experts) and projections
// ([3D, D] and [D, D]: kmajor_attn), made once per quantization (stacked
// [L, ...] once per preset for the megakernel), one box per 64 output
// columns, SBO = 1 KB.
//
// Rounding: the f32 sums of a bf16 product run in the tensor core's order,
// k-step by k-step, so every kernel that runs a bf16 stage under the same
// tile plan gives the same bits (on the H100 the bf16 projections gave the
// same bits under every tile plan too: chip_smoke.py phase 15, which
// reports it); the s32 sums of the int8 products are
// exact (|sum| <= 1024 * 127^2 < 2^31), whatever the tiles. Every epilogue
// performs its f32 operations per element in the order of the JAX kernels'
// cast chain.
#pragma once

#include <cuda.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "layer_stages.cuh"

namespace mdp {
namespace wg {

constexpr int kBoxRows = 64;        // rows of every TMA box
constexpr int kBox = 8192;          // bytes of every box: 64 rows of 128 B
constexpr int kRingBytes = 196608;  // shared memory of the ring
constexpr int kMaxStages = 8;

// ---- PTX helpers -------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(bar) : "memory");
}

// Order this thread's generic-proxy writes (to global and shared memory)
// before later async-proxy accesses (TMA) to the same memory, and the other
// way round: inside one kernel, a stage's stores and the next stage's TMA
// loads are ordered by this fence on both sides of the grid barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: 8-row groups
// 1 KB apart (SBO); lbo is the distance between 64-column chunks of an
// MN-major operand (unused for K-major ones).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// ---- wgmma.mma_async, D += A B, one 64-row slab -----------------------------
// bf16: m64nNk16, A K-major, B MN-major (trans-b); s8: m64nNk32, both
// K-major. d holds N / 2 accumulators per thread: value i sits at row
// 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) +
// 2 * (lane % 4) + i % 2 of the slab.
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (N == 64) wgmma_bf16_n64(d, da, db);
  else if constexpr (N == 128) wgmma_bf16_n128(d, da, db);
  else wgmma_bf16_n256(d, da, db);
}

template <int N>
__device__ __forceinline__ void mma(int (&d)[N / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (N == 64) wgmma_s8_n64(d, da, db);
  else if constexpr (N == 128) wgmma_s8_n128(d, da, db);
  else wgmma_s8_n256(d, da, db);
}

// ---- the GEMM stages ---------------------------------------------------------
// Operands of every MoE stage; each reads the ones its epilogue needs.
struct MoeArgs {
  const int* idx;       // [S, 2] routing table
  const float* probs;   // [S, 2]
  int step, M, D, HH, TH, E;
  int n_mt, n_nt, n_tiles;   // tiles over rows, over columns, in all
  int ex0;              // the expert map's first coordinate of this layer's
                        // experts (l * E in a stack of layers, else 0)
  const void* bias;     // b1 [E, 2H]: bf16 (bf16 MoE) or f32 (int8 layer)
  const float* s_row;   // int8: sx [M] (up), sa [2, M, H / TH] (down)
  const float* s_col;   // int8: w1_s [E, 2H] (up), w2_s [E, D] (down)
  const bf16* seed;     // down: the sum's seed [M, D], or nullptr for 0
  void* out;            // act [2, M, H] (bf16 or f32); down: out [M, D]
                        // (bf16), or the f32 partials [2 H / TH, M, D]
};

struct Tile {
  int z, m0, n0, ex;    // z: up, the slot (ex its expert); down, the
                        // (slot, hidden block) of a partials tile
};

// Tile t -> (column tile fastest, row tile, z). The plans that the Python
// wrappers take (ops/kernels/moe_kernel.py moe_tile_plan, attn_kernel.py
// proj_tile_plan) mirror it.
template <class Args>
__device__ __forceinline__ Tile tile_of(const Args& a, int t, int bm,
                                        int bn) {
  Tile tl;
  tl.n0 = (t % a.n_nt) * bn;
  tl.m0 = ((t / a.n_nt) % a.n_mt) * bm;
  tl.z = t / (a.n_nt * a.n_mt);
  tl.ex = 0;
  return tl;
}

__device__ __forceinline__ float bias_of(const void* b, size_t i, bool bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(b)[i])
            : static_cast<const float*>(b)[i];
}

// The three kinds of expert products: bf16 weights (fused_top2_mlp), int8
// products (fused_layer_q8c), int8 weights with bf16 products
// (fused_top2_mlp_q8: each int8 weight box lands in shared memory as it is
// and is widened to bf16 there, exact, in the swizzled layout that the
// bf16 products read, so that it runs the bf16 products in the same order:
// with unit scales it gives the bf16 kind's bits).
enum Kind { kBf16, kS8, kW8 };

// Stage bytes: kWG A boxes, then the B boxes (W8: raw int8 boxes of 64 x
// 64 bytes, widened into one of three bf16 copies after the ring).
template <int WG, int N, int KIND>
struct Shape {
  static constexpr int kWG = WG, kBM = 64 * WG, kN = N, kR = N / 2;
  static constexpr bool S8 = KIND == kS8, W8 = KIND == kW8;
  static constexpr int kChunks = N / 64;   // B boxes: 64 output columns each
  static constexpr int kStage = kBox * WG + (W8 ? kBox / 2 : kBox) * kChunks;
  static constexpr int kWide = W8 ? 3 * kBox * kChunks : 0;
  static constexpr int kStages = (kRingBytes - kWide) / kStage < kMaxStages
                                     ? (kRingBytes - kWide) / kStage
                                     : kMaxStages;
  static constexpr int kSmem = kStages * kStage + kWide + 1024;  // + align
  using Acc = typename std::conditional<S8, int, float>::type;

  // B of the stage at st: the boxes themselves, or (W8) their widened
  // copy, made here by the 128 WG consumer threads: the copy of k-step it
  // goes to buffer it % 3, whose last reader, k-step it - 3, every
  // consumer warpgroup has waited for (wgmma_wait<1> at k-step it - 2)
  // before the barrier of k-step it - 1.
  __device__ static uint32_t operand_b(uint32_t st, uint32_t wide, int it) {
    if constexpr (!W8) {
      return st + WG * kBox;
    } else {
      const uint32_t raw = st + WG * kBox;
      const uint32_t dst = wide + (it % 3) * kBox * kChunks;
      // 16 int8 of one k row per unit, two 16-byte groups of 8 bf16 out
      for (int u = threadIdx.x; u < kChunks * 256; u += 128 * WG) {
        const int c = u / 256, k = (u % 256) / 4, g = 2 * (u % 4);
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(raw + c * (kBox / 2) + 16 * (u % 256)));
        uint32_t w[8];
        const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t b = in[i / 2] >> (16 * (i % 2));
          const __nv_bfloat162 h = __floats2bfloat162_rn(
              (float)(int8_t)(b & 0xff), (float)(int8_t)((b >> 8) & 0xff));
          w[i] = *reinterpret_cast<const uint32_t*>(&h);
        }
        const uint32_t row = dst + c * kBox + 128 * k;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                       ::"r"(row + (((g + h) ^ (k % 8)) << 4)),
                       "r"(w[4 * h]), "r"(w[4 * h + 1]), "r"(w[4 * h + 2]),
                       "r"(w[4 * h + 3]) : "memory");
      }
      // the generic-proxy writes, seen by the products (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 3, %0;\n" ::"n"(128 * WG) : "memory");
      return dst;
    }
  }

  // One B box of the stage: 64 output columns from col, 128 bytes of k
  // from k0, of the outer coordinate ex (an expert, or a layer); bf16
  // [E, K, N] MN-major boxes, int8 K-major ([E, N, K]) boxes, or (W8) raw
  // int8 [E, K, N] boxes of 64 k rows x 64 columns.
  static constexpr int kBBox = W8 ? kBox / 2 : kBox;
  __device__ static void load_b(const CUtensorMap* tb, uint32_t st, int c,
                                int col, int k0, int ex, uint32_t bar) {
    if constexpr (S8)
      tma_3d(st + WG * kBox + c * kBBox, tb, bar, k0, col, ex);
    else
      tma_3d(st + WG * kBox + c * kBBox, tb, bar, col, k0, ex);
  }
};

// The products of one stage: 128 bytes of k of A per stage, four wgmma
// k-steps.
template <bool S8, int N, typename Acc>
__device__ __forceinline__ void stage_mma(Acc (&d)[N / 2], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (S8)
      mma<N>(d, sw128_desc(a + 32 * kk, 16), sw128_desc(b + 32 * kk, 16));
    else
      mma<N>(d, sw128_desc(a + 32 * kk, 16),
             sw128_desc(b + 2048 * kk, kBox));
  }
}

// The epilogues run from registers to global memory, with few warps per
// SM: each stage's column operands (biases, scales) of the tile are staged
// in shared memory and its row scales in registers before the products,
// so that the per-element arithmetic waits on no global load. A thread
// holds rows r0 and r0 + 8 of its warp's 16 (Row) and, for each 8-column
// group j, columns c0 + 8 j and c0 + 8 j + 1.
struct Row {
  int r0;         // first of the thread's two rows
  float s[2];     // int8 products: the row scale of each (sx or sa)
};

__device__ __forceinline__ int row0(const Tile& tl, int wg) {
  const int tid = threadIdx.x % 128;
  return tl.m0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;
}

// The thread's two rows and (s_row: int8 products) their scales.
__device__ __forceinline__ Row row_of(const Tile& tl, int wg, int M,
                                      const float* s_row) {
  Row rw;
  rw.r0 = row0(tl, wg);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rw.s[r] = s_row && rw.r0 + 8 * r < M ? ldf(s_row + rw.r0 + 8 * r) : 0.f;
  return rw;
}

// Stage N column operands cols[i] = f(i) in shared memory, the consumer
// warpgroup's loads all issued before its first store (a load after a
// store to the generic address of cols would wait for it).
template <int N, class F>
__device__ __forceinline__ void stage_cols(float* cols, F f) {
  constexpr int kPer = (N + 127) / 128;
  float v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x % 128 + 128 * u;
    v[u] = i < N ? f(i) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x % 128 + 128 * u;
    if (i < N) cols[i] = v[u];
  }
}

// MoE up, one slot: act[slot, r, n] = value * silu(gate) of the value
// columns n0 .. n0 + 64 WG and the gate columns H + n0 ..:
//   bf16: act = bf16((xm W1v + b1v) * silu(xm W1g + b1g));
//   W8:   act = bf16(((xm W1v) s1v + b1v) * silu((xm W1g) s1g + b1g));
//   S8:   act = (acc_v (sx s1v) + b1v) * silu(acc_g (sx s1g) + b1g), f32.
// A: xm / xq [M, D] (2-D map); B: W1 [E, D, 2H] (bf16 MN-major, W8 raw) or
// the K-major int8 copy [E, 2H, D] (S8).
template <int WG, int KIND>
struct Up : Shape<WG, 128 * WG, KIND> {
  using Sh = Shape<WG, 128 * WG, KIND>;
  using Acc = typename Sh::Acc;
  using Args = MoeArgs;
  static constexpr bool S8 = Sh::S8, W8 = Sh::W8;
  static constexpr int kNV = 64 * WG;   // value (and gate) columns
  // staged columns: b1v, b1g (and int8: s1v, s1g), kNV floats each
  static constexpr int kCols = (KIND == kBf16 ? 2 : 4) * kNV;

  struct Sum {};   // one pass per tile: nothing carried between passes

  __device__ static Tile tile(const MoeArgs& a, int t) {
    Tile tl = tile_of(a, t, Sh::kBM, kNV);
    tl.ex = expert_of(a.idx, a.step, tl.z, a.E);
    return tl;
  }
  __device__ static int passes(const MoeArgs&) { return 1; }
  __device__ static int nk(const MoeArgs& a) { return a.D / (S8 ? 128 : 64); }
  // f(c, col, k0, ex) for every B box of k-step kt
  template <class F>
  __device__ static void for_b(const MoeArgs& a, const Tile& tl, int, int kt,
                               F f) {
#pragma unroll
    for (int c = 0; c < 2 * WG; ++c)
      // chunks 0 .. WG-1 value columns, then as many gate columns
      f(c, (c < WG ? 0 : a.HH - kNV) + tl.n0 + 64 * c, kt * (S8 ? 128 : 64),
        a.ex0 + tl.ex);
  }
  __device__ static void load(const CUtensorMap* ta, const CUtensorMap* tb,
                              const MoeArgs& a, const Tile& tl, int z, int kt,
                              uint32_t st, uint32_t bar) {
    const int k0 = kt * (S8 ? 128 : 64);
#pragma unroll
    for (int w = 0; w < WG; ++w) tma_2d(st + w * kBox, ta, bar, k0, tl.m0 + 64 * w);
    for_b(a, tl, z, kt, [&](int c, int col, int k, int ex) {
      Sh::load_b(tb, st, c, col, k, ex, bar);
    });
  }
  __device__ static void mma(Acc (&d)[Sh::kR], uint32_t st, uint32_t b,
                             int wg) {
    stage_mma<S8, Sh::kN>(d, st + wg * kBox, b);
  }
  // cols[k * kNV + n]: k = 0 b1v, 1 b1g, (int8) 2 s1v, 3 s1g
  __device__ static Row operands(const MoeArgs& a, const Tile& tl, int wg,
                                 float* cols) {
    const Row rw = row_of(tl, wg, a.M, S8 ? a.s_row : nullptr);
    const size_t eb = (size_t)tl.ex * 2 * a.HH + tl.n0;
    stage_cols<kCols>(cols, [&](int i) {
      const int k = i / kNV, n = i % kNV;
      const size_t at = eb + (k % 2 ? a.HH : 0) + n;
      return k < 2 ? bias_of(a.bias, at, KIND == kBf16) : a.s_col[at];
    });
    return rw;
  }
  __device__ static void seed(Sum&, const MoeArgs&, const Tile&,
                              const Row&) {}
  __device__ static void pass_operands(const MoeArgs&, const Tile&, int,
                                       Row&) {}
  __device__ static void finish(const Sum&, const MoeArgs&, const Tile&,
                                const Row&) {}
  __device__ static void store(const Acc (&d)[Sh::kR], const MoeArgs& a,
                               const Tile& tl, const Row& rw,
                               const float* cols, int, Sum&) {
    const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
    for (int j = 0; j < kNV / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rw.r0 + 8 * r;
        float out[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = c0 + 8 * j + c, i = 4 * j + 2 * r + c;
          float v = (float)d[i], g = (float)d[i + kNV / 2];
          if constexpr (S8) {
            v = __fmul_rn(v, __fmul_rn(rw.s[r], cols[2 * kNV + n]));
            g = __fmul_rn(g, __fmul_rn(rw.s[r], cols[3 * kNV + n]));
          } else if constexpr (W8) {
            v = __fmul_rn(v, cols[2 * kNV + n]);
            g = __fmul_rn(g, cols[3 * kNV + n]);
          }
          v = __fadd_rn(v, cols[n]);
          g = __fadd_rn(g, cols[kNV + n]);
          out[c] = __fmul_rn(v, silu(g));
        }
        const size_t at =
            ((size_t)tl.z * a.M + row) * a.HH + tl.n0 + c0 + 8 * j;
        if (row < a.M) {
          if constexpr (S8)
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at) =
                make_float2(out[0], out[1]);
          else
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) +
                                               at) =
                __floats2bfloat162_rn(out[0], out[1]);
        }
      }
    }
  }
};

// MoE down, the contributions c_z of the (slot, hidden block) pairs z =
// slot * (H / TH) + block in the JAX order, each a product over the TH
// hidden columns of the block:
//   c_z = p * (act W2) (bf16), p * ((act W2) s2) (W8), p * (acc (sa s2))
//   (S8),
// and their ordered sum out = bf16(((seed + c_0) + c_1) + ...), seeded with
// the residual (or 0). SUM: one tile of out, columns n0 .. n0 + 64 WG, runs
// one pass per z and adds each to an f32 sum held in registers; else a tile
// is one z of one (row, column) tile, written as the f32 partial part[z],
// and moe_sum_elems adds them in a later stage. Both run the same f32
// operations per element in the same order, so they give the same bits;
// the first saves the partials' round trip through memory, the second
// spreads few token rows over more CTAs (the small-tile plan).
// A: act / aq [2, M, H] (3-D map); B: W2 [E, H, D] (bf16 MN-major, W8 raw)
// or the K-major int8 copy [E, D, H] (S8).
template <int WG, int KIND, bool SUM>
struct Down : Shape<WG, 64 * WG, KIND> {
  using Sh = Shape<WG, 64 * WG, KIND>;
  using Acc = typename Sh::Acc;
  using Args = MoeArgs;
  static constexpr bool S8 = Sh::S8, W8 = Sh::W8;
  // staged columns: the int8 weights' s2 of both slots' experts
  static constexpr int kCols = KIND == kBf16 ? 1 : 2 * Sh::kN;
  struct Sum {
    float v[SUM ? Sh::kR : 1];
  };

  __device__ static Tile tile(const MoeArgs& a, int t) {
    return tile_of(a, t, Sh::kBM, Sh::kN);
  }
  __device__ static int passes(const MoeArgs& a) {
    return SUM ? 2 * (a.HH / a.TH) : 1;
  }
  __device__ static int nk(const MoeArgs& a) { return a.TH / (S8 ? 128 : 64); }
  __device__ static int k_of(const MoeArgs& a, int z, int kt) {
    return (z % (a.HH / a.TH)) * a.TH + kt * (S8 ? 128 : 64);
  }
  // f(c, col, k0, ex) for every B box of k-step kt of pass `pass`
  template <class F>
  __device__ static void for_b(const MoeArgs& a, const Tile& tl, int pass,
                               int kt, F f) {
    const int z = SUM ? pass : tl.z;
    const int ex = expert_of(a.idx, a.step, z / (a.HH / a.TH), a.E);
#pragma unroll
    for (int c = 0; c < WG; ++c)
      f(c, tl.n0 + 64 * c, k_of(a, z, kt), a.ex0 + ex);
  }
  __device__ static void load(const CUtensorMap* ta, const CUtensorMap* tb,
                              const MoeArgs& a, const Tile& tl, int pass,
                              int kt, uint32_t st, uint32_t bar) {
    const int z = SUM ? pass : tl.z;
    const int k0 = k_of(a, z, kt), slot = z / (a.HH / a.TH);
#pragma unroll
    for (int w = 0; w < WG; ++w)
      tma_3d(st + w * kBox, ta, bar, k0, tl.m0 + 64 * w, slot);
    for_b(a, tl, pass, kt, [&](int c, int col, int k, int ex) {
      Sh::load_b(tb, st, c, col, k, ex, bar);
    });
  }
  __device__ static void mma(Acc (&d)[Sh::kR], uint32_t st, uint32_t b,
                             int wg) {
    stage_mma<S8, Sh::kN>(d, st + wg * kBox, b);
  }
  // cols[slot * kN + n]: s2 of the slot's expert
  __device__ static Row operands(const MoeArgs& a, const Tile& tl, int wg,
                                 float* cols) {
    if constexpr (KIND != kBf16) {
      const int ex[2] = {expert_of(a.idx, a.step, 0, a.E),
                         expert_of(a.idx, a.step, 1, a.E)};
      stage_cols<kCols>(cols, [&](int i) {
        return a.s_col[(size_t)ex[i / Sh::kN] * a.D + tl.n0 + i % Sh::kN];
      });
    }
    return row_of(tl, wg, a.M, nullptr);
  }
  // int8 products: this pass's row scales sa, loaded under its products
  __device__ static void pass_operands(const MoeArgs& a, const Tile& tl,
                                       int pass, Row& rw) {
    const int z = SUM ? pass : tl.z;
    const int n_h = a.HH / a.TH, slot = z / n_h, kb = z % n_h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rw.r0 + 8 * r;
      rw.s[r] = S8 && row < a.M
                    ? ldf(a.s_row + ((size_t)slot * a.M + row) * n_h + kb)
                    : 0.f;
    }
  }
  __device__ static void seed(Sum& sum, const MoeArgs& a, const Tile& tl,
                              const Row& rw) {
    if constexpr (SUM) {
      const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
      for (int j = 0; j < Sh::kN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rw.r0 + 8 * r, i = 4 * j + 2 * r;
          float2 v = make_float2(0.f, 0.f);
          // through L2 (__ldcg): the megakernel wrote the seed in this launch
          if (a.seed && row < a.M)
            v = __bfloat1622float2(
                __ldcg(reinterpret_cast<const __nv_bfloat162*>(
                    a.seed + (size_t)row * a.D + tl.n0 + c0 + 8 * j)));
          sum.v[i] = v.x;
          sum.v[i + 1] = v.y;
        }
    }
  }
  __device__ static void store(const Acc (&d)[Sh::kR], const MoeArgs& a,
                               const Tile& tl, const Row& rw,
                               const float* cols, int pass, Sum& sum) {
    const int z = SUM ? pass : tl.z, slot = z / (a.HH / a.TH);
    const float p = a.probs[a.step * 2 + slot];
    const float* s2 = cols + slot * Sh::kN;
    const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
    for (int j = 0; j < Sh::kN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float y[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = c0 + 8 * j + c, i = 4 * j + 2 * r + c;
          if constexpr (S8)
            y[c] = __fmul_rn(p, __fmul_rn((float)d[i],
                                          __fmul_rn(rw.s[r], s2[n])));
          else if constexpr (W8)
            y[c] = __fmul_rn(p, __fmul_rn(d[i], s2[n]));
          else
            y[c] = __fmul_rn(p, d[i]);
        }
        const int row = rw.r0 + 8 * r, i = 4 * j + 2 * r;
        if constexpr (SUM) {
          sum.v[i] = __fadd_rn(sum.v[i], y[0]);
          sum.v[i + 1] = __fadd_rn(sum.v[i + 1], y[1]);
        } else if (row < a.M) {
          *reinterpret_cast<float2*>(
              static_cast<float*>(a.out) + ((size_t)z * a.M + row) * a.D +
              tl.n0 + c0 + 8 * j) = make_float2(y[0], y[1]);
        }
      }
  }
  __device__ static void finish(const Sum& sum, const MoeArgs& a,
                                const Tile& tl, const Row& rw) {
    if constexpr (SUM) {
      const int c0 = 2 * (threadIdx.x % 4);
      bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
      for (int j = 0; j < Sh::kN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rw.r0 + 8 * r, i = 4 * j + 2 * r;
          if (row < a.M)
            *reinterpret_cast<__nv_bfloat162*>(
                out + (size_t)row * a.D + tl.n0 + c0 + 8 * j) =
                __floats2bfloat162_rn(sum.v[i], sum.v[i + 1]);
        }
    }
  }
};

// The dense projections of the attention sub-block (QKV and c_proj of
// fused_attn_block, fused_attn_block_q8, both fused_layer_q8c launchers and
// the DiT megakernel): out = A W over M rows, in tiles of 64 WG rows x BN
// columns, W the layer `layer` of a [L, ., .] weight map (L = 1 for one
// layer). Two kinds:
//   bf16 (KIND kBf16): A [M, K] the bf16 rows (h or o); W [K, N] read
//   MN-major as it is stored, one box per 64 output columns; the epilogues
//   of the JAX kernel's cast chain
//     EPI 0 (QKV):    out_f32[r, n]  = acc + bias[n]
//     EPI 1 (c_proj): out_bf16[r, n] = bf16(resid[r, n] + acc)
//   int8 (KIND kS8): A [M, K] the int8 rows (hq or oq) and W [K, N] read
//   from its K-major copy W_t [N, K] (ops/quant.py kmajor_attn), the
//   column scales (and bias) staged in shared memory, the row scales in
//   registers:
//     EPI 0 (QKV):    out_f32[r, n]  = acc * (sa[r] * sb[n]) + bias[n]
//     EPI 1 (c_proj): out_bf16[r, n] = bf16(resid[r, n] + acc * (sa[r] * sb[n]))
struct ProjArgs {
  int M, N, K;                // rows, output columns, contraction
  int n_mt, n_nt, n_tiles;    // tiles over rows, over columns, in all
  int layer;                  // the weight map's outer coordinate
  const float* s_row;         // int8: sa [M], hs or os
  const float* s_col;         // int8: sb [N], wqkv_s or wout_s
  const float* bias;          // EPI 0: bqkv [N]
  const bf16* resid;          // EPI 1: x [M, N]
  void* out;                  // EPI 0: qkv f32 [M, N]; EPI 1: bf16 [M, N]
};

template <int WG, int BN, int EPI, int KIND = kS8>
struct Proj : Shape<WG, BN, KIND> {
  static_assert(KIND != kW8, "the projections have no widened kind");
  using Sh = Shape<WG, BN, KIND>;
  using Acc = typename Sh::Acc;
  using Args = ProjArgs;
  static constexpr bool S8 = Sh::S8;
  // staged columns: int8, sb and (EPI 0) the bias; bf16, (EPI 0) the bias;
  // BN floats each
  static constexpr int kCols =
      S8 ? (EPI == 0 ? 2 : 1) * BN : (EPI == 0 ? BN : 1);
  struct Sum {};

  __device__ static Tile tile(const ProjArgs& a, int t) {
    return tile_of(a, t, Sh::kBM, BN);
  }
  __device__ static int passes(const ProjArgs&) { return 1; }
  __device__ static int nk(const ProjArgs& a) { return a.K / (S8 ? 128 : 64); }
  // f(c, col, k0, layer) for every B box of k-step kt
  template <class F>
  __device__ static void for_b(const ProjArgs& a, const Tile& tl, int, int kt,
                               F f) {
#pragma unroll
    for (int c = 0; c < Sh::kChunks; ++c)
      f(c, tl.n0 + 64 * c, kt * (S8 ? 128 : 64), a.layer);
  }
  __device__ static void load(const CUtensorMap* ta, const CUtensorMap* tb,
                              const ProjArgs& a, const Tile& tl, int z, int kt,
                              uint32_t st, uint32_t bar) {
    const int k0 = kt * (S8 ? 128 : 64);
#pragma unroll
    for (int w = 0; w < WG; ++w)
      tma_2d(st + w * kBox, ta, bar, k0, tl.m0 + 64 * w);
    for_b(a, tl, z, kt, [&](int c, int col, int k, int l) {
      Sh::load_b(tb, st, c, col, k, l, bar);
    });
  }
  __device__ static void mma(Acc (&d)[Sh::kR], uint32_t st, uint32_t b,
                             int wg) {
    stage_mma<S8, BN>(d, st + wg * kBox, b);
  }
  // int8: cols[n] sb, cols[BN + n] the bias (EPI 0); bf16: cols[n] the
  // bias (EPI 0)
  __device__ static Row operands(const ProjArgs& a, const Tile& tl, int wg,
                                 float* cols) {
    const Row rw = row_of(tl, wg, a.M, S8 ? a.s_row : nullptr);
    if constexpr (S8)
      stage_cols<kCols>(cols, [&](int i) {
        return i < BN ? a.s_col[tl.n0 + i] : a.bias[tl.n0 + i - BN];
      });
    else if constexpr (EPI == 0)
      stage_cols<BN>(cols, [&](int i) { return a.bias[tl.n0 + i]; });
    return rw;
  }
  __device__ static void seed(Sum&, const ProjArgs&, const Tile&,
                              const Row&) {}
  __device__ static void pass_operands(const ProjArgs&, const Tile&, int,
                                       Row&) {}
  __device__ static void finish(const Sum&, const ProjArgs&, const Tile&,
                                const Row&) {}
  __device__ static void store(const Acc (&d)[Sh::kR], const ProjArgs& a,
                               const Tile& tl, const Row& rw,
                               const float* cols, int, Sum&) {
    constexpr int kBias = S8 ? BN : 0;   // where the staged bias starts
    const int c0 = 2 * (threadIdx.x % 4);
    // EPI 1: this thread's residual values, loaded together ahead of the
    // stores (a load between two stores waits for its own round trip),
    // through L2 (__ldcg): the megakernel wrote x in this launch
    float2 x[EPI == 1 ? BN / 8 : 1][2];
    if constexpr (EPI == 1) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rw.r0 + 8 * r;
          x[j][r] = row < a.M
                        ? __bfloat1622float2(__ldcg(
                              reinterpret_cast<const __nv_bfloat162*>(
                                  a.resid + (size_t)row * a.N + tl.n0 + c0 +
                                  8 * j)))
                        : make_float2(0.f, 0.f);
        }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rw.r0 + 8 * r;
        if (row >= a.M) continue;
        const size_t at = (size_t)row * a.N + tl.n0 + c0 + 8 * j;
        float y[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = c0 + 8 * j + c, i = 4 * j + 2 * r + c;
          if constexpr (S8)
            y[c] = __fmul_rn((float)d[i], __fmul_rn(rw.s[r], cols[n]));
          else
            y[c] = d[i];
        }
        if constexpr (EPI == 0) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at) =
              make_float2(__fadd_rn(y[0], cols[kBias + c0 + 8 * j]),
                          __fadd_rn(y[1], cols[kBias + c0 + 8 * j + 1]));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + at) =
              __floats2bfloat162_rn(__fadd_rn(x[j][r].x, y[0]),
                                    __fadd_rn(x[j][r].y, y[1]));
        }
      }
  }
};

// ---- the mainloop ---------------------------------------------------------
// A ring of n stages in shared memory, `slot` bytes apart from base (1024-
// aligned), each with a "full" mbarrier (the producer's TMA loads, with
// their byte count) and an "empty" one (one arrival per consumer
// warpgroup once its products have read the stage). Both sides count the
// k-steps they pass through the ring in `it`, which runs on across stages
// (and, in the megakernel, across layers): k-step it uses stage it % n,
// in its (it / n)-th round.
struct Ring {
  uint32_t base, full, empty;   // shared-memory addresses
  int slot, n;                  // bytes between stages, stages
};

// Run by one thread, before any other thread of the CTA touches the ring.
__device__ __forceinline__ void ring_init(const Ring& r, int consumers) {
  for (int s = 0; s < r.n; ++s) {
    mbar_init(r.full + 8 * s, 1);
    mbar_init(r.empty + 8 * s, consumers);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void wg_barrier(int wg) {
  // the 128 threads of consumer warpgroup wg (barrier 0 is __syncthreads)
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The producer of one GEMM stage, run by ONE thread: every load of this
// CTA's tiles t = blockIdx.x, + gridDim.x, ... into the ring.
template <class Op>
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* ta,
                                        const CUtensorMap* tb,
                                        const typename Op::Args& a, int& it) {
  const int nk = Op::nk(a), passes = Op::passes(a);
  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
    const Tile tl = Op::tile(a, t);
    for (int z = 0; z < passes; ++z)
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % r.n;
        if (it >= r.n) mbar_wait(r.empty + 8 * s, ((it / r.n) - 1) & 1);
        mbar_expect_tx(r.full + 8 * s, Op::kStage);
        Op::load(ta, tb, a, tl, z, kt, r.base + s * r.slot, r.full + 8 * s);
      }
  }
}

// The consumers of one GEMM stage, run by every thread of consumer
// warpgroup wg: the same tiles as the producer, its 64 rows of each, each
// tile running Op::passes products of nk k-steps, each followed by
// Op::store; Op::finish ends the tile. cols: the warpgroup's Op::kCols
// staged column operands; wide: the W8 widened copies.
template <class Op>
__device__ __forceinline__ void consume(const Ring& r,
                                        const typename Op::Args& a,
                                        float* cols, uint32_t wide, int wg,
                                        int& it) {
  const int nk = Op::nk(a), passes = Op::passes(a);
  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
    const Tile tl = Op::tile(a, t);
    // the previous tile's epilogue has read cols: stage this tile's
    // operands, whose loads then run under the products
    wg_barrier(wg);
    Row rw = Op::operands(a, tl, wg, cols);
    typename Op::Sum sum;
    Op::seed(sum, a, tl, rw);
    for (int z = 0; z < passes; ++z) {
      Op::pass_operands(a, tl, z, rw);
      typename Op::Acc d[Op::kR];
#pragma unroll
      for (int i = 0; i < Op::kR; ++i) d[i] = 0;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % r.n;
        const uint32_t st = r.base + s * r.slot;
        mbar_wait(r.full + 8 * s, (it / r.n) & 1);
        const uint32_t b = Op::operand_b(st, wide, it);
        fence_acc(d);
        wgmma_fence();
        Op::mma(d, st, b, wg);
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(d);
        // the products of the previous k-step have read their stage
        if (kt > 0 && threadIdx.x % 128 == 0)
          mbar_arrive(r.empty + 8 * ((it - 1) % r.n));
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (threadIdx.x % 128 == 0) mbar_arrive(r.empty + 8 * ((it - 1) % r.n));
      if (z == 0) wg_barrier(wg);   // the staged columns are in place
      Op::store(d, a, tl, rw, cols, z, sum);
    }
    Op::finish(sum, a, tl, rw);
  }
}

// One GEMM stage as a kernel of its own: run by every thread of a CTA of
// 128 * (Op::kWG + 1) threads with Op::kSmem bytes of dynamic shared
// memory; warpgroup Op::kWG produces, the others consume.
template <class Op>
__device__ __forceinline__ void gemm(const CUtensorMap* ta,
                                     const CUtensorMap* tb,
                                     const typename Op::Args& a) {
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t bars[2 * Op::kStages];
  __shared__ float cols[Op::kWG][Op::kCols];
  const Ring r{(smem_u32(wg_smem) + 1023u) & ~1023u, smem_u32(bars),
               smem_u32(bars) + 8 * Op::kStages, Op::kStage, Op::kStages};
  const uint32_t wide = r.base + Op::kStages * Op::kStage;   // W8 only
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) ring_init(r, Op::kWG);
  __syncthreads();
  int it = 0;
  if (wg == Op::kWG) {
    // the producer warpgroup: one thread issues every load
    if constexpr (Op::kWG > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) produce<Op>(r, ta, tb, a, it);
  } else {
    if constexpr (Op::kWG > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<Op>(r, a, cols[wg], wide, wg, it);
  }
}

// ---- host side --------------------------------------------------------------
// cuTensorMapEncodeTiled is a driver function: taken through the runtime's
// entry-point query, so that the libraries need no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Error codes of the launchers beside CUDA's own: no cuTensorMapEncodeTiled
// in the driver, or a tensor it refused.
constexpr int kErrNoEncode = -1;
constexpr int kErrEncode = -2;

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// A map over a row-major tensor of `rank` (2 or 3) dims, innermost first,
// of esz-byte elements (bf16 or int8), in 128-byte-swizzled boxes of 128
// bytes x 64 rows, or (raw) plain boxes of 64 bytes x 64 rows.
inline int encode(CUtensorMap* m, const void* ptr, int esz, int rank,
                  const uint64_t* dims, bool raw) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return kErrNoEncode;
  cuuint64_t gd[3], gs[2];
  cuuint32_t box[3] = {static_cast<cuuint32_t>((raw ? 64 : 128) / esz),
                       kBoxRows, 1};
  cuuint32_t es[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) gd[i] = dims[i];
  gs[0] = dims[0] * esz;
  if (rank == 3) gs[1] = dims[0] * dims[1] * esz;
  const CUresult r = fn(
      m, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      rank, const_cast<void*>(ptr), gd, gs, box, es,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      raw ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// The map of a tensor, encoded at its first use and kept for the next
// launches that pass the same pointer, shape and type: encoding costs host
// time on every launch otherwise, and the weights outlive many launches
// while the activations and scratch come back at the same addresses from
// the caching allocator. A map describes nothing but the memory it names,
// so a kept one is right whenever its key matches.
inline int cached_map(CUtensorMap* out, const void* ptr, int esz, int rank,
                      const uint64_t* dims, bool raw = false) {
  struct Entry {
    const void* ptr;
    uint64_t key[6];
    CUtensorMap map;
  };
  constexpr int kCache = 256;
  static Entry cache[kCache];
  static int used = 0, next = 0;
  static std::mutex mu;
  const uint64_t key[6] = {static_cast<uint64_t>(esz),
                           static_cast<uint64_t>(rank), dims[0], dims[1],
                           rank == 3 ? dims[2] : 1, raw};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].ptr == ptr && std::equal(key, key + 6, cache[i].key)) {
      *out = cache[i].map;
      return 0;
    }
  CUtensorMap m;
  if (const int e = encode(&m, ptr, esz, rank, dims, raw)) return e;
  Entry& slot = cache[used < kCache ? used++ : next++ % kCache];
  slot.ptr = ptr;
  std::copy(key, key + 6, slot.key);
  slot.map = m;
  *out = m;
  return 0;
}

// The map of an expert tensor [E, d1, d0] (raw: plain int8 boxes, for W8).
inline int weight_map(CUtensorMap* out, const void* ptr, int esz,
                      uint64_t d0, uint64_t d1, uint64_t E, bool raw = false) {
  const uint64_t dims[3] = {d0, d1, E};
  return cached_map(out, ptr, esz, 3, dims, raw);
}

// Operands of a stage over M rows with tiles of 64 * wg rows and `bn`
// columns out of n_cols, for nz slots (up: 2), (slot, hidden block) pairs
// (down writing partials: 2 H / TH) or 1 (down summing its passes).
__host__ __device__ inline MoeArgs stage_args(
    const void* idx, const void* probs, int step, int M, int D, int HH,
    int TH, int E, int wg, int bn, int n_cols, int nz, const void* bias,
    const void* s_row, const void* s_col, const void* seed, void* out,
    int ex0 = 0) {
  MoeArgs a;
  a.idx = static_cast<const int*>(idx);
  a.probs = static_cast<const float*>(probs);
  a.step = step;
  a.M = M; a.D = D; a.HH = HH; a.TH = TH; a.E = E;
  a.n_mt = (M + 64 * wg - 1) / (64 * wg);
  a.n_nt = n_cols / bn;
  a.n_tiles = nz * a.n_mt * a.n_nt;
  a.ex0 = ex0;
  a.bias = bias;
  a.s_row = static_cast<const float*>(s_row);
  a.s_col = static_cast<const float*>(s_col);
  a.seed = static_cast<const bf16*>(seed);
  a.out = out;
  return a;
}

// Operands of a projection over M rows in tiles of 64 * wg rows x bn
// columns out of N, from layer `layer` of the weight map.
__host__ __device__ inline ProjArgs proj_args(
    int M, int N, int K, int wg, int bn, const void* s_row,
    const void* s_col, const void* bias, const void* resid, void* out,
    int layer = 0) {
  ProjArgs a;
  a.M = M; a.N = N; a.K = K;
  a.layer = layer;
  a.n_mt = (M + 64 * wg - 1) / (64 * wg);
  a.n_nt = N / bn;
  a.n_tiles = a.n_mt * a.n_nt;
  a.s_row = static_cast<const float*>(s_row);
  a.s_col = static_cast<const float*>(s_col);
  a.bias = static_cast<const float*>(bias);
  a.resid = static_cast<const bf16*>(resid);
  a.out = out;
  return a;
}

// Grant a kernel `bytes` of dynamic shared memory, once per kernel and
// device unless it asks for more later (cudaFuncSetAttribute costs host
// time on every launch otherwise). Keyed by the kernel's own address: the
// static state of an inline function is one object per process (a GNU
// unique symbol), shared by every library of the port that includes this
// header, where the same template instantiated in two libraries is two
// kernels that each need their grant.
inline cudaError_t grant_smem(const void* kernel, int bytes) {
  struct Entry {
    const void* kernel;
    int dev, bytes;
  };
  constexpr int kGrants = 256;
  static Entry done[kGrants];
  static int used = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < used && !(done[i].kernel == kernel && done[i].dev == dev)) ++i;
  if (i < used && done[i].bytes >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && i < kGrants) {
    done[i] = Entry{kernel, dev, bytes};
    if (i == used) ++used;
  }
  return e;
}

// Launch one stage's __global__ wrapper on at most `ctas` persistent CTAs.
template <class Op, typename K>
inline cudaError_t run(K kernel, const CUtensorMap& ta, const CUtensorMap& tb,
                       const typename Op::Args& a, int ctas,
                       cudaStream_t st) {
  const cudaError_t e =
      grant_smem(reinterpret_cast<const void*>(kernel), Op::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<a.n_tiles < ctas ? a.n_tiles : ctas, 128 * (Op::kWG + 1),
           Op::kSmem, st>>>(ta, tb, a);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace mdp
