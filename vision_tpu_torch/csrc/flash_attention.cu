// Fused mask-free attention, softmax(q k^T * scale) v, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _attn_kernel at
// vision_tpu/ops/pallas/flash_attention.py:26 (launched by _flash_attention
// through pl.pallas_call). Same contract: q (BH, Tq, D), k and v (BH, Tk, D),
// contiguous, no mask, non-causal, Tq may differ from Tk; logits and softmax
// statistics in f32, the probabilities rounded to the input type before the
// PV product (the Pallas body casts p to v's dtype), PV accumulated in f32,
// output in the input type. Head dims 32, 64 and 128.
//
// The Pallas kernel keeps a whole K/V row in VMEM. On this card a block has
// 227 KB of shared memory, and the row of a Depth-Anything request at 518x728
// (1925 keys x 64 x 2 B, twice) is 493 KB, so both kernels below tile K/V and
// keep an online softmax instead: a running row max and row sum in f32, the
// f32 output accumulator rescaled whenever the max moves, one division at the
// end. Ragged keys are masked to -inf (a zero logit would join the softmax)
// and their K and V rows read as zeros; ragged q rows are computed on zeros
// and never stored.
//
// What bounds the bf16 kernel on this card: operations. At the Depth-Anything
// shapes (BH 24, D 64, 1370 or 1925 tokens) one call is 11.5 or 22.8 GFLOP
// against 17 or 24 MB of q, k, v and o, ~700 FLOP per byte, far above the
// ~295 at which the tensor cores and not device memory set the pace. Only
// wgmma reaches the tensor cores' rate, and the loads, the softmax and the
// products have to overlap. At D 64 the softmax is as heavy as the products:
// one ex2 and a handful of FP32 operations a logit against 256 tensor-core
// operations, and the SM's ex2 rate is 1/256 of its bf16 rate. The design:
//   * one block per (128-row q tile, b*h): two consumer warpgroups of 64 q
//     rows each and one producer warp that issues every copy;
//   * TMA: the q tile once, then K and V tiles of 128 keys (64 at D 128) into
//     a 4-stage ring, each stage with a "full" mbarrier (the copy's bytes
//     arrived) and an "empty" one (all 8 consumer warps are done with it), so
//     the next tiles arrive while tile j is multiplied. The tensor maps are
//     3-D (D, T, BH), so a ragged last tile is zero-filled by the copy engine
//     and never holds the next head's rows. Rows are 128-byte swizzled at D
//     64 and 128 (two 64-column boxes at D 128), 64-byte at D 32, which keeps
//     wgmma's shared-memory reads free of bank conflicts;
//   * S = Q K^T by wgmma m64nNk16 (N = the tile's keys), Q and K both read
//     from shared memory in their natural K-major layout, so nothing is
//     transposed;
//   * the online softmax runs on S's accumulator fragment in registers (each
//     thread owns 2 rows), in base 2: the max on the raw logits, scaled once
//     a row, and each probability one FFMA (scale * log2(e) and the max
//     folded in) and one ex2;
//   * O += P V by wgmma with A = P in registers (S's accumulator converted to
//     bf16 A fragments without touching shared memory, as FlashAttention-3
//     does) and B = the V tile read as MN-major (the transpose bit): no
//     thread ever transposes V;
//   * the two consumer warpgroups take turns to issue their products, so one
//     warpgroup's softmax overlaps the other's products, and each issues
//     tile j's S with tile j-1's P V, so its own softmax overlaps its P V;
//   * 145 KB of shared memory at D 64 and 141-160 registers a thread: one
//     block of 9 warps an SM. At BH 24 and 1370 / 1925 q rows that is 264 /
//     384 blocks: 2.0 / 2.9 waves over 132 SMs.
// The tensor maps are encoded on the host for each call, through
// cuTensorMapEncodeTiled from cudaGetDriverEntryPointByVersion, so the
// library links no -lcuda.
//
// f32 (the CPU-parity type, off the serving path): plain FMA loops over f32
// tiles in shared memory (4x4 register tiles per thread, 16-byte shared
// loads), bound by shared-memory bandwidth and FMA issue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per block of the f32 kernel
constexpr int BK = 64;  // keys per K/V tile of the f32 kernel

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA kernel
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;                     // q rows per consumer warpgroup
constexpr int CONSUMERS = 2;                    // consumer warpgroups per block
constexpr int Q_ROWS = WG_ROWS * CONSUMERS;     // q rows per block
constexpr int STAGES = 4;                       // depth of the K/V ring
constexpr int TMA_THREADS = CONSUMERS * 128 + 32;  // the consumers and one producer warp

template <int D>
struct Tiles {
  static constexpr int KEYS = D == 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int COLS = D < 64 ? D : 64;      // columns of one TMA box: one swizzle row
  static constexpr int ROW_BYTES = COLS * 2;        // 128 (128-byte swizzle) or 64 (64-byte)
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // wgmma descriptor's swizzle code
  static constexpr int Q_BYTES = Q_ROWS * D * 2;
  static constexpr int KV_BYTES = KEYS * D * 2;     // one K or one V tile
  // 1024 bytes to align the swizzled tiles, the q tile, the ring, the barriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle code in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of the given parity has completed; a wait of more
// than ~2^32 cycles (a copy or an arrival that never comes) traps, so a
// fault ends the launch with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1LL << 32)) __trap();
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// named barriers 1 and 2 (0 is __syncthreads'), over the two consumer warpgroups
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(CONSUMERS * 128) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(CONSUMERS * 128) : "memory");
}

// keep the compiler from moving reads of an accumulator above wgmma_wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one register of two bf16 (round to nearest), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The wgmma shapes the kernel issues. An accumulator of m64nN holds N/2
// floats a thread: float i of warp w, lane l sits at row 16w + l/4 (+8 for
// i % 4 >= 2), column 8(i/4) + 2(l%4) + i%2, as mma.sync's m16n8 C fragment
// repeated over the N/8 column tiles.

// m64n64k16: d = A (64 x 16) * B (16 x 64), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// m64n64k16: d += A (64 x 16) * B (16 x 64), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// m64n128k16: d = A (64 x 16) * B (16 x 128), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// m64n128k16: d += A (64 x 16) * B (16 x 128), both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// m64n32k16: d += A (64 x 16, registers) * B (16 x 32, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// m64n64k16: d += A (64 x 16, registers) * B (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// m64n128k16: d += A (64 x 16, registers) * B (16 x 128, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(TMA_THREADS, 1)
flash_attention_fwd_bf16(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, int tq, int tk,
                         float scale) {
  static_assert(D == 32 || D == 64 || D == 128, "head dim must be 32, 64 or 128");
  using L = Tiles<D>;
  constexpr int KEYS = L::KEYS;
  constexpr int SN = KEYS / 2;         // S accumulator floats a thread
  constexpr int ON = D / 2;            // O accumulator floats a thread
  constexpr int QK_STEPS = D / 16;     // k16 steps of Q K^T
  constexpr int PV_STEPS = KEYS / 16;  // k16 steps of P V
  constexpr int BOX_STEPS = L::COLS / 16;  // k16 steps inside one column box
  constexpr uint32_t ATOM = 8 * L::ROW_BYTES;  // 8 swizzled rows: the descriptors' stride byte offset

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // [box][Q_ROWS][COLS]
  const uint32_t ring = q_s + L::Q_BYTES;  // stage s: K [box][KEYS][COLS], then V alike
  const uint32_t bars = ring + STAGES * 2 * L::KV_BYTES;
  const uint32_t q_full = bars;                      // the q tile arrived
  const uint32_t full0 = bars + 8;                   // full0 + 8s: stage s arrived
  const uint32_t empty0 = bars + 8 * (1 + STAGES);   // empty0 + 8s: stage s consumed

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * Q_ROWS;
  const int bh = blockIdx.y;
  const int n_tiles = (tk + KEYS - 1) / KEYS;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // the producer warp: one lane issues every copy, then the warp is done
    if (tid == CONSUMERS * 128) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int b = 0; b < D / L::COLS; ++b) tma_load(q_s + b * Q_ROWS * L::ROW_BYTES, &q_map, q_full, b * L::COLS, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * s, (j / STAGES - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, 2 * L::KV_BYTES);
        const uint32_t ks = ring + s * 2 * L::KV_BYTES, vs = ks + L::KV_BYTES;
        for (int b = 0; b < D / L::COLS; ++b) {
          tma_load(ks + b * KEYS * L::ROW_BYTES, &k_map, full0 + 8 * s, b * L::COLS, j * KEYS, bh);
          tma_load(vs + b * KEYS * L::ROW_BYTES, &v_map, full0 + 8 * s, b * L::COLS, j * KEYS, bh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: q rows q0 + 64 wg .. + 63; this thread's rows are
  // r0 = 16 warp + lane/4 and r0 + 8 of them
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4;
  const float scale_log2 = scale * 1.4426950408889634f;

  float s_acc[SN];
  float o_acc[ON];
#pragma unroll
  for (int i = 0; i < ON; ++i) o_acc[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running row max, base-2 logits
  float l_run[2] = {0.f, 0.f};  // this thread's share of the running row sum

  const uint32_t q_wg = q_s + wg * WG_ROWS * L::ROW_BYTES;
  // S = Q K^T of tile j: k16 step kk reads 32 bytes into a swizzled row of
  // column box kk / BOX_STEPS of Q and of K
  auto issue_s = [&](int j) {
    const uint32_t ks = ring + (j % STAGES) * 2 * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < QK_STEPS; ++kk) {
      const uint32_t col = (kk % BOX_STEPS) * 32;
      const uint64_t da = smem_desc(q_wg + (kk / BOX_STEPS) * Q_ROWS * L::ROW_BYTES + col, 16, ATOM, L::LAYOUT);
      const uint64_t db = smem_desc(ks + (kk / BOX_STEPS) * KEYS * L::ROW_BYTES + col, 16, ATOM, L::LAYOUT);
      if (kk == 0)
        wgmma_ss_first(s_acc, da, db);
      else
        wgmma_ss(s_acc, da, db);
    }
    wgmma_commit();
  };
  // O += P V of tile j: k16 step kk reads 16 key rows of V as MN-major B;
  // column boxes of V (two at D 128) sit KEYS * ROW_BYTES apart
  auto issue_pv = [&](int j, const uint32_t (&pa)[PV_STEPS][4]) {
    const uint32_t vs = ring + (j % STAGES) * 2 * L::KV_BYTES + L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < PV_STEPS; ++kk)
      wgmma_rs(o_acc, pa[kk], smem_desc(vs + kk * 16 * L::ROW_BYTES, KEYS * L::ROW_BYTES, ATOM, L::LAYOUT));
    wgmma_commit();
  };
  // the online softmax of tile j's S, in place: the running max of the
  // base-2 logits S * scale * log2(e) moved (alpha rescales what came
  // before), S replaced by the unnormalised probabilities exp2(S * scale *
  // log2(e) - max), one FFMA and one ex2 an element: the max is taken on the
  // raw S (the smallest, with a negative scale) and scaled once a row, which
  // saves a multiply an element on the FP32 pipe that the softmax keeps busy.
  // The ragged last tile is scaled first and its keys past Tk set to -inf. A
  // row's keys live on the 4 lanes of one quad.
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int k0 = j * KEYS;
    float mul = scale_log2;  // what turns this tile's S into base-2 logits
    if (k0 + KEYS > tk) {
#pragma unroll
      for (int i = 0; i < SN; ++i)
        s_acc[i] = k0 + (i / 4) * 8 + 2 * t + (i & 1) >= tk ? -CUDART_INF_F : s_acc[i] * scale_log2;
      mul = 1.f;
    }
    float mx[2];
    if (mul >= 0.f) {
      mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < SN; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s_acc[i]);
    } else {
      mx[0] = mx[1] = CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < SN; ++i) mx[(i >> 1) & 1] = fminf(mx[(i >> 1) & 1], s_acc[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] *= mul;
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: every tile holds a live key
      alpha[r] = exp2_approx(m_run[r] - m_new);     // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < SN; ++i) {
      s_acc[i] = exp2_approx(fmaf(s_acc[i], mul, -m_run[(i >> 1) & 1]));
      l_run[(i >> 1) & 1] += s_acc[i];
    }
  };
  // P rounded to bf16 as wgmma A fragments: k16 step kk takes S's column
  // tiles 2kk and 2kk + 1, (row r0, row r0 + 8) each
  auto to_a = [&](uint32_t (&pa)[PV_STEPS][4]) {
#pragma unroll
    for (int n = 0; n < KEYS / 8; ++n) {
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(s_acc[4 * n + 0], s_acc[4 * n + 1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(s_acc[4 * n + 2], s_acc[4 * n + 3]);
    }
  };

  // Two schedules, as FlashAttention-3 has them. Within the warpgroup: tile
  // j's S product is issued together with tile j-1's P V product, tile j's
  // softmax runs while P V is still on the tensor cores, and only once P V
  // has landed are O rescaled and P's registers (P V's input) rewritten.
  // Between the two warpgroups (ping-pong): they take turns to issue their
  // products (named barrier 1 + wg: "my turn"), so one's softmax, which
  // keeps the SM's exponential units busy, overlaps the other's products.
  // Each warpgroup issues n_tiles + 1 times; warpgroup 1 opens the first
  // turn for warpgroup 0 and leaves its own last turn unpassed, so every
  // arrival meets a sync.
  const int other = 1 - wg;
  auto my_turn = [&] { named_sync(1 + wg); };
  auto pass_turn = [&] { named_arrive(1 + other); };
  uint32_t pa[PV_STEPS][4];
  float alpha[2];
  if (wg == 1) pass_turn();
  mbar_wait(q_full, 0);
  mbar_wait(full0, 0);
  my_turn();
  wgmma_fence();
  issue_s(0);
  pass_turn();
  wgmma_wait<0>();
  pin(s_acc);
  softmax(0, alpha);
  to_a(pa);
  for (int j = 1; j < n_tiles; ++j) {
    mbar_wait(full0 + 8 * (j % STAGES), (j / STAGES) & 1);
    my_turn();
    wgmma_fence();
    issue_s(j);
    issue_pv(j - 1, pa);
    pass_turn();
    wgmma_wait<1>();  // S of tile j
    pin(s_acc);
    softmax(j, alpha);
    wgmma_wait<0>();  // P V of tile j - 1
    pin(o_acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * ((j - 1) % STAGES));
#pragma unroll
    for (int i = 0; i < ON; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
    to_a(pa);
  }
  my_turn();
  wgmma_fence();
  issue_pv(n_tiles - 1, pa);
  if (wg == 0) pass_turn();
  wgmma_wait<0>();
  pin(o_acc);

  // divide by the row sum once; rows past Tq are never stored
  __nv_bfloat16* og = o + (size_t)bh * tq * D;
  const int row0 = q0 + wg * WG_ROWS + warp * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row >= tq) continue;
    const float inv = 1.f / l;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(og + (size_t)row * D + n * 8 + 2 * t) =
          pack_bf16(o_acc[4 * n + 2 * r] * inv, o_acc[4 * n + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;  // 16 x 16 threads, each a 4 x 4 tile of S
constexpr int LDT = BQ + 4;       // padded row of the transposed tiles (16-byte aligned)
static_assert(BQ == BK, "the transposed tiles share one padded row length");

template <int D>
constexpr size_t fma_smem_bytes() {
  // qt [D][LDT] + kt [D][LDT] + vs [BK][D] + pt [BK][LDT], f32
  return sizeof(float) * (2 * D * LDT + BK * D + BK * LDT);
}

template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
flash_attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        float* __restrict__ o, int tq, int tk, float scale) {
  static_assert(D % 16 == 0 && D >= 32, "head dim must be 32, 64 or 128");
  constexpr int CPT = D / 16;  // output columns per thread

  extern __shared__ __align__(16) float smem_f32[];
  float* qt = smem_f32;         // [D][LDT]  Q tile, transposed
  float* kt = qt + D * LDT;     // [D][LDT]  K tile, transposed
  float* vs = kt + D * LDT;     // [BK][D]   V tile
  float* pt = vs + BK * D;      // [BK][LDT] P tile, transposed

  const int tid = threadIdx.x;
  const int tx = tid % 16;      // owns keys / output columns
  const int ty = tid / 16;      // owns q rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const float* qg = q + bh * (size_t)tq * D;
  const float* kg = k + bh * (size_t)tk * D;
  const float* vg = v + bh * (size_t)tk * D;
  float* og = o + bh * (size_t)tq * D;

  // the q tile is one contiguous run of BQ*D elements (rows past Tq -> 0)
  for (int i = tid; i < BQ * D; i += FMA_THREADS) {
    const int r = i / D, c = i % D;
    qt[c * LDT + r] = (q0 + r < tq) ? qg[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += FMA_THREADS) {
      const int r = i / D, c = i % D;
      const bool live = k0 + r < tk;
      const size_t gi = (size_t)(k0 + r) * D + c;
      kt[c * LDT + r] = live ? kg[gi] : 0.f;
      vs[r * D + c] = live ? vg[gi] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDT + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * LDT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax; a row's 64 keys live on the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx * 4 + j < tk) ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // finite: every tile holds at least one live key
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - m_new);
        sum += p;
        pt[(tx * 4 + j) * LDT + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete

    // O += P V for rows ty*4+i, columns tx*CPT+c
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + kk * LDT + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[CPT];
      const float* vrow = vs + kk * D + tx * CPT;
      if constexpr (CPT % 4 == 0) {
#pragma unroll
        for (int c = 0; c < CPT; c += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vrow + c);
          vv[c] = t4.x; vv[c + 1] = t4.y; vv[c + 2] = t4.z; vv[c + 3] = t4.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; c += 2) {
          const float2 t2 = *reinterpret_cast<const float2*>(vrow + c);
          vv[c] = t2.x; vv[c + 1] = t2.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= tq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < CPT; ++c) og[(size_t)row * D + tx * CPT + c] = acc[i][c] * inv;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a contiguous (bh, t, d) bf16 tensor read in boxes of `rows` rows by one
// swizzle row (min(d, 64) columns) of one head; rows past t read as zeros
cudaError_t tensor_map(CUtensorMap* map, const void* base, int bh, int t, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int cols = d < 64 ? d : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int tq, int tk, float scale,
                        cudaStream_t stream) {
  using L = Tiles<D>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = tensor_map(&q_map, q, bh, tq, D, Q_ROWS);
  if (err == cudaSuccess) err = tensor_map(&k_map, k, bh, tk, D, L::KEYS);
  if (err == cudaSuccess) err = tensor_map(&v_map, v, bh, tk, D, L::KEYS);
  if (err != cudaSuccess) return err;
  auto kernel = flash_attention_fwd_bf16<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + Q_ROWS - 1) / Q_ROWS, bh);
  kernel<<<grid, TMA_THREADS, L::SMEM, stream>>>(q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), tq, tk,
                                                 scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int tq, int tk, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_attention_fwd_f32<D>;
  constexpr size_t smem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  kernel<<<grid, FMA_THREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                              static_cast<const float*>(v), static_cast<float*>(o), tq, tk, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, void* o, int bh, int tq, int tk,
                     float scale, cudaStream_t stream) {
  return dtype == 0 ? launch_f32<D>(q, k, v, o, bh, tq, tk, scale, stream)
                    : launch_bf16<D>(q, k, v, o, bh, tq, tk, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (bf16 pointers 16-byte aligned). Returns
// the cudaError_t of the launch.
extern "C" int vtt_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int bh, int tq, int tk, int d, int dtype, float scale,
                                       void* stream) {
  if (bh <= 0 || bh > 65535 || tq <= 0 || tk <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_d<32>(dtype, q, k, v, o, bh, tq, tk, scale, s);
    case 64: return (int)launch_d<64>(dtype, q, k, v, o, bh, tq, tk, scale, s);
    case 128: return (int)launch_d<128>(dtype, q, k, v, o, bh, tq, tk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
