// Windowed multi-head attention with a per-head additive bias and an optional
// per-window mask, for Hopper (sm_90a):
//
//   out[w, :, h] = softmax(q[w, :, h] * scale . k[w, :, h]^T + bias[h] + mask[w % nW]) . v[w, :, h]
//
// Replaces the Pallas kernel _kernel at scripts/exp_winattn2.py:19 (launched
// by that script's window_attention through pl.pallas_call), TinyViT's
// window attention in every MobileSAM encoder block; it also serves every
// SWIN block of BiRefNet's encoder. Same contract: q, k, v (NW, T, C)
// contiguous with C = H * hd, hd = 32 and head h in channels [h*hd,
// (h+1)*hd) (no head transposes); bias (H, T, T) shared by all windows, or
// none, read in its own type (f32 or bf16) and added in f32. The mask (nW,
// T, T) is f32, window w reads mask w % nW (windows ordered image-major, as
// SWIN's window_partition orders them), and it may hold -inf (SWIN's
// shifted-window zones), never on a whole row: a query always shares its zone
// with itself. T <= 256. Rounding follows the Pallas body: q * scale in f32,
// rounded to q's type; logits, bias and mask adds and softmax in f32; the
// normalised probabilities rounded to v's type; PV accumulated in f32;
// output in q's type. The spatial padding of window_partition is not masked
// here: those tokens are real (zero-padded, layer-normed) keys in the model.
//
// What bounds it on this card: bytes. A (window, head) problem at SWIN-L's
// T 144 reads q, k, v and writes o, 37 KB, for 2.7 MFLOP (72 FLOP per byte,
// a quarter of the ~295 at which the tensor cores would set the pace). Its
// logits also need T x T bias and mask values, 124 KB per problem if each is
// read per logit: more than the problem's own bytes. The bf16 design:
//   * a block takes one mask class (the windows w = m mod nW: the same window
//     position in every image of the batch), or with no mask a run of
//     consecutive windows, times a group of heads. It stages the class's mask
//     (T x T f32) once and each of its heads' biases (T x T in their own
//     type) once in shared memory, rows padded so that the 8-byte reads in
//     the accumulator layout hit distinct banks; every (window, head)
//     problem of the block then reads them from there. The launch plan
//     (plan() below, mirrored by window_plan in ops/cuda/window_attention.py)
//     picks the largest head group that fits 227 KB and splits head groups,
//     then windows, until the grid fills two waves of the card. Where even
//     one head's bias and the mask do not fit (T near 256), a second instance
//     reads them from L2 in the accumulator layout, 8-byte pairs where
//     aligned;
//   * one warp per 16-row tile of the problem (9 warps at T 144, 4 at T 49,
//     13 at T 196), each against all keys at once, so no warp waits on an
//     uneven split; T rounds up to the 16-row tile, keys >= T are masked to
//     -inf and their K and V rows are zeros, rows >= T are computed on zeros
//     and never stored;
//   * the next problem's q, k and v are loaded with cp.async (16 bytes a
//     thread) into a double buffer while this one computes; rows are 64
//     bytes with their 16-byte chunks XOR-swizzled, so the fragments come
//     through ldmatrix without bank conflicts: Q's and K's as stored, V's
//     through ldmatrix.trans, so no thread writes a transposed element;
//   * mma.sync m16n8k16 with f32 accumulators (wgmma's 64-row tiles would
//     pad T 144 to 192); S stays in registers, and up to T 144 (9 key tiles)
//     the softmax takes one pass over it. Above that the keys go in two
//     chunks and two passes (max and sum, then the normalised P), which keeps
//     S's registers to one chunk and the rounding of P as above;
//   * at most 128 registers a thread wherever two or more blocks fit an SM
//     (__launch_bounds__ asks for them), so that the warps in flight are not
//     capped by registers: at T 49, 4 blocks of 4 warps an SM. At T 144 the
//     staged mask, biases and double buffer (230 KB) hold an SM to one block
//     of 9 warps, and its registers are left uncapped.
//
// f32 (the CPU-parity type, off the serving path): one thread per q row, FMA
// loops over K and V in shared memory with an online softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // threads of the f32 kernel's blocks
constexpr int HEAD_DIM = 32;        // head dim of every TinyViT and SWIN stage

__device__ __forceinline__ float load_bias(const void* bias, int bias_dtype, size_t i) {
  return bias_dtype == 1 ? static_cast<const float*>(bias)[i]
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[i]);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may use
constexpr int SMEM_PER_SM = 233472;  // shared memory of an SM (each block also takes 1 KB)
constexpr int SMS = 132;             // SMs of an H100 SXM
constexpr int MAX_REGS = 128;        // registers a thread of the bf16 kernel may use
constexpr int ROW = HEAD_DIM * 2;          // bytes of one q, k or v row of a head

// smallest row length >= t with length % 16 == 8: 8-byte reads of the
// accumulator layout (8 rows x 4 column pairs a warp) then hit distinct banks
__host__ __device__ constexpr int padded(int t) { return t + (24 - t % 16) % 16; }

constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// the blocks of 32 * tiles threads whose registers an SM holds at MAX_REGS a
// thread: the kernel is compiled to let that many in (at most 128 registers
// a thread where two or more fit; where only one does, as many as it needs)
constexpr int min_blocks(int tiles) {
  return 65536 / (32 * tiles * MAX_REGS) > 1 ? 65536 / (32 * tiles * MAX_REGS) : 1;
}

// key tiles of the instance that serves T (warps of its blocks, one per 16-row tile)
constexpr int instance_tiles(int t) {
  const int n = (t + 15) / 16;
  return n <= 4 ? n : n <= 7 ? 7 : n <= 9 ? 9 : n <= 13 ? 13 : 16;
}

struct Plan {
  int classes;      // mask classes (nW), or 1 without a mask
  int run;          // windows of a class per block
  int runs;         // blocks along a class: ceil(NW / classes / run)
  int heads;        // heads per block
  int groups;       // head groups: H / heads
  int threads;      // 32 per 16-row tile
  int smem;         // dynamic shared memory bytes
  bool staged;      // mask and biases in shared memory (else read from L2)
  long long blocks;
};

// the launch plan; window_plan in ops/cuda/window_attention.py is its mirror
Plan plan(int nw, int t, int n_heads, int n_wmask, int bias_bytes) {
  Plan p{};
  const int tiles = instance_tiles(t);
  const int qkv = 2 * 3 * 16 * tiles * ROW;  // q, k, v double-buffered
  const int mask = n_wmask > 0 ? align16(t * padded(t) * 4) : 0;
  const int bias = align16(t * padded(t) * bias_bytes);
  auto smem = [&](int heads, bool staged) { return staged ? mask + heads * bias + qkv : qkv; };
  p.classes = n_wmask > 0 ? n_wmask : 1;
  p.threads = 32 * tiles;
  p.staged = smem(1, true) <= SMEM_MAX;
  p.heads = n_heads;
  while (smem(p.heads, p.staged) > SMEM_MAX || n_heads % p.heads) --p.heads;
  const int per_class = nw / p.classes;
  p.run = per_class;
  for (;;) {
    p.smem = smem(p.heads, p.staged);
    p.groups = n_heads / p.heads;
    p.runs = (per_class + p.run - 1) / p.run;
    p.blocks = (long long)p.classes * p.runs * p.groups;
    int per_sm = SMEM_PER_SM / (p.smem + 1024);
    per_sm = per_sm < 2048 / p.threads ? per_sm : 2048 / p.threads;
    per_sm = per_sm < 65536 / (p.threads * MAX_REGS) ? per_sm : 65536 / (p.threads * MAX_REGS);
    if (p.blocks >= 2LL * SMS * per_sm) break;
    if (p.heads > 1) {
      do --p.heads; while (n_heads % p.heads);
    } else if (p.run > 1) {
      p.run = (p.run + 1) / 2;
    } else {
      break;
    }
  }
  return p;
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from global memory, or 16 zero bytes when !live
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two f32 -> one register of two bf16 (round to nearest), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c (0-3) of row r in a swizzled 64-byte-row tile
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * ROW + ((c ^ ((r >> 1) & 3)) << 4); }

// Element (r, c) of the t x t row-major matrix `src` to shared memory at
// dst + (r * ld + c) * sizeof(E), one row per warp at a time. Every copy is in
// flight at once: cp.async in 16-byte chunks where rows are whole chunks,
// else in 4-byte units where those are aligned (f32, or bf16 at even t);
// else (bf16 at odd t) plain loads, ROWS rows of up to COLS * 32 elements a
// warp per batch. The cp.async copies join the caller's next commit group.
template <typename E, int COLS>
__device__ __forceinline__ void stage(uint32_t dst, int ld, const E* src, int t, int warp, int lane, int n_warps) {
  const int row_bytes = t * (int)sizeof(E);
  const char* bytes = reinterpret_cast<const char*>(src);
  if (row_bytes % 16 == 0) {
    for (int r = warp; r < t; r += n_warps)
      for (int ch = lane; ch < row_bytes / 16; ch += 32)
        cp_async16(dst + r * ld * (int)sizeof(E) + ch * 16, bytes + (size_t)r * row_bytes + ch * 16, true);
  } else if (sizeof(E) == 4 || t % 2 == 0) {
    for (int r = warp; r < t; r += n_warps)
      for (int u = lane; u < row_bytes / 4; u += 32)
        cp_async4(dst + r * ld * (int)sizeof(E) + u * 4, bytes + (size_t)r * row_bytes + u * 4);
  } else if constexpr (sizeof(E) == 2) {
    constexpr int ROWS = 16 / COLS > 0 ? 16 / COLS : 1;
    for (int r0 = warp; r0 < t; r0 += ROWS * n_warps) {
      E vals[ROWS][COLS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int r = r0 + u * n_warps, c = lane + 32 * j;
          if (r < t && c < t) vals[u][j] = src[(size_t)r * t + c];
        }
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int r = r0 + u * n_warps, c = lane + 32 * j;
          if (r < t && c < t)
            asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst + (r * ld + c) * 2),
                         "h"(*reinterpret_cast<const unsigned short*>(&vals[u][j]))
                         : "memory");
        }
    }
  }
}

// a pair of neighbouring values of a T x T matrix row in its own type, as f32
__device__ __forceinline__ float2 pair_f32(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// NKT: 16-key tiles covering T, and as many warps, one per 16-row tile.
// STAGED: the class's mask and the block's biases in shared memory; else
// both are read from L2. Block b takes head group b % groups and, of mask
// class b / groups / runs, the windows m + classes * i for i in
// [i0, i0 + run) with i0 = (b / groups) % runs * run and i < per_class: each
// window with each of heads h0 .. h0 + heads - 1.
template <int NKT, bool STAGED>
__global__ void __launch_bounds__(32 * NKT, min_blocks(NKT))
window_attention_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const void* __restrict__ bias, int bias_dtype,
                      const float* __restrict__ wmask, __nv_bfloat16* __restrict__ o, int t, int n_heads,
                      float scale, int classes, int per_class, int run, int runs, int heads) {
  constexpr int TP = 16 * NKT;               // rows and keys, padded to the tile
  constexpr int THREADS_B = 32 * NKT;
  constexpr int TILE = TP * ROW;             // bytes of one q, k or v tile
  constexpr int NCH = (NKT + 8) / 9;         // key chunks of at most 9 tiles
  constexpr int KC = (NKT + NCH - 1) / NCH;  // key tiles per chunk
  constexpr float LOG2E = 1.4426950408889634f;

  extern __shared__ __align__(16) uint8_t smem[];
  const int ld = padded(t);
  const int mask_bytes = wmask != nullptr ? (t * ld * 4 + 15) / 16 * 16 : 0;
  const int bias_bytes = bias_dtype != 0 ? (t * ld * (bias_dtype == 1 ? 4 : 2) + 15) / 16 * 16 : 0;
  float* mask_s = reinterpret_cast<float*>(smem);  // STAGED: [t][ld]
  uint8_t* bias_s = smem + mask_bytes;             // STAGED: heads x [t][ld] in the bias type
  // buffer b holds the q, k and v tiles at qkv + (3b + x) * TILE, rows swizzled
  const uint32_t qkv = smem_u32(smem + (STAGED ? mask_bytes + heads * bias_bytes : 0));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int groups = n_heads / heads;
  const int h0 = blockIdx.x % groups * heads;
  const int i0 = blockIdx.x / groups % runs * run;
  const int m = blockIdx.x / groups / runs;  // the mask class
  const int n_prob = min(run, per_class - i0) * heads;
  const int c = n_heads * HEAD_DIM;
  const float* mask_g = wmask != nullptr ? wmask + (size_t)m * t * t : nullptr;

  // problem p: window m + classes * (i0 + p / heads), head h0 + p % heads
  auto problem_base = [&](int p) {
    return (size_t)(m + classes * (i0 + p / heads)) * t * c + (size_t)(h0 + p % heads) * HEAD_DIM;
  };
  // q, k and v of problem p into buffer b: 16 bytes a thread, rows >= t zeros
  auto load = [&](int p, int b) {
    const size_t base = problem_base(p);
#pragma unroll
    for (int j = 0; j < 6; ++j) {  // 3 tiles x TP rows x 4 chunks over 32 NKT threads
      const int i = tid + j * THREADS_B;
      const int x = i / (TP * 4), r = i / 4 % TP, ch = i % 4;
      const __nv_bfloat16* src = x == 0 ? q : x == 1 ? k : v;
      const bool live = r < t;
      cp_async16(qkv + (3 * b + x) * TILE + swz(r, ch), live ? src + base + (size_t)r * c + ch * 8 : src, live);
    }
    cp_async_commit();
  };

  load(0, 0);
  if (STAGED) {  // meanwhile: the class's mask and the block's biases, once
    constexpr int COLS = (TP + 31) / 32;
    if (mask_g != nullptr) stage<float, COLS>(smem_u32(mask_s), ld, mask_g, t, warp, lane, NKT);
    for (int hl = 0; hl < (bias_dtype != 0 ? heads : 0); ++hl) {
      const uint32_t dst = smem_u32(bias_s + hl * bias_bytes);
      if (bias_dtype == 1)
        stage<float, COLS>(dst, ld, static_cast<const float*>(bias) + (size_t)(h0 + hl) * t * t, t, warp, lane, NKT);
      else
        stage<__nv_bfloat16, COLS>(dst, ld, static_cast<const __nv_bfloat16*>(bias) + (size_t)(h0 + hl) * t * t, t,
                                   warp, lane, NKT);
    }
    cp_async_commit();
  }

  const int row0 = warp * 16 + g, row1 = row0 + 8;  // this thread's two rows
  for (int p = 0; p < n_prob; ++p) {
    if (p + 1 < n_prob) {
      load(p + 1, (p + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // problem p's tiles (and the staged mask and biases) are in

    const int hl = p % heads;
    const uint32_t qs = qkv + 3 * (p & 1) * TILE, ks = qs + TILE, vs = ks + TILE;

    // this warp's 16 q rows, scaled in f32 and rounded, as A fragments
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldmatrix_x4(qa[kk], qs + swz(warp * 16 + lane % 16, 2 * kk + lane / 16));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][e]));
        qa[kk][e] = pack_bf16(f.x * scale, f.y * scale);
      }
    }

    // the logits of key chunk cc: Q K^T, + bias, + mask, keys >= t to -inf.
    // Staged, a thread reads its two rows' bias and mask pairs from shared
    // memory; rows >= t read row 0's (their logits are never stored).
    auto logits = [&](int cc, float (&s)[2 * KC][4]) {
#pragma unroll
      for (int j = 0; j < 2 * KC; ++j) {
        const int tile8 = cc * 2 * KC + j;  // 8-key tile
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        if (tile8 >= 2 * NKT) continue;
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + swz(tile8 * 8 + lane % 8, lane / 8));
        mma_bf16(s[j], qa[0], kb[0], kb[1]);
        mma_bf16(s[j], qa[1], kb[2], kb[3]);
      }
      const int key0 = cc * 2 * KC * 8 + 2 * tq;  // key of s[0][0]; s[j][e] holds key0 + 8j + e % 2
      if (STAGED) {
        const int at0 = (row0 < t ? row0 : 0) * ld + key0, at1 = (row1 < t ? row1 : 0) * ld + key0;
        if (bias_dtype == 1) {
          const float* bs = reinterpret_cast<const float*>(bias_s + hl * bias_bytes);
#pragma unroll
          for (int j = 0; j < 2 * KC; ++j) {
            const float2 b0 = pair_f32(bs + at0 + 8 * j), b1 = pair_f32(bs + at1 + 8 * j);
            s[j][0] += b0.x, s[j][1] += b0.y, s[j][2] += b1.x, s[j][3] += b1.y;
          }
        } else if (bias_dtype == 2) {
          const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(bias_s + hl * bias_bytes);
#pragma unroll
          for (int j = 0; j < 2 * KC; ++j) {
            const float2 b0 = pair_f32(bs + at0 + 8 * j), b1 = pair_f32(bs + at1 + 8 * j);
            s[j][0] += b0.x, s[j][1] += b0.y, s[j][2] += b1.x, s[j][3] += b1.y;
          }
        }
        if (mask_g != nullptr) {
#pragma unroll
          for (int j = 0; j < 2 * KC; ++j) {
            const float2 m0 = pair_f32(mask_s + at0 + 8 * j), m1 = pair_f32(mask_s + at1 + 8 * j);
            s[j][0] += m0.x, s[j][1] += m0.y, s[j][2] += m1.x, s[j][3] += m1.y;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2 * KC; ++j) {
          const int key = key0 + 8 * j;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r == 0 ? row0 : row1;
            if (row >= t || key >= t) continue;
            const size_t at = (size_t)row * t + key, bh = (size_t)(h0 + hl) * t * t;
            const bool pair = (t & 1) == 0;  // then `at` is even: an aligned pair
            float2 b = make_float2(0.f, 0.f), mk = make_float2(0.f, 0.f);
            if (bias_dtype == 1) {
              const float* bp = static_cast<const float*>(bias) + bh + at;
              b = pair ? pair_f32(bp) : make_float2(bp[0], key + 1 < t ? bp[1] : 0.f);
            }
            if (bias_dtype == 2) {
              const __nv_bfloat16* bp = static_cast<const __nv_bfloat16*>(bias) + bh + at;
              b = pair ? pair_f32(bp)
                       : make_float2(__bfloat162float(bp[0]), key + 1 < t ? __bfloat162float(bp[1]) : 0.f);
            }
            if (mask_g != nullptr)
              mk = pair ? pair_f32(mask_g + at) : make_float2(mask_g[at], key + 1 < t ? mask_g[at + 1] : 0.f);
            s[j][2 * r] = (s[j][2 * r] + b.x) + mk.x;
            s[j][2 * r + 1] = (s[j][2 * r + 1] + b.y) + mk.y;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * KC; ++j) {
        if (key0 - 2 * tq + 8 * j + 8 <= t) continue;  // every key of this tile is < t
        const int key = key0 + 8 * j;
        if (key >= t) s[j][0] = s[j][2] = -CUDART_INF_F;
        if (key + 1 >= t) s[j][1] = s[j][3] = -CUDART_INF_F;
      }
    };

    // row max and row sum; a row's keys live on the 4 lanes of one quad.
    // A live row keeps its own key, a padded row (>= t) key 0: both finite.
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.f, 0.f};
    float s[2 * KC][4];
    if (NCH == 1) {
      logits(0, s);
#pragma unroll
      for (int j = 0; j < 2 * KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      const float ml[2] = {mx[0] * LOG2E, mx[1] * LOG2E};
#pragma unroll
      for (int j = 0; j < 2 * KC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2_approx(fmaf(s[j][e], LOG2E, -ml[e >> 1]));
          sum[e >> 1] += s[j][e];
        }
    } else {  // first pass: the running max and sum over the chunks
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) {
        logits(cc, s);
        float cm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < 2 * KC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], s[j][e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
          cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
          const float m_new = fmaxf(mx[r], cm[r]);
          // a chunk may hold only masked keys of a row: -inf - -inf is NaN
          const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
          sum[r] *= exp2_approx((mx[r] - m_use) * LOG2E);
          mx[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 2 * KC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float m_use = mx[e >> 1] == -CUDART_INF_F ? 0.f : mx[e >> 1];
            sum[e >> 1] += exp2_approx((s[j][e] - m_use) * LOG2E);
          }
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      inv[r] = 1.f / sum[r];
    }

    // O = P V, P the normalised probabilities rounded to bf16; V's B
    // fragments through ldmatrix.trans (keys 16 kt + 0..15, dims 16 np + 0..15)
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      if (NCH > 1) {  // second pass: the chunk's logits again, as probabilities
        logits(cc, s);
#pragma unroll
        for (int j = 0; j < 2 * KC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = exp2_approx((s[j][e] - mx[e >> 1]) * LOG2E);
      }
      uint32_t pa[KC][4];
#pragma unroll
      for (int j = 0; j < 2 * KC; ++j) {
        pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(s[j][0] * inv[0], s[j][1] * inv[0]);  // row g
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[j][2] * inv[1], s[j][3] * inv[1]);  // row g + 8
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const int kt = cc * KC + kk;
        if (kt >= NKT) continue;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + swz(kt * 16 + (lane / 8 & 1) * 8 + lane % 8, 2 * np + lane / 16));
          mma_bf16(acc[2 * np], pa[kk], vb[0], vb[1]);
          mma_bf16(acc[2 * np + 1], pa[kk], vb[2], vb[3]);
        }
      }
    }

    // stored for live rows only
    __nv_bfloat16* ob = o + problem_base(p);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = n * 8 + 2 * tq;
      if (row0 < t) *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * c + col) = pack_bf16(acc[n][0], acc[n][1]);
      if (row1 < t) *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * c + col) = pack_bf16(acc[n][2], acc[n][3]);
    }
    __syncthreads();  // buffer p & 1 is free for problem p + 2
  }
}

// ---------------------------------------------------------------------------
// f32: FMA kernel, one thread per q row
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS)
window_attention_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const void* __restrict__ bias, int bias_dtype, const float* __restrict__ wmask,
                     int n_wmask, float* __restrict__ o, int t, int n_heads, float scale) {
  extern __shared__ __align__(16) float smem_f32[];
  float* ks = smem_f32;      // [t][HD]
  float* vs = ks + t * HD;   // [t][HD]

  const int head = blockIdx.x % n_heads;
  const size_t win = blockIdx.x / n_heads;
  const int c = n_heads * HD;
  const size_t base = win * (size_t)t * c + (size_t)head * HD;

  for (int i = threadIdx.x; i < t * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    ks[i] = k[base + (size_t)r * c + d];
    vs[i] = v[base + (size_t)r * c + d];
  }
  __syncthreads();

  const size_t bias_head = (size_t)head * t * t;
  const float* mask_win = wmask == nullptr ? nullptr : wmask + (win % n_wmask) * (size_t)t * t;
  for (int row = threadIdx.x; row < t; row += THREADS) {
    float qr[HD], acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = q[base + (size_t)row * c + d] * scale;
      acc[d] = 0.f;
    }
    float m = -CUDART_INF_F, l = 0.f;
    for (int j = 0; j < t; ++j) {
      const float* kj = ks + j * HD;  // every lane reads the same key: a broadcast
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) sc = fmaf(qr[d], kj[d], sc);
      if (bias_dtype != 0) sc += load_bias(bias, bias_dtype, bias_head + (size_t)row * t + j);
      if (mask_win != nullptr) sc += mask_win[(size_t)row * t + j];
      if (sc == -CUDART_INF_F) continue;  // a masked key: p = 0 (and -inf - -inf would be NaN)
      const float m_new = fmaxf(m, sc);
      const float alpha = expf(m - m_new);  // 0 on the first key
      const float p = expf(sc - m_new);
      l = l * alpha + p;
      const float* vj = vs + j * HD;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vj[d], acc[d] * alpha);
      m = m_new;
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[base + (size_t)row * c + d] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  int bias_dtype;
  const float* wmask;
  int n_wmask;
  void* o;
  int nw, t, n_heads;
  float scale;
  cudaStream_t stream;
};

int bias_size(int bias_dtype) { return bias_dtype == 0 ? 0 : bias_dtype == 1 ? 4 : 2; }

template <int NKT, bool STAGED>
cudaError_t launch_bf16(const Args& a, const Plan& p) {
  auto kernel = window_attention_bf16<NKT, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)p.blocks, p.threads, p.smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.bias, a.bias_dtype, a.wmask, static_cast<__nv_bfloat16*>(a.o), a.t,
      a.n_heads, a.scale, p.classes, a.nw / p.classes, p.run, p.runs, p.heads);
  return cudaGetLastError();
}

cudaError_t launch_bf16_t(const Args& a) {
  const Plan p = plan(a.nw, a.t, a.n_heads, a.n_wmask, bias_size(a.bias_dtype));
  switch (instance_tiles(a.t)) {
    case 1: return launch_bf16<1, true>(a, p);
    case 2: return launch_bf16<2, true>(a, p);
    case 3: return launch_bf16<3, true>(a, p);
    case 4: return launch_bf16<4, true>(a, p);  // TinyViT, SWIN-T: T = 49
    case 7: return launch_bf16<7, true>(a, p);
    case 9: return launch_bf16<9, true>(a, p);  // SWIN-L: T = 144
    case 13: return p.staged ? launch_bf16<13, true>(a, p) : launch_bf16<13, false>(a, p);  // TinyViT: T = 196
    default: return p.staged ? launch_bf16<16, true>(a, p) : launch_bf16<16, false>(a, p);
  }
}

template <int HD_>
cudaError_t launch_f32(const Args& a) {
  const size_t smem = sizeof(float) * 2 * (size_t)a.t * HD_;
  auto kernel = window_attention_f32<HD_>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.nw * a.n_heads, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v), a.bias,
      a.bias_dtype, a.wmask, a.n_wmask, static_cast<float*>(a.o), a.t, a.n_heads, a.scale);
  return cudaGetLastError();
}

bool valid(int nw, int t, int n_heads, int n_wmask, int bias_dtype) {
  return nw > 0 && t > 0 && t <= 256 && n_heads > 0 && (long long)nw * n_heads < (1LL << 31) && bias_dtype >= 0 &&
         bias_dtype <= 2 && n_wmask >= 0 && (n_wmask == 0 || nw % n_wmask == 0);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; bias_dtype: 0 = no bias, 1 = float32,
// 2 = bfloat16. q, k, v, o: (nw, t, n_heads * hd), 16-byte aligned; bias:
// (n_heads, t, t); wmask: (n_wmask, t, t) float32 with nw % n_wmask == 0, or
// null with n_wmask = 0. Returns the cudaError_t of the launch.
extern "C" int vtt_window_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                        const void* wmask, int n_wmask, void* o, int nw, int t, int n_heads, int hd,
                                        int dtype, int bias_dtype, float scale, void* stream) {
  if (!valid(nw, t, n_heads, n_wmask, bias_dtype) || (dtype != 0 && dtype != 1) ||
      (bias_dtype != 0 && bias == nullptr) || (n_wmask == 0) != (wmask == nullptr) || hd != HEAD_DIM)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, bias, bias_dtype, static_cast<const float*>(wmask), n_wmask, o, nw, t, n_heads, scale,
               static_cast<cudaStream_t>(stream)};
  return (int)(dtype == 0 ? launch_f32<HEAD_DIM>(a) : launch_bf16_t(a));
}

// The bf16 launch plan for these arguments, as six integers: blocks, threads
// a block, dynamic shared memory bytes, heads a block, windows a block (of
// one mask class), and 1 when the mask and biases are staged in shared
// memory. Returns 0, or cudaErrorInvalidValue for arguments the kernel
// refuses.
extern "C" int vtt_window_attention_plan(int nw, int t, int n_heads, int n_wmask, int bias_dtype, long long* out) {
  if (!valid(nw, t, n_heads, n_wmask, bias_dtype)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(nw, t, n_heads, n_wmask, bias_size(bias_dtype));
  const long long fields[6] = {p.blocks, p.threads, p.smem, p.heads, p.run, p.staged ? 1 : 0};
  for (int i = 0; i < 6; ++i) out[i] = fields[i];
  return 0;
}
