// Fused deformable convolution v2 for Hopper (sm_90a): the bilinear samples,
// the product with the weight and the epilogue in one kernel,
//
//   acc[p, co] = sum over taps t = ky * kw + kx and channels c of
//                mask[p, t] * bilinear(x[b, :, :, c], py, px) * w[co, c, ky, kx]
//   py = oy * stride - pad + ky + off[p, 2t],  px = ox * stride - pad + kx + off[p, 2t + 1]
//   out[p, co] = act(scale[co] * (acc[p, co] + bias[co]) + shift[co])
//
// zero outside the image, with the offsets first clamped to [-bound, bound]
// when a bound is given; act is ReLU or the identity; bias, scale and shift
// are optional (f32 or bf16, read as f32). x is NHWC (B, H, W, Cin), bf16 or f32; the offsets
// (B, Ho, Wo, 2 kh kw) are tap-major (dy, dx) pairs and the mask (B, Ho, Wo,
// kh kw) is optional, each f32 or bf16 and read as f32; out is a channel
// view of an NHWC buffer (pixel stride o_ps >= Cout) in x's type.
//
// Replaces the Pallas bodies of the bounded-offset deformable conv probes,
// scripts/exp_deform_pallas.py (make_kernel's kernel), exp_deform_pallas2.py
// (d0..d4), exp_deform_pallas3.py (unrolled, into_ref, fori,
// dy_fori_dx_static), exp_deform_pallas4.py (r25, s25r) and
// exp_deform_pallas5.py (roll25, hyb): the tent-weighted 25-window MAC of
// deform_conv_2d_shift (vision_tpu/ops/deform.py:45), of which at most 4
// coefficients are nonzero, the bilinear corners that this kernel evaluates;
// with no bound it is deform_conv_2d (vision_tpu/ops/deform.py:118). The JAX
// package multiplies the sampled columns by the weight with jnp.matmul
// outside any Pallas kernel; here the product is inside, because writing the
// columns to device memory and reading them back is most of the cost of the
// unfused route (csrc/deform_sample.cu, then torch.matmul): at BiRefNet's
// k = 7 conv at 256^2, Cin 112, 49 x 112 bf16 a pixel, 2.9 GB a batch of 4.
//
// What bounds it on this card: operations. A batch-4 1024^2 forward's 20
// convs blend 2.4e9 column elements at 7 f32 FLOPs each (the mask folded
// into the corner weights once per (pixel, tap), then a product and three
// FMAs: 0.25 ms at 67 TFLOP/s) and multiply them by the weight (0.15
// TFLOP, 0.15 ms on the tensor cores); x, the offsets, the mask and the
// outputs are ~0.3 GB (0.09 ms). Blending after the product (each input
// pixel times each tap's weight, then a blend of Cout = 28 results instead
// of Cin = 112 channels) would do fewer operations; this kernel blends
// first. The columns never reach device memory. What costs in practice is the
// blend's gather of 4 corner rows of Cin channels per (pixel, tap) through
// L1, and how its loads fall on L1's wavefronts: a warp's 16-byte loads that
// touch 16 pixels' rows take 16 wavefronts each, where 512 bytes need 4.
// The design, bf16:
//   * one CTA (one warpgroup, 128 threads) per 8 x 8 output pixels of one
//     image and one tile of BN output channels (BN 32, or 64 tiles past 32
//     channels): neighbouring pixels' corner rows meet in L1;
//   * per tap, 64 threads compute each pixel's four corner indices and four
//     weights (times the mask) once, into shared memory one tap ahead;
//   * the blend: each warp takes 16 of the pixels, two (or four, at Cin <=
//     64) at a time, its lanes on consecutive 8-channel chunks of one pixel,
//     so each 16-byte corner load reads whole rows (two pixels' 224 bytes at
//     Cin 112: 4-6 wavefronts); the four corner rows are blended in f32
//     (corner order 00, 01, 10, 11, times the mask);
//   * the tap's A tile (64 pixels x Cin rounded up to 64) goes to shared
//     memory in wgmma's K-major 128-byte-swizzled layout (64-channel boxes of
//     128-byte rows, chunk c of row r at c ^ (r % 8)), so a pixel's 16-byte
//     chunks fill all 32 banks; beside it the tap's weight slice (BN x Cin,
//     no swizzle, from a (kh kw, N, K) copy made by the wrapper's
//     weight_layout, once by the model) by cp.async;
//   * precision: the column is split into a bf16 pair hi = bf16(v), lo =
//     bf16(v - hi), and two wgmma m64nBNk16 per k step add hi * w and lo * w
//     into one f32 accumulator, so the product sees the column to ~16 bits,
//     as the JAX exact form's f32 product does, and the output is rounded
//     once (the weight is bf16, exact in both);
//   * the accumulators live across all kh kw taps;
//   * the epilogue on the accumulator fragments: bias, scale, shift, ReLU in
//     f32, one rounding, stores into the channel view (4-byte pairs where
//     alignment allows), 64-bit offsets.
// f32 (the CPU-parity type, off the serving path): CUDA-core FMA over the
// same samples, 32 channels a step through shared memory, 32 output
// channels a CTA. Index arithmetic over rows is 32-bit (the wrapper keeps B
// Ho Wo kh kw < 2^31); every memory offset is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 8, TP = TH * TW;  // output tile: 8 x 8 pixels
constexpr int THREADS = 128;                  // the bf16 kernel: one warpgroup
constexpr int SMEM_CAP = 232448;              // a block's shared memory on Hopper
constexpr int BOX = 64;                       // channels of one 128-byte swizzled row of A

struct Args {
  const void* x;
  const void* w;       // bf16: (kk, np, kp) bf16; f32: (kk, cin, np) f32; zero padded
  const void* offset;
  int off_dtype;
  const void* mask;    // null: no modulation
  int mask_dtype;
  const void* bias;    // (cout) each, or null, in epi_dtype
  const void* scale;
  const void* shift;
  int epi_dtype;
  int relu;
  void* out;
  long long o_ps;      // pixel stride of out, elements
  int b, h, w_, cin, ho, wo, kh, kw, stride, pad, cout;
  float bound;         // < 0: no clamp
  int tiles_x, tiles_y;
  int np, kp;          // the weight copy's padded output and input widths
  int pairs;           // out stored as 4-byte pairs
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element i of a float32 (dtype 0) or bfloat16 (dtype 1) array, as f32
__device__ __forceinline__ float load_any(const void* p, int dtype, size_t i) {
  return dtype == 0 ? static_cast<const float*>(p)[i] : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// act(scale * (v + bias) + shift) for output channel co, in f32
__device__ __forceinline__ float epilogue(const Args& a, float v, int co) {
  if (a.bias != nullptr) v += load_any(a.bias, a.epi_dtype, co);
  if (a.scale != nullptr) v *= load_any(a.scale, a.epi_dtype, co);
  if (a.shift != nullptr) v += load_any(a.shift, a.epi_dtype, co);
  return a.relu ? fmaxf(v, 0.f) : v;
}

// what the corners of pixel m of the tile at tap t are computed from: its
// offsets (clamped to the bound) and its mask, read from device memory; a
// pixel past the output's edge reads its nearest pixel's and is not live
struct CornerIn {
  float dy, dx, m;
  int oy, ox;
  bool live;
};

__device__ __forceinline__ CornerIn corner_inputs(const Args& a, int m, int t, int img, int oy0, int ox0) {
  CornerIn c;
  c.oy = oy0 + m / TW;
  c.ox = ox0 + m % TW;
  c.live = c.oy < a.ho && c.ox < a.wo;
  const int kk = a.kh * a.kw;
  const size_t pix = ((size_t)img * a.ho + min(c.oy, a.ho - 1)) * a.wo + min(c.ox, a.wo - 1);
  c.dy = load_any(a.offset, a.off_dtype, pix * (2 * kk) + 2 * t);
  c.dx = load_any(a.offset, a.off_dtype, pix * (2 * kk) + 2 * t + 1);
  if (a.bound >= 0.f) {
    c.dy = fminf(fmaxf(c.dy, -a.bound), a.bound);
    c.dx = fminf(fmaxf(c.dx, -a.bound), a.bound);
  }
  c.m = a.mask != nullptr ? load_any(a.mask, a.mask_dtype, pix * kk + t) : 1.f;
  return c;
}

// the four bilinear corners: their pixel indices in the image and their
// weights times the mask, in the order 00, 01, 10, 11. A corner outside the
// image, or any corner of a pixel that is not live, gets weight 0 and the
// index of a pixel inside (the nearest): every corner's load stays a plain
// load, with no branch around it
__device__ __forceinline__ void corner_weights(const Args& a, const CornerIn& c, int t, int4& idx, float4& wt) {
  const int ky = t / a.kw, kx = t - ky * a.kw;
  const float py = (float)(c.oy * a.stride - a.pad + ky) + c.dy;
  const float px = (float)(c.ox * a.stride - a.pad + kx) + c.dx;
  const float y0f = floorf(py), x0f = floorf(px);
  const float fy = py - y0f, fx = px - x0f;
  const int y0 = (int)y0f, x0 = (int)x0f;
  const float wts[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx, fy * (1.f - fx), fy * fx};
  int ix[4];
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = y0 + (k >> 1), xx = x0 + (k & 1);
    const bool inside = c.live && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w_;
    ix[k] = min(max(yy, 0), a.h - 1) * a.w_ + min(max(xx, 0), a.w_ - 1);
    w[k] = inside ? wts[k] * c.m : 0.f;
  }
  idx = make_int4(ix[0], ix[1], ix[2], ix[3]);
  wt = make_float4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// bf16: sampled A tiles in shared memory, wgmma with a bf16 hi/lo split
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// make this thread's generic-proxy shared-memory writes visible to wgmma
__device__ __forceinline__ void fence_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// keep the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma's shared-memory descriptor: start address, leading byte offset
// (between core matrices along K) and stride byte offset (between 8-row
// groups along M or N), in 16-byte units, and the swizzle code in bits
// 62-63 (0: none, 1: 128 bytes)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t swizzle = 0) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (swizzle << 62);
}

// d = A (64 x 16) * B (16 x N) (+ d unless acc_in is 0), both K-major in
// shared memory. An m64nN accumulator holds N/2 floats a thread: float i of
// warp w, lane l sits at row 16w + l/4 (+8 for i % 4 >= 2), column 8(i/4) +
// 2(l%4) + i%2.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc_in) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc_in));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc_in) {
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
      : "l"(da), "l"(db), "r"(acc_in));
}

// Shared memory, from a 1024-byte boundary: A hi and A lo (each kp / 64
// boxes of 64 rows x 128 bytes, 128-byte swizzled), B (BN x kp bf16, no
// swizzle), the corners of two taps (TP int4 indices, TP float4 weights
// each), and one 16-byte slot that takes the stores of lanes past a tile's
// end, so that no store sits in a branch
__host__ __device__ constexpr size_t a_bytes(int kp) { return (size_t)TP * kp * 2; }
constexpr size_t META_BYTES = 2 * TP * 16;
template <int BN>
__host__ __device__ constexpr size_t smem_bytes(int kp) {
  return 1024 + 2 * a_bytes(kp) + (size_t)BN * kp * 2 + 2 * META_BYTES + 16;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// 16 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The control flow before each wgmma is uniform across the warpgroup: loop
// bounds follow from the kernel's arguments, the corner warps are picked by
// a shuffled warp index, and loads and stores past a tile's end are
// redirected (to a pixel's first chunk with weight 0, to the spare slot)
// instead of branched around. A branch ptxas takes for divergent puts the
// wgmma on a divergent path, and it serializes them.
template <int BN, bool VEC, int U>
__global__ void __launch_bounds__(THREADS, 3) deform_conv_bf16(const Args a) {
  constexpr int NA = BN / 2;  // accumulator floats a thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kp = a.kp, kc8 = kp / 8, ksteps = kp / 16;
  const uint32_t base = smem_u32(smem);
  const uint32_t a_hi = base, a_lo = base + (uint32_t)a_bytes(kp), bsm = base + (uint32_t)(2 * a_bytes(kp));
  uint8_t* meta = smem + 2 * a_bytes(kp) + (size_t)BN * kp * 2;
  const uint32_t spare = smem_u32(meta + 2 * META_BYTES);
  // the corners of tap t: buffer t % 2
  auto meta_idx = [&](int t) { return reinterpret_cast<int4*>(meta + (t & 1) * META_BYTES); };
  auto meta_wt = [&](int t) { return reinterpret_cast<float4*>(meta + (t & 1) * META_BYTES + TP * 16); };

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  const bool corner_warp = warp < TP / 32;  // one pixel a thread
  const int tile = blockIdx.x;  // < 2^31, checked by the entry point
  const int ox0 = (tile % a.tiles_x) * TW;
  const int oy0 = ((tile / a.tiles_x) % a.tiles_y) * TH;
  const int img = tile / (a.tiles_x * a.tiles_y);
  const int n0 = blockIdx.y * BN;
  const int kk = a.kh * a.kw;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x) + (size_t)img * a.h * a.w_ * a.cin;
  const __nv_bfloat16* wg = static_cast<const __nv_bfloat16*>(a.w);
  const int n_b = BN * kc8;

  auto corners_of = [&](int t) {
    if (corner_warp) {
      int4 ii;
      float4 ww;
      corner_weights(a, corner_inputs(a, tid, t, img, oy0, ox0), t, ii, ww);
      meta_idx(t)[tid] = ii;
      meta_wt(t)[tid] = ww;
    }
  };

  // tap t's weight slice by cp.async: unit u = (chunk j, output channel n)
  // at (j BN + n) * 16
  auto fill_b = [&](int t) {
    const __nv_bfloat16* wt_src = wg + ((size_t)t * a.np + n0) * kp;
    for (int u0 = 0; u0 < n_b; u0 += THREADS) {
      const int u = u0 + tid;
      const bool live = u < n_b;
      const int uu = live ? u : 0, n = uu % BN, j = uu / BN;
      cp_async16(live ? bsm + (uint32_t)u * 16 : spare, wt_src + (size_t)n * kp + 8 * j);
    }
  };

  // tap t's A tiles, from the corners in meta buffer t % 2. Warp w takes
  // pixels 16 w .. 16 w + 15, ppi at a time (step r: pixel 16 w + ppi r +
  // lane / lp), its lp lanes a pixel on consecutive chunks (chunk j = lane
  // % lp + lp p, pass p). Chunk j of pixel m goes to box j / 8, row m,
  // 16-byte column (j % 8) ^ (m % 8).
  const int lp = kc8 < 16 ? kc8 : 16, ppi = 32 / lp, passes = (kc8 + lp - 1) / lp;  // kc8 <= 32: passes 1 or 2
  const int n_items = 16 / ppi * passes;  // per thread: (step, pass) = (item / passes, item % passes)
  const int m_lane = 16 * warp + lane / lp, j_lane = lane % lp;
  auto fill = [&](int t) {
    const int4* idx = meta_idx(t);
    const float4* wt = meta_wt(t);
    for (int q0 = 0; q0 < n_items; q0 += U) {
      float v[U][8];
      uint32_t dst[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u;
        const bool live = q < n_items;
        const int qq = live ? q : 0, r = qq >> (passes - 1), pass = qq & (passes - 1);
        const int m = m_lane + ppi * r, j = j_lane + lp * pass, c0 = 8 * j;
        const bool inch = live && j < kc8 && c0 < a.cin;  // chunks past Cin blend to 0
        const int cs = inch ? c0 : 0;
        const int4 ii = idx[m];
        const float4 ww = wt[m];
        const int at[4] = {ii.x, ii.y, ii.z, ii.w};
        const float cw[4] = {inch ? ww.x : 0.f, inch ? ww.y : 0.f, inch ? ww.z : 0.f, inch ? ww.w : 0.f};
        dst[u] = live && j < kc8 ? base + (uint32_t)((j >> 3) * (TP * 128) + m * 128 + (((j & 7) ^ (m & 7)) << 4))
                                 : spare;
        if constexpr (VEC) {
          uint4 raw[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) raw[c] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)at[c] * a.cin + cs));
#pragma unroll
          for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t words[4] = {raw[c].x, raw[c].y, raw[c].z, raw[c].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[e]));
              v[u][2 * e] = fmaf(f.x, cw[c], v[u][2 * e]);
              v[u][2 * e + 1] = fmaf(f.y, cw[c], v[u][2 * e + 1]);
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const bool in = inch && c0 + e < a.cin;
            float acc_e = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc_e = fmaf(__bfloat162float(x[(size_t)at[c] * a.cin + (in ? cs + e : 0)]), in ? cw[c] : 0.f, acc_e);
            v[u][e] = acc_e;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[u][2 * e], v[u][2 * e + 1]);
          const float2 hf = __bfloat1622float2(h2);
          const __nv_bfloat162 l2 = __floats2bfloat162_rn(v[u][2 * e] - hf.x, v[u][2 * e + 1] - hf.y);
          hi[e] = *reinterpret_cast<const uint32_t*>(&h2);
          lo[e] = *reinterpret_cast<const uint32_t*>(&l2);
        }
        st_shared(dst[u], make_uint4(hi[0], hi[1], hi[2], hi[3]));
        st_shared(dst[u] == spare ? spare : dst[u] + (uint32_t)a_bytes(kp), make_uint4(lo[0], lo[1], lo[2], lo[3]));
      }
    }
  };

  // each tap's first product overwrites the accumulators (acc_in 0)
  float acc[NA];

  // prologue: the corners of taps 0 and 1, tap 0's tiles
  corners_of(0);
  __syncthreads();
  fill_b(0);
  fill(0);
  if (kk > 1) corners_of(1);
  cp_async_wait_all();
  fence_async();
  __syncthreads();

  for (int t = 0; t < kk; ++t) {
    wgmma_fence();
    for (int s = 0; s < ksteps; ++s) {
      // k step s: 32 bytes into the swizzled rows of box s / 4
      const uint32_t ao = (uint32_t)((s >> 2) * (TP * 128) + (s & 3) * 32);
      const uint64_t db = smem_desc(bsm + (uint32_t)(2 * s * BN * 16), BN * 16, 128);
      wgmma_ss(acc, smem_desc(a_hi + ao, 16, 1024, 1), db, t + s > 0);
      wgmma_ss(acc, smem_desc(a_lo + ao, 16, 1024, 1), db, 1);
    }
    wgmma_commit();
    if (t + 1 < kk) {
      // the stage is read by tap t's wgmma until it completes; the corner
      // buffer written below was last read before the barrier that ended
      // tap t - 1
      wgmma_wait0();
      // the next weight slice and the offsets and mask of tap t + 2 are
      // requested first, so that their latency hides behind the blend
      fill_b(t + 1);
      const bool next = corner_warp && t + 2 < kk;
      CornerIn ci{};
      if (next) ci = corner_inputs(a, tid, t + 2, img, oy0, ox0);
      fill(t + 1);
      if (next) {
        int4 ii;
        float4 ww;
        corner_weights(a, ci, t + 2, ii, ww);
        meta_idx(t + 2)[tid] = ii;
        meta_wt(t + 2)[tid] = ww;
      }
      cp_async_wait_all();
      fence_async();
      __syncthreads();
    }
  }
  wgmma_wait0();
  pin(acc);

  // the epilogue on the fragments: bias, scale, shift, ReLU, one rounding;
  // each column's vectors read once for both of the thread's rows
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int co = n0 + 8 * jn + 2 * (lane % 4);
    float add0[2], mul[2], add1[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = min(co + e, a.cout - 1);
      add0[e] = a.bias != nullptr ? load_any(a.bias, a.epi_dtype, c) : 0.f;
      mul[e] = a.scale != nullptr ? load_any(a.scale, a.epi_dtype, c) : 1.f;
      add1[e] = a.shift != nullptr ? load_any(a.shift, a.epi_dtype, c) : 0.f;
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int m = 16 * warp + lane / 4 + 8 * rh;
      const int oy = oy0 + m / TW, ox = ox0 + m % TW;
      if (oy >= a.ho || ox >= a.wo) continue;
      __nv_bfloat16* o = out + (((size_t)img * a.ho + oy) * a.wo + ox) * a.o_ps;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = (acc[4 * jn + 2 * rh + e] + add0[e]) * mul[e] + add1[e];
        if (a.relu) v[e] = fmaxf(v[e], 0.f);
      }
      if (a.pairs && co + 1 < a.cout) {
        *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(v[0], v[1]);
      } else {
        if (co < a.cout) o[co] = __float2bfloat16_rn(v[0]);
        if (co + 1 < a.cout) o[co + 1] = __float2bfloat16_rn(v[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA, one thread per (pixel, 8 output channels)
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;
constexpr int F32_BN = 32;  // output channels per CTA
constexpr int F32_KC = 32;  // input channels per step
constexpr int LDC = F32_KC + 1;

__global__ void __launch_bounds__(F32_THREADS) deform_conv_f32(const Args a) {
  __shared__ int4 idx[TP];
  __shared__ float4 wt[TP];
  __shared__ float cols[TP * LDC];     // [pixel][channel]
  __shared__ float ws[F32_KC * F32_BN];  // [channel][output channel]

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int ox0 = (tile % a.tiles_x) * TW;
  const int oy0 = ((tile / a.tiles_x) % a.tiles_y) * TH;
  const int img = tile / (a.tiles_x * a.tiles_y);
  const int n0 = blockIdx.y * F32_BN;
  const int kk = a.kh * a.kw;
  const float* x = static_cast<const float*>(a.x) + (size_t)img * a.h * a.w_ * a.cin;
  const float* wg = static_cast<const float*>(a.w);
  const int p = tid % TP, ng = tid / TP;  // this thread's pixel and 8 output channels

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  for (int t = 0; t < kk; ++t) {
    __syncthreads();
    if (tid < TP) corner_weights(a, corner_inputs(a, tid, t, img, oy0, ox0), t, idx[tid], wt[tid]);
    __syncthreads();
    for (int c0 = 0; c0 < a.cin; c0 += F32_KC) {
      for (int q = tid; q < TP * F32_KC; q += F32_THREADS) {
        const int m = q / F32_KC, c = q % F32_KC;
        const int4 ii = idx[m];
        const float4 ww = wt[m];
        float v = 0.f;
        if (c0 + c < a.cin) {
          v = fmaf(x[(size_t)ii.x * a.cin + c0 + c], ww.x, v);
          v = fmaf(x[(size_t)ii.y * a.cin + c0 + c], ww.y, v);
          v = fmaf(x[(size_t)ii.z * a.cin + c0 + c], ww.z, v);
          v = fmaf(x[(size_t)ii.w * a.cin + c0 + c], ww.w, v);
        }
        cols[m * LDC + c] = v;
      }
      for (int q = tid; q < F32_KC * F32_BN; q += F32_THREADS) {
        const int c = q / F32_BN, n = q % F32_BN;
        ws[q] = c0 + c < a.cin ? wg[((size_t)t * a.cin + c0 + c) * a.np + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < F32_KC; ++c) {
        const float xv = cols[p * LDC + c];
        const float* wr = ws + c * F32_BN + ng * 8;  // the same row for the whole warp: a broadcast
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(xv, wr[i], acc[i]);
      }
      __syncthreads();
    }
  }

  const int oy = oy0 + p / TW, ox = ox0 + p % TW;
  if (oy >= a.ho || ox >= a.wo) return;
  float* o = static_cast<float*>(a.out) + (((size_t)img * a.ho + oy) * a.wo + ox) * a.o_ps;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = n0 + ng * 8 + i;
    if (co >= a.cout) continue;
    o[co] = epilogue(a, acc[i], co);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int BN, bool VEC>
cudaError_t launch_bf16(const Args& a, unsigned tiles, cudaStream_t s) {
  const size_t smem = smem_bytes<BN>(a.kp);
  if (smem > SMEM_CAP) return cudaErrorInvalidValue;
  auto kern = deform_conv_bf16<BN, VEC, 4>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(tiles, (unsigned)(a.np / BN)), THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The output-channel tile: f32 32; bf16 32 up to 32 output channels, else
// 64. The weight copy's padded widths follow from it; the wrapper lays the
// copy out by the same rule and passes them here to be checked.
int tile_n(int cout, int dtype) { return dtype == 0 ? 32 : (cout <= 32 ? 32 : 64); }

// dtype (of x, w and out): 0 = float32, 1 = bfloat16; off_dtype, mask_dtype:
// the same codes. x (b, h, wd, cin) contiguous and 16-byte aligned; w the
// wrapper's zero-padded copy of the weight: bf16 (kh kw, np, kp) with kp =
// cin rounded up to 64, f32 (kh kw, cin, np), with np = cout rounded up to
// tile_n(cout, dtype); offset (b, ho, wo, 2 kh kw) and mask (b, ho, wo, kh
// kw, or null) contiguous; bias, scale, shift (cout) or null, in epi_dtype
// (the same codes); out a (b, ho, wo, cout) view with pixel stride o_ps.
// bound < 0: no clamp.
// Returns the cudaError_t of the launch.
extern "C" int vtt_deform_conv_fwd(const void* x, const void* w, int np, int kp, const void* offset, int off_dtype,
                                   const void* mask, int mask_dtype, const void* bias, const void* scale,
                                   const void* shift, int epi_dtype, int relu, void* out, long long o_ps, int b,
                                   int h, int wd, int cin, int ho, int wo, int kh, int kw, int stride, int pad,
                                   float bound, int cout, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || wd <= 0 || cin <= 0 || ho <= 0 || wo <= 0 || kh <= 0 || kw <= 0 || stride <= 0 ||
      pad < 0 || cout <= 0 || o_ps < cout || (dtype != 0 && dtype != 1) || (off_dtype != 0 && off_dtype != 1) ||
      (mask != nullptr && mask_dtype != 0 && mask_dtype != 1) || (epi_dtype != 0 && epi_dtype != 1) ||
      (long long)b * ho * wo * kh * kw >= (1LL << 31) || (long long)h * wd >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int bn = tile_n(cout, dtype);
  const int kalign = dtype == 0 ? 16 : BOX;
  if (np != (cout + bn - 1) / bn * bn || kp != (cin + kalign - 1) / kalign * kalign) return (int)cudaErrorInvalidValue;
  const int tiles_x = (wo + TW - 1) / TW, tiles_y = (ho + TH - 1) / TH;
  const long long tiles = (long long)b * tiles_y * tiles_x;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t esz = dtype == 0 ? 4 : 2;
  const bool pairs = reinterpret_cast<uintptr_t>(out) % (2 * esz) == 0 && o_ps % 2 == 0 && cout % 2 == 0;
  const Args a{x, w, offset, off_dtype, mask, mask_dtype, bias, scale, shift, epi_dtype, relu, out, o_ps, b, h,
               wd, cin, ho, wo, kh, kw, stride, pad, cout, bound, tiles_x, tiles_y, np, kp, (int)pairs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    deform_conv_f32<<<dim3((unsigned)tiles, (unsigned)(np / F32_BN)), F32_THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const bool vec = cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const unsigned t = (unsigned)tiles;
  if (bn == 32) return (int)(vec ? launch_bf16<32, true>(a, t, s) : launch_bf16<32, false>(a, t, s));
  return (int)(vec ? launch_bf16<64, true>(a, t, s) : launch_bf16<64, false>(a, t, s));
}
