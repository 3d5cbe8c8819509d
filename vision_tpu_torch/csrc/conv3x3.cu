// 3x3, stride-1, pad-1 convolution of an NHWC image, for Hopper (sm_90a):
//
//   out[n, y, x, co] = sum over dy, dx in {0, 1, 2} and ci of
//                      pad1(x)[n, y + dy, x + dx, ci] * w[co, ci, dy, dx]
//
// Replaces the Pallas kernel `kernel` of conv_rowblock in
// scripts/exp_pallas_conv.py (launched through pl.pallas_call there), which
// computes this for one (1, H, W, C) image with an HWIO weight over row
// blocks whose one-row halo it fetches by async copy. Same contract, with a
// batch axis: x (N, H, W, Cin) contiguous; the weight in its torch-canonical
// (Cout, Cin, 3, 3) layout, as the model's parameters hold it, read in place
// (no per-call transpose launch); f32 accumulation; output (N, H, W, Cout)
// in x's type (round to nearest even); no bias. Its consumer is every conv
// of Real-ESRGAN's RRDBNet (models/esrgan.py through ops/nn.py conv_3x3):
// 351 launches per forward at scale 4 with 23 blocks.
//
// What bounds it on this card: per conv, max(FLOPs / 989 TFLOP/s,
// bytes / 3.35 TB/s) with FLOPs = 18 * P * Cin * Cout and bytes =
// 2 * P * (Cin + Cout) in bf16. The RDB convs (Cin 64..192 -> 32, Cout 32
// at 1024^2: 39-97 GFLOP over 0.2-0.4 GB) and the full-resolution tail
// convs (64 -> 64 and 64 -> 3 at 4096^2) are bound by bytes; the 192 -> 64
// conv5 by the tensor cores. So the design keeps each input pixel's reads
// from device memory near one: a block computes a 16 x 16 pixel tile for
// up to 64 output channels, and stages its input tile with the one-pixel
// halo (18 x 18 pixels) in shared memory, 16 input channels at a time, so
// the nine taps read shared memory, not device memory (18^2 / 16^2 = 1.27
// reads per pixel per output-channel tile). It is an implicit GEMM with
// M = the tile's 256 pixels, N = the output-channel tile and K = 9 * Cin,
// walked as (Cin chunk of 16, dy, dx).
//
// Ragged shapes: input channels are padded to 16 with zeros in shared
// memory (Cin 3, 4, 12, 20 load per element; a multiple of 8 loads 16
// bytes at a time), and the weight rows past Cout are zero; nothing is
// stored past Cout, H or W. The image border's zero padding comes from
// predicated loads, never from a neighbouring row or image. Every offset
// into x or out is computed in 64 bits: at scale 4, a batch of four 1024^2
// requests runs (4, 4096, 4096, 64) tensors of 4.3e9 elements.
//
// bf16 (the model's type on the card): mma.sync m16n8k16 with f32
// accumulators, fragments loaded with ldmatrix from padded rows (48 bytes
// per pixel: conflict-free). 8 warps; warp w owns tile rows 2w and 2w + 1,
// one 16-pixel row per m16 tile. The weight chunk is restaged per block in
// the order the B fragments want ([tap][out channel][in channel]), from
// 16-byte loads when Cin % 8 == 0; two blocks share an SM, so one block's
// staging overlaps the other's products. f32 (the CPU-parity type, off the
// serving path): one thread per output pixel, FMA loops over 32 output
// channels. Making it fast (wgmma, TMA, a pipeline over the chunks, a
// persistent grid that stages the weight once) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16, TW = 16;          // output tile: 16 rows x 16 columns
constexpr int HR = TH + 2, HC = TW + 2;  // the input tile with its halo
constexpr int THREADS = 256;             // 8 warps
constexpr int KC = 16;                   // input channels per step
constexpr int LDK = 24;                  // padded bf16 row of a staged pixel or weight row

struct Args {
  const void* x;
  const void* w;
  void* out;
  int h, wd, cin, cout;
  int tiles_x, tiles_y;
  long long tiles;  // n * tiles_y * tiles_x
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT: 8-channel output tiles per block (even), so BN = 8 * NT output
// channels. Two blocks per SM (at most 128 registers a thread): one block's
// staging overlaps the other's products.
template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
             __nv_bfloat16* __restrict__ out, int h, int wd, int cin, int cout, int tiles_x, int tiles_y) {
  static_assert(NT % 2 == 0, "B fragments are loaded two 8-channel tiles at a time");
  constexpr int BN = 8 * NT;
  __shared__ __align__(16) __nv_bfloat16 xs[HR * HC * LDK];  // [halo pixel][channel]
  __shared__ __align__(16) __nv_bfloat16 ws[9 * BN * LDK];   // [tap][out channel][in channel]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // mma fragment row group and column pair
  const int tile = blockIdx.x;
  const int x0 = (tile % tiles_x) * TW;
  const int y0 = ((tile / tiles_x) % tiles_y) * TH;
  const size_t img_base = (size_t)(tile / (tiles_x * tiles_y)) * h * wd;  // pixel (img, 0, 0)
  const int co0 = blockIdx.y * BN;
  const bool vec = (cin % 8) == 0;
  const __nv_bfloat16 zero = __ushort_as_bfloat16((unsigned short)0);

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  for (int kc = 0; kc < cin; kc += KC) {
    __syncthreads();  // the previous step's reads are done
    // the input tile with its halo, channels [kc, kc + 16), zeros outside
    // the image and past cin; two 8-channel halves per pixel
    for (int i = tid; i < HR * HC * 2; i += THREADS) {
      const int pix = i >> 1, half = i & 1;
      const int gy = y0 - 1 + pix / HC, gx = x0 - 1 + pix % HC;
      const int c = kc + half * 8;
      __nv_bfloat16* dst = xs + pix * LDK + half * 8;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
      if (vec) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (inside && c < cin)
          v = *reinterpret_cast<const uint4*>(x + (img_base + (size_t)gy * wd + gx) * cin + c);
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const size_t base = inside ? (img_base + (size_t)gy * wd + gx) * cin : 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (inside && c + e < cin) ? x[base + c + e] : zero;
      }
    }
    // the weight for channels [kc, kc + 16) and this block's output tile,
    // read in place: for one output channel the chunk is 16 * 9 contiguous
    // elements of (Cout, Cin, 3, 3), which start on a 16-byte boundary when
    // cin % 8 == 0 (8 x 9 elements of 2 bytes per 8 channels)
    if (vec) {
      const int live = min(KC, cin - kc) * 9;  // elements of the chunk that exist: a multiple of 8
      for (int i = tid; i < BN * (KC * 9 / 8); i += THREADS) {
        const int n = i / (KC * 9 / 8), e0 = (i % (KC * 9 / 8)) * 8;
        const int co = co0 + n;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (co < cout && e0 < live) v = *reinterpret_cast<const uint4*>(wt + ((size_t)co * cin + kc) * 9 + e0);
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ws[(((e0 + e) % 9) * BN + n) * LDK + (e0 + e) / 9] =
              __ushort_as_bfloat16((unsigned short)(words[e / 2] >> (16 * (e % 2))));
      }
    } else {
      for (int i = tid; i < BN * KC * 9; i += THREADS) {
        const int n = i / (KC * 9), rem = i % (KC * 9);
        const int k = rem / 9, tap = rem % 9;
        const int co = co0 + n, ci = kc + k;
        ws[(tap * BN + n) * LDK + k] = (co < cout && ci < cin) ? wt[((size_t)co * cin + ci) * 9 + tap] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // A: 16 pixels of one output row x 16 channels; lane l addresses
      // pixel (l % 16) at channel offset 8 * (l / 16)
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = 2 * warp + m;
        ldmatrix_x4(a[m], xs + ((r + dy) * HC + (lane & 15) + dx) * LDK + (lane >> 4) * 8);
      }
      // B: two 8-channel output tiles; lane l addresses output channel
      // 8 * (j + (l / 16)) + l % 8 at input-channel offset 8 * ((l / 8) % 2)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int q = lane >> 3;
        uint32_t b[4];
        ldmatrix_x4(b, ws + (tap * BN + 8 * j + (q >> 1) * 8 + (lane & 7)) * LDK + (q & 1) * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[m][j], a[m], b[0], b[1]);
          mma_bf16(acc[m][j + 1], a[m], b[2], b[3]);
        }
      }
    }
  }

  // store: fragment rows are pixels g and g + 8 of the warp's row, columns
  // are output channels 2 * tq and 2 * tq + 1 of each 8-channel tile
  const bool pairs = (cout % 2) == 0;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int y = y0 + 2 * warp + m;
    if (y >= h) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = x0 + g + 8 * half;
      if (px >= wd) continue;
      const size_t pix = img_base + (size_t)y * wd + px;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = co0 + 8 * j + 2 * tq;
        const float v0 = acc[m][j][2 * half], v1 = acc[m][j][2 * half + 1];
        __nv_bfloat16* o = out + pix * cout + co;
        if (pairs && co + 1 < cout) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < cout) o[0] = __float2bfloat16_rn(v0);
          if (co + 1 < cout) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA kernel, one thread per output pixel
// ---------------------------------------------------------------------------

constexpr int F32_BN = 32;   // output channels per block
constexpr int LDF = KC + 1;  // padded f32 row of a staged pixel

__global__ void __launch_bounds__(THREADS)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ wt, float* __restrict__ out, int h, int wd,
            int cin, int cout, int tiles_x, int tiles_y) {
  __shared__ float xs[HR * HC * LDF];    // [halo pixel][channel]
  __shared__ float ws[9 * KC * F32_BN];  // [tap][in channel][out channel]

  const int tid = threadIdx.x;
  const int r = tid / TW, c = tid % TW;  // this thread's pixel in the tile
  const int tile = blockIdx.x;
  const int x0 = (tile % tiles_x) * TW;
  const int y0 = ((tile / tiles_x) % tiles_y) * TH;
  const size_t img_base = (size_t)(tile / (tiles_x * tiles_y)) * h * wd;
  const int co0 = blockIdx.y * F32_BN;

  float acc[F32_BN];
#pragma unroll
  for (int n = 0; n < F32_BN; ++n) acc[n] = 0.f;

  for (int kc = 0; kc < cin; kc += KC) {
    __syncthreads();
    for (int i = tid; i < HR * HC * KC; i += THREADS) {
      const int pix = i / KC, k = i % KC;
      const int gy = y0 - 1 + pix / HC, gx = x0 - 1 + pix % HC;
      const bool live = gy >= 0 && gy < h && gx >= 0 && gx < wd && kc + k < cin;
      xs[pix * LDF + k] = live ? x[(img_base + (size_t)gy * wd + gx) * cin + kc + k] : 0.f;
    }
    for (int i = tid; i < F32_BN * KC * 9; i += THREADS) {
      const int n = i / (KC * 9), rem = i % (KC * 9);
      const int k = rem / 9, tap = rem % 9;
      const int co = co0 + n, ci = kc + k;
      ws[(tap * KC + k) * F32_BN + n] = (co < cout && ci < cin) ? wt[((size_t)co * cin + ci) * 9 + tap] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* xr = xs + ((r + tap / 3) * HC + c + tap % 3) * LDF;
      for (int k = 0; k < KC; ++k) {
        const float xv = xr[k];
        const float* wr = ws + (tap * KC + k) * F32_BN;  // every thread reads the same row: a broadcast
#pragma unroll
        for (int n = 0; n < F32_BN; ++n) acc[n] = fmaf(xv, wr[n], acc[n]);
      }
    }
  }

  const int y = y0 + r, px = x0 + c;
  if (y >= h || px >= wd) return;
  float* o = out + (img_base + (size_t)y * wd + px) * cout;
#pragma unroll
  for (int n = 0; n < F32_BN; ++n)
    if (co0 + n < cout) o[co0 + n] = acc[n];
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int NT>
cudaError_t launch_bf16(const Args& a) {
  const dim3 grid((unsigned)a.tiles, (unsigned)((a.cout + 8 * NT - 1) / (8 * NT)));
  conv3x3_bf16<NT><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const __nv_bfloat16*>(a.w),
      static_cast<__nv_bfloat16*>(a.out), a.h, a.wd, a.cin, a.cout, a.tiles_x, a.tiles_y);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Args& a) {
  const dim3 grid((unsigned)a.tiles, (unsigned)((a.cout + F32_BN - 1) / F32_BN));
  conv3x3_f32<<<grid, THREADS, 0, a.stream>>>(static_cast<const float*>(a.x), static_cast<const float*>(a.w),
                                             static_cast<float*>(a.out), a.h, a.wd, a.cin, a.cout, a.tiles_x,
                                             a.tiles_y);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: (n, h, wd, cin), w: (cout, cin, 3, 3),
// out: (n, h, wd, cout), all contiguous and 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int vtt_conv3x3_fwd(const void* x, const void* w, void* out, int n, int h, int wd, int cin, int cout,
                               int dtype, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (wd + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  const long long tiles = (long long)n * tiles_y * tiles_x;
  if (tiles >= (1LL << 31) || (long long)cout * cin * 9 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Args a{x, w, out, h, wd, cin, cout, tiles_x, tiles_y, tiles, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_f32(a);
  if (cout <= 16) return (int)launch_bf16<2>(a);
  if (cout <= 32) return (int)launch_bf16<4>(a);
  return (int)launch_bf16<8>(a);
}
