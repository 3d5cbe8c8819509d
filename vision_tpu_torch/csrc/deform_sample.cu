// Deformable-conv v2 sampling for Hopper (sm_90a): the modulated columns
//
//   cols[b, oy, ox, k, c] = mask[b, oy, ox, k] * bilinear(x[b, :, :, c], py, px)
//   py = oy * stride - pad + ky + off[b, oy, ox, 2k],  px = ox * stride - pad + kx + off[b, oy, ox, 2k + 1]
//
// with tap k = ky * kw + kx, zero outside the image, and the offsets first
// clamped to [-bound, bound] when a bound is given. x is NHWC (B, H, W, Cin),
// bf16 or f32; the offsets (B, Ho, Wo, 2 * kh * kw) are tap-major (dy, dx)
// pairs and the mask (B, Ho, Wo, kh * kw) is optional, each f32 or bf16 and
// read as f32; the columns (B, Ho, Wo, kh * kw, Cin) are in x's type. The
// deformable conv is these columns times the weight, one matrix product that
// stays outside the kernel (ops/deform.py).
//
// Replaces the Pallas bodies of the bounded-offset deformable conv probes,
// scripts/exp_deform_pallas.py (make_kernel's kernel: "sliced", "rolled"),
// exp_deform_pallas2.py (d0..d4), exp_deform_pallas3.py (unrolled,
// into_ref, fori, dy_fori_dx_static), exp_deform_pallas4.py (r25, s25r) and
// exp_deform_pallas5.py (roll25, hyb): each computes, for one tap,
// sum over 25 shifts (dy, dx) in [-2, 2]^2 of coef_d(p) * x[p + (dy, dx)],
// the tent-weighted window MAC of deform_conv_2d_shift
// (vision_tpu/ops/deform.py:45). At most 4 of the 25 coefficients are
// nonzero, the bilinear corners. The TPU form computes all 25 because its
// row gathers ran at ~92 GB/s; on this card a gather of 4 neighbouring
// pixel rows is served by L1/L2, so the kernel evaluates only the 4
// corners: the same function (exact for |offset| <= bound, and with no
// bound it is deform_conv_2d, vision_tpu/ops/deform.py:118).
//
// What bounds it: bytes. Per (pixel, tap) it reads up to 4 rows of Cin
// values that neighbouring taps and pixels share (L2 serves most of them)
// and writes one row of Cin columns; the columns dominate (BiRefNet's k = 7
// conv at 256^2, Cin 112, writes 49 x 112 bf16 per pixel, ~0.72 GB per
// image). The least time is the columns written plus x, the offsets and the
// mask read once, over the memory rate. The design: one thread per (pixel,
// tap, 16-byte chunk of channels), so the column rows are written by
// neighbouring threads in full 16-byte stores and each corner row is read
// in 16-byte loads (Cin % 8 == 0 in bf16, as BiRefNet's 112; Cin % 4 in
// f32; other widths one element at a time). The corner coordinates and
// weights are computed in f32 by each chunk's thread from the same three
// values, which L1 serves; the blend is f32 in the reference's order
// (corner 00, 01, 10, 11), times the mask in f32, rounded once to x's type.
// A block covers whole (pixel, tap) rows, so index arithmetic is 32-bit
// (the wrapper keeps B * Ho * Wo * kh * kw below 2^31) and every memory
// offset is 64-bit: one batch-8 k = 7 conv at 256^2 holds more than 2^31
// column elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// element i of a float32 (dtype 0) or bfloat16 (dtype 1) array, as f32
__device__ __forceinline__ float load_any(const void* p, int dtype, size_t i) {
  return dtype == 0 ? static_cast<const float*>(p)[i] : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// VEC consecutive elements as floats: one 16-byte load, or one element
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(p[0]);
  } else {
    static_assert(sizeof(T) * VEC == 16, "a vector is 16 bytes");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f(e[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

struct Args {
  const void* x;
  const void* offset;
  int off_dtype;
  const void* mask;  // null: no modulation
  int mask_dtype;
  void* out;
  int b, h, w, cin, ho, wo, kh, kw, stride, pad;
  float bound;  // < 0: no clamp
  cudaStream_t stream;
};

// grid: one block per `rows` consecutive (pixel, tap) rows; the block's
// threads walk its rows' chunks of VEC channels
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
deform_sample_kernel(const T* __restrict__ x, const void* __restrict__ offset, int off_dtype,
                     const void* __restrict__ mask, int mask_dtype, T* __restrict__ out, int h, int w, int cin,
                     int ho, int wo, int kh, int kw, int stride, int pad, float bound, int n_rows, int rows) {
  const int kk = kh * kw;
  const int chunks = cin / VEC;
  const int first = blockIdx.x * rows;  // < n_rows < 2^31
  const int items = rows * chunks;
  for (int j = threadIdx.x; j < items; j += THREADS) {
    const int lr = j / chunks;
    const int row = first + lr;  // (pixel, tap) row: pixel * kk + tap
    if (row >= n_rows) break;   // j only grows
    const int c0 = (j - lr * chunks) * VEC;
    const int tap = row % kk;
    const int pix = row / kk;  // (b * ho + oy) * wo + ox
    const int ox = pix % wo;
    const int oy = (pix / wo) % ho;
    const int bi = pix / (wo * ho);
    const int ky = tap / kw, kx = tap - ky * kw;

    const size_t off_i = (size_t)pix * (2 * kk) + 2 * tap;
    float dy = load_any(offset, off_dtype, off_i);
    float dx = load_any(offset, off_dtype, off_i + 1);
    if (bound >= 0.f) {
      dy = fminf(fmaxf(dy, -bound), bound);
      dx = fminf(fmaxf(dx, -bound), bound);
    }
    const float py = (float)(oy * stride - pad + ky) + dy;
    const float px = (float)(ox * stride - pad + kx) + dx;
    const float y0f = floorf(py), x0f = floorf(px);
    const float fy = py - y0f, fx = px - x0f;
    const int y0 = (int)y0f, x0 = (int)x0f;
    const float wt[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx, fy * (1.f - fx), fy * fx};

    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yy = y0 + (c >> 1), xx = x0 + (c & 1);
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;  // zero outside the image
      float v[VEC];
      load_vec<T, VEC>(x + (((size_t)bi * h + yy) * w + xx) * cin + c0, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += v[e] * wt[c];
    }
    if (mask != nullptr) {
      const float m = load_any(mask, mask_dtype, (size_t)pix * kk + tap);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= m;
    }
    store_vec<T, VEC>(out + (size_t)row * cin + c0, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const Args& a) {
  const int chunks = a.cin / VEC;
  const int rows = chunks >= THREADS ? 1 : THREADS / chunks;
  const int n_rows = a.b * a.ho * a.wo * a.kh * a.kw;  // < 2^31, checked by the caller
  const int blocks = (n_rows + rows - 1) / rows;
  deform_sample_kernel<T, VEC><<<blocks, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.offset, a.off_dtype, a.mask, a.mask_dtype, static_cast<T*>(a.out), a.h, a.w,
      a.cin, a.ho, a.wo, a.kh, a.kw, a.stride, a.pad, a.bound, n_rows, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Args& a) {
  constexpr int VEC = 16 / sizeof(T);
  return a.cin % VEC == 0 ? launch<T, VEC>(a) : launch<T, 1>(a);
}

}  // namespace

// dtype (of x and out): 0 = float32, 1 = bfloat16; off_dtype, mask_dtype:
// the same codes. x (b, h, w, cin) and out (b, ho, wo, kh * kw, cin)
// contiguous and 16-byte aligned; offset (b, ho, wo, 2 * kh * kw) and mask
// (b, ho, wo, kh * kw, or null) contiguous. bound < 0: no clamp. Returns the
// cudaError_t of the launch.
extern "C" int vtt_deform_sample_fwd(const void* x, const void* offset, int off_dtype, const void* mask,
                                     int mask_dtype, void* out, int b, int h, int w, int cin, int ho, int wo, int kh,
                                     int kw, int stride, int pad, float bound, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || ho <= 0 || wo <= 0 || kh <= 0 || kw <= 0 || stride <= 0 ||
      pad < 0 || (dtype != 0 && dtype != 1) || (off_dtype != 0 && off_dtype != 1) ||
      (mask != nullptr && mask_dtype != 0 && mask_dtype != 1) ||
      (long long)b * ho * wo * kh * kw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Args a{x, offset, off_dtype, mask, mask_dtype, out, b, h, w, cin, ho, wo, kh, kw, stride, pad, bound,
               static_cast<cudaStream_t>(stream)};
  return (int)(dtype == 0 ? launch_t<float>(a) : launch_t<__nv_bfloat16>(a));
}
