// Block dequantization for Hopper (sm_90a): an int8-resident weight
// (core/quant.py QuantResident) back to its canonical float tensor,
//
//   v[i] = (float)q[i] * scale[i / 32] (+ minv[i / 32])
//   out  = permute(reshape(v, file_shape), perm)   contiguous, bf16 or f32
//
// It implements the JAX package's QuantResident.dequant
// (vision_tpu/core/quant.py), which XLA fuses into the weight's consumer
// inside the jitted graph; it is no Pallas kernel's port. The plain PyTorch
// form (ops/cuda/dequant.py dequant_plain) makes five passes over f32
// intermediates for it: the cast, the scale, the minimum, the permute and the
// cast to bf16, ~19 bytes an element. This kernel makes one.
//
// Numbers: the product and the sum are each rounded to f32 (__fmul_rn,
// __fadd_rn: nvcc would otherwise contract them into one FMA, and an FMA
// rounds once, which would break bit-equality with numpy's `q * d + m`
// (core/gguf.py dequantize_q4_1) and PyTorch's), then rounded to bf16 to
// nearest even. The minimum is added only when the format has one, so a
// -0.0 product stays -0.0 as in the plain form.
//
// What bounds it: bytes. It reads 1 byte of q an element and 4 (8 with a
// minimum) bytes of scales a 32-block, 1.125 (1.25) bytes, and writes 2
// (bf16) or 4 (f32). The design: where the permute is the identity, one
// thread converts 8 consecutive elements (all of one 32-block): one 8-byte
// load of q, one 16-byte store of bf16 (two of f32). Otherwise one thread an
// output element, in the output's order, so the stores are coalesced; it
// reads q at the permuted source offset (the weights are a few MB, and L2
// serves the strided reads). The wrapper keeps n below 2^31, so the index
// arithmetic is 32-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // elements a thread on the identity path

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <bool HAS_MIN>
__device__ __forceinline__ float level(int8_t q, float s, float m) {
  float v = __fmul_rn(static_cast<float>(q), s);
  if constexpr (HAS_MIN) v = __fadd_rn(v, m);
  return v;
}

template <typename T, bool HAS_MIN>
__global__ void __launch_bounds__(THREADS)
    dequant_identity_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                            const float* __restrict__ minv, T* __restrict__ out, int n_vec) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_vec) return;
  const int i0 = t * VEC;
  const int blk = i0 >> 5;
  const float s = scale[blk];
  const float m = HAS_MIN ? minv[blk] : 0.0f;
  const uint2 raw = *reinterpret_cast<const uint2*>(q + i0);
  const int8_t* qv = reinterpret_cast<const int8_t*>(&raw);
  constexpr int WORDS = static_cast<int>(sizeof(T)) * VEC / 16;  // 16-byte stores: 1 in bf16, 2 in f32
  uint4 u[WORDS];
  T* e = reinterpret_cast<T*>(u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(level<HAS_MIN>(qv[j], s, m));
  uint4* o = reinterpret_cast<uint4*>(out + i0);
#pragma unroll
  for (int c = 0; c < WORDS; ++c) o[c] = u[c];
}

struct Perm {
  int shape[4];   // the output's shape, leading dims of 1 where it has fewer than 4
  int stride[4];  // the source offset of one step along each output dim
};

template <typename T, bool HAS_MIN>
__global__ void __launch_bounds__(THREADS)
    dequant_permute_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                           const float* __restrict__ minv, T* __restrict__ out, int n, Perm p) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  int rest = i, src = 0;
#pragma unroll
  for (int d = 3; d >= 0; --d) {
    const int c = rest % p.shape[d];
    rest /= p.shape[d];
    src += c * p.stride[d];
  }
  const int blk = src >> 5;
  out[i] = from_f<T>(level<HAS_MIN>(q[src], scale[blk], HAS_MIN ? minv[blk] : 0.0f));
}

template <typename T, bool HAS_MIN>
cudaError_t launch(const int8_t* q, const float* scale, const float* minv, void* out, int n, bool identity,
                   const Perm& p, cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  if (identity) {
    const int n_vec = n / VEC;
    dequant_identity_kernel<T, HAS_MIN><<<(n_vec + THREADS - 1) / THREADS, THREADS, 0, stream>>>(q, scale, minv, o,
                                                                                                 n_vec);
  } else {
    dequant_permute_kernel<T, HAS_MIN><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(q, scale, minv, o, n, p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const int8_t* q, const float* scale, const float* minv, void* out, int n, bool identity,
                     const Perm& p, cudaStream_t stream) {
  return minv != nullptr ? launch<T, true>(q, scale, minv, out, n, identity, p, stream)
                         : launch<T, false>(q, scale, minv, out, n, identity, p, stream);
}

}  // namespace

// q: n int8 levels in the file's C order (n a multiple of 32, below 2^31,
// 16-byte aligned); scale and minv (or null): n / 32 f32; out: n elements,
// 16-byte aligned, dtype 0 = float32, 1 = bfloat16. shape and stride: the
// output's 4 dims (leading 1s) and the source offset of a step along each;
// identity != 0 when the output is the source in its own order (then shape
// and stride are not read). Returns the cudaError_t of the launch.
extern "C" int vtt_dequant_fwd(const void* q, const void* scale, const void* minv, void* out, int n,
                               const int* shape, const int* stride, int identity, int dtype, void* stream) {
  if (n <= 0 || n % 32 != 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  Perm p{};
  if (!identity) {
    long long prod = 1;
    for (int d = 0; d < 4; ++d) {
      if (shape[d] <= 0) return (int)cudaErrorInvalidValue;
      p.shape[d] = shape[d];
      p.stride[d] = stride[d];
      prod *= shape[d];
    }
    if (prod != n) return (int)cudaErrorInvalidValue;
  }
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  const float* mp = static_cast<const float*>(minv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_t<float>(qp, sp, mp, out, n, identity != 0, p, st)
                          : launch_t<__nv_bfloat16>(qp, sp, mp, out, n, identity != 0, p, st));
}
