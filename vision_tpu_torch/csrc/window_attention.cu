// Windowed multi-head attention with a per-head additive bias and an optional
// per-window mask, for Hopper (sm_90a):
//
//   out[w, :, h] = softmax(q[w, :, h] * scale . k[w, :, h]^T + bias[h] + mask[w % nW]) . v[w, :, h]
//
// Replaces the Pallas kernel _kernel in scripts/exp_winattn2.py (launched
// by that script's window_attention through pl.pallas_call), TinyViT's
// window attention in every MobileSAM encoder block; it also serves every
// SWIN block of BiRefNet's encoder. Same contract: q, k, v (NW, T, C)
// contiguous with C = H * hd and head h in channels [h*hd, (h+1)*hd) (no
// head transposes); bias (H, T, T) shared by all windows, or none; the bias
// is read in its own type (f32 or bf16) and added in f32. The mask (nW, T,
// T) is f32, window w reads mask w % nW (windows ordered image-major, as
// SWIN's window_partition orders them), and it may hold -inf (SWIN's
// shifted-window zones), never on a whole row: a query always shares its
// zone with itself. Rounding follows the Pallas body: q * scale in f32,
// rounded to q's type; logits, bias and mask adds and softmax in f32; the
// normalised probabilities rounded to v's type; PV accumulated in f32;
// output in q's type.
//
// What bounds it on this card: the work is tiny and plentiful. At the
// slice's stage 1 (T = 49, H = 4, hd = 32) a batch of 6 images is 2,166
// windows, 8,664 (window, head) problems of 49 x 49 x 32, each reading
// 9 KB; the whole launch moves ~80 MB and does ~2.5 GFLOP, so it is bound by
// launch, scheduling and occupancy (how many small blocks are in flight and
// how much of each tile is padding), not by device memory or the tensor
// cores. The design keeps each problem in one block and off device memory:
// one block per (window, head) stages K and V^T whole in shared memory
// (T <= 256, so no online softmax is needed), each warp takes 16 q rows
// against all keys at once, and nothing but q, k, v, the bias and the output
// touches device memory. T rounds up to the 16-row tile (49 -> 64,
// 196 -> 208); keys >= T are masked to -inf and their K and V rows loaded as
// zeros (a zero logit would join the softmax, and garbage times a zero
// probability can be NaN); rows >= T are computed on zeros and never stored.
// SWIN-L's T = 144 is nine 16-key tiles exactly. The mask of one window is
// read by that window's H blocks, which are launched next to each other, so
// all but the first read come from L2.
// The spatial padding of window_partition is not masked here: those tokens
// are real (zero-padded, layer-normed) keys in the model.
//
// bf16 (the model's type on the card): mma.sync m16n8k16 with f32
// accumulators, as in flash_attention.cu. f32 (the CPU-parity type, off the
// serving path): one thread per q row, FMA loops over K and V in shared
// memory with an online softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps

__device__ __forceinline__ float load_bias(const void* bias, int bias_dtype, size_t i) {
  return bias_dtype == 1 ? static_cast<const float*>(bias)[i]
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[i]);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 -> one register of two bf16, the lower-indexed element in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// q * scale rounded to bf16, for two neighbouring channels of one row
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* row, int c, bool live, float scale) {
  if (!live) return 0u;
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(row + c);
  return pack_bf16(__low2float(x) * scale, __high2float(x) * scale);
}

template <int NKT, int HD>
constexpr size_t mma_smem_bytes() {
  // ks [TP][HD+8] + vt [HD][TP+8], bf16
  return sizeof(__nv_bfloat16) * (16 * NKT * (HD + 8) + HD * (16 * NKT + 8));
}

// NKT: 16-key tiles covering T (TP = 16 * NKT >= T); HD: head dim
template <int NKT, int HD>
__global__ void __launch_bounds__(THREADS)
window_attention_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const void* __restrict__ bias, int bias_dtype,
                      const float* __restrict__ wmask, int n_wmask, __nv_bfloat16* __restrict__ o, int t,
                      int n_heads, float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int TP = 16 * NKT;
  constexpr int LDS = HD + 8;  // padded row of ks (fragment loads hit 32 banks)
  constexpr int LDV = TP + 8;  // padded row of vt
  constexpr int KD = HD / 16;  // k-steps of Q K^T
  constexpr int NS = 2 * NKT;  // 8-key tiles of S
  constexpr int ND = HD / 8;   // 8-column tiles of O
  constexpr int C8 = HD / 8;   // 16-byte chunks in a head's row

  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  __nv_bfloat16* ks = smem_bf16;     // [TP][LDS]
  __nv_bfloat16* vt = ks + TP * LDS;  // [HD][LDV], V transposed

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // mma fragment row group and column pair
  const int head = blockIdx.x % n_heads;
  const size_t win = blockIdx.x / n_heads;
  const int c = n_heads * HD;
  const size_t base = win * (size_t)t * c + (size_t)head * HD;  // row 0 of this (window, head)
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < TP * C8; i += THREADS) {
    const int r = i / C8, cc = (i % C8) * 8;
    const bool live = r < t;
    const size_t gi = base + (size_t)r * c + cc;
    *reinterpret_cast<uint4*>(ks + r * LDS + cc) = live ? *reinterpret_cast<const uint4*>(k + gi) : zero;
    const uint4 vv = live ? *reinterpret_cast<const uint4*>(v + gi) : zero;
    const uint32_t vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vt[(cc + e) * LDV + r] = __ushort_as_bfloat16((unsigned short)(vw[e / 2] >> (16 * (e % 2))));
  }
  __syncthreads();

  const size_t bias_head = (size_t)head * t * t;
  const float* mask_win = wmask == nullptr ? nullptr : wmask + (win % n_wmask) * (size_t)t * t;
  for (int rt = warp; rt < NKT; rt += THREADS / 32) {
    const int row0 = rt * 16 + g, row1 = row0 + 8;
    const bool live0 = row0 < t, live1 = row1 < t;
    const __nv_bfloat16* q0 = q + base + (size_t)row0 * c;
    const __nv_bfloat16* q1 = q + base + (size_t)row1 * c;

    // this warp's 16 q rows, scaled and rounded, as A fragments
    uint32_t qa[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qa[kk][0] = q_pair(q0, kk * 16 + 2 * tq, live0, scale);
      qa[kk][1] = q_pair(q1, kk * 16 + 2 * tq, live1, scale);
      qa[kk][2] = q_pair(q0, kk * 16 + 2 * tq + 8, live0, scale);
      qa[kk][3] = q_pair(q1, kk * 16 + 2 * tq + 8, live1, scale);
    }

    // S = Q K^T against every key of the window
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * LDS + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) mma_bf16(s[n], qa[kk], ld_pair(kr + kk * 16), ld_pair(kr + kk * 16 + 8));
    }

    // bias, window mask, key mask and row max; a row's keys live on the 4
    // lanes of one row group
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tq + (e & 1);
        const int row = (e < 2) ? row0 : row1;
        float x = s[n][e];
        if (key >= t) {
          x = -CUDART_INF_F;
        } else if (row < t) {
          if (bias_dtype != 0) x += load_bias(bias, bias_dtype, bias_head + (size_t)row * t + key);
          if (mask_win != nullptr) x += mask_win[(size_t)row * t + key];
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      // finite: a live row keeps its own key, a padded row (>= T) key 0
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - mx[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      inv[r] = 1.f / sum[r];
    }

    // P = softmax rows rounded to bf16, as A fragments of P V (two key tiles per k-step)
    uint32_t pa[NKT][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(s[n][0] * inv[0], s[n][1] * inv[0]);  // row g
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[n][2] * inv[1], s[n][3] * inv[1]);  // row g + 8
    }

    // O = P V, stored for live rows only
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* vr = vt + (n * 8 + g) * LDV + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < NKT; ++kk) mma_bf16(acc, pa[kk], ld_pair(vr + kk * 16), ld_pair(vr + kk * 16 + 8));
      const int col = n * 8 + 2 * tq;
      if (live0) *reinterpret_cast<uint32_t*>(o + base + (size_t)row0 * c + col) = pack_bf16(acc[0], acc[1]);
      if (live1) *reinterpret_cast<uint32_t*>(o + base + (size_t)row1 * c + col) = pack_bf16(acc[2], acc[3]);
    }
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

template <int NKT, int HD>
cudaError_t launch_bf16(const Args& a) {
  constexpr size_t smem = mma_smem_bytes<NKT, HD>();
  auto kernel = window_attention_bf16<NKT, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.nw * a.n_heads, THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.bias, a.bias_dtype, a.wmask, a.n_wmask,
      static_cast<__nv_bfloat16*>(a.o), a.t, a.n_heads, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16_t(const Args& a) {
  // the fewest 16-key tiles from a short ladder that cover T
  const int nkt = (a.t + 15) / 16;
  if (nkt <= 1) return launch_bf16<1, HD>(a);
  if (nkt <= 2) return launch_bf16<2, HD>(a);
  if (nkt <= 4) return launch_bf16<4, HD>(a);
  if (nkt <= 8) return launch_bf16<8, HD>(a);
  if (nkt <= 9) return launch_bf16<9, HD>(a);  // SWIN-L: T = 144
  if (nkt <= 13) return launch_bf16<13, HD>(a);
  return launch_bf16<16, HD>(a);
}

template <int HD>
cudaError_t launch_f32(const Args& a) {
  const size_t smem = sizeof(float) * 2 * (size_t)a.t * HD;
  auto kernel = window_attention_f32<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.nw * a.n_heads, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v), a.bias,
      a.bias_dtype, a.wmask, a.n_wmask, static_cast<float*>(a.o), a.t, a.n_heads, a.scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; bias_dtype: 0 = no bias, 1 = float32,
// 2 = bfloat16. q, k, v, o: (nw, t, n_heads * hd), 16-byte aligned; bias:
// (n_heads, t, t); wmask: (n_wmask, t, t) float32 with nw % n_wmask == 0, or
// null with n_wmask = 0. Returns the cudaError_t of the launch.
extern "C" int vtt_window_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                        const void* wmask, int n_wmask, void* o, int nw, int t, int n_heads, int hd,
                                        int dtype, int bias_dtype, float scale, void* stream) {
  if (nw <= 0 || t <= 0 || t > 256 || n_heads <= 0 || (long long)nw * n_heads >= (1LL << 31) ||
      (dtype != 0 && dtype != 1) || bias_dtype < 0 || bias_dtype > 2 || (bias_dtype != 0 && bias == nullptr) ||
      n_wmask < 0 || (n_wmask == 0) != (wmask == nullptr) || (n_wmask > 0 && nw % n_wmask != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, bias, bias_dtype, static_cast<const float*>(wmask), n_wmask, o, nw, t, n_heads, scale,
               static_cast<cudaStream_t>(stream)};
  if (hd != 32) return (int)cudaErrorInvalidValue;  // every TinyViT stage: 32
  return (int)(dtype == 0 ? launch_f32<32>(a) : launch_bf16_t<32>(a));
}
