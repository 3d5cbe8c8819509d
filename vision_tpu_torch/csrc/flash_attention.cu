// Fused mask-free attention, softmax(q k^T * scale) v, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _attn_kernel in
// vision_tpu/ops/pallas/flash_attention.py (launched by _flash_attention
// through pl.pallas_call). Same contract: q (BH, Tq, D), k and v (BH, Tk, D),
// contiguous, no mask, non-causal, Tq may differ from Tk; logits and softmax
// statistics in f32, the probabilities rounded to the input type before the
// PV product (the Pallas body casts p to v's dtype), PV accumulated in f32,
// output in the input type.
//
// The Pallas kernel keeps a whole K/V row in VMEM. On this card a block has
// 227 KB of shared memory, and the row of the Depth-Anything slice
// (1888 keys x 64 x 2 B, twice) is 483 KB, so both kernels below tile K/V
// and keep an online softmax instead: one block per (64-row q tile, b*h);
// the block walks 64-key K/V tiles, keeps a running row max and row sum in
// f32, rescales its f32 output accumulator whenever the max moves, and
// divides once at the end. Ragged keys are masked to -inf (a zero logit
// would join the softmax) and their V rows loaded as zeros; ragged q rows
// are computed on zeros and never stored.
//
// bf16 (the model's type on the card): tensor cores through mma.sync
// m16n8k16 with f32 accumulators. Four warps own 16 q rows each; Q's
// fragments stay in registers for the whole walk, K and V^T tiles are staged
// in shared memory (rows padded by 8 elements so fragment loads hit 32
// distinct banks), and S's accumulators turn into P's A fragments in
// registers, never touching shared memory. At D = 64 that is ~2 x 64 x 64
// FLOP per byte of K/V staged, so the kernel is bound by the shared-memory
// loads of B fragments and by the softmax's exp/shuffle work between the two
// products (nothing overlaps the next tile's loads with this tile's math),
// not by device memory: the 64-row q tiles re-read their head's K/V
// ceil(Tq/64) times, mostly from the 50 MB L2. wgmma, TMA and warp
// specialisation are later work.
//
// f32 (the CPU-parity type, off the serving path): plain FMA loops over f32
// tiles in shared memory (4x4 register tiles per thread, 16-byte shared
// loads), bound by shared-memory bandwidth and FMA issue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // keys per K/V tile

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 q rows

template <int D>
constexpr size_t mma_smem_bytes() {
  // qs [BQ][D+8] + ks [BK][D+8] + vt [D][BK+8], bf16
  return sizeof(__nv_bfloat16) * (BQ * (D + 8) + BK * (D + 8) + D * (BK + 8));
}

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

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int tq,
                         int tk, float scale) {
  static_assert(D % 16 == 0 && D >= 32 && D <= 128, "head dim must be 32, 64 or 128");
  constexpr int LDS = D + 8;   // padded row of qs and ks
  constexpr int LDV = BK + 8;  // padded row of vt
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int NS = BK / 8;   // key tiles of S
  constexpr int ND = D / 8;    // column tiles of O
  constexpr int C8 = D / 8;    // 16-byte chunks in a row

  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  __nv_bfloat16* qs = smem_bf16;    // [BQ][LDS]
  __nv_bfloat16* ks = qs + BQ * LDS;  // [BK][LDS]
  __nv_bfloat16* vt = ks + BK * LDS;  // [D][LDV], V transposed

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group and column pair
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qg = q + bh * (size_t)tq * D;
  const __nv_bfloat16* kg = k + bh * (size_t)tk * D;
  const __nv_bfloat16* vg = v + bh * (size_t)tk * D;
  __nv_bfloat16* og = o + bh * (size_t)tq * D;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < BQ * C8; i += MMA_THREADS) {
    const int r = i / C8, c = (i % C8) * 8;
    *reinterpret_cast<uint4*>(qs + r * LDS + c) =
        (q0 + r < tq) ? *reinterpret_cast<const uint4*>(qg + (size_t)(q0 + r) * D + c) : zero;
  }
  __syncthreads();

  // this warp's 16 q rows as A fragments, for every k-step
  uint32_t qa[KD][4];
  const __nv_bfloat16* qw = qs + warp * 16 * LDS;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    qa[kk][0] = ld_pair(qw + g * LDS + kk * 16 + 2 * t);
    qa[kk][1] = ld_pair(qw + (g + 8) * LDS + kk * 16 + 2 * t);
    qa[kk][2] = ld_pair(qw + g * LDS + kk * 16 + 2 * t + 8);
    qa[kk][3] = ld_pair(qw + (g + 8) * LDS + kk * 16 + 2 * t + 8);
  }

  // rows g (index 0) and g + 8 (index 1) of this warp's 16
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * C8; i += MMA_THREADS) {
      const int r = i / C8, c = (i % C8) * 8;
      const bool live = k0 + r < tk;
      const size_t gi = (size_t)(k0 + r) * D + c;
      *reinterpret_cast<uint4*>(ks + r * LDS + c) = live ? *reinterpret_cast<const uint4*>(kg + gi) : zero;
      const uint4 vv = live ? *reinterpret_cast<const uint4*>(vg + gi) : zero;
      const uint32_t vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        vt[(c + e) * LDV + r] = __ushort_as_bfloat16((unsigned short)(vw[e / 2] >> (16 * (e % 2))));
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) mma_bf16(s[n], qa[kk], ld_pair(kr + kk * 16), ld_pair(kr + kk * 16 + 8));
    }

    // online softmax; a row's keys live on the 4 lanes of one row group
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = key < tk ? s[n][e] * scale : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: every tile holds a live key
      alpha[r] = __expf(m[r] - m_new);         // 0 on the first tile
      m[r] = m_new;
    }
    // P, rounded to bf16, as A fragments of P V (two key tiles per k-step)
    uint32_t pa[NS / 2][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = __expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += p[e];
      }
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(p[0], p[1]);  // row g
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);  // row g + 8
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }

    // O = O * alpha + P V
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
      const __nv_bfloat16* vr = vt + (n * 8 + g) * LDV + 2 * t;
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) mma_bf16(acc[n], pa[kk], ld_pair(vr + kk * 16), ld_pair(vr + kk * 16 + 8));
    }
  }

  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= tq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(og + (size_t)row * D + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
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

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const void* q, const void* k, const void* v,
                   void* o, int bh, int tq, int tk, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(o), tq, tk, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, void* o, int bh, int tq, int tk,
                     float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_attention_fwd_f32<D>, FMA_THREADS, fma_smem_bytes<D>(), q, k, v, o, bh, tq, tk,
                         scale, stream);
  return launch<__nv_bfloat16>(flash_attention_fwd_bf16<D>, MMA_THREADS, mma_smem_bytes<D>(), q, k, v, o, bh,
                               tq, tk, scale, stream);
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
