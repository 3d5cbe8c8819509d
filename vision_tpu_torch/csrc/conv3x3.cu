// 3x3, stride-1, pad-1 convolution of an NHWC image with a fused epilogue,
// for Hopper (sm_90a):
//
//   acc[n, y, x, co] = sum over dy, dx in {0, 1, 2} and ci of
//                      pad1(x)[n, y + dy, x + dx, ci] * w[co, ci, dy, dx]
//   v[n, y, x, co]   = scale[co] * (acc + b[co]) + shift[co]
//   out[n, y, x, co] = r2 + s2 * act(r1 + s1 * v)
//
// Replaces the Pallas kernel `kernel` of conv_rowblock in
// scripts/exp_pallas_conv.py (launched through pl.pallas_call there), which
// computes the sum for one (1, H, W, C) image with an HWIO weight over row
// blocks whose one-row halo it fetches by async copy. Same sum, with a batch
// axis, the weight in its torch-canonical (Cout, Cin, 3, 3) layout read in
// place, and an epilogue: b, scale, shift (a fused BatchNorm), r1 and r2 are
// optional, act is the identity, leaky ReLU (x if x >= 0, else x * slope) or
// SiLU (x * sigmoid(x)), all of it in f32 on the f32 sum, rounded once to x's
// type. x is read from a channel view of a wider NHWC buffer (pixel stride
// x_ps >= Cin elements), and out, r1 and r2 are channel views too (their own
// pixel strides). Two consumers:
//   * Real-ESRGAN (models/esrgan.py): every conv of RRDBNet, 351 launches per
//     forward at scale 4 with 23 blocks, and no elementwise pass between
//     them. Its dense block runs on one buffer: conv1-4 read a channel prefix
//     and write their 32 channels after it with bias and leaky ReLU fused,
//     conv5 writes x + 0.2 * (conv + b) into the next block's buffer (act and
//     r1 are never given together there, so act may come before or after r1);
//   * YOLOv9t (models/yolov9t.py): its 112 stride-1 3x3 convs a forward, each
//     with its BatchNorm and SiLU; a RepConv's 1x1 branch comes in as r1
//     (SiLU of the branches' sum), a RepBottleneck's shortcut as r2, and the
//     ELAN blocks' convs write into channel views of their concatenation.
//
// What bounds it on this card: per conv, max(FLOPs / 989 TFLOP/s, bytes /
// 3.35 TB/s) with FLOPs = 18 * P * Cin * Cout and bytes = 2 * P * (Cin +
// Cout) in bf16 (plus the residuals read). At the RDB shapes at 1024^2 the
// four 32-wide growth convs are near balance (39-97 GFLOP over 0.2-0.4 GB),
// the 192 -> 64 conv5 is bound by the tensor cores (232 GFLOP), the
// full-resolution tail convs (64 -> 64 and 64 -> 3 at 4096^2) by bytes.
// YOLOv9t's (16 to 128 channels at 160^2 down to 20^2, batch 8) sit at or
// below balance: bytes bound the 160^2 and 80^2 ones, and the 20^2 ones are
// a few microseconds of work each, where the launch and the first tiles'
// latency weigh as much as either bound. The design, for the tensor cores
// and for one read of each input byte:
//   * wgmma m64nNk16 (N = BN = 64, 32 or 8 output channels), M = pixels: a
//     block is WGS consumer warpgroups, each walking its own tiles of 4 ROWS
//     x 16 pixels; warp w of a warpgroup owns output rows w ROWS .. w ROWS +
//     ROWS - 1 of the tile, so m64 tile t holds row t of each warp (16
//     pixels a warp, mma.sync's A fragment layout). The tap shift puts a
//     16-pixel row at an odd place inside the 18-pixel halo row, which a
//     shared-memory descriptor cannot address, so A comes from registers:
//     ldmatrix from the staged halo tile. A warp loads its ROWS + 2 halo
//     rows once per (dx, channel chunk) and uses each for up to 3 of its
//     (row, dy) products: 6 ldmatrix for 12 wgmma at ROWS 4;
//   * B is the weight in shared memory behind a descriptor (K-major, no
//     swizzle: 8 x 16-byte core matrices). The grid is persistent (one block
//     per SM), and each block stages its output channels' whole weight once
//     per conv, in the order the descriptors read it, while the first halo
//     tiles are in flight. conv5's weight (221 KB) does not fit beside the
//     halo ring, so it is split in two halves of 32 output channels, taken
//     by neighbouring blocks walking the same tiles (their halo reads meet
//     in L2);
//   * the halo tile ((4 ROWS + 2) x 18 pixels, 16 channels) arrives by TMA:
//     one producer warp, one lane of it issuing a 4-D box copy per (tile,
//     channel chunk) into a STAGES-deep ring per warpgroup, completing on the
//     stage's "full" mbarrier; the consumers read it with ldmatrix and free
//     it on its "empty" mbarrier. The box's out-of-bounds zero fill is the
//     image border and the channels past Cin; its 32-byte swizzle keeps the
//     ldmatrix rows conflict-free. So the consumers issue no loads and wait
//     at no block barrier. A view TMA cannot take (the stem's Cin 3: pixels
//     6 bytes apart) is copied by the producer warp element by element;
//   * two or three A register sets (SETS) keep one or two wgmma groups in
//     flight while the next set loads;
//   * the epilogue runs on the accumulator fragments in registers: the bias,
//     scale and shift (staged as f32), the activation, r1 and r2 read in the store's fragment
//     layout (4-byte pairs where base and stride allow, each 8-pixel group's
//     loads issued together), one rounding.
// The configurations (BN, ROWS, WGS, STAGES, SETS) by output width are at
// launch_bf16_any: three consumer warpgroups with a 3-deep ring each (the
// last conv: two, 4-deep).
// Every offset into x, out, r1 and r2 is computed in 64 bits: a batch of four
// 1024^2 requests runs (4, 4096, 4096, 64) tensors of 4.3e9 elements.
//
// f32 (the CPU-parity type, off the serving path): one thread per output
// pixel, FMA loops over 32 output channels, with the same epilogue and views.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int TW = 16, HC = TW + 2;      // output tile width; the halo tile's
constexpr int KC = 16;                   // input channels per ring stage (one k16 step)
constexpr int PIX = KC * 2;              // bytes of a staged halo pixel
constexpr int SMEM_CAP = 232448;         // a block's shared memory on Hopper

struct Args {
  const void* x;
  long long x_ps;  // pixel stride of x, elements
  const void* w;
  const void* b;   // (cout) in x's type, or null
  const void* scale;  // (cout) in x's type, or null: a fused BatchNorm's weight
  const void* shift;  // (cout) in x's type, or null: its bias
  void* out;
  long long o_ps;
  const void* r1;  // residuals of out's shape, or null
  long long r1_ps;
  const void* r2;
  long long r2_ps;
  float s1, s2, slope;
  int act;         // 0: identity, 1: leaky ReLU with slope, 2: SiLU
  int n, h, wd, cin, cout;
  int tiles_x, tiles_y;
  long long tiles;  // n * tiles_y * tiles_x
  int tma;          // x by TMA: cin >= 16, x_ps a multiple of 8, x 16-byte aligned
  int wvec;         // w in 16-byte chunks: cin a multiple of 8, w 16-byte aligned
  int pairs;        // out, r1, r2 as 4-byte pairs: cout and strides even, bases 4-byte aligned
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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
// wait until the phase of the given parity has completed; a wait of more
// than ~2^32 cycles (a copy or an arrival that never comes) traps, so a
// fault ends the launch with an error instead of hanging the card. The loop
// lives inside the asm: as C++ its data-dependent exit would put the wgmma
// after it on a path the compiler takes for divergent, and serialize them
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4294967296;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// where 16-byte half h of halo pixel p sits in a stage: TMA's 32-byte
// swizzle (address bit 4 ^= bit 7; the stages are 1024-byte aligned), so
// the 8 rows of an ldmatrix (8 neighbouring pixels, one half) meet no bank
// twice
__device__ __forceinline__ uint32_t halo_byte(int p, int h) { return (uint32_t)(p * PIX + 16 * (h ^ ((p >> 2) & 1))); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads of an accumulator above wgmma_wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma's shared-memory descriptor, no swizzle: start address, leading byte
// offset (between the two 8-element core matrices along K) and stride byte
// offset (between 8-row groups along N), in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d = A (64 x 16, registers) * B (16 x N, K-major in shared memory), plus d
// itself unless acc_in is 0. An
// m64nN accumulator holds N/2 floats a thread: float i of warp w, lane l
// sits at row 16w + l/4 (+8 for i % 4 >= 2), column 8(i/4) + 2(l%4) + i%2.
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t db, int acc_in) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc_in));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc_in) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc_in));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc_in) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc_in));
}

// SILU: the kernel instance takes act 2, SiLU by the fast exponential and
// reciprocal (MUFU: no division subroutine to hold registers beside the
// accumulators); the relative error is ~1e-6 at |v| ~ 20, and v * 0 where
// e^-v overflows
template <bool SILU>
__device__ __forceinline__ float act(float v, const Args& a) {
  if (a.act == 1) return !(v >= 0.f) ? v * a.slope : v;
  if constexpr (SILU) {
    if (a.act == 2) return __fdividef(v, 1.f + __expf(-v));
  }
  return v;
}

// ---------------------------------------------------------------------------
// bf16: persistent wgmma kernel, TMA halo ring
// ---------------------------------------------------------------------------

// A bf16 launch configuration: BN output channels per block, ROWS output
// rows per warp (a warpgroup's tile is 4 ROWS x 16 pixels, ROWS m64 tiles),
// WGS consumer warpgroups per block (and one producer warp), a STAGES-deep
// halo ring per warpgroup, SETS A register sets (one per dx, or two where
// the accumulators leave no room)
template <int BN_, int ROWS_, int WGS_, int STAGES_, int SETS_>
struct Cfg {
  static constexpr int BN = BN_, ROWS = ROWS_, WGS = WGS_, STAGES = STAGES_, SETS = SETS_;
  static constexpr int TH = 4 * ROWS, HR = TH + 2, CONSUMERS = 128 * WGS, THREADS = CONSUMERS + 32;
  static constexpr int TILE_BYTES = HR * HC * PIX;                   // one halo box
  static constexpr int STAGE_BYTES = (TILE_BYTES + 1023) / 1024 * 1024;
  static constexpr int RING_BYTES = WGS * STAGES * STAGE_BYTES;
  __host__ __device__ static constexpr size_t weight_bytes(int kch) { return (size_t)kch * 9 * KC * BN * 2; }
  // 1024 bytes of slack to align the ring; the ring, the weight, the f32
  // bias, scale and shift, the full and empty barriers
  static constexpr size_t smem_bytes(int kch) {
    return 1024 + RING_BYTES + weight_bytes(kch) + 3 * BN * 4 + 2 * WGS * STAGES * 8;
  }
};

// `splits` blocks side by side cover ceil(cout / BN) * BN channels, block b
// taking split b % splits. BNS: the instance with the scale, the shift and
// SiLU (YOLOv9t's); without them (Real-ESRGAN's) the epilogue keeps the
// registers and instructions it had before they came
template <class C, bool BNS>
__global__ void __launch_bounds__(C::THREADS, 1)
    conv3x3_bf16(const __grid_constant__ CUtensorMap xmap, const Args a, int splits) {
  constexpr int BN = C::BN, ROWS = C::ROWS, WGS = C::WGS, STAGES = C::STAGES, SETS = C::SETS;
  constexpr int TH = C::TH, HR = C::HR, CONSUMERS = C::CONSUMERS, STAGE_BYTES = C::STAGE_BYTES;
  constexpr int NA = BN / 2;  // accumulator floats a thread per m64 tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kch = (a.cin + KC - 1) / KC;
  // ring [warpgroup][stage]; weight [chunk][tap][k half][out channel][8 in
  // channels]: the B operand of (chunk, tap) is 2 * BN rows of 16 bytes, its
  // K halves BN * 16 bytes apart
  const uint32_t ring = smem_u32(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + C::RING_BYTES);
  float* bs = reinterpret_cast<float*>(smem + C::RING_BYTES + C::weight_bytes(kch));
  float* ss = bs + BN;  // the scale, 1 where none is given
  float* hs = ss + BN;  // the shift, 0 where none is given
  const uint32_t bars = smem_u32(hs + BN);
  auto full = [&](int w, int st) { return bars + (uint32_t)((w * STAGES + st) * 8); };
  auto empty = [&](int w, int st) { return bars + (uint32_t)(((WGS + w) * STAGES + st) * 8); };

  const int tid = threadIdx.x;
  const int split = blockIdx.x % splits;
  const int co0 = split * BN;
  // tiles < 2^31 (the entry point checks): 32-bit tile and step counts
  const int per_split = gridDim.x / splits;
  const int first0 = (blockIdx.x / splits) * WGS;  // warpgroup w's first tile is first0 + w
  const int stride = per_split * WGS;
  const int tiles_img = a.tiles_x * a.tiles_y;
  // ring steps of warpgroup w: (tile, channel chunk), tile-major
  auto steps = [&](int w) {
    const int f = first0 + w;
    return f < a.tiles ? ((int)((a.tiles - 1 - f) / stride) + 1) * kch : 0;
  };

  if (tid == 0) {
    for (int w = 0; w < WGS; ++w)
      for (int st = 0; st < STAGES; ++st) {
        mbar_init(full(w, st), a.tma ? 1 : 32);  // TMA: one arrival and the bytes; else the producer's lanes
        mbar_init(empty(w, st), 128);           // every thread of the warpgroup
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warp index, shuffled so the compiler sees the branch below uniform
  if (__shfl_sync(0xffffffffu, tid / 32, 0) == CONSUMERS / 32) {
    // the producer warp: every warpgroup's halo tiles in step order, each
    // into its ring once the consumers have freed the stage
    const int lane = tid % 32;
    if (a.tma && lane != 0) return;
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
    const int most = steps(0);  // warpgroup 0 has the most
    for (int s = 0; s < most; ++s) {
      const int st = s % STAGES;
      for (int w = 0; w < WGS; ++w) {
        if (s >= steps(w)) continue;
        if (s >= STAGES) mbar_wait(empty(w, st), (s / STAGES - 1) & 1);
        const int tile = first0 + w + (s / kch) * stride, c0 = (s % kch) * KC;
        const int x0 = (tile % a.tiles_x) * TW, y0 = ((tile % tiles_img) / a.tiles_x) * TH;
        const int img = tile / tiles_img;
        const uint32_t dst = ring + (uint32_t)((w * STAGES + st) * STAGE_BYTES);
        if (a.tma) {
          mbar_expect_tx(full(w, st), C::TILE_BYTES);
          tma_load(dst, &xmap, full(w, st), c0, x0 - 1, y0 - 1, img);
        } else {
          // element by element, four 16-byte halves of halo pixels a lane
          // in flight at once
          constexpr int UNITS = HR * HC * 2, BATCH = 4;
#pragma unroll 1
          for (int i0 = 0; i0 < UNITS; i0 += 32 * BATCH) {
          uint32_t v[BATCH][4];
#pragma unroll
          for (int k = 0; k < BATCH; ++k) {
            const int i = i0 + lane + 32 * k, pix = i >> 1, half = i & 1;
            const int gy = y0 - 1 + pix / HC, gx = x0 - 1 + pix % HC, c = c0 + half * 8;
            const bool inside = i < UNITS && gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd;
            const __nv_bfloat16* src = x + (inside ? (((size_t)img * a.h + gy) * a.wd + gx) * (size_t)a.x_ps : 0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t lo = inside && c + 2 * e < a.cin ? __bfloat16_as_ushort(src[c + 2 * e]) : 0u;
              const uint32_t hi = inside && c + 2 * e + 1 < a.cin ? __bfloat16_as_ushort(src[c + 2 * e + 1]) : 0u;
              v[k][e] = lo | (hi << 16);
            }
          }
#pragma unroll
          for (int k = 0; k < BATCH; ++k) {
            const int i = i0 + lane + 32 * k;
            if (i < UNITS)
              asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + halo_byte(i >> 1, i & 1)),
                           "r"(v[k][0]), "r"(v[k][1]), "r"(v[k][2]), "r"(v[k][3])
                           : "memory");
          }
          }
          mbar_arrive(full(w, st));
        }
      }
    }
    return;
  }

  // the consumers: stage the weight, the bias, the scale and the shift once,
  // then multiply
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  const int row = a.cin * 9;  // weight elements per output channel
  auto put = [&](int n, int idx, __nv_bfloat16 v) {
    const int ci = idx / 9, tap = idx % 9;
    ws[((((ci / KC) * 9 + tap) * 2 + (ci % KC) / 8) * BN + n) * 8 + ci % 8] = v;
  };
  auto consumers_sync = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(C::CONSUMERS) : "memory"); };
  if (a.cin % KC != 0 || co0 + BN > a.cout) {  // padding rows and channels stay zero
    uint4* z = reinterpret_cast<uint4*>(ws);
    for (int i = tid; i < (int)(C::weight_bytes(kch) / 16); i += CONSUMERS) z[i] = make_uint4(0, 0, 0, 0);
    consumers_sync();
  }
  if (a.wvec) {
    const int units = row / 8;
    for (int i = tid; i < BN * units; i += CONSUMERS) {
      const int n = i / units, e0 = (i % units) * 8;
      if (co0 + n >= a.cout) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(w + (size_t)(co0 + n) * row + e0);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) put(n, e0 + e, __ushort_as_bfloat16((unsigned short)(words[e / 2] >> (16 * (e % 2)))));
    }
  } else {
    for (int i = tid; i < BN * row; i += CONSUMERS) {
      const int n = i / row;
      if (co0 + n < a.cout) put(n, i % row, w[(size_t)(co0 + n) * row + i % row]);
    }
  }
  for (int i = tid; i < BN; i += CONSUMERS) {
    const bool live = co0 + i < a.cout;
    auto vec = [&](const void* v, float none) {
      return live && v != nullptr ? __bfloat162float(static_cast<const __nv_bfloat16*>(v)[co0 + i]) : none;
    };
    bs[i] = vec(a.b, 0.f);
    if constexpr (BNS) {
      ss[i] = vec(a.scale, 1.f);
      hs[i] = vec(a.shift, 0.f);
    }
  }
  consumers_sync();

  // the warpgroup index, shuffled so the compiler sees it uniform: every
  // loop bound below follows from it, and wgmma must not sit on a path the
  // compiler takes for divergent (it would serialize them)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (tid % 128) / 32, 0), lane = tid % 32;
  float acc[ROWS][NA];  // each tile's first products overwrite it (acc_in 0)
  // A fragments of the warp's halo rows: one set per dx, or two, dx 2
  // taking set 0 again
  static_assert(SETS == 2 || SETS == 3, "two or three A register sets");
  uint32_t af[SETS][ROWS + 2][4];
  const uint32_t ws_u32 = smem_u32(ws);
  const int g = lane / 4, tq = lane % 4;
  const int total = steps(wg);

  int tile = first0 + wg, c = 0;  // the step being multiplied
  for (int s = 0; s < total; ++s) {
    const int st = s % STAGES;
    mbar_wait(full(wg, st), (s / STAGES) & 1);  // step s's halo chunk has landed
    const uint32_t stage = ring + (uint32_t)((wg * STAGES + st) * STAGE_BYTES);
    // one k16 chunk at column shift dx: its A set loaded, then 12 products
    auto shift = [&](auto dx_t) {
      constexpr int dx = decltype(dx_t)::value, k = dx % SETS;
      // the group that last read set k must be done: with three sets it is
      // the previous step's dx, two groups back; with two, set 0 was last
      // read by the previous step's dx 2 (no group since) or this step's
      // dx 0 (one since), set 1 by the previous step's dx 1 (two since)
      if constexpr (SETS == 3 || dx == 1) {
        wgmma_wait<2>();
      } else if constexpr (dx == 0) {
        wgmma_wait<0>();
      } else {
        wgmma_wait<1>();
      }
      // lane l addresses pixel (l % 16) + dx, 16-byte half l / 16
#pragma unroll
      for (int j = 0; j < ROWS + 2; ++j)
        ldmatrix_x4(af[k][j], stage + halo_byte((warp * ROWS + j) * HC + (lane & 15) + dx, lane >> 4));
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint64_t db = smem_desc(ws_u32 + (uint32_t)((c * 9 + dy * 3 + dx) * 2 * BN * 16), BN * 16, 128);
#pragma unroll
        for (int t = 0; t < ROWS; ++t) wgmma_rs(acc[t], af[k][t + dy], db, c + dx + dy > 0);
      }
      wgmma_commit();
    };
    shift(std::integral_constant<int, 0>{});
    shift(std::integral_constant<int, 1>{});
    shift(std::integral_constant<int, 2>{});
    // every ldmatrix of the step has delivered (the wgmma took its
    // registers): the stage is free for the producer
    mbar_arrive(empty(wg, st));
    if (++c < kch) continue;

    // the tile is complete: the epilogue on the fragments, one rounding
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < ROWS; ++t) pin(acc[t]);
    const int x0 = (tile % a.tiles_x) * TW;
    const int y0 = ((tile % tiles_img) / a.tiles_x) * TH;
    const size_t img = (size_t)(tile / tiles_img);
    c = 0;
    tile += stride;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
    const __nv_bfloat16* r1 = static_cast<const __nv_bfloat16*>(a.r1);
    const __nv_bfloat16* r2 = static_cast<const __nv_bfloat16*>(a.r2);
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const int y = y0 + warp * ROWS + t;
      if (a.pairs) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int px = x0 + g + 8 * rh;
          const size_t pix = (img * a.h + y) * a.wd + px;
          // the residuals of these 8 pixels first, all loads in flight at
          // once (out may alias r2, so a load after a store would wait)
          uint32_t rv1[BN / 8], rv2[BN / 8];
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int co = co0 + 8 * j + 2 * tq;
            const bool live = y < a.h && px < a.wd && co < a.cout;
            rv1[j] = live && r1 != nullptr ? *reinterpret_cast<const uint32_t*>(r1 + pix * a.r1_ps + co) : 0u;
            rv2[j] = live && r2 != nullptr ? *reinterpret_cast<const uint32_t*>(r2 + pix * a.r2_ps + co) : 0u;
          }
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int cl = 8 * j + 2 * tq, co = co0 + cl;
            if (y >= a.h || px >= a.wd || co >= a.cout) continue;
            float v0 = acc[t][4 * j + 2 * rh] + bs[cl];
            float v1 = acc[t][4 * j + 2 * rh + 1] + bs[cl + 1];
            if constexpr (BNS) {
              v0 = fmaf(ss[cl], v0, hs[cl]);
              v1 = fmaf(ss[cl + 1], v1, hs[cl + 1]);
            }
            if (r1 != nullptr) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv1[j]));
              v0 = fmaf(a.s1, v0, f.x);
              v1 = fmaf(a.s1, v1, f.y);
            }
            v0 = act<BNS>(v0, a);
            v1 = act<BNS>(v1, a);
            if (r2 != nullptr) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv2[j]));
              v0 = fmaf(a.s2, v0, f.x);
              v1 = fmaf(a.s2, v1, f.y);
            }
            *reinterpret_cast<__nv_bfloat162*>(out + pix * a.o_ps + co) = __floats2bfloat162_rn(v0, v1);
          }
        }
      } else {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int px = x0 + g + 8 * rh;
          const size_t pix = (img * a.h + y) * a.wd + px;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int cl = 8 * j + 2 * tq, co = co0 + cl;
            if (y >= a.h || px >= a.wd || co >= a.cout) continue;
            const bool two = co + 1 < a.cout;
            float v0 = acc[t][4 * j + 2 * rh] + bs[cl];
            float v1 = acc[t][4 * j + 2 * rh + 1] + bs[cl + 1];
            if constexpr (BNS) {
              v0 = fmaf(ss[cl], v0, hs[cl]);
              v1 = fmaf(ss[cl + 1], v1, hs[cl + 1]);
            }
            if (r1 != nullptr) {
              v0 = fmaf(a.s1, v0, __bfloat162float(r1[pix * a.r1_ps + co]));
              if (two) v1 = fmaf(a.s1, v1, __bfloat162float(r1[pix * a.r1_ps + co + 1]));
            }
            v0 = act<BNS>(v0, a);
            v1 = act<BNS>(v1, a);
            if (r2 != nullptr) {
              v0 = fmaf(a.s2, v0, __bfloat162float(r2[pix * a.r2_ps + co]));
              if (two) v1 = fmaf(a.s2, v1, __bfloat162float(r2[pix * a.r2_ps + co + 1]));
            }
            __nv_bfloat16* o = out + pix * a.o_ps + co;
            o[0] = __float2bfloat16_rn(v0);
            if (two) o[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA kernel, one thread per output pixel
// ---------------------------------------------------------------------------

constexpr int F32_BN = 32;   // output channels per block
constexpr int F32_TH = 16, F32_HR = F32_TH + 2;  // output tile 16 x 16, one thread a pixel
constexpr int LDF = KC + 1;  // padded f32 row of a staged pixel

__global__ void __launch_bounds__(256) conv3x3_f32(const Args a) {
  __shared__ float xs[F32_HR * HC * LDF];    // [halo pixel][channel]
  __shared__ float ws[9 * KC * F32_BN];  // [tap][in channel][out channel]

  const float* x = static_cast<const float*>(a.x);
  const float* wt = static_cast<const float*>(a.w);
  const int tid = threadIdx.x;
  const int r = tid / TW, c = tid % TW;  // this thread's pixel in the tile
  const int tile = blockIdx.x;
  const int x0 = (tile % a.tiles_x) * TW;
  const int y0 = ((tile / a.tiles_x) % a.tiles_y) * F32_TH;
  const size_t img_base = (size_t)(tile / (a.tiles_x * a.tiles_y)) * a.h * a.wd;
  const int co0 = blockIdx.y * F32_BN;

  float acc[F32_BN];
#pragma unroll
  for (int n = 0; n < F32_BN; ++n) acc[n] = 0.f;

  for (int kc = 0; kc < a.cin; kc += KC) {
    __syncthreads();
    for (int i = tid; i < F32_HR * HC * KC; i += 256) {
      const int pix = i / KC, k = i % KC;
      const int gy = y0 - 1 + pix / HC, gx = x0 - 1 + pix % HC;
      const bool live = gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd && kc + k < a.cin;
      xs[pix * LDF + k] = live ? x[(img_base + (size_t)gy * a.wd + gx) * a.x_ps + kc + k] : 0.f;
    }
    for (int i = tid; i < F32_BN * KC * 9; i += 256) {
      const int n = i / (KC * 9), rem = i % (KC * 9);
      const int k = rem / 9, tap = rem % 9;
      const int co = co0 + n, ci = kc + k;
      ws[(tap * KC + k) * F32_BN + n] = (co < a.cout && ci < a.cin) ? wt[((size_t)co * a.cin + ci) * 9 + tap] : 0.f;
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
  if (y >= a.h || px >= a.wd) return;
  const size_t pix = img_base + (size_t)y * a.wd + px;
  const float* b = static_cast<const float*>(a.b);
  const float* sc = static_cast<const float*>(a.scale);
  const float* sh = static_cast<const float*>(a.shift);
  const float* r1 = static_cast<const float*>(a.r1);
  const float* r2 = static_cast<const float*>(a.r2);
  float* o = static_cast<float*>(a.out) + pix * a.o_ps;
#pragma unroll
  for (int n = 0; n < F32_BN; ++n) {
    const int co = co0 + n;
    if (co >= a.cout) continue;
    float v = fmaf(sc != nullptr ? sc[co] : 1.f, acc[n] + (b != nullptr ? b[co] : 0.f), sh != nullptr ? sh[co] : 0.f);
    if (r1 != nullptr) v = fmaf(a.s1, v, r1[pix * a.r1_ps + co]);
    v = act<true>(v, a);
    if (r2 != nullptr) v = fmaf(a.s2, v, r2[pix * a.r2_ps + co]);
    o[co] = v;
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

// x as a 4-D (channel, column, row, image) tensor read in halo boxes of 16
// channels x 18 columns x `rows` rows, 32-byte swizzled; what lies outside
// (the border, channels past cin) reads as zeros
cudaError_t halo_map(CUtensorMap* map, const Args& a, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t ps = (cuuint64_t)a.x_ps * 2;  // bytes
  const cuuint64_t dims[4] = {(cuuint64_t)a.cin, (cuuint64_t)a.wd, (cuuint64_t)a.h, (cuuint64_t)a.n};
  const cuuint64_t strides[3] = {ps, ps * a.wd, ps * a.wd * a.h};
  const cuuint32_t box[4] = {(cuuint32_t)KC, (cuuint32_t)HC, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(a.x), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class C, bool BNS>
cudaError_t launch_bf16(Args a, cudaStream_t stream) {
  const int kch = (a.cin + KC - 1) / KC;
  const size_t smem = C::smem_bytes(kch);
  a.tiles_y = (a.h + C::TH - 1) / C::TH;
  a.tiles = (long long)a.n * a.tiles_y * a.tiles_x;
  if (a.tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof xmap);
  cudaError_t err = a.tma ? halo_map(&xmap, a, C::HR) : cudaSuccess;
  if (err != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(conv3x3_bf16<C, BNS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const int splits = (a.cout + C::BN - 1) / C::BN;
  // one block per SM, as many as the tiles need, the same count per split
  long long per_split = sms / splits > 0 ? sms / splits : 1;
  const long long needed = (a.tiles + C::WGS - 1) / C::WGS;
  if (per_split > needed) per_split = needed;
  conv3x3_bf16<C, BNS><<<(unsigned)(per_split * splits), C::THREADS, smem, stream>>>(xmap, a, splits);
  return cudaGetLastError();
}

template <class C>
bool fits(int kch) {
  return C::smem_bytes(kch) <= SMEM_CAP;
}

// The configurations, by output width, each the fastest of those timed on an
// H100 at its shapes: Cout <= 8 (the last conv); <= 32 (the growth convs);
// <= 64 (the stem and the 64 -> 64 convs: 8-row tiles); else, or where a
// weight does not fit beside those rings (conv5's 192 channels), 32-channel
// splits. Three consumer warpgroups and the producer warp are 13 warps, 4
// of them on one of the SM's four 16K-register files: 128 registers a
// thread, and ptxas serializes some wgmma for want of more. Still they were
// the fastest: four warpgroups (102 registers) serialize more, two leave
// the tensor cores idle through each warpgroup's epilogue, and issuing the
// copies from the consumer warpgroups instead of a producer warp (12 warps,
// 168 registers) put the wgmma on a divergent path.
using Last = Cfg<8, 4, 2, 4, 3>;
using Growth = Cfg<32, 4, 3, 3, 2>;
using Split = Cfg<32, 4, 3, 3, 2>;
using Wide = Cfg<64, 2, 3, 3, 3>;

template <bool BNS>
cudaError_t launch_bf16_any(const Args& a, cudaStream_t s) {
  const int kch = (a.cin + KC - 1) / KC;
  if (a.cout <= 8 && fits<Last>(kch)) return launch_bf16<Last, BNS>(a, s);
  if (a.cout <= 32 && fits<Growth>(kch)) return launch_bf16<Growth, BNS>(a, s);
  if (a.cout > 32 && a.cout <= 64 && fits<Wide>(kch)) return launch_bf16<Wide, BNS>(a, s);
  if (fits<Split>(kch)) return launch_bf16<Split, BNS>(a, s);
  if (fits<Last>(kch)) return launch_bf16<Last, BNS>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: a (n, h, wd, cin) view whose pixels
// are x_ps elements apart (rows and images packed); w: (cout, cin, 3, 3)
// contiguous; b, scale, shift: (cout) or null; out, r1, r2: (n, h, wd, cout)
// views with pixel strides o_ps, r1_ps, r2_ps (r1, r2 may be null); act 1
// applies leaky ReLU with `slope`, act 2 SiLU, after r1 and before r2.
// Returns the cudaError_t of the launch.
extern "C" int vtt_conv3x3_fwd(const void* x, long long x_ps, const void* w, const void* b, const void* scale,
                               const void* shift, void* out, long long o_ps, const void* r1, long long r1_ps,
                               float s1, const void* r2, long long r2_ps, float s2, int act, float slope, int n,
                               int h, int wd, int cin, int cout, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || (dtype != 0 && dtype != 1) || act < 0 || act > 2 ||
      x_ps < cin || o_ps < cout || (r1 != nullptr && r1_ps < cout) || (r2 != nullptr && r2_ps < cout))
    return (int)cudaErrorInvalidValue;
  // the f32 kernel's 16-row tiles; a bf16 launch redoes tiles_y for its own
  const int tiles_x = (wd + TW - 1) / TW, tiles_y = (h + F32_TH - 1) / F32_TH;
  const long long tiles = (long long)n * tiles_y * tiles_x;
  if (tiles >= (1LL << 31) || (long long)cout * cin * 9 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t esz = dtype == 0 ? 4 : 2;
  auto aligned = [](const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; };
  const bool pairs = cout % 2 == 0 && aligned(out, 2 * esz) && o_ps % 2 == 0 &&
                     (r1 == nullptr || (aligned(r1, 2 * esz) && r1_ps % 2 == 0)) &&
                     (r2 == nullptr || (aligned(r2, 2 * esz) && r2_ps % 2 == 0));
  const Args a{x, x_ps, w, b, scale, shift, out, o_ps, r1, r1_ps, r2, r2_ps, s1, s2, slope, act, n, h, wd, cin, cout,
               tiles_x, tiles_y, tiles,
               (int)(cin >= KC && x_ps % 8 == 0 && aligned(x, 16)),
               (int)(cin % 8 == 0 && aligned(w, 16)), (int)pairs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((unsigned)tiles, (unsigned)((cout + F32_BN - 1) / F32_BN));
    conv3x3_f32<<<grid, 256, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const bool bns = scale != nullptr || shift != nullptr || act == 2;
  return (int)(bns ? launch_bf16_any<true>(a, s) : launch_bf16_any<false>(a, s));
}
