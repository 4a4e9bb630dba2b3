// Fused ResNet stem for Hopper (sm_90a), plain C interface:
// conv 7x7 / stride 2 / pad 3 (3 -> 64 channels), + folded frozen-BN bias,
// ReLU, then maxpool 3x3 / stride 2 / pad 1, in one kernel.
//
// Replaces clipbert_tpu/ops/pallas_stem.py::fused_stem_pool (body
// `_stem_kernel`) with the same arithmetic: the 147 taps summed in fp32 over
// the input widened to fp32 and the weights rounded to the input dtype,
// + bias, ReLU, max over the pool window, one rounding to the output dtype.
// Zero pool padding equals the reference's -inf padding only because the
// pool runs after ReLU (every value >= 0) and every window holds at least
// one real conv output (clipbert_tpu/ops/pallas_stem.py:37-39): conv
// positions outside the image are set to 0, never to relu(bias).
//
// The TPU kernel's space-to-depth^3 term packing (pack_stem_weights, s2d3)
// exists for the TPU's matrix unit and (8, 128) tiles and is not carried
// over. Both bodies take any H, W >= 1.
//
// What bounds it on this card: 2 * 147 * 64 FLOPs per conv output against
// 3 input bytes per conv output read and 64 output channels written per
// pooled pixel (a quarter of the conv outputs): ~0.94 GFLOP per 448^2
// frame over ~2.8 MB, far above the ridge, so it is compute-bound, and only
// the tensor cores come near that bound: on the fp32 CUDA cores (67
// TFLOP/s) 32 frames take at least ~0.45 ms. The fusion saves memory as
// well: the (B, H/2, W/2, 64) conv activation never reaches device memory.
//
// Two bodies; ops/fused_stem_pool.py::_plan picks one, and the entry point
// derives the same plan and refuses another (kPlanMismatch).
//
// Body "direct" (fp32, and bf16 whose x or out is off 16 bytes): a direct
// convolution on the fp32 CUDA cores. One block computes a tile of PH x PW
// pooled outputs for all 64 channels. It stages the input halo (3 x 35 x 39
// values, fp32) and the weights (147 x 64 fp32, packed and rounded by the
// wrapper) in shared memory, computes the (2 PH + 1) x (2 PW + 1) conv tile
// that the pool windows cover (the one-row and one-column pool halo is
// recomputed, not exchanged), pools it across columns in registers and
// across rows in shared memory, and writes the pooled tile once. Each warp
// owns 8 output channels; each lane owns one conv row of 9 consecutive
// columns (8 plus the one the next column group shares), so for every
// (input channel, kernel row) a lane loads 23 input values and 14 broadcast
// weight vectors and issues 504 FMAs.
//
// Body "tc" (bf16, the main path): the conv as an implicit GEMM on the
// tensor cores, M = conv outputs, N = 64 channels, K = taps, on mma.sync
// m16n8k16 (bf16 in, fp32 accumulate; bf16 x bf16 products are exact in
// fp32, so only the order of the fp32 sum differs from the plain version).
//   - No im2col copy. In NHWC the 7 x 3 = 21 taps of one kernel row ky are
//     21 contiguous bf16 of one input row, and conv column j + 1 starts 6
//     elements after column j. The input halo row is staged from one
//     element before the first tap's pixel (rounded down to a 16-byte
//     boundary, which shifts the whole tile), so kernel row ky of conv
//     output (r, j) is the 22 staged elements from 6 j of halo row 2 r + ky:
//     tap 0 a neighbouring value times a zero weight, taps 1..21 real. K is
//     the 7 rows' 154 taps in order, padded to 160 (10 k16 steps). Each A
//     register (taps 2p, 2p + 1: both in kernel row p / 11) is one aligned
//     32-bit shared load from a per-thread row base at an offset that a
//     small table gives per (k16 step, lane): 4 loads per m16 tile and step.
//     Packing K across kernel rows needs 10 k16 steps where 7 rows of k16 +
//     k8 need 14 mma (an m16n8k8 costs the card as much as an m16n8k16).
//   - Tiles of 8 x 7 pooled outputs (112 = 16 x 7 = 14 x 8, so a 448^2
//     frame has no partial tile): a 17 x 15 conv tile, 255 rows of M (1.14x
//     the 224 the pool needs), over a 39 x 35-pixel input halo.
//   - One persistent block an SM, 256 threads: two groups of 4 warps, each
//     with its own tiles, two input halo buffers and conv tile; the packed
//     weight is shared. The groups take turns on the tensor cores (named
//     barriers order tile j's products after tile j - 1's), so one group's
//     epilogue, which the tensor cores sit out, runs under the other's
//     products. 256 threads in one block let ptxas give each thread up to
//     255 registers, so nothing spills. The next tile's halo is loaded by
//     cp.async into a group's second buffer while its current tile computes
//     (16-byte copies with zero fill where W % 8 == 0, which makes every
//     16-byte chunk wholly inside or outside a row; element by element
//     otherwise).
//   - B, the weight, is packed by the block once from the folded OIHW fp32
//     weight (rounded to bf16 as torch's cast does) into [64][168] bf16: a
//     336-byte row pitch (21 16-byte chunks, odd) makes each 8-row ldmatrix
//     conflict-free.
//   - Each warp owns 4 m16 tiles x 64 channels (128 fp32 accumulators a
//     thread, started at the bias), loads a k16 step's B fragments once (4
//     ldmatrix.x4) and uses them for its 4 tiles: 32 mma per 16 A loads.
//   - Epilogue: ReLU and one rounding to bf16 in one cvt, 0 outside the
//     image, into a [255][64] shared tile (16-byte chunks XOR-swizzled by
//     row, so the fragment stores and the pool's 16-byte reads are
//     conflict-free); rounding is monotone, so the max of the rounded
//     values is the rounded max. Each pooled pixel's 64 channels are then
//     the max of 9 rows of the tile, written as 128 contiguous bytes in
//     16-byte stores.
//   - The halo row pitch, 56 words (== 8 mod 16), puts the two conv rows an
//     m16 tile can span on disjoint banks. Where a lane quad's 4 tap pairs
//     straddle two kernel rows (5 of the 20 pair groups), its loads meet
//     2-way bank conflicts; 24 taps a row would avoid them at 11 k16 steps,
//     which measured slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int C_OUT = 64, C_IN = 3, KS = 7;
constexpr int TAPS = C_IN * KS * KS;           // 147
constexpr int PH = 7, PW = 8;                  // pooled outputs per block
constexpr int CONV_R = 2 * PH + 1;             // 15 conv rows per tile
constexpr int COLS = 9;                        // conv columns per lane
constexpr int NCG = PW / 4;                    // column groups of 8 (+1)
constexpr int SLOTS = CONV_R * NCG;            // 30 lanes busy per warp
constexpr int CPT = 8;                         // channels per warp
constexpr int kThreads = 32 * (C_OUT / CPT);   // 256
constexpr int IN_R = 2 * (CONV_R - 1) + KS;    // 35 input rows
constexpr int IN_C = 2 * (8 * NCG) + KS;       // 39 input columns
constexpr int XW = 2 * COLS + KS - 2;          // 23 inputs per lane and row
constexpr int XS_FLOATS = (C_IN * IN_R * IN_C + 3) / 4 * 4;  // hp 16 B aligned
constexpr int kSmemFloats = TAPS * C_OUT + XS_FLOATS + CONV_R * PW * C_OUT;
static_assert(SLOTS <= 32, "one conv row slot per lane");
static_assert(PW % 4 == 0, "column groups of four pooled columns");

template <bool BF16>
struct Tr {
  using raw = typename std::conditional<BF16, uint16_t, float>::type;
  static __device__ __forceinline__ float to_f(raw v) {
    if constexpr (BF16) return __uint_as_float(uint32_t(v) << 16);
    else return v;
  }
  static __device__ __forceinline__ raw from_f(float v) {
    if constexpr (BF16) return __bfloat16_as_ushort(__float2bfloat16_rn(v));
    else return v;
  }
};

struct Args {
  const void* x;       // (B, H, W, 3), input dtype
  const float* w;      // (3, 7, 7, 64): [c][ky][kx][out channel]
  const float* bias;   // (64,)
  void* out;           // (B, Hp, Wp, 64), input dtype
  int H, W, Hc, Wc, Hp, Wp, tiles_x, tiles_y;
};

template <bool BF16>
__global__ void __launch_bounds__(kThreads) fused_stem_pool_kernel(Args a) {
  using T = Tr<BF16>;
  using raw = typename T::raw;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                          // [TAPS][64]
  float* xs = ws + TAPS * C_OUT;             // [3][IN_R][IN_C]
  float* hp = xs + XS_FLOATS;                // [CONV_R][PW][64]

  const int tiles = a.tiles_x * a.tiles_y;
  const int b = blockIdx.x / tiles;
  const int py0 = (blockIdx.x % tiles) / a.tiles_x * PH;
  const int px0 = (blockIdx.x % a.tiles_x) * PW;
  const int cr0 = 2 * py0 - 1, cc0 = 2 * px0 - 1;   // conv origin
  const int ir0 = 2 * cr0 - 3, ic0 = 2 * cc0 - 3;   // input origin
  const int tid = threadIdx.x;

  for (int i = tid; i < TAPS * C_OUT / 4; i += kThreads)
    reinterpret_cast<float4*>(ws)[i] = reinterpret_cast<const float4*>(a.w)[i];
  const raw* xb = static_cast<const raw*>(a.x) + (long long)b * a.H * a.W * C_IN;
  for (int i = tid; i < IN_R * IN_C * C_IN; i += kThreads) {
    const int c = i % C_IN, q = i / C_IN;
    const int col = q % IN_C, row = q / IN_C;
    const int gr = ir0 + row, gc = ic0 + col;
    float v = 0.f;                              // the conv's zero padding
    if (gr >= 0 && gr < a.H && gc >= 0 && gc < a.W)
      v = T::to_f(xb[((long long)gr * a.W + gc) * C_IN + c]);
    xs[(c * IN_R + row) * IN_C + col] = v;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int ch0 = warp * CPT;
  if (lane < SLOTS) {
    const int r = lane % CONV_R, g = lane / CONV_R;   // conv tile row, group
    float acc[COLS][CPT];
#pragma unroll
    for (int j = 0; j < COLS; ++j)
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[j][e] = 0.f;

    for (int c = 0; c < C_IN; ++c) {
      for (int ky = 0; ky < KS; ++ky) {
        const float* xr = xs + (c * IN_R + 2 * r + ky) * IN_C + 16 * g;
        float xv[XW];
#pragma unroll
        for (int i = 0; i < XW; ++i) xv[i] = xr[i];
        const float* wr = ws + (c * KS + ky) * KS * C_OUT + ch0;
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) {
          const float4 w0 = *reinterpret_cast<const float4*>(wr + kx * C_OUT);
          const float4 w1 =
              *reinterpret_cast<const float4*>(wr + kx * C_OUT + 4);
          const float wv[CPT] = {w0.x, w0.y, w0.z, w0.w,
                                 w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            const float xx = xv[2 * j + kx];
#pragma unroll
            for (int e = 0; e < CPT; ++e) acc[j][e] = fmaf(xx, wv[e], acc[j][e]);
          }
        }
      }
    }

    // bias + ReLU; conv positions outside the image are 0 (pool padding)
    float bv[CPT];
#pragma unroll
    for (int e = 0; e < CPT; ++e) bv[e] = a.bias[ch0 + e];
    const int cr = cr0 + r;
    const bool row_ok = cr >= 0 && cr < a.Hc;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int cc = cc0 + 8 * g + j;
      const bool ok = row_ok && cc >= 0 && cc < a.Wc;
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        acc[j][e] = ok ? fmaxf(acc[j][e] + bv[e], 0.f) : 0.f;
    }
    // pool across columns: pooled column 4g + m reads tile columns
    // 8g + 2m .. 8g + 2m + 2, i.e. this lane's j = 2m .. 2m + 2
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float v[CPT];
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        v[e] = fmaxf(fmaxf(acc[2 * m][e], acc[2 * m + 1][e]), acc[2 * m + 2][e]);
      float4* dst = reinterpret_cast<float4*>(
          hp + (r * PW + 4 * g + m) * C_OUT + ch0);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  __syncthreads();

  // pool across rows: pooled row i reads tile rows 2i .. 2i + 2
  raw* out = static_cast<raw*>(a.out);
  for (int i = tid; i < PH * PW * C_OUT; i += kThreads) {
    const int ch = i % C_OUT, q = i / C_OUT;
    const int pj = q % PW, pi = q / PW;
    const int py = py0 + pi, px = px0 + pj;
    if (py >= a.Hp || px >= a.Wp) continue;
    const float* h = hp + (2 * pi * PW + pj) * C_OUT + ch;
    const float v = fmaxf(fmaxf(h[0], h[PW * C_OUT]), h[2 * PW * C_OUT]);
    out[(((long long)b * a.Hp + py) * a.Wp + px) * C_OUT + ch] = T::from_f(v);
  }
}

// ---- body "tc": the conv as an implicit GEMM on mma.sync ------------------

constexpr int kTcPH = 8, kTcPW = 7;              // pooled outputs per tile
constexpr int kTcCR = 2 * kTcPH + 1;             // 17 conv rows per tile
constexpr int kTcCC = 2 * kTcPW + 1;             // 15 conv columns
constexpr int kTcRows = kTcCR * kTcCC;           // 255 conv outputs: M
constexpr int kTcMTiles = (kTcRows + 15) / 16;   // 16 m16 tiles
constexpr int kTcWarpTiles = 4;                  // m16 tiles per warp
constexpr int kTcGroupWarps = kTcMTiles / kTcWarpTiles;  // 4 a tile
constexpr int kTcGroupThreads = 32 * kTcGroupWarps;      // 128
constexpr int kTcGroups = 2;                     // tiles in flight a block
constexpr int kTcThreads = kTcGroups * kTcGroupThreads;  // 256
constexpr int kKRow = 22;                        // K per kernel row
constexpr int kK = 160;                          // 7 x 22, padded to k16
constexpr int kKSteps = kK / 16;                 // 10
constexpr int kWsPitch = kK + 8;                 // 168 bf16 a weight row
constexpr int kHaloR = 2 * (kTcCR - 1) + KS;     // 39 input rows
// staged elements a row: the taps of 15 conv columns, from up to 4
// elements past the 16-byte boundary the row is staged from
constexpr int kHaloE = (6 * (kTcCC - 1) + kKRow + 4 + 7) / 8 * 8;   // 112
constexpr int kHaloPitch = kHaloE;               // 56 words
constexpr int kHaloChunks = kHaloE / 8;          // 16-byte chunks a row
constexpr int kHaloBytes = kHaloR * kHaloPitch * 2;
constexpr int kWsBytes = C_OUT * kWsPitch * 2;   // [64][168] bf16
constexpr int kCtBytes = kTcRows * C_OUT * 2;    // [255][64] bf16
constexpr int kLutBytes = kKSteps * 4 * 8;       // [10][4] pairs of offsets
constexpr int kSharedBytes = kWsBytes + C_OUT * 4 + kLutBytes;
constexpr int kGroupBytes = 2 * kHaloBytes + kCtBytes;
constexpr int kTcSmem = kSharedBytes + kTcGroups * kGroupBytes;
static_assert(kTcMTiles % kTcWarpTiles == 0, "whole m16 tiles per warp");
static_assert(kTcThreads == 256, "255 registers a thread: no spills");
static_assert(kHaloE % 8 == 0 && kHaloBytes % 16 == 0, "16-byte chunks");
static_assert(kHaloPitch / 2 % 16 == 8, "two conv rows on disjoint banks");
static_assert(kSharedBytes % 16 == 0 && kGroupBytes % 16 == 0,
              "16-byte aligned regions");
static_assert(kTcSmem <= 232448, "a block's shared memory");

struct TcArgs {
  const uint16_t* x;   // (B, H, W, 3) bf16, 16-byte aligned
  const float* w;      // (64, 3, 7, 7) OIHW fp32, 16-byte aligned
  const float* bias;   // (64,)
  uint16_t* out;       // (B, Hp, Wp, 64) bf16, 16-byte aligned
  int H, W, Hc, Wc, Hp, Wp, tiles_x, tiles_y, tiles;
  bool vec;            // W % 8 == 0: halo rows by 16-byte cp.async
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, the bytes past src_bytes (0 or 16) zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// named barriers: 0 is __syncthreads'; 1 + g: group g's turn on the tensor
// cores (both groups, 256 threads); 3 + g: group g alone (128 threads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// max(lo, 0), max(hi, 0) -> two bf16 (round to nearest even, as torch's
// cast), lo in the low half. ReLU after the rounding equals ReLU before it:
// the rounding is monotone and keeps 0.
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

struct TcTile {
  int b, py0, px0;
};
__device__ __forceinline__ TcTile tc_tile(const TcArgs& a, int tile) {
  const int per_frame = a.tiles_x * a.tiles_y;
  const int b = tile / per_frame, rem = tile - b * per_frame;
  const int ty = rem / a.tiles_x;
  return {b, ty * kTcPH, (rem - ty * a.tiles_x) * kTcPW};
}

// The input halo of `tile` into `halo` [kHaloR][kHaloPitch]: halo row hr is
// input row 4 py0 - 5 + hr, and its element s the row's element e0 - sh + s,
// where e0 = 12 px0 - 16 is one before the first tap of conv column
// 2 px0 - 1 and sh = e0 mod 8 (0 or 4) puts element 0 on a 16-byte
// boundary of the row; zero outside the image. vec: cp.async, which the
// caller commits. gt: the thread's index in its group. Returns sh.
__device__ __forceinline__ int tc_stage(uint16_t* halo, const TcArgs& a,
                                        int tile, int gt) {
  const TcTile t = tc_tile(a, tile);
  const int ir0 = 4 * t.py0 - 5, sh = (12 * t.px0) & 7;
  const long long e0 = 12LL * t.px0 - 16 - sh, row = 3LL * a.W;
  const uint16_t* xb = a.x + (long long)t.b * a.H * row;
  if (a.vec) {
    for (int i = gt; i < kHaloR * kHaloChunks; i += kTcGroupThreads) {
      const int hr = i / kHaloChunks, gr = ir0 + hr;
      const long long ge = e0 + 8 * (i % kHaloChunks);
      const bool ok = gr >= 0 && gr < a.H && ge >= 0 && ge < row;
      cp_async16(halo + hr * kHaloPitch + 8 * (i % kHaloChunks),
                 ok ? xb + gr * row + ge : a.x, ok ? 16u : 0u);
    }
  } else {
    for (int i = gt; i < kHaloR * kHaloE; i += kTcGroupThreads) {
      const int hr = i / kHaloE, gr = ir0 + hr;
      const long long ge = e0 + i % kHaloE;
      halo[hr * kHaloPitch + i % kHaloE] =
          gr >= 0 && gr < a.H && ge >= 0 && ge < row ? xb[gr * row + ge]
                                                     : uint16_t(0);
    }
  }
  return sh;
}

__global__ void __launch_bounds__(kTcThreads, 1)
    fused_stem_pool_tc_kernel(TcArgs a) {
  extern __shared__ __align__(16) uint8_t smem_tc[];
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem_tc);
  float* bs = reinterpret_cast<float*>(smem_tc + kWsBytes);
  uint2* lut = reinterpret_cast<uint2*>(bs + C_OUT);
  const int tid = threadIdx.x, lane = tid & 31;
  const int grp = tid / kTcGroupThreads, gt = tid % kTcGroupThreads;
  const int warp = gt >> 5, g = lane >> 2, t4 = lane & 3;
  uint8_t* const gbase = smem_tc + kSharedBytes + grp * kGroupBytes;
  uint16_t* halo = reinterpret_cast<uint16_t*>(gbase);   // 2 buffers
  uint8_t* ct = gbase + 2 * kHaloBytes;

  // group grp takes tiles 2 blockIdx.x + grp + k * 2 gridDim.x: the block's
  // tile j = 2 k + grp
  const int stride = kTcGroups * gridDim.x;
  int tile = kTcGroups * blockIdx.x + grp;
  int sh = tile < a.tiles ? tc_stage(halo, a, tile, gt) : 0;
  cp_async_commit();
  // B: ws[n][kKRow ky + 1 + 3 kx + c] = bf16(w[n][c][ky][kx]); the other
  // taps are 0. All of a thread's weight loads are issued first.
  constexpr int kW4 = C_OUT * TAPS / 4;
  constexpr int kW4Thread = (kW4 + kTcThreads - 1) / kTcThreads;
  float4 wv[kW4Thread];
#pragma unroll
  for (int r = 0; r < kW4Thread; ++r)
    if (tid + r * kTcThreads < kW4)
      wv[r] = reinterpret_cast<const float4*>(a.w)[tid + r * kTcThreads];
  for (int i = tid; i < kWsBytes / 16; i += kTcThreads)
    reinterpret_cast<uint4*>(ws)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kW4Thread; ++r) {
    if (tid + r * kTcThreads >= kW4) continue;
    const float vs[4] = {wv[r].x, wv[r].y, wv[r].z, wv[r].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = 4 * (tid + r * kTcThreads) + e;
      const int n = f / TAPS, tap = f % TAPS;
      const int c = tap / (KS * KS), ky = tap / KS % KS, kx = tap % KS;
      ws[n * kWsPitch + kKRow * ky + 1 + C_IN * kx + c] =
          __bfloat16_as_ushort(__float2bfloat16_rn(vs[e]));
    }
  }
  if (tid < C_OUT) bs[tid] = a.bias[tid];
  // A: k16 step s, lane quad t holds tap pairs p = 8 s + t and 8 s + 4 + t;
  // pair p < 77 is taps 2 (p % 11), +1 of kernel row p / 11: byte offset
  // (p / 11 rows, 2 (p % 11) elements) from a fragment row's base. Pairs
  // 77..79 have zero weights and read the base.
  if (tid < kKSteps * 4) {
    uint32_t off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pr = 8 * (tid / 4) + 4 * h + tid % 4;
      off[h] = pr < KS * kKRow / 2
                   ? (pr / (kKRow / 2) * kHaloPitch + 2 * (pr % (kKRow / 2))) *
                         2
                   : 0u;
    }
    lut[tid] = make_uint2(off[0], off[1]);
  }

  // ldmatrix rows: x4 number p of a k16 step holds n-tiles 2p, 2p + 1 (k 0-7
  // and 8-15 of each)
  const int mat = lane >> 3, r8 = lane & 7;
  const uint32_t b16 =
      smem_u32(ws) + (((mat >> 1) * 8 + r8) * kWsPitch + (mat & 1) * 8) * 2;
  // A: byte offsets in a halo buffer of the first tap of kernel row 0 for
  // this thread's fragment rows g and g + 8 of each m16 tile (row 255, past
  // the tile, reads row 254; its sums are dropped)
  uint32_t lo[kTcWarpTiles], hi[kTcWarpTiles];
#pragma unroll
  for (int mt = 0; mt < kTcWarpTiles; ++mt) {
    const int m = (warp * kTcWarpTiles + mt) * 16 + g;
    const int ml = min(m, kTcRows - 1), mh = min(m + 8, kTcRows - 1);
    lo[mt] = (2 * (ml / kTcCC) * kHaloPitch + 6 * (ml % kTcCC)) * 2;
    hi[mt] = (2 * (mh / kTcCC) * kHaloPitch + 6 * (mh % kTcCC)) * 2;
  }

  __syncthreads();         // the weights, bias and offsets are shared

  int buf = 0;
  for (int j = grp; tile < a.tiles; tile += stride, j += kTcGroups) {
    const int next = tile + stride;
    const int sh_next =
        next < a.tiles ? tc_stage(halo + (buf ^ 1) * (kHaloBytes / 2), a,
                                  next, gt)
                       : 0;
    cp_async_commit();
    cp_async_wait1();      // this tile's halo (the group before) has landed
    bar_sync(3 + grp, kTcGroupThreads);
    if (j > 0) bar_sync(1 + grp, kTcThreads);   // tile j - 1's products

    // the sums start at the bias (one more fp32 term, summed first)
    float acc[kTcWarpTiles][8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 bv =
          *reinterpret_cast<const float2*>(bs + nt * 8 + 2 * t4);
#pragma unroll
      for (int mt = 0; mt < kTcWarpTiles; ++mt) {
        acc[mt][nt][0] = acc[mt][nt][2] = bv.x;
        acc[mt][nt][1] = acc[mt][nt][3] = bv.y;
      }
    }
    const uint8_t* hb =
        reinterpret_cast<const uint8_t*>(halo) + buf * kHaloBytes + 2 * sh;
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      uint32_t bk[8][2];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t r[4];
        ldmatrix_x4(r, b16 + s * 32 + p * 16 * kWsPitch * 2);
        bk[2 * p][0] = r[0];
        bk[2 * p][1] = r[1];
        bk[2 * p + 1][0] = r[2];
        bk[2 * p + 1][1] = r[3];
      }
      const uint2 off = lut[s * 4 + t4];
#pragma unroll
      for (int mt = 0; mt < kTcWarpTiles; ++mt) {
        const uint32_t af[4] = {
            *reinterpret_cast<const uint32_t*>(hb + lo[mt] + off.x),
            *reinterpret_cast<const uint32_t*>(hb + hi[mt] + off.x),
            *reinterpret_cast<const uint32_t*>(hb + lo[mt] + off.y),
            *reinterpret_cast<const uint32_t*>(hb + hi[mt] + off.y)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_k16(acc[mt][nt], af, bk[nt][0], bk[nt][1]);
      }
    }
    // tile j + 1, the other group's, may start its products
    const int after = grp == 0 ? tile + 1 : tile - 1 + stride;
    if (after < a.tiles) bar_arrive(1 + (grp ^ 1), kTcThreads);

    // ReLU, one rounding, 0 outside the image; into the conv tile
    const TcTile tt = tc_tile(a, tile);
    const int cr0 = 2 * tt.py0 - 1, cc0 = 2 * tt.px0 - 1;
#pragma unroll
    for (int mt = 0; mt < kTcWarpTiles; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (warp * kTcWarpTiles + mt) * 16 + g + 8 * h;
        if (m >= kTcRows) continue;
        const int cr = cr0 + m / kTcCC, cc = cc0 + m % kTcCC;
        const bool ok = cr >= 0 && cr < a.Hc && cc >= 0 && cc < a.Wc;
        uint8_t* row = ct + m * (C_OUT * 2) + t4 * 4;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t v =
              relu_bf16x2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          *reinterpret_cast<uint32_t*>(row + ((nt ^ (m & 7)) * 16)) =
              ok ? v : 0u;
        }
      }
    }
    bar_sync(3 + grp, kTcGroupThreads);

    // the pool: pooled (pi, pj), channels 8 q .. 8 q + 7, from tile rows
    // (2 pi + dy) x (2 pj + dx)
    for (int i = gt; i < kTcPH * kTcPW * 8; i += kTcGroupThreads) {
      const int q = i & 7, pj = (i >> 3) % kTcPW, pi = (i >> 3) / kTcPW;
      const int py = tt.py0 + pi, px = tt.px0 + pj;
      if (py >= a.Hp || px >= a.Wp) continue;
      uint4 mx = make_uint4(0u, 0u, 0u, 0u);   // every value is >= 0
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int m = (2 * pi + dy) * kTcCC + 2 * pj + dx;
          const uint4 v = *reinterpret_cast<const uint4*>(
              ct + m * (C_OUT * 2) + ((q ^ (m & 7)) * 16));
          mx.x = max_bf16x2(mx.x, v.x);
          mx.y = max_bf16x2(mx.y, v.y);
          mx.z = max_bf16x2(mx.z, v.z);
          mx.w = max_bf16x2(mx.w, v.w);
        }
      *reinterpret_cast<uint4*>(
          a.out + (((long long)tt.b * a.Hp + py) * a.Wp + px) * C_OUT +
          8 * q) = mx;
    }
    bar_sync(3 + grp, kTcGroupThreads);   // the tile and halo buffer are free
    buf ^= 1;
    sh = sh_next;
  }
}

template <bool BF16>
int launch_direct(const Args& a, long long blocks, cudaStream_t st) {
  static bool configured = false;   // the attribute is per kernel, set once
  const size_t smem = kSmemFloats * sizeof(float);
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_stem_pool_kernel<BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_stem_pool_kernel<BF16><<<unsigned(blocks), kThreads, smem, st>>>(a);
  return int(cudaGetLastError());
}

int launch_tc(const TcArgs& a, long long blocks, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_stem_pool_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmem);
  if (attr != cudaSuccess) return int(attr);
  fused_stem_pool_tc_kernel<<<unsigned(blocks), kTcThreads, kTcSmem, st>>>(a);
  return int(cudaGetLastError());
}

constexpr int kPlanMismatch = -1;    // the caller's plan is not this one
constexpr int kBodyDirect = 0, kBodyTc = 1;

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x and out share it). w: for body direct the
// (3, 7, 7, 64) fp32 weight [c][ky][kx][out channel] already rounded to the
// input dtype; for body tc the folded (64, 3, 7, 7) OIHW fp32 weight, which
// the kernel rounds to bf16. bias: (64,) fp32. body: the caller's plan
// (kBodyDirect or kBodyTc); forced: the body was chosen by the caller for a
// measurement, else it must be the one derived here; n_sms: the card's SM
// count; grid, threads, smem_bytes: the rest of the caller's plan, which
// must be the one derived here. Returns the launch's cudaError_t (0 on
// success) or kPlanMismatch; does not synchronise.
extern "C" int clipbert_fused_stem_pool(const void* x, const void* w,
                                        const void* bias, void* out,
                                        int dtype, int B, int H, int W,
                                        int body, int forced, int n_sms,
                                        long long grid, int threads,
                                        int smem_bytes, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || n_sms < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;   // conv 7x7 / 2
  const int Hp = (Hc - 1) / 2 + 1, Wp = (Wc - 1) / 2 + 1;  // pool 3x3 / 2
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool can_tc = dtype == 1 && aligned;
  if (!forced && body != (can_tc ? kBodyTc : kBodyDirect))
    return kPlanMismatch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (body == kBodyTc) {
    if (!can_tc) return kPlanMismatch;
    const int tiles_x = (Wp + kTcPW - 1) / kTcPW;
    const int tiles_y = (Hp + kTcPH - 1) / kTcPH;
    const long long tiles = (long long)tiles_x * tiles_y * B;
    if (tiles + kTcGroups * (long long)n_sms > 0x7fffffffLL)
      return cudaErrorInvalidValue;   // tile indices within 32 bits
    const long long pairs = (tiles + kTcGroups - 1) / kTcGroups;
    const long long blocks = pairs < n_sms ? pairs : n_sms;
    if (grid != blocks || threads != kTcThreads || smem_bytes != kTcSmem)
      return kPlanMismatch;
    const TcArgs a{static_cast<const uint16_t*>(x),
                   static_cast<const float*>(w),
                   static_cast<const float*>(bias),
                   static_cast<uint16_t*>(out),
                   H, W, Hc, Wc, Hp, Wp, tiles_x, tiles_y, int(tiles),
                   W % 8 == 0};
    return launch_tc(a, blocks, st);
  }

  if (body != kBodyDirect) return kPlanMismatch;
  const int tiles_x = (Wp + PW - 1) / PW, tiles_y = (Hp + PH - 1) / PH;
  const long long blocks = (long long)tiles_x * tiles_y * B;
  if (grid != blocks || threads != kThreads ||
      smem_bytes != int(kSmemFloats * sizeof(float)))
    return kPlanMismatch;
  const Args a{x, static_cast<const float*>(w),
               static_cast<const float*>(bias), out, H, W, Hc, Wc, Hp, Wp,
               tiles_x, tiles_y};
  return dtype == 1 ? launch_direct<true>(a, blocks, st)
                    : launch_direct<false>(a, blocks, st);
}
