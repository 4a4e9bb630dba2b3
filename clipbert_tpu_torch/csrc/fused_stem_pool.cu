// Fused ResNet stem for Hopper (sm_90a), plain C interface:
// conv 7x7 / stride 2 / pad 3 (3 -> 64 channels), + folded frozen-BN bias,
// ReLU, then maxpool 3x3 / stride 2 / pad 1, in one kernel.
//
// Replaces clipbert_tpu/ops/pallas_stem.py::fused_stem_pool (body
// `_stem_kernel`) with the same arithmetic: the 147 taps summed in fp32 over
// the input widened to fp32 and the weights rounded to the input dtype (the
// wrapper passes them as fp32), + bias, ReLU, max over the pool window, one
// rounding to the output dtype. Zero pool padding equals the reference's
// -inf padding only because the pool runs after ReLU (every value >= 0) and
// every window holds at least one real conv output
// (clipbert_tpu/ops/pallas_stem.py:37-39): conv positions outside the image
// are set to 0, never to relu(bias).
//
// The TPU kernel's space-to-depth^3 term packing (pack_stem_weights, s2d3)
// exists for the TPU's matrix unit and (8, 128) tiles and is not carried
// over: this is a direct convolution.
//
// What bounds it on this card: 2 * 147 * 64 FLOPs per conv output against
// 3 input bytes per conv output read and 64 output channels written per
// pooled pixel (a quarter of the conv outputs): ~0.94 GFLOP per 448^2
// frame over ~2.8 MB, far above the ridge, so it is compute-bound. A
// 3-channel conv maps poorly onto tensor cores, so this first version runs
// on the fp32 CUDA cores. The point of the fusion is memory: the
// (B, H/2, W/2, 64) conv activation never reaches device memory (the
// unfused form writes it, reads it back for the bias/ReLU pass, writes it,
// and reads it once more for the pool).
//
// Design: one block computes a tile of PH x PW pooled outputs for all 64
// channels. It stages the input halo (3 x 35 x 39 values, fp32) and the
// weights (147 x 64 fp32) in shared memory, computes the (2 PH + 1) x
// (2 PW + 1) conv tile that the pool windows cover (the one-row and
// one-column pool halo is recomputed, not exchanged), pools it across
// columns in registers and across rows in shared memory, and writes the
// pooled tile once. Each warp owns 8 output channels; each lane owns one
// conv row of 9 consecutive columns (8 plus the one the next column group
// shares), so for every (input channel, kernel row) a lane loads 23 input
// values and 14 broadcast weight vectors and issues 504 FMAs.

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

template <bool BF16>
int launch(const Args& a, int B, cudaStream_t st) {
  static bool configured = false;   // the attribute is per kernel, set once
  const size_t smem = kSmemFloats * sizeof(float);
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_stem_pool_kernel<BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  const long long blocks = (long long)a.tiles_x * a.tiles_y * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_stem_pool_kernel<BF16><<<unsigned(blocks), kThreads, smem, st>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x and out share it). w is (3, 7, 7, 64)
// fp32, bias (64,) fp32. Returns a cudaError_t; 0 means the kernel was
// launched.
extern "C" int clipbert_fused_stem_pool(const void* x, const void* w,
                                        const void* bias, void* out,
                                        int dtype, int B, int H, int W,
                                        void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(w), static_cast<const float*>(bias),
         out, H, W, 0, 0, 0, 0, 0, 0};
  a.Hc = (H - 1) / 2 + 1;   // conv 7x7 / 2, pad 3
  a.Wc = (W - 1) / 2 + 1;
  a.Hp = (a.Hc - 1) / 2 + 1;   // maxpool 3x3 / 2, pad 1
  a.Wp = (a.Wc - 1) / 2 + 1;
  a.tiles_x = (a.Wp + PW - 1) / PW;
  a.tiles_y = (a.Hp + PH - 1) / PH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<false>(a, B, st);
    case 1: return launch<true>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}
