// 1x1 convolution as a GEMM with the frozen-BN / residual / ReLU epilogue
// fused, for Hopper (sm_90a), plain C interface.
//
// Replaces clipbert_tpu/ops/pallas_kernels.py::matmul_bn_act (Pallas bodies
// `_kernel_no_res` and `_kernel_res`) and, through the row indexing below,
// the strided slice of its NHWC wrapper `conv1x1_bn_act`:
//
//   out[r, n] = act((sum_k x[src(r), k] * w[n, k]) * scale[n] + bias[n]
//                   [+ residual[r, n]])
//
// with the TPU kernel's arithmetic: products summed in fp32, scale and bias
// in fp32, the residual widened to fp32, ReLU, then one rounding to the
// output dtype. `scale` may be null (all ones: the BN scale was folded into
// w). x is an NHWC activation (B, in_h, in_w, K), contiguous; a strided 1x1
// conv reads pixel (b, ho*stride, wo*stride) for output row
// r = (b*out_h + ho)*out_w + wo, so the subsampled input is never copied.
// w is the conv weight in PyTorch's OIHW layout, (N, K, 1, 1): K contiguous
// per output channel, which is the "col" B operand of mma.sync.
//
// What bounds it on this card: the R50 1x1 convs at the eval shape do
// 2*R*K*N FLOPs over (R*K + K*N + R*N [+ R*N]) * 2 bytes, 32 to 205 FLOP per
// byte; the larger-K convs sit near the H100's ~295 FLOP/byte ridge, so
// both the tensor-core rate and the memory passes matter. The unfused form
// (cuDNN conv, then a bias add, a residual add and a ReLU pass) writes and
// re-reads the (R, N) activation three to four times; this kernel reads
// each operand once per tile and writes the output once.
//
// Design (a first, simple tensor-core kernel): 128 x 128 output tiles, 8
// warps each owning a 64 x 32 sub-tile as 4 x 4 mma.sync m16n8k16 bf16
// tiles with fp32 accumulators in registers; K advances 32 at a time
// through shared memory (rows padded to 40 halves, so fragment loads hit
// distinct banks), the next K slice is prefetched into registers while the
// current one is multiplied; the epilogue runs on the accumulator
// registers and stores pairs of outputs. Ragged R, N and K are masked (zero
// fill on load, guarded stores). The fp32 instantiation stages the same
// tiles and applies the same epilogue but multiplies on the CUDA cores in
// fp32 (no TF32), so the card can hold the indexing to a tight fp32 bound.
// wgmma, TMA and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, kThreads = 256;
constexpr int WARPS_N = 4;
constexpr int WM = 64, WN = 32;            // warp tile (2 x 4 warps)
constexpr int MT = WM / 16, NT = WN / 8;   // mma tiles per warp

template <bool BF16>
struct Tr {
  using raw = typename std::conditional<BF16, uint16_t, float>::type;
  static constexpr int kChunk = 16 / sizeof(raw);   // elements per 16 B
  static constexpr int kLds = BF16 ? BK + 8 : BK + 4;  // smem row, 16 B mult.
  static __device__ __forceinline__ float to_f(raw v) {
    if constexpr (BF16) return __uint_as_float(uint32_t(v) << 16);
    else return v;
  }
  static __device__ __forceinline__ raw from_f(float v) {
    // round to nearest even, as torch's cast
    if constexpr (BF16) return __bfloat16_as_ushort(__float2bfloat16_rn(v));
    else return v;
  }
};

struct Args {
  const void* x;
  const void* w;
  const float* scale;     // null: all ones
  const float* bias;
  const void* res;        // null: no residual
  void* out;
  long long R;
  int K, N, stride, relu, vec;
  long long in_h, in_w, out_h, out_w;
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 16-byte chunk of a tile row: a vector load when the whole chunk is
// in range and aligned, else element by element with zero fill.
template <bool BF16>
__device__ __forceinline__ uint4 load_chunk(
    const typename Tr<BF16>::raw* base, long long row_off, int k, int K,
    bool row_ok, bool vec) {
  using raw = typename Tr<BF16>::raw;
  constexpr int CH = Tr<BF16>::kChunk;
  union { uint4 u; raw r[CH]; } c;
  if (row_ok && vec && k < K) {
    c.u = *reinterpret_cast<const uint4*>(base + row_off + k);
  } else {
#pragma unroll
    for (int e = 0; e < CH; ++e)
      c.r[e] = (row_ok && k + e < K) ? base[row_off + k + e] : raw(0);
  }
  return c.u;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
matmul_bn_act_kernel(Args a) {
  using T = Tr<BF16>;
  using raw = typename T::raw;
  constexpr int CH = T::kChunk, LDS = T::kLds;
  constexpr int CPR = BK / CH;                    // chunks per tile row
  constexpr int A_PER = BM * CPR / kThreads;      // chunks per thread
  constexpr int B_PER = BN * CPR / kThreads;
  __shared__ __align__(16) raw As[BM * LDS];
  __shared__ __align__(16) raw Bs[BN * LDS];

  const raw* x = static_cast<const raw*>(a.x);
  const raw* w = static_cast<const raw*>(a.w);
  const int num_n = (a.N + BN - 1) / BN;
  const long long m0 = (long long)(blockIdx.x / num_n) * BM;
  const int n0 = (blockIdx.x % num_n) * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  // Source row offsets of this thread's chunks, fixed across the K loop.
  long long a_off[A_PER];
  bool a_ok[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const long long r = m0 + (tid + i * kThreads) / CPR;
    a_ok[i] = r < a.R;
    long long src = r;
    if (a.stride != 1) {
      const long long wo = r % a.out_w, q = r / a.out_w;
      const long long ho = q % a.out_h, b = q / a.out_h;
      src = (b * a.in_h + ho * a.stride) * a.in_w + wo * a.stride;
    }
    a_off[i] = src * a.K;
  }
  long long b_off[B_PER];
  bool b_ok[B_PER];
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int n = n0 + (tid + i * kThreads) / CPR;
    b_ok[i] = n < a.N;
    b_off[i] = (long long)n * a.K;
  }

  uint4 ra[A_PER], rb[B_PER];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i)
      ra[i] = load_chunk<BF16>(x, a_off[i],
                               k0 + ((tid + i * kThreads) % CPR) * CH, a.K,
                               a_ok[i], a.vec);
#pragma unroll
    for (int i = 0; i < B_PER; ++i)
      rb[i] = load_chunk<BF16>(w, b_off[i],
                               k0 + ((tid + i * kThreads) % CPR) * CH, a.K,
                               b_ok[i], a.vec);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int num_k = (a.K + BK - 1) / BK;
  load_tiles(0);
  for (int kt = 0; kt < num_k; ++kt) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[(c / CPR) * LDS + (c % CPR) * CH]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&Bs[(c / CPR) * LDS + (c % CPR) * CH]) = rb[i];
    }
    __syncthreads();
    if (kt + 1 < num_k) load_tiles((kt + 1) * BK);   // in flight meanwhile

    if constexpr (BF16) {
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t fa[MT][4], fb[NT][2];
        const int kk = ks + t * 2;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = wm * WM + i * 16 + g;
          fa[i][0] = *reinterpret_cast<const uint32_t*>(&As[r * LDS + kk]);
          fa[i][1] = *reinterpret_cast<const uint32_t*>(&As[(r + 8) * LDS + kk]);
          fa[i][2] = *reinterpret_cast<const uint32_t*>(&As[r * LDS + kk + 8]);
          fa[i][3] =
              *reinterpret_cast<const uint32_t*>(&As[(r + 8) * LDS + kk + 8]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wn * WN + j * 8 + g;
          fb[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[n * LDS + kk]);
          fb[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[n * LDS + kk + 8]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], fa[i], fb[j]);
      }
    } else {
      // the same accumulator elements as the mma layout: rows g and g + 8
      // of each 16-row tile, columns 2t and 2t + 1 of each 8-column tile
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float va[MT][2], vb[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = wm * WM + i * 16 + g;
          va[i][0] = As[r * LDS + k];
          va[i][1] = As[(r + 8) * LDS + k];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wn * WN + j * 8 + t * 2;
          vb[j][0] = Bs[n * LDS + k];
          vb[j][1] = Bs[(n + 1) * LDS + k];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            acc[i][j][0] = fmaf(va[i][0], vb[j][0], acc[i][j][0]);
            acc[i][j][1] = fmaf(va[i][0], vb[j][1], acc[i][j][1]);
            acc[i][j][2] = fmaf(va[i][1], vb[j][0], acc[i][j][2]);
            acc[i][j][3] = fmaf(va[i][1], vb[j][1], acc[i][j][3]);
          }
      }
    }
    __syncthreads();
  }

  // Epilogue on the accumulators: scale, bias, residual, ReLU, one cast.
  const raw* res = static_cast<const raw*>(a.res);
  raw* out = static_cast<raw*>(a.out);
  const bool pairs = (a.N % 2) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn * WN + j * 8 + t * 2;
    float s[2], bb[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = n + e < a.N;
      s[e] = (ok && a.scale) ? a.scale[n + e] : 1.f;
      bb[e] = ok ? a.bias[n + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = m0 + wm * WM + i * 16 + g + h * 8;
        if (r >= a.R) continue;
        const long long o = r * a.N + n;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[i][j][h * 2 + e] * s[e] + bb[e];
          if (res && n + e < a.N) v[e] += T::to_f(res[o + e]);
          if (a.relu) v[e] = fmaxf(v[e], 0.f);
        }
        if (pairs && n + 1 < a.N) {
          if constexpr (BF16) {
            const uint32_t p = uint32_t(T::from_f(v[0])) |
                               (uint32_t(T::from_f(v[1])) << 16);
            *reinterpret_cast<uint32_t*>(&out[o]) = p;
          } else {
            *reinterpret_cast<float2*>(&out[o]) = make_float2(v[0], v[1]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < a.N) out[o + e] = T::from_f(v[e]);
        }
      }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w, residual and out share it).
// Returns a cudaError_t; 0 means the kernel was launched.
extern "C" int clipbert_matmul_bn_act(
    const void* x, const void* w, const void* scale, const void* bias,
    const void* residual, void* out, int dtype, long long R, int K, int N,
    int stride, long long in_h, long long in_w, long long out_h,
    long long out_w, int relu, void* stream) {
  if (R < 0 || K <= 0 || N <= 0 || stride < 1) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const int chunk_bytes = 16;
  const int esize = dtype == 1 ? 2 : 4;
  Args a{x, w, static_cast<const float*>(scale),
         static_cast<const float*>(bias), residual, out, R, K, N, stride,
         relu, 0, in_h, in_w, out_h, out_w};
  a.vec = (K * esize) % chunk_bytes == 0 &&
          reinterpret_cast<uintptr_t>(x) % chunk_bytes == 0 &&
          reinterpret_cast<uintptr_t>(w) % chunk_bytes == 0;
  const long long tiles = ((R + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      matmul_bn_act_kernel<false><<<unsigned(tiles), kThreads, 0, st>>>(a);
      break;
    case 1:
      matmul_bn_act_kernel<true><<<unsigned(tiles), kThreads, 0, st>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
