// Fused multi-head attention core for Hopper (sm_90a), plain C interface.
//
// Replaces clipbert_tpu/ops/pallas_attention.py::fused_attention (Pallas
// kernel body `_kernel`): for every batch item b and head h
//
//   out[b, :, h, :] = softmax(q[b, :, h, :] k[b, :, h, :]^T * scale
//                             + key_bias[b, None, :]) v[b, :, h, :]
//
// with the same casts: scores accumulate in fp32, the softmax is the exact
// full-row fp32 softmax (row max, then sum; not an online softmax), the
// probabilities are rounded to v's dtype before the PV product, PV
// accumulates in fp32, and the result is written in q's dtype.
//
// What bounds it on this card: at the scoring shape (S = 69, H = 12,
// dh = 64) one (b, h) pair is 4*S*S*dh ~ 1.2 MFLOP over ~35 KB of q, k, v
// and output in bf16, ~35 FLOP per byte. On the tensor cores that would be
// bound by device memory (the H100 needs ~295 FLOP/byte before its bf16
// tensor cores are the limit), so the kernel's job is to move q, k and v
// once and the output once. The unfused form writes and re-reads a
// (B, H, S, S) fp32 score tensor (1.9 GB at B = 8192): this design keeps
// each tile's scores in shared memory and never writes them out. This
// first version does its two small products on the fp32 CUDA cores
// (~67 TFLOP/s, ~20 FLOP/byte at full memory bandwidth), so it is bound by
// FMA and shared-memory issue rather than by memory; moving the products to
// mma/wgmma is later work.
//
// Design: one block of 8 warps per (batch item, head, tile of query rows).
// The tile's queries and its score rows sit in shared memory; K, then V,
// are staged through a shared buffer in chunks of keys (the whole sequence
// in one chunk at S = 69) with 16-byte loads where the operands allow.
// Each warp owns every 8th query row of the tile (R rows, a compile-time
// count): for the scores, lanes split the keys and each lane keeps R row
// sums in registers, reading 4 dims of q and k per shared-memory load; a
// warp-shuffle max and sum give the softmax; for PV, lanes split the head
// dimension (DPL dims each) and keep R x DPL sums in registers, reading 4
// probabilities per load. Sums run in the same order as a sequential FMA
// chain. Operands may be strided views (any batch, sequence and head
// stride, contiguous head dimension), so the three slices of a merged QKV
// projection go in without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSeq = 640;
constexpr int kMaxHeadDim = 128;
constexpr int kScoreBytes = 96 * 1024;       // budget for the score tile
constexpr int kSmemBytes = 200 * 1024;       // of the 227 KB a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  long long b, s, h;   // in elements; the head dimension is contiguous
};

// 16 bytes of T -> fp32 into dst[0 .. 16/sizeof(T)), dst 16-byte aligned
__device__ __forceinline__ void widen16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void widen16(float* dst, const __nv_bfloat16* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Stage rows [c0, c0 + n) of one head of q, K or V into `dst` as fp32 with
// row stride `ld` floats (a multiple of 4). `vec`: every row starts on a
// 16-byte boundary, so each thread moves 16 bytes per load.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           long long row_stride, int c0,
                                           int n, int dh, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = dh / E;
    for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
      const int j = i / per_row, e = (i - j * per_row) * E;
      widen16(dst + j * ld + e, src + (long long)(c0 + j) * row_stride + e);
    }
  } else {
    for (int i = threadIdx.x; i < n * dh; i += kThreads) {
      const int j = i / dh, d = i - j * dh;
      dst[j * ld + d] = to_f32(src[(long long)(c0 + j) * row_stride + d]);
    }
  }
}

// R: query rows per warp (tile = 8 R rows); DPL: head dims per lane in PV.
template <typename T, int R, int DPL>
__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ key_bias,
                       T* __restrict__ out, Strides qst, Strides kst,
                       Strides vst, int S, int H, int dh, int k_chunk,
                       int n_tiles, float scale, bool vec) {
  constexpr int q_tile = kWarps * R;
  const int Sp = (S + 3) & ~3;          // score row stride, 16-byte rows
  const int ld = dh + 4;                // K/V row stride: conflict-free
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [q_tile][dh]
  float* p_s = q_s + q_tile * dh;                 // [q_tile][Sp]
  float* kv_s = p_s + q_tile * Sp;                // [k_chunk][ld]

  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % H;
  const long long b = bh / H;
  const int row0 = tile * q_tile;
  const int rows = min(q_tile, S - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this warp owns tile rows warp + i * kWarps for i < my_rows (<= R)
  const int my_rows = rows > warp ? (rows - warp + kWarps - 1) / kWarps : 0;

  const T* qb = q + b * qst.b + h * qst.h;
  const T* kb = k + b * kst.b + h * kst.h;
  const T* vb = v + b * vst.b + h * vst.h;
  const float* bias = key_bias + b * S;

  stage_rows(q_s, dh, qb, qst.s, row0, rows, dh, vec);

  // ---- pass 1: scores = q k^T * scale + key_bias --------------------------
  for (int c0 = 0; c0 < S; c0 += k_chunk) {
    const int kc = min(k_chunk, S - c0);
    __syncthreads();                    // q staged / previous chunk consumed
    stage_rows(kv_s, ld, kb, kst.s, c0, kc, dh, vec);
    __syncthreads();
    for (int j = lane; j < kc; j += 32) {
      float acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = 0.f;
      const float4* kr = reinterpret_cast<const float4*>(kv_s + j * ld);
      for (int d4 = 0; d4 < dh / 4; ++d4) {
        const float4 kv = kr[d4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (i < my_rows) {
            const float4 qv = reinterpret_cast<const float4*>(
                q_s + (warp + i * kWarps) * dh)[d4];
            acc[i] = fmaf(qv.x, kv.x, acc[i]);
            acc[i] = fmaf(qv.y, kv.y, acc[i]);
            acc[i] = fmaf(qv.z, kv.z, acc[i]);
            acc[i] = fmaf(qv.w, kv.w, acc[i]);
          }
        }
      }
      const float bj = bias[c0 + j];
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (i < my_rows) p_s[(warp + i * kWarps) * Sp + c0 + j] = acc[i] * scale + bj;
    }
  }
  __syncwarp();

  // ---- exact fp32 softmax over each full row; P rounded to v's dtype -----
  for (int i = 0; i < my_rows; ++i) {
    float* pr = p_s + (warp + i * kWarps) * Sp;
    float m = -CUDART_INF_F;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) pr[j] = to_f32(from_f32<T>(pr[j] / sum));
  }

  // ---- pass 2: out = P v ---------------------------------------------------
  float acc[R][DPL];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  bool has_d[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) has_d[c] = lane + 32 * c < dh;

  for (int c0 = 0; c0 < S; c0 += k_chunk) {   // k_chunk % 4 == 0 or == S
    const int kc = min(k_chunk, S - c0);
    __syncthreads();                    // K chunk / previous V chunk consumed
    stage_rows(kv_s, ld, vb, vst.s, c0, kc, dh, vec);
    __syncthreads();
    int j = 0;
    for (; j + 4 <= kc; j += 4) {
      float vd[4][DPL];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          vd[t][c] = has_d[c] ? kv_s[(j + t) * ld + lane + 32 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i < my_rows) {
          const float4 p = *reinterpret_cast<const float4*>(
              p_s + (warp + i * kWarps) * Sp + c0 + j);
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            acc[i][c] = fmaf(p.x, vd[0][c], acc[i][c]);
            acc[i][c] = fmaf(p.y, vd[1][c], acc[i][c]);
            acc[i][c] = fmaf(p.z, vd[2][c], acc[i][c]);
            acc[i][c] = fmaf(p.w, vd[3][c], acc[i][c]);
          }
        }
      }
    }
    for (; j < kc; ++j) {
      float vd[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        vd[c] = has_d[c] ? kv_s[j * ld + lane + 32 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i < my_rows) {
          const float p = p_s[(warp + i * kWarps) * Sp + c0 + j];
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(p, vd[c], acc[i][c]);
        }
      }
    }
  }

  // output is a fresh contiguous (B, S, H, dh) tensor
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < my_rows) {
      const long long r = row0 + warp + i * kWarps;
      T* orow = out + ((b * S + r) * H + h) * dh;
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        if (has_d[c]) orow[lane + 32 * c] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T, int R, int DPL>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const float* key_bias, void* out, int B, int S,
                        int H, int dh, Strides qst, Strides kst, Strides vst,
                        float scale, bool vec, cudaStream_t stream) {
  constexpr int q_tile = kWarps * R;
  const int Sp = (S + 3) & ~3, ld = dh + 4;
  const int fixed = 4 * (q_tile * dh + q_tile * Sp);
  int k_chunk = (kSmemBytes - fixed) / (4 * ld);
  if (k_chunk >= S) k_chunk = S;
  else k_chunk &= ~3;                   // chunks start on 16-byte score offsets
  if (k_chunk < 4 && k_chunk < S) return cudaErrorInvalidValue;
  const size_t smem = fixed + 4 * (size_t)k_chunk * ld;
  const int n_tiles = (S + q_tile - 1) / q_tile;
  const long long blocks = (long long)B * H * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;

  auto kern = fused_attention_kernel<T, R, DPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_bias, static_cast<T*>(out), qst, kst,
      vst, S, H, dh, k_chunk, n_tiles, scale, vec);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const float* key_bias, void* out, int B, int S,
                        int H, int dh, Strides qst, Strides kst, Strides vst,
                        float scale, bool vec, cudaStream_t stream) {
  if (dh <= 32)
    return launch_tile<T, R, 1>(q, k, v, key_bias, out, B, S, H, dh, qst,
                                kst, vst, scale, vec, stream);
  if (dh <= 64)
    return launch_tile<T, R, 2>(q, k, v, key_bias, out, B, S, H, dh, qst,
                                kst, vst, scale, vec, stream);
  return launch_tile<T, R, 4>(q, k, v, key_bias, out, B, S, H, dh, qst, kst,
                              vst, scale, vec, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* key_bias, void* out, int B, int S, int H,
                   int dh, Strides qst, Strides kst, Strides vst,
                   float scale, cudaStream_t stream) {
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 || dh < 8 || dh % 8 != 0 ||
      dh > kMaxHeadDim)
    return cudaErrorInvalidValue;
  // 16-byte staging loads need every row of q, k and v 16-byte aligned
  auto rows16 = [](const Strides& st) {
    const long long e = sizeof(T);
    return (st.b * e) % 16 == 0 && (st.s * e) % 16 == 0 &&
           (st.h * e) % 16 == 0;
  };
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   rows16(qst) && rows16(kst) && rows16(vst);
  // rows per warp: the whole sequence in one tile where it fits (S = 69:
  // 9 rows per warp, one tile), else the largest tile whose score rows
  // stay within their budget
  const int Sp = (S + 3) & ~3;
  const int choices[] = {1, 2, 4, 9, 16};
  int R = 1;
  for (int c : choices) {
    if (kWarps * c * Sp * 4 > kScoreBytes) break;
    R = c;
    if (kWarps * c >= S) break;
  }
  switch (R) {
#define CLIPBERT_ROWS(RR)                                                    \
  case RR:                                                                   \
    return launch_rows<T, RR>(q, k, v, key_bias, out, B, S, H, dh, qst, kst, \
                              vst, scale, vec, stream);
    CLIPBERT_ROWS(1)
    CLIPBERT_ROWS(2)
    CLIPBERT_ROWS(4)
    CLIPBERT_ROWS(9)
    CLIPBERT_ROWS(16)
#undef CLIPBERT_ROWS
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). key_bias is
// a contiguous (B, S) float32 array, out a contiguous (B, S, H, dh) array.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int clipbert_fused_attention(
    const void* q, const void* k, const void* v, const void* key_bias,
    void* out, int dtype, int B, int S, int H, int dh, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  const Strides qst{q_sb, q_ss, q_sh}, kst{k_sb, k_ss, k_sh},
      vst{v_sb, v_ss, v_sh};
  const float* bias = static_cast<const float*>(key_bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, bias, out, B, S, H, dh, qst, kst, vst,
                           scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, bias, out, B, S, H, dh, qst, kst,
                                   vst, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
