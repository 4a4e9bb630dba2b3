// Fused multi-head attention core for Hopper (sm_90a), plain C interface.
//
// Replaces clipbert_tpu/ops/pallas_attention.py::fused_attention (Pallas
// kernel body `_kernel`), and through it fused_attention_shard_heads, which
// runs the same body on a rank's heads: for every batch item b and head h
//
//   out[b, :, h, :] = softmax(q[b, :, h, :] k[b, :, h, :]^T * scale
//                             + key_bias[b, None, :]) v[b, :, h, :]
//
// with the same casts: scores accumulate in fp32, the softmax is the exact
// full-row fp32 softmax (row max, then exp, then sum, then divide; not an
// online softmax), the probabilities are rounded to v's dtype after the
// division, PV accumulates in fp32, and the result is written in q's dtype.
//
// What bounds it on this card: at the scoring shape (S = 69, H = 12,
// dh = 64) one (b, h) pair is 4*S*S*dh ~ 1.2 MFLOP over ~35 KB of q, k, v
// and output in bf16, ~35 FLOP per byte, far below the ~295 FLOP per byte
// at which the H100's bf16 tensor cores rather than its 3.35 TB/s of device
// memory are the limit. So the bound is bytes: q, k and v read once and the
// output written once (0.0648 ms at B = 512). The unfused form writes and
// re-reads a (B, H, S, S) fp32 score tensor (1.9 GB at B = 8192); both
// bodies below keep the scores on chip and never write them out.
//
// Two hand-written bodies; the wrapper (ops/fused_attention.py::_plan)
// chooses one by dtype and shape and passes its plan (body, blocks,
// threads, shared-memory bytes, 16-byte staging), which the launcher here
// derives again and refuses if it differs (kPlanMismatch).
//
// Body "tc" (tensor cores; bf16, dh a multiple of 16 up to 128, S up to
// kTcMaxSeq = 128, the whole main path). The products move to the tensor
// cores: on the fp32 CUDA cores (67 TFLOP/s) the two products alone at
// B = 512 would take ~0.11 ms, above the byte bound.
//   - One block per (batch item, head), blockIdx.x = b * H + h, so
//     neighbouring blocks read neighbouring heads of the same rows. One
//     warp per 16 query rows: S is padded to SP = 16 * KT inside the kernel
//     (S = 69: 80 rows and keys, 5 warps); nothing is padded in memory.
//   - K and V of the (b, h) are staged into shared memory as bf16, rows
//     padded to DH + 8 elements (a pitch of 16 bytes times an odd number,
//     so each 8-row ldmatrix hits 8 distinct bank groups). Where every row
//     of q, k and v starts on a 16-byte boundary (the merged-QKV views: row
//     pitch 2304 or 1152 elements) they are copied with cp.async, K in one
//     group and V in the next, so V lands while Q K^T and the softmax run;
//     otherwise element by element. Padded key rows are zero-filled.
//   - Q goes straight from device memory into the A fragments (two bf16
//     per 32-bit load), padded query rows as zeros.
//   - S = Q K^T on mma.sync m16n8k16 (bf16 in, fp32 accumulate). K's
//     [key][dim] rows are the column-major B operand as they stand, so its
//     fragments come through ldmatrix without a transpose. A thread holds
//     2 * KT n-tiles x 4 scores (40 at S = 69).
//   - The softmax runs on those registers: scale and key_bias added (two
//     roundings, as the plain version), padded keys j >= S set to -inf (a
//     padded key with a finite score would shift every row), row max and
//     sum over the 4 threads of a quad with __shfl_xor_sync, expf, divide.
//     The probabilities are rounded to bf16 and the m16n8 accumulator
//     pairs become the A fragments of the PV product directly: P never
//     touches shared memory.
//   - O = P V on mma.sync, V's fragments through ldmatrix.trans; 2 * DK
//     n-tiles x 4 fp32 accumulators (32 at dh = 64), cast to bf16 and
//     stored as pairs. Padded query rows are never written.
//   - Budget at S = 69, dh = 64: 4 * SP * (DH + 8) = 23,040 bytes of
//     shared memory per block and 88 registers a thread (ptxas), so four
//     blocks (20 warps) fit on an SM; no instantiation spills
//     (chip_smoke.py phase 2 checks it).
//   On an H100 80GB HBM3 at 700 W it takes 0.18 ms at (B, S, H, dh) =
//   (512, 69, 12, 64), 35% of its byte bound, against 0.32 ms for SDPA and
//   0.68 ms for body v2 (PERF.md).
//   Why mma.sync and not wgmma here: wgmma takes 64-row M tiles, so S = 69
//   would pad to 128 rows (85% more product work and registers), and it
//   wants B in the canonical swizzled shared-memory layout. At ~35 FLOP per
//   byte the kernel is bound by bytes, and mma.sync's rate is far above
//   what the bytes allow. wgmma + TMA is for a later change, if the card
//   shows this body bound by instruction throughput rather than by bytes.
//
// Body "v2" (the first body, unchanged; fp32 operands, S above kTcMaxSeq,
// dh not a multiple of 16): one block of 8 warps per (batch item, head, tile
// of query rows); the tile's queries and its score rows sit in shared
// memory in fp32; K, then V, are staged through a shared buffer in chunks
// of keys with 16-byte loads where the operands allow. Each warp owns every
// 8th query row of the tile (R rows, a compile-time count): for the
// scores, lanes split the keys and each lane keeps R row sums in
// registers; a warp-shuffle max and sum give the softmax; for PV, lanes
// split the head dimension (DPL dims each) and keep R x DPL sums in
// registers. The products run on the fp32 CUDA cores, summed in the order
// of a sequential FMA chain, which is what the fp32 comparisons need.
//
// Operands may be strided views for both bodies (any batch, sequence and
// head stride, contiguous head dimension), so the three slices of a merged
// QKV projection go in without a copy.

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

// ---- body "tc": both products on mma.sync, the softmax in registers -------

constexpr int kTcMaxSeq = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats -> two bf16 (round to nearest even, as torch's cast), the
// first in the low half: the element order of an mma fragment register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// two neighbouring bf16 of device memory; `vec`: 4-byte aligned
__device__ __forceinline__ uint32_t load_pair(const uint16_t* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  return uint32_t(p[0]) | (uint32_t(p[1]) << 16);
}

// Rows [0, S) of one head into dst [16 KT][DH + 8] as bf16, rows [S, 16 KT)
// zero. 16 KT rows x DH / 8 chunks of 16 bytes is DK chunks per thread.
// `vec`: cp.async (the caller commits the group), else element by element.
template <int KT, int DK>
__device__ __forceinline__ void stage_tc(uint16_t* dst, const uint16_t* src,
                                         long long row_stride, int S,
                                         bool vec) {
  constexpr int LD = 16 * DK + 8, CPR = 2 * DK;
#pragma unroll
  for (int it = 0; it < DK; ++it) {
    const int i = threadIdx.x + it * 32 * KT;
    const int j = i / CPR, c = (i - j * CPR) * 8;
    uint16_t* d = dst + j * LD + c;
    if (j >= S) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if (vec) {
      cp_async16(d, src + j * row_stride + c);
    } else {
      union { uint4 u; uint16_t e[8]; } x;
#pragma unroll
      for (int e = 0; e < 8; ++e) x.e[e] = src[j * row_stride + c + e];
      *reinterpret_cast<uint4*>(d) = x.u;
    }
  }
}

// KT: 16-key tiles (S <= 16 KT, one warp per 16 query rows); DK: dh / 16.
template <int KT, int DK>
__global__ void __launch_bounds__(32 * KT)
fused_attention_tc_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const float* __restrict__ key_bias,
                          uint16_t* __restrict__ out, Strides qst,
                          Strides kst, Strides vst, int S, int H,
                          float scale, bool vec) {
  constexpr int DH = 16 * DK, LD = DH + 8;
  constexpr int NT = 2 * KT;            // 8-key n-tiles of a score row
  constexpr int ON = 2 * DK;            // 8-dim n-tiles of an output row
  extern __shared__ uint4 smem_tc[];
  uint16_t* k_s = reinterpret_cast<uint16_t*>(smem_tc);   // [16 KT][LD]
  uint16_t* v_s = k_s + 16 * KT * LD;                      // [16 KT][LD]

  const int h = blockIdx.x % H;
  const long long b = blockIdx.x / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* qb = q + b * qst.b + h * qst.h;
  const uint16_t* kb = k + b * kst.b + h * kst.h;
  const uint16_t* vb = v + b * vst.b + h * vst.h;
  const float* bias = key_bias + b * S;

  stage_tc<KT, DK>(k_s, kb, kst.s, S, vec);
  cp_async_commit();
  stage_tc<KT, DK>(v_s, vb, vst.s, S, vec);
  cp_async_commit();

  // Q's A fragments: rows r0 = 16 warp + g and r0 + 8, dims 16 ks + 2t (+1)
  // and 16 ks + 8 + 2t (+1)
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  uint32_t qf[DK][4];
#pragma unroll
  for (int ks = 0; ks < DK; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = r0 < S ? load_pair(qb + r0 * qst.s + c, vec) : 0u;
    qf[ks][1] = r1 < S ? load_pair(qb + r1 * qst.s + c, vec) : 0u;
    qf[ks][2] = r0 < S ? load_pair(qb + r0 * qst.s + c + 8, vec) : 0u;
    qf[ks][3] = r1 < S ? load_pair(qb + r1 * qst.s + c + 8, vec) : 0u;
  }

  cp_async_wait<1>();                   // this thread's K copies landed
  __syncthreads();                      // everyone's

  // ---- scores = Q K^T: ldmatrix.x4 gives the B fragments of two n-tiles
  // (keys 16 np .. +15) at one k-step (dims 16 ks .. +15): lanes 0-7 point
  // at keys +0..7 dims +0, 8-15 keys +0..7 dims +8, 16-23 keys +8..15
  // dims +0, 24-31 keys +8..15 dims +8
  float sc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int ks = 0; ks < DK; ++ks) {
#pragma unroll
    for (int np = 0; np < KT; ++np) {
      uint32_t kf[4];
      ldmatrix_x4(kf, k_s + (np * 16 + k_row) * LD + ks * 16 + k_col);
      mma_bf16(sc[2 * np], qf[ks], kf[0], kf[1]);
      mma_bf16(sc[2 * np + 1], qf[ks], kf[2], kf[3]);
    }
  }

  // ---- exact full-row softmax on the accumulators: this thread holds
  // rows r0 (elements 0, 1) and r1 (2, 3) at keys 8 n + 2t (+1) ---------
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = n * 8 + 2 * t + e;
      const float bj = j < S ? bias[j] : 0.f;
      sc[n][e] = j < S ? __fadd_rn(__fmul_rn(sc[n][e], scale), bj)
                       : -CUDART_INF_F;
      sc[n][e + 2] = j < S ? __fadd_rn(__fmul_rn(sc[n][e + 2], scale), bj)
                           : -CUDART_INF_F;
    }
    mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
    mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    sc[n][0] = expf(sc[n][0] - mx0);
    sc[n][1] = expf(sc[n][1] - mx0);
    sc[n][2] = expf(sc[n][2] - mx1);
    sc[n][3] = expf(sc[n][3] - mx1);
    sum0 += sc[n][0] + sc[n][1];
    sum1 += sc[n][2] + sc[n][3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  // P in bf16, packed as the A fragments of PV: k-step kt takes keys
  // 16 kt .. +15, i.e. n-tiles 2 kt (registers 0, 1) and 2 kt + 1 (2, 3)
  uint32_t pf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const float* lo = sc[2 * kt];
    const float* hi = sc[2 * kt + 1];
    pf[kt][0] = pack_bf16(lo[0] / sum0, lo[1] / sum0);
    pf[kt][1] = pack_bf16(lo[2] / sum1, lo[3] / sum1);
    pf[kt][2] = pack_bf16(hi[0] / sum0, hi[1] / sum0);
    pf[kt][3] = pack_bf16(hi[2] / sum1, hi[3] / sum1);
  }

  cp_async_wait<0>();                   // V landed
  __syncthreads();

  // ---- out = P V: ldmatrix.x4.trans gives the B fragments of two n-tiles
  // (dims 16 dp .. +15) at one k-step (keys 16 kt .. +15): lanes 0-7 point
  // at keys +0..7 dims +0, 8-15 keys +8..15 dims +0, 16-23 keys +0..7
  // dims +8, 24-31 keys +8..15 dims +8
  float o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_col = (lane >> 4) << 3;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int dp = 0; dp < DK; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, v_s + (kt * 16 + v_row) * LD + dp * 16 + v_col);
      mma_bf16(o[2 * dp], pf[kt], vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pf[kt], vf[2], vf[3]);
    }
  }

  // output: a fresh contiguous (B, S, H, dh) tensor; rows >= S not written
  uint16_t* o0 = out + ((b * S + r0) * H + h) * DH + 2 * t;
  uint16_t* o1 = o0 + 8LL * H * DH;
#pragma unroll
  for (int n = 0; n < ON; ++n) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o0 + n * 8) = pack_bf16(o[n][0], o[n][1]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o1 + n * 8) = pack_bf16(o[n][2], o[n][3]);
  }
}

// ---- host: plans and launches -----------------------------------------

constexpr int kPlanMismatch = -1;       // the caller's plan is not this one
constexpr int kBodyV2 = 0, kBodyTc = 1;

struct V2Plan {
  int R, k_chunk, n_tiles;
  size_t smem;
};

// v2: rows per warp R, the whole sequence in one tile where it fits (S =
// 69: 9 rows per warp, one tile), else the largest tile whose score rows
// stay within their budget; then the largest key chunk (a multiple of 4, or
// all of S) that fits beside them.
bool plan_v2(int S, int dh, V2Plan* p) {
  const int Sp = (S + 3) & ~3;
  const int choices[] = {1, 2, 4, 9, 16};
  int R = 1;
  for (int c : choices) {
    if (kWarps * c * Sp * 4 > kScoreBytes) break;
    R = c;
    if (kWarps * c >= S) break;
  }
  const int q_tile = kWarps * R, ld = dh + 4;
  const int fixed = 4 * (q_tile * dh + q_tile * Sp);
  int k_chunk = (kSmemBytes - fixed) / (4 * ld);
  if (k_chunk >= S) k_chunk = S;
  else k_chunk &= ~3;                   // chunks start on 16-byte score offsets
  if (k_chunk < 4 && k_chunk < S) return false;
  *p = V2Plan{R, k_chunk, (S + q_tile - 1) / q_tile,
              (size_t)fixed + 4 * (size_t)k_chunk * ld};
  return true;
}

template <typename T, int R, int DPL>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const float* key_bias, void* out, int B, int S,
                        int H, int dh, Strides qst, Strides kst, Strides vst,
                        float scale, bool vec, const V2Plan& p,
                        cudaStream_t stream) {
  auto kern = fused_attention_kernel<T, R, DPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)((long long)B * H * p.n_tiles), kThreads, p.smem,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), key_bias, static_cast<T*>(out),
                   qst, kst, vst, S, H, dh, p.k_chunk, p.n_tiles, scale, vec);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const float* key_bias, void* out, int B, int S,
                        int H, int dh, Strides qst, Strides kst, Strides vst,
                        float scale, bool vec, const V2Plan& p,
                        cudaStream_t stream) {
  if (dh <= 32)
    return launch_tile<T, R, 1>(q, k, v, key_bias, out, B, S, H, dh, qst,
                                kst, vst, scale, vec, p, stream);
  if (dh <= 64)
    return launch_tile<T, R, 2>(q, k, v, key_bias, out, B, S, H, dh, qst,
                                kst, vst, scale, vec, p, stream);
  return launch_tile<T, R, 4>(q, k, v, key_bias, out, B, S, H, dh, qst, kst,
                              vst, scale, vec, p, stream);
}

template <typename T>
cudaError_t launch_v2(const void* q, const void* k, const void* v,
                      const float* key_bias, void* out, int B, int S, int H,
                      int dh, Strides qst, Strides kst, Strides vst,
                      float scale, bool vec, const V2Plan& p,
                      cudaStream_t stream) {
  switch (p.R) {
#define CLIPBERT_ROWS(RR)                                                    \
  case RR:                                                                   \
    return launch_rows<T, RR>(q, k, v, key_bias, out, B, S, H, dh, qst, kst, \
                              vst, scale, vec, p, stream);
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

template <int KT, int DK>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* key_bias, void* out, int B, int S, int H,
                      Strides qst, Strides kst, Strides vst, float scale,
                      bool vec, int smem, cudaStream_t stream) {
  auto kern = fused_attention_tc_kernel<KT, DK>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(unsigned)((long long)B * H), 32 * KT, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), key_bias, static_cast<uint16_t*>(out),
      qst, kst, vst, S, H, scale, vec);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_tc_dk(int DK, const void* q, const void* k, const void* v,
                         const float* key_bias, void* out, int B, int S,
                         int H, Strides qst, Strides kst, Strides vst,
                         float scale, bool vec, int smem,
                         cudaStream_t stream) {
  switch (DK) {
#define CLIPBERT_DK(D)                                                      \
  case D:                                                                   \
    return launch_tc<KT, D>(q, k, v, key_bias, out, B, S, H, qst, kst, vst, \
                            scale, vec, smem, stream);
    CLIPBERT_DK(1)
    CLIPBERT_DK(2)
    CLIPBERT_DK(3)
    CLIPBERT_DK(4)
    CLIPBERT_DK(5)
    CLIPBERT_DK(6)
    CLIPBERT_DK(7)
    CLIPBERT_DK(8)
#undef CLIPBERT_DK
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_tc_any(int KT, int DK, const void* q, const void* k,
                          const void* v, const float* key_bias, void* out,
                          int B, int S, int H, Strides qst, Strides kst,
                          Strides vst, float scale, bool vec, int smem,
                          cudaStream_t stream) {
  switch (KT) {
#define CLIPBERT_KT(K)                                                     \
  case K:                                                                  \
    return launch_tc_dk<K>(DK, q, k, v, key_bias, out, B, S, H, qst, kst,  \
                           vst, scale, vec, smem, stream);
    CLIPBERT_KT(1)
    CLIPBERT_KT(2)
    CLIPBERT_KT(3)
    CLIPBERT_KT(4)
    CLIPBERT_KT(5)
    CLIPBERT_KT(6)
    CLIPBERT_KT(7)
    CLIPBERT_KT(8)
#undef CLIPBERT_KT
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). body: 0 =
// v2, 1 = tc (bfloat16, dh % 16 == 0, S <= kTcMaxSeq). key_bias is a
// contiguous (B, S) float32 array, out a contiguous (B, S, H, dh) array.
// blocks, threads, smem and vec are the caller's plan of the launch
// (ops/fused_attention.py::_plan); it must equal the one derived here.
// Returns the launch's cudaError_t (0 on success), or kPlanMismatch;
// does not synchronise.
extern "C" int clipbert_fused_attention(
    const void* q, const void* k, const void* v, const void* key_bias,
    void* out, int dtype, int body, int B, int S, int H, int dh,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, long long blocks, int threads, int smem,
    int vec, void* stream) {
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 || dh < 8 || dh % 8 != 0 ||
      dh > kMaxHeadDim || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const Strides qst{q_sb, q_ss, q_sh}, kst{k_sb, k_ss, k_sh},
      vst{v_sb, v_ss, v_sh};
  const float* bias = static_cast<const float*>(key_bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte staging needs every row of q, k and v 16-byte aligned
  const long long e = dtype == 0 ? 4 : 2;
  auto rows16 = [e](const Strides& s) {
    return (s.b * e) % 16 == 0 && (s.s * e) % 16 == 0 && (s.h * e) % 16 == 0;
  };
  const bool v16 = aligned16(q) && aligned16(k) && aligned16(v) &&
                   rows16(qst) && rows16(kst) && rows16(vst);
  if (vec != (int)v16) return kPlanMismatch;
  if (body == kBodyTc) {
    if (dtype != 1 || dh % 16 != 0 || S > kTcMaxSeq)
      return cudaErrorInvalidValue;
    const int KT = (S + 15) / 16, DK = dh / 16;
    if (blocks != (long long)B * H || threads != 32 * KT ||
        smem != 4 * 16 * KT * (dh + 8))
      return kPlanMismatch;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    return launch_tc_any(KT, DK, q, k, v, bias, out, B, S, H, qst, kst, vst,
                         scale, v16, smem, st);
  }
  if (body != kBodyV2) return cudaErrorInvalidValue;
  V2Plan p;
  if (!plan_v2(S, dh, &p)) return cudaErrorInvalidValue;
  if (blocks != (long long)B * H * p.n_tiles || threads != kThreads ||
      smem != (long long)p.smem)
    return kPlanMismatch;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_v2<float>(q, k, v, bias, out, B, S, H, dh, qst, kst, vst,
                            scale, v16, p, st);
  return launch_v2<__nv_bfloat16>(q, k, v, bias, out, B, S, H, dh, qst, kst,
                                  vst, scale, v16, p, st);
}
