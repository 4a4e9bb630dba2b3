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
// kTcMaxSeq = 176: every joint length of the repo's configs, 69 for
// retrieval and MSRVTT-MC, 149 for MSRVTT-QA, DiDeMo and ANet, 164 for
// VQA, 169 for TGIF-QA, 174 for pretraining). The products move to the
// tensor cores: on the fp32 CUDA cores (67 TFLOP/s) the two products alone
// at B = 512, S = 69 would take ~0.11 ms, above the byte bound.
//   - One warp per 16 query rows: S is padded to 16 * KT inside the kernel
//     (S = 69: 80 rows and keys; S = 164: 176); nothing is padded in
//     memory. The KT query tiles of a (batch item, head) are split over
//     tc_splits(KT) blocks of at most kTcBlockWarps = 6 warps (S <= 96:
//     one block; S = 97-176: two blocks of 4-6 warps), blockIdx.x =
//     (b * H + h) * splits + split, so the blocks that stage the same K and
//     V are neighbours and the second read comes from L2. Why split: a row's
//     16 KT scores stay in registers, so at KT = 10-11 a thread holds 80-88
//     scores and takes 128-168 registers; one block of 11 warps then fits
//     once on an SM and waits alone on its loads, two blocks of 5-6 warps
//     fit twice (at KT = 10 three, at 128 registers) and overlap. Blocks of
//     at most 4 warps (three per (b, h)) stage K and V once more and were
//     slower (attention_ablations.py, PERF.md).
//   - K and V of the (b, h) are staged into shared memory as bf16, rows
//     padded to DH + 8 elements (a pitch of 16 bytes times an odd number,
//     so each 8-row ldmatrix hits 8 distinct bank groups). Where every row
//     of q, k and v starts on a 16-byte boundary (the merged-QKV views: row
//     pitch 2304 or 1152 elements) they are copied with cp.async, K in one
//     group and V in the next, so V lands while Q K^T and the softmax run;
//     otherwise element by element. Padded key rows are zero-filled. The
//     key bias is staged beside them in fp32, -inf on the padded keys
//     j >= S (a padded key with a finite score would shift every row), so
//     the score loop needs no bounds test.
//   - Q goes straight from device memory into the A fragments (two bf16
//     per 32-bit load), padded query rows as zeros.
//   - S = Q K^T on mma.sync m16n8k16 (bf16 in, fp32 accumulate). K's
//     [key][dim] rows are the column-major B operand as they stand, so its
//     fragments come through ldmatrix without a transpose. A thread holds
//     2 * KT n-tiles x 4 scores (40 at S = 69, 88 at S = 164-176).
//   - The exact full-row softmax runs on those registers: scale and bias
//     added (two roundings, as the plain version), row max and sum over the
//     4 threads of a quad with __shfl_xor_sync, expf, then p = e * (1 /
//     sum) (within an fp32 ulp of e / sum; the IEEE division took half the
//     body's time at S = 164). The normalized probabilities are rounded to
//     bf16 once and the m16n8 accumulator pairs become the A fragments of
//     the PV product directly: P never touches shared memory.
//   - O = P V on mma.sync, V's fragments through ldmatrix.trans; 2 * DK
//     n-tiles x 4 fp32 accumulators (32 at dh = 64), cast to bf16 and
//     stored as pairs. Padded query rows are never written; a warp past
//     the last tile (the second block of S = 161-176 has 5 live warps of
//     6) only stages.
//   - Budget: 64 * KT * (DH + 9) bytes of shared memory per block (23,360
//     at S = 69, 51,392 at S = 164-176, dh = 64). Registers a thread
//     (ptxas, dh = 64): 72 at KT = 5, 127-128 at KT = 9-10, 167 at
//     KT = 11; at most 168 for any dh. So at dh = 64 an SM holds 2 blocks
//     of 6 warps at S = 161-176, 3 of 5 at S = 129-160. No instantiation
//     spills (chip_smoke.py phase 2 checks it).
//   On an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md): 0.101 ms at
//   (B, S, H, dh) = (512, 69, 12, 64) and 1.46 ms at (8192, 69), 64% and
//   71% of the byte bound, against SDPA's 0.32 and 4.98; 0.029 ms at
//   VQA's (32, 164) and 0.169 ms at MSRVTT-QA's (256, 149), 33% and 41%
//   of the bound, against SDPA's 0.038 and 0.482 and body v2's 0.55 and
//   3.44.
//   Latent attention (DeepSeek-V3 MLA, models/deepseek_v3.py) gives q and
//   k 192 dims (128 + 64 RoPE) and v 128, under a causal mask: the same
//   body with K and V staged at their own widths (32 * KT * (dk + dv + 18)
//   bytes: 54,080 at S = 69), Q's fragments 12 k-steps deep (48
//   registers), and a causal warp skipping the key tiles past its query
//   tile in both products, so about half the product work of the full
//   square is done. The existing instantiations (dk == dv, not causal)
//   compile as before.
//   Why mma.sync and not wgmma here: wgmma takes 64-row M tiles, so S = 69
//   would pad to 128 rows (85% more product work and registers), and it
//   wants B in the canonical swizzled shared-memory layout. At ~35-80 FLOP
//   per byte the kernel is bound by bytes, and mma.sync's rate is far
//   above what the bytes allow. wgmma + TMA is for a later change, if the
//   card shows this body bound by instruction throughput rather than by
//   bytes.
//
// Body "v2" (the first body, unchanged; fp32 operands, S above kTcMaxSeq
// up to kMaxSeq = 640, dh not a multiple of 16): one block of 8 warps per
// (batch item, head, tile of query rows); the tile's queries and its score
// rows sit in shared memory in fp32; K, then V, are staged through a shared
// buffer in chunks of keys with 16-byte loads where the operands allow.
// Each warp owns every 8th query row of the tile (R rows, a compile-time
// count): for the scores, lanes split the keys and each lane keeps R row
// sums in registers; a warp-shuffle max and sum give the softmax; for PV,
// lanes split the head dimension (DPL dims each) and keep R x DPL sums in
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

constexpr int kTcMaxSeq = 176;
// latent attention's head widths (DeepSeek-V3 MLA: 128 + 64 RoPE dims of q
// and k, 128 of v), the one tc instantiation with dk != dv
constexpr int kMlaQkDim = 192, kMlaVDim = 128;

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
// zero: 16 KT rows x DH / 8 chunks of 16 bytes, spread over the block's
// threads. `vec`: cp.async (the caller commits the group), else element by
// element.
template <int KT, int DK>
__device__ __forceinline__ void stage_tc(uint16_t* dst, const uint16_t* src,
                                         long long row_stride, int S,
                                         bool vec) {
  constexpr int LD = 16 * DK + 8, CPR = 2 * DK, N = 16 * KT * CPR;
#pragma unroll 4
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
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

// Warps of one block: at most kTcBlockWarps. The KT query tiles of a
// (batch item, head) are split over `splits` = ceil(KT / kTcBlockWarps)
// blocks of ceil(KT / splits) warps each, and every block stages all of
// the (b, h)'s K and V (the blocks of one (b, h) are neighbours in the
// grid, so the second read comes from L2).
constexpr int kTcBlockWarps = 6;

__host__ __device__ constexpr int tc_splits(int KT) {
  return (KT + kTcBlockWarps - 1) / kTcBlockWarps;
}
__host__ __device__ constexpr int tc_block_threads(int KT) {
  return 32 * ((KT + tc_splits(KT) - 1) / tc_splits(KT));
}

// KT: 16-key tiles (S <= 16 KT); DK: the q/k head dim / 16; DV: v's head
// dim / 16 (DK for BERT; 8 beside DK = 12 for latent attention's 192-wide
// q/k and 128-wide v); CAUSAL: key j > query i is masked as well, and a
// warp skips the 16-key tiles past its own query tile in both products.
// One warp per 16 query rows, blockDim.x / 32 warps a block; a warp past
// the last tile only stages.
template <int KT, int DK, int DV, bool CAUSAL>
__global__ void __launch_bounds__(tc_block_threads(KT))
fused_attention_tc_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const float* __restrict__ key_bias,
                          uint16_t* __restrict__ out, Strides qst,
                          Strides kst, Strides vst, int S, int H,
                          int splits, float scale, bool vec) {
  constexpr int DH = 16 * DK, LD = DH + 8;
  constexpr int DHV = 16 * DV, LDV = DHV + 8;
  constexpr int NT = 2 * KT;            // 8-key n-tiles of a score row
  constexpr int ON = 2 * DV;            // 8-dim n-tiles of an output row
  extern __shared__ uint4 smem_tc[];
  uint16_t* k_s = reinterpret_cast<uint16_t*>(smem_tc);   // [16 KT][LD]
  uint16_t* v_s = k_s + 16 * KT * LD;                      // [16 KT][LDV]
  float* b_s = reinterpret_cast<float*>(v_s + 16 * KT * LDV);  // [16 KT]

  const int split = blockIdx.x % splits;
  const int bh = blockIdx.x / splits;
  const int h = bh % H;
  const long long b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = split * (blockDim.x >> 5) + warp;   // 16 query rows
  const bool live = tile < KT;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* qb = q + b * qst.b + h * qst.h;
  const uint16_t* kb = k + b * kst.b + h * kst.h;
  const uint16_t* vb = v + b * vst.b + h * vst.h;
  const float* bias = key_bias + b * S;

  stage_tc<KT, DK>(k_s, kb, kst.s, S, vec);
  cp_async_commit();
  stage_tc<KT, DV>(v_s, vb, vst.s, S, vec);
  cp_async_commit();
  // the key bias, -inf on the padded keys j >= S (a padded key with a
  // finite score would shift every row)
  for (int j = threadIdx.x; j < 16 * KT; j += blockDim.x)
    b_s[j] = j < S ? bias[j] : -CUDART_INF_F;

  // Q's A fragments: rows r0 = 16 tile + g and r0 + 8, dims 16 ks + 2t
  // (+1) and 16 ks + 8 + 2t (+1); rows >= S (and a dead warp's) are zero
  const int r0 = tile * 16 + g, r1 = r0 + 8;
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
  __syncthreads();                      // everyone's, and the bias

  // P in bf16, packed as the A fragments of PV: k-step kt takes keys
  // 16 kt .. +15, i.e. n-tiles 2 kt (registers 0, 1) and 2 kt + 1 (2, 3)
  uint32_t pf[KT][4];
  if (live) {
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
        if (CAUSAL && np > tile) continue;   // every key past every row
        uint32_t kf[4];
        ldmatrix_x4(kf, k_s + (np * 16 + k_row) * LD + ks * 16 + k_col);
        mma_bf16(sc[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // ---- exact full-row softmax on the accumulators: this thread holds
    // rows r0 (elements 0, 1) and r1 (2, 3) at keys 8 n + 2t (+1); scale
    // and bias added with two roundings, as the plain version
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 bj = *reinterpret_cast<const float2*>(b_s + n * 8 + 2 * t);
      sc[n][0] = __fadd_rn(__fmul_rn(sc[n][0], scale), bj.x);
      sc[n][1] = __fadd_rn(__fmul_rn(sc[n][1], scale), bj.y);
      sc[n][2] = __fadd_rn(__fmul_rn(sc[n][2], scale), bj.x);
      sc[n][3] = __fadd_rn(__fmul_rn(sc[n][3], scale), bj.y);
      if (CAUSAL) {                     // keys 8 n + 2t (+1) past rows r0, r1
        const int j0 = n * 8 + 2 * t;
        if (j0 > r0) sc[n][0] = -CUDART_INF_F;
        if (j0 + 1 > r0) sc[n][1] = -CUDART_INF_F;
        if (j0 > r1) sc[n][2] = -CUDART_INF_F;
        if (j0 + 1 > r1) sc[n][3] = -CUDART_INF_F;
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
    // p = e / sum as e * (1 / sum): within one fp32 ulp of the quotient,
    // far below the bf16 rounding that follows
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const float* lo = sc[2 * kt];
      const float* hi = sc[2 * kt + 1];
      pf[kt][0] = pack_bf16(lo[0] * inv0, lo[1] * inv0);
      pf[kt][1] = pack_bf16(lo[2] * inv1, lo[3] * inv1);
      pf[kt][2] = pack_bf16(hi[0] * inv0, hi[1] * inv0);
      pf[kt][3] = pack_bf16(hi[2] * inv1, hi[3] * inv1);
    }
  }

  cp_async_wait<0>();                   // V landed
  __syncthreads();
  if (!live) return;                    // no barrier after this point

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
    if (CAUSAL && kt > tile) continue;  // probabilities all 0 there
#pragma unroll
    for (int dp = 0; dp < DV; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, v_s + (kt * 16 + v_row) * LDV + dp * 16 + v_col);
      mma_bf16(o[2 * dp], pf[kt], vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pf[kt], vf[2], vf[3]);
    }
  }

  // output: a fresh contiguous (B, S, H, dv) tensor; rows >= S not written
  uint16_t* o0 = out + ((b * S + r0) * H + h) * DHV + 2 * t;
  uint16_t* o1 = o0 + 8LL * H * DHV;
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

// The tc plan: (b, h) split over `splits` blocks of `threads` threads;
// shared memory holds K ([16 KT][dk + 8] bf16), V ([16 KT][dv + 8]) and
// the key bias (16 KT fp32)
struct TcPlan {
  int KT, DK, DV, causal, splits, threads, smem;
};

TcPlan plan_tc(int S, int dk, int dv, int causal) {
  const int KT = (S + 15) / 16;
  return TcPlan{KT, dk / 16, dv / 16, causal, tc_splits(KT),
                tc_block_threads(KT), 32 * KT * (dk + dv + 18)};
}

// The tc body's head widths: dk == dv (a multiple of 16 up to 128, not
// causal: BERT), or latent attention's dk 192 with dv 128, causal or not
bool tc_dims_ok(int dk, int dv, int causal) {
  if (dk == kMlaQkDim && dv == kMlaVDim) return true;
  return dk == dv && dk % 16 == 0 && dk <= kMaxHeadDim && !causal;
}

template <int KT, int DK, int DV, bool CAUSAL>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* key_bias, void* out, int B, int S, int H,
                      Strides qst, Strides kst, Strides vst, float scale,
                      bool vec, const TcPlan& p, cudaStream_t stream) {
  auto kern = fused_attention_tc_kernel<KT, DK, DV, CAUSAL>;
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(unsigned)((long long)B * H * p.splits), p.threads, p.smem,
         stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), key_bias, static_cast<uint16_t*>(out),
      qst, kst, vst, S, H, p.splits, scale, vec);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_tc_dk(const void* q, const void* k, const void* v,
                         const float* key_bias, void* out, int B, int S,
                         int H, Strides qst, Strides kst, Strides vst,
                         float scale, bool vec, const TcPlan& p,
                         cudaStream_t stream) {
  if (p.DK == kMlaQkDim / 16) {
    if (p.causal)
      return launch_tc<KT, kMlaQkDim / 16, kMlaVDim / 16, true>(
          q, k, v, key_bias, out, B, S, H, qst, kst, vst, scale, vec, p,
          stream);
    return launch_tc<KT, kMlaQkDim / 16, kMlaVDim / 16, false>(
        q, k, v, key_bias, out, B, S, H, qst, kst, vst, scale, vec, p,
        stream);
  }
  switch (p.DK) {
#define CLIPBERT_DK(D)                                                     \
  case D:                                                                  \
    return launch_tc<KT, D, D, false>(q, k, v, key_bias, out, B, S, H, qst, \
                                      kst, vst, scale, vec, p, stream);
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

cudaError_t launch_tc_any(const void* q, const void* k, const void* v,
                          const float* key_bias, void* out, int B, int S,
                          int H, Strides qst, Strides kst, Strides vst,
                          float scale, bool vec, const TcPlan& p,
                          cudaStream_t stream) {
  switch (p.KT) {
#define CLIPBERT_KT(K)                                                     \
  case K:                                                                  \
    return launch_tc_dk<K>(q, k, v, key_bias, out, B, S, H, qst, kst, vst, \
                           scale, vec, p, stream);
    CLIPBERT_KT(1)
    CLIPBERT_KT(2)
    CLIPBERT_KT(3)
    CLIPBERT_KT(4)
    CLIPBERT_KT(5)
    CLIPBERT_KT(6)
    CLIPBERT_KT(7)
    CLIPBERT_KT(8)
    CLIPBERT_KT(9)
    CLIPBERT_KT(10)
    CLIPBERT_KT(11)
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
// v2 (dh == dv, not causal), 1 = tc (bfloat16, S <= kTcMaxSeq, tc_dims_ok;
// plan_tc). dh is q's and k's head width, dv v's; causal masks key j > query
// i on top of key_bias. key_bias is a contiguous (B, S) float32 array, out a
// contiguous (B, S, H, dv) array.
// blocks, threads, smem and vec are the caller's plan of the launch
// (ops/fused_attention.py::_plan); it must equal the one derived here.
// Returns the launch's cudaError_t (0 on success), or kPlanMismatch;
// does not synchronise.
extern "C" int clipbert_fused_attention(
    const void* q, const void* k, const void* v, const void* key_bias,
    void* out, int dtype, int body, int B, int S, int H, int dh, int dv,
    int causal, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, long long blocks, int threads, int smem,
    int vec, void* stream) {
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 || dh < 8 || dh % 8 != 0 ||
      (dtype != 0 && dtype != 1) || (causal != 0 && causal != 1))
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
    if (dtype != 1 || !tc_dims_ok(dh, dv, causal) || S > kTcMaxSeq)
      return cudaErrorInvalidValue;
    const TcPlan p = plan_tc(S, dh, dv, causal);
    if (blocks != (long long)B * H * p.splits || threads != p.threads ||
        smem != p.smem)
      return kPlanMismatch;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    return launch_tc_any(q, k, v, bias, out, B, S, H, qst, kst, vst, scale,
                         v16, p, st);
  }
  if (body != kBodyV2 || dh != dv || dh > kMaxHeadDim || causal)
    return cudaErrorInvalidValue;
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
