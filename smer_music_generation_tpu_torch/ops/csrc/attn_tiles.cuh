// Tensor-core tile helpers shared by the mma.sync attention kernels of this
// directory (attention.cu's flash_fwd_kernel, train_attention.cu's
// train_fwd_kernel and its backward pair train_bwd_rows_kernel +
// train_bwd_keys_kernel, flash_train.cu's flash_train_fwd_kernel), for
// Hopper (sm_90a), head_dim 64, bf16 operands.  flash_train.cu's backward
// pair runs on wgmma and TMA (hopper.cuh) and takes only the scalar helpers
// here (ldmatrix, pack_bf16, exp2_ftz, quad_sum) and the constants.
//
// A block of kWarps = 4 warps owns 64 rows of one operand, 16 a warp, held as
// A fragments in registers, and streams 64-row tiles of the others through
// shared memory:
//   - tiles are row-major [row][kTileLd] bf16 with the row padded from 64 to
//     72 elements (144 bytes), so the 8 row addresses of one ldmatrix phase
//     fall on 8 distinct 16-byte bank groups: no bank conflicts, and every
//     row start stays 16-byte aligned for cp.async;
//   - copies are 16-byte cp.async.cg (rows past the tensor's end are
//     zero-filled), committed as groups, in a two-stage ring: the next tile
//     is in flight while the current one is used;
//   - products are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with
//     f32 accumulators: A (16x16) fragments from ldmatrix; X Y^T of two
//     row-major tiles (QK^T, and in the backward g V^T, K Q^T, V g^T) reads
//     Y's B fragments by ldmatrix (qk_blocks), P Y (PV, and in the backward
//     ds K, wd^T g, ds^T Q) by ldmatrix.trans (pv_chunk);
//   - an accumulator of a warp's 16 x 64 tile is 8 n-blocks of 4 f32 a lane:
//     lane = 4 g + t holds rows g and g + 8, columns 8 j + 2 t and 8 j + 2 t + 1
//     of n-block j; a row's values sit in the 4 lanes of a quad, so a row
//     reduction is a quad (xor 1, 2) shuffle;
//   - the C layout of two neighbouring n-blocks is the A layout of one k16
//     chunk, so a tile computed in registers (P, wd, ds) becomes the A
//     operand of the next product in registers (pack_bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tiles {

constexpr int kHD = 64;               // head_dim
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQTile = 16 * kWarps;   // query rows a block
constexpr int kKTile = 64;            // keys a tile
constexpr int kTileLd = kHD + 8;      // padded row of a shared tile (bf16)
constexpr int kTileElems = 64 * kTileLd;
constexpr int kNB = kKTile / 8;       // n-blocks of a score tile (and of HD)
constexpr int kKC = kHD / 16;         // k16 chunks of a QK^T product

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !pred (src
// is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4-byte asynchronous copy global -> shared (through L1); zero-fills when
// !pred, src then unread but a valid address
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows p0 .. p0 + 63 of one head of a (B, L, H, 64) bf16 tensor (base at
// (b, 0, h, 0), `stride` elements between positions) into a shared tile;
// rows at or past `limit` zero-filled.  Every thread of the block takes
// part: thread i copies 16-byte chunk i % 8 of rows i / 8 + 16 u, u = 0..3,
// a trip count fixed at compile time so the loop unrolls into four copies.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          size_t stride, int p0, int limit) {
  constexpr int kChunks = kHD / 8, kStep = kThreads / kChunks;
  const int r0 = threadIdx.x / kChunks, c = 8 * (threadIdx.x % kChunks);
  const __nv_bfloat16* src = base + (size_t)(p0 + r0) * stride + c;
#pragma unroll
  for (int u = 0; u < 64 / kStep; ++u) {
    const bool ok = p0 + r0 + kStep * u < limit;
    cp_async16(dst + (r0 + kStep * u) * kTileLd + c, ok ? src + (size_t)kStep * u * stride : base,
               ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b, one m16n8k16 bf16 product with f32 sums
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of this warp's 16 rows (rows 16 w .. 16 w + 15 of a shared
// tile: Q's in the forwards and the rows kernel, K's and V's in the keys
// kernel), one per k16 chunk of head_dim.
__device__ __forceinline__ void load_a_frags(uint32_t a[kKC][4], const __nv_bfloat16* tile,
                                             int warp, int lane) {
#pragma unroll
  for (int kc = 0; kc < kKC; ++kc)
    ldsm_x4(a[kc], tile + (16 * warp + (lane & 15)) * kTileLd + 16 * kc + 8 * (lane >> 4));
}

// s[jj] = X Y^T of this warp's 16 rows of X (A fragments xa) against rows
// 8 (j0 + jj) .. 8 (j0 + jj) + 7 of a shared tile of Y (Q K^T: keys), jj <
// NJ: the n-blocks j0 .. j0 + NJ - 1 of a 16 x 64 product.  f32 sums over
// head_dim in k16 chunks 0, 1, 2, 3 (always this order, so the same tiles
// give the same bits every time, whichever n-blocks a call takes).
template <int NJ>
__device__ __forceinline__ void qk_blocks(float s[][4], const uint32_t xa[kKC][4],
                                          const __nv_bfloat16* ys, int j0, int lane) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    // matrices: dims 0-7, 8-15, 16-23, 24-31 (then 32-63)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t b[4];
      ldsm_x4(b, ys + (8 * (j0 + jj) + (lane & 7)) * kTileLd + 32 * half + 8 * (lane >> 3));
      mma_bf16(s[jj], xa[2 * half], b[0], b[1]);
      mma_bf16(s[jj], xa[2 * half + 1], b[2], b[3]);
    }
  }
}

// Two floats as one bf16 pair (lo in the low half): the A fragment of k16
// chunk kc of a 16 x 64 tile held as C fragments is the pairs of n-blocks
// 2 kc and 2 kc + 1, rows g and g + 8.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a and b rounded to bf16 (one F2FP for the pair), back as f32
__device__ __forceinline__ void round_bf16x2(float& a, float& b) {
  const float2 f = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  a = f.x;
  b = f.y;
}

// o += P Y for one k16 chunk of Y's rows (rows 16 kc .. 16 kc + 15 of a
// shared tile: V's keys in PV) and all 64 dims; `a` is P's A fragment of
// that chunk.
__device__ __forceinline__ void pv_chunk(float o[kNB][4], const uint32_t a[4],
                                         const __nv_bfloat16* ys, int kc, int lane) {
#pragma unroll
  for (int jp = 0; jp < kNB / 2; ++jp) {
    // matrices: rows 0-7 / 8-15 of the chunk, dims 16 jp .. + 7 / + 8 .. + 15
    uint32_t b[4];
    ldsm_x4_trans(b, ys + (16 * kc + (lane & 15)) * kTileLd + 16 * jp + 8 * (lane >> 4));
    mma_bf16(o[2 * jp], a, b[0], b[1]);
    mma_bf16(o[2 * jp + 1], a, b[2], b[3]);
  }
}

// 2^x on the SFU (MUFU.EX2), denormal results flushed to zero: one
// instruction where exp2f adds a range check and two scalings around it
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A warp's 16 x 64 f32 accumulator, as bf16, into rows 16 w .. of a shared
// [64][kTileLd] tile, then (after a block barrier the caller places) rows
// t0 .. t0 + 63 of the block out to a (B, T, H, 64) tensor in 16-byte stores.
__device__ __forceinline__ void stage_out(__nv_bfloat16* os, const float o[kNB][4],
                                          float inv0, float inv1, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    __nv_bfloat16* r0 = os + (16 * warp + g) * kTileLd + 8 * j + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(r0) = __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * kTileLd) =
        __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
  }
}

__device__ __forceinline__ void store_out(__nv_bfloat16* ob, const __nv_bfloat16* os,
                                          size_t stride, int t0, int T) {
  constexpr int kChunks = kHD / 8, kStep = kThreads / kChunks;
  const int r0 = threadIdx.x / kChunks, c = 8 * (threadIdx.x % kChunks);
#pragma unroll
  for (int u = 0; u < kQTile / kStep; ++u) {
    const int r = r0 + kStep * u;
    if (t0 + r < T)
      *reinterpret_cast<uint4*>(ob + (size_t)(t0 + r) * stride + c) =
          *reinterpret_cast<const uint4*>(os + r * kTileLd + c);
  }
}

// The base pointers the kernels cast to 16-byte vectors must be aligned so.
__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace attn_tiles
